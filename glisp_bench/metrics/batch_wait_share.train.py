"""The share of the training window the loop spent fetching the next batch
from the batch pipeline (the benchmark's ``batch_wait`` span), in %."""


def read(record: dict):
    if record.get("kind") != "train" or not record.get("window_s"):
        return None
    return 100.0 * record["spans"].get("batch_wait", 0.0) / record["window_s"]
