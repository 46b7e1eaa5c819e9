"""The share of the timed passes the engine spent waiting on its sample
tickets (the host span around ``SampleTicket.result``), in %."""


def read(record: dict):
    if record.get("kind") != "infer" or not record.get("window_s") or not record["spans"]:
        return None
    return 100.0 * record["spans"].get("sampling_wait", 0.0) / record["window_s"]
