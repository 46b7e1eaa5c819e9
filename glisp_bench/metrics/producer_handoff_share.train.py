"""The batch producer's share of each batch spent handing it to the
consumer, in %: the self time of the ``pipeline.put`` span (the put on the
worker's queue) over each ``pipeline.produce`` root of the program's
tracer, the median over the roots (``harness/spans.py``)."""
from glisp_bench.harness.spans import median_share


def read(record: dict):
    if record.get("kind") != "train":
        return None
    return median_share("pipeline.produce", ("pipeline.put",))
