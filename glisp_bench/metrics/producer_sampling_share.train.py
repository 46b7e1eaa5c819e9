"""The batch producer's share of each batch spent sampling, in %: the self
time of the ``sampling.*`` spans (the submit and the wait, and under them
the sampling service's rounds, hops and per-server gathers) over each
``pipeline.produce`` root of the program's tracer, the median over the
roots (``harness/spans.py``)."""
from glisp_bench.harness.spans import median_share


def read(record: dict):
    if record.get("kind") != "train":
        return None
    return median_share("pipeline.produce", ("sampling.",))
