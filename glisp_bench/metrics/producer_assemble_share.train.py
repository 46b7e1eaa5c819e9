"""The batch producer's share of each batch spent assembling the padded
batch, in %: the self time of the ``batch.*`` spans (``subgraph_to_batch``
and the feature gather inside it) over each ``pipeline.produce`` root of
the program's tracer, the median over the roots (``harness/spans.py``)."""
from glisp_bench.harness.spans import median_share


def read(record: dict):
    if record.get("kind") != "train":
        return None
    return median_share("pipeline.produce", ("batch.",))
