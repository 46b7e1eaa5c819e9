"""The inference engine's own share of each layerwise pass, in %: the
self time of the ``engine.pass`` and ``engine.layer`` spans (reordering,
sorting and gathering the sampled edges, outside every storage, sampling
and slice span) over each ``engine.pass`` root of the program's tracer, the
median over the passes (``harness/spans.py``)."""
from glisp_bench.harness.spans import median_share


def read(record: dict):
    if record.get("kind") != "infer":
        return None
    return median_share("engine.pass", ("engine.pass", "engine.layer"))
