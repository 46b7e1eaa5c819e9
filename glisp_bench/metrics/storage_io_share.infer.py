"""The share of each layerwise pass spent in the stores' file I/O, in %: the
self time of the ``storage.chunk_read``, ``storage.chunk_write`` and
``storage.fsync`` spans over each ``engine.pass`` root of the program's
tracer, the median over the passes (``harness/spans.py``)."""
from glisp_bench.harness.spans import median_share


def read(record: dict):
    if record.get("kind") != "infer":
        return None
    return median_share("engine.pass",
                        ("storage.chunk_read", "storage.chunk_write", "storage.fsync"))
