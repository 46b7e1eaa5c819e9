"""How many batch producers were making batches at once, on average, while
any was: the producer-seconds spent making batches over the time at least
one producer was making one. Each ``pipeline.produce`` root of the
program's tracer (kept in the consumer, absorbed from whichever forked
producer ran it) is busy from its start until its ``pipeline.put`` (the
last span of a root: the wait for a slot on its queue) began; the busy
spans of all roots are merged on the one clock of a process and its
forks. So a stretch in which every producer waits (set-up, a compile, the
profiler starting) counts for nothing. Exactly 1 with one producer, W
when W producers are always busy together; None when the program has no
tracer or closed no such root."""


def concurrency(roots):
    """The busy producer-seconds of ``roots`` over the time their busy
    spans cover."""
    spans = sorted((r.start_ns, r.start_ns + r.dur_ns - r.self_ns.get("pipeline.put", 0))
                   for r in roots)
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    busy = sum(b - a for a, b in spans)
    covered, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    return busy / covered


def read(record: dict):
    if record.get("kind") != "train":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return concurrency(tracing.roots("pipeline.produce"))
