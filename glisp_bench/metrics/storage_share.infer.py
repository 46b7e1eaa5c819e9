"""The share of the timed passes the engine spent in tiered storage, in %:
the host spans around store writes, cache fills and cache reads over the
passes' seconds."""


def read(record: dict):
    if record.get("kind") != "infer" or not record.get("window_s"):
        return None
    s = record["spans"]
    if not s:
        return None
    return 100.0 * (s.get("store_write", 0.0) + s.get("cache_fill", 0.0)
                    + s.get("cache_read", 0.0)) / record["window_s"]
