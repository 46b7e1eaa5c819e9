"""The serving cache's memory-tier hit share at the window's end
(``ServeStats.cache_hit_ratios["0:memory"]``), in %."""


def read(record: dict):
    if record.get("kind") != "serve":
        return None
    hit = record.get("cache_hit_ratios", {}).get("0:memory")
    return None if hit is None else 100.0 * hit
