"""cache_hit_pct: the column cache's hits over its lookups in the traced
window, from DeviceColumnCache.stats() before and after it, in %."""


def read(ctx):
    before, after = ctx.cache
    hits = after["hits"] - before["hits"]
    looks = hits + after["misses"] - before["misses"]
    return 100.0 * hits / looks if looks > 0 else None
