"""upsert_store_ms: the median milliseconds of the benchmark's span
around TableShard.save_upsert_batch for the upserts of the window: the
parse, the redo-log write and the live store's apply."""

import statistics


def read(ctx):
    lo, hi = ctx.window
    vals = [1e3 * (e - s) for s, e in ctx.store_spans if lo <= s and e <= hi]
    return statistics.median(vals) if vals else None
