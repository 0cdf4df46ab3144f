"""sort_batch_pct: the batches that took the sort (keyed) route,
plan.stats["sortBatches"], over all batches, plan.stats["batches"],
summed over the window's queries, in %; None where the program counts
no such batches."""

from portbench.metrics._common import window_queries


def read(ctx):
    keyed = total = 0
    for r in window_queries(ctx):
        span = ctx.spans.get(r[5])
        st = span[2] if span is not None else None
        if not st or not isinstance(st.get("sortBatches"), int):
            continue
        keyed += st["sortBatches"]
        total += st["batches"]
    return 100.0 * keyed / total if total > 0 else None
