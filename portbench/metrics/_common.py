"""What the readers share: the window's answered queries and their
service spans."""

from __future__ import annotations

import statistics


def window_queries(ctx) -> list:
    """The records ([query, due, sent, answered, ok, request id]) of the
    queries due in the window and answered by its close, without
    error."""
    lo, hi = ctx.window
    return [r for r in ctx.records if r[4] and lo <= r[1] and r[3] <= hi]


def stage_mean(ctx, keys) -> float:
    """The mean over the window's queries of the summed milliseconds of
    plan.stats' stages `keys`; None without one. A mean, not a median:
    a cell's queries may differ by tens of times (D4 and D2),
    and a median of two such groups jumps between them from run to
    run."""
    vals = []
    for r in window_queries(ctx):
        span = ctx.spans.get(r[5])
        if span is None or not span[2]:
            continue
        st = span[2]
        if all(isinstance(st.get(k), float) for k in keys):
            vals.append(1e3 * sum(st[k] for k in keys))
    return statistics.fmean(vals) if vals else None
