"""scan_roofline: the least time the card needs for the window's
queries, over the time its kernels took in the window, in %.

The least time of a query is the bytes it needs (`bench.query_bytes`:
its used columns' values and validity over the rows it needs, read once,
and its output written once) over 3.35e12 B/s (`stats.bound_ms`). Each
answered query counts by the share of its time from send to answer that
lies in the window, so the queries running as it opens or closes count
as far as the kernel time counted for them does. The kernels' time is
the sum of every kernel's time in the window from the profiler, copies
and memsets left out."""

from portbench import stats as S
from portbench.bench import bytes_of
from portbench.devtrace import is_copy


def in_window(r, lo: float, hi: float) -> float:
    """The share of a record's send-to-answer time that lies in
    [lo, hi]."""
    _, _, sent, answered, _, _ = r
    if answered <= sent:
        return 0.0
    return max(0.0, min(answered, hi) - max(sent, lo)) / (answered - sent)


def read(ctx):
    if not ctx.device:
        return None
    kernel_s = sum(e - s for name, s, e in ctx.device if not is_copy(name))
    if kernel_s <= 0:
        return None
    lo, hi = ctx.window
    least_ms = 0.0
    for r in ctx.records:
        if r[4]:
            qb = ctx.query_bytes[r[0]]
            least_ms += in_window(r, lo, hi) * S.bound_ms(
                bytes_of(qb, ctx.groups[r[0]]))[0]
    return 100.0 * least_ms / 1e3 / kernel_s if least_ms else None
