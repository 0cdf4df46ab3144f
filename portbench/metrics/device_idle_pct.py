"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card (the union of the profiler's device
intervals), in %."""

from portbench import stats as S


def read(ctx):
    if not ctx.device:
        return None
    lo, hi = ctx.window
    busy = S.covered([(s, e) for _, s, e in ctx.device])
    return 100.0 * (1.0 - busy / (hi - lo))
