"""idle_in_query_pct: the share of the time in which a query was in the
service (the union of the window's service spans, the benchmark's spans
around `QueryService.handle_aql`) that the card ran no kernel, copy or
memset (the profiler's device intervals), in %. Unlike
`device_idle_pct`, the stretches with no query in the service do not
count."""

from portbench import stats as S


def read(ctx):
    if not ctx.device:
        return None
    lo, hi = ctx.window
    served = S.union([(s, e) for s, e, _ in ctx.spans.values()
                      if lo <= s and e <= hi])
    total = sum(e - s for s, e in served)
    if total <= 0:
        return None
    busy = [(s, e) for _, s, e in ctx.device]
    covered = sum(S.covered(S.clip(busy, s, e)) for s, e in served)
    return 100.0 * (1.0 - covered / total)
