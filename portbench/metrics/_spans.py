"""What the readers of the program's own spans share: the window's
queries, each as its `service` span and the spans of its trace.

The spans are those that `aresdb_tpu_torch/utils/tracing.py` kept over
the window, as `ctx.program_spans`: each with its name, trace, id,
parent, start and end (ns of time.monotonic_ns(), the window's clock)
and cpu (the thread's CPU ns, or None). A run holds none where the
harness does not switch the program's tracing on, or the program has
none; each reader then returns None."""

from __future__ import annotations

import statistics


def window_queries(ctx):
    """[(service span, spans of its trace)] of each `service` span that
    lies in the window; None without one."""
    spans = getattr(ctx, "program_spans", None)
    if not spans:
        return None
    lo, hi = ctx.window
    traces = {}
    for s in spans:
        traces.setdefault(s.trace, []).append(s)
    out = [(s, traces[s.trace]) for s in spans if s.name == "service"
           and lo <= s.start / 1e9 and s.end / 1e9 <= hi]
    return out or None


def wall_ns(spans, names) -> int:
    return sum(s.end - s.start for s in spans if s.name in names)


def mean_ms(ctx, of):
    """The mean over the window's queries of of(service, trace spans), a
    number of ns, in ms; None without a query."""
    qs = window_queries(ctx)
    if qs is None:
        return None
    return statistics.fmean(of(svc, trace) for svc, trace in qs) / 1e6
