"""http_self_ms: the median over the window's queries of their `http`
span's own milliseconds, less its `queue` and `service` children: the
body's read, routing, JSON and the answer's write, from the program's
spans."""

import statistics

from portbench.metrics._spans import wall_ns, window_queries


def read(ctx):
    qs = window_queries(ctx)
    if qs is None:
        return None
    vals = []
    for _, trace in qs:
        roots = [s for s in trace if s.name == "http" and s.parent is None]
        if len(roots) == 1:
            root = roots[0]
            children = [s for s in trace if s.parent == root.id]
            vals.append((root.end - root.start - wall_ns(
                children, ("queue", "service"))) / 1e6)
    return statistics.median(vals) if vals else None
