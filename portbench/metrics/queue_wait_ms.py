"""queue_wait_ms: the mean over the window's queries of the milliseconds
a query waited before its work began: its `queue` span (from the HTTP
thread's submit to a query worker's start) and its `admission` span (the
device-memory estimate and reservation), from the program's spans."""

from portbench.metrics._spans import mean_ms, wall_ns


def read(ctx):
    return mean_ms(ctx, lambda svc, trace: wall_ns(trace,
                                                   ("queue", "admission")))
