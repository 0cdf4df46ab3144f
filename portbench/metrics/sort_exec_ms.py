"""sort_exec_ms: the mean over the window's queries of a query's
plan.stats["sortExec"], the host seconds of its batches' work on the
sort (keyed) route inside the batch loop, in ms; None where the program
keeps no such stage."""

from portbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx, ("sortExec",))
