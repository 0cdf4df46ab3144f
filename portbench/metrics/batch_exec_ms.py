"""batch_exec_ms: the mean over the window's queries of a query's
plan.stats["batchExec"], the host seconds of the batch loop, in ms."""

from portbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx, ("batchExec",))
