"""stage_ms: the mean over the window's queries of a query's
plan.stats["transfer"], the host seconds staging live and archive
batches into the column cache, in ms."""

from portbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx, ("transfer",))
