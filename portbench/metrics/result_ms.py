"""result_ms: the mean over the window's queries of a query's
plan.stats["resultFetch"] + ["postprocess"]: fetch, merge and
postprocess, in ms."""

from portbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx, ("resultFetch", "postprocess"))
