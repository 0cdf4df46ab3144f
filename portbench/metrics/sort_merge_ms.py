"""sort_merge_ms: the mean over the window's queries of a query's
plan.stats["sortMerge"], the host seconds of resolving its keyed batches
(capacity reruns and the device merge), in ms; None where the program
keeps no such stage."""

from portbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx, ("sortMerge",))
