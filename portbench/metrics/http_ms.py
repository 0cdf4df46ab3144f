"""http_ms: the median over the window's queries of the client's
milliseconds from the send to the parsed answer less the service call's
(`QueryService.handle_aql`'s span) for the same request: the HTTP layer,
the JSON and the client's parse."""

import statistics

from portbench.metrics._common import window_queries


def read(ctx):
    vals = []
    for r in window_queries(ctx):
        span = ctx.spans.get(r[5])
        if span is not None:
            vals.append(1e3 * ((r[3] - r[2]) - (span[1] - span[0])))
    return statistics.median(vals) if vals else None
