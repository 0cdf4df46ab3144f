"""The benchmark's arithmetic: percentiles, spreads, the union of device
intervals and the roofline's least time. Standard library and numpy."""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of values by linear interpolation
    between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, by statistics.quantiles(values, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def bound_ms(nbytes: int, flops: int = 0) -> tuple:
    """(least time in ms, what bounds it) for moving nbytes and doing flops
    float32 operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def union(intervals) -> list:
    """The disjoint, sorted intervals that cover the (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float) -> list:
    """The parts of intervals that lie in [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals) -> float:
    """The length that the union of intervals covers."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def clip_events(events, lo: float, hi: float) -> list:
    """The (name, start, end) events' parts that lie in [lo, hi]."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if min(e, hi) > max(s, lo)]
