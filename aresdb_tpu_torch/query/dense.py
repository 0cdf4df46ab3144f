"""Dense group-by planning: map bounded dimensions to a small slot space.

The sort-based group-by (kernels.reduce_by_key) is fully general but pays a
64-bit sort per batch — expensive on TPU where 64-bit is emulated. Most
analytics group-bys have *bounded* dimensions: time buckets bounded by the
time filter, enums bounded by their dictionary, small ints bounded by the
data. For those, every row maps to a slot in [0, K) with
K = Π(domain_i + 1) (one extra value per dim for NULL), and aggregation is a
direct fixed-size segment reduction — no sort, no 64-bit keys.

The reference has no equivalent (its thrust sort_reduce handles everything,
query/sort_reduce.cu); this is the TPU-shaped redesign the survey calls for
(SURVEY.md §7 'Group-by on TPU').
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import time_util as TU
from aresdb_tpu_torch.query.compiler import CompiledQuery, DimensionPlan

DENSE_MAX_SLOTS = 1 << 16


@dataclass
class DimDomain:
    """Bounded integer domain of one dimension's values.

    value = (base + idx * step) / post_div   (post_div 0 → no division)
    or, for 'lookup' kind, value = values[idx].
    """

    size: int
    kind: str = "affine"            # 'affine' | 'lookup'
    base: int = 0
    step: int = 1
    post_div: float = 0.0
    values: Optional[np.ndarray] = None   # for 'lookup'

    def decode(self, idx: np.ndarray) -> np.ndarray:
        if self.kind == "lookup":
            return self.values[np.clip(idx, 0, self.size - 1)]
        if isinstance(self.step, float) or isinstance(self.base, float):
            return (np.float32(self.base)
                    + idx.astype(np.float32) * np.float32(self.step))
        v = self.base + idx.astype(np.int64) * self.step
        if self.post_div:
            return (v / self.post_div).astype(np.float32)
        return v


def _pow2_at_least(n: int, cap: int = DENSE_MAX_SLOTS) -> int:
    c = 1
    while c < n:
        c <<= 1
    return min(c, cap)


def _time_window(plan: CompiledQuery, tstats=None) -> Optional[tuple]:
    """(lo, hi) of the time values a time dimension may see: the resolved
    time filter, or — when the query has none — the batch's observed
    time-column (min, max) stats; widened by the filter's offsets. None
    without either."""
    if plan.from_ts is not None and plan.to_ts is not None:
        lo, hi = plan.from_ts, plan.to_ts
    elif tstats is not None:
        lo, hi = tstats
    else:
        return None
    return (lo + min(plan.from_offset, plan.to_offset, 0),
            hi + max(plan.from_offset, plan.to_offset, 0))


def _time_bucket_domain(plan: CompiledQuery, width: int,
                        tstats=None) -> Optional[DimDomain]:
    """Bucket domain from the resolved time filter, or — when the query has
    no time filter — from the batch's observed time-column (min, max) stats
    (the dense overflow guard keeps stale stats safe)."""
    if plan.uses_tz_table:
        # per-row offsets make the bucket range data-dependent; the sort
        # path handles it (dense overflow guard would fire anyway)
        return None
    window = _time_window(plan, tstats)
    if window is None:
        return None
    lo, hi = window
    vmin = (lo // width) * width
    vmax = (hi // width) * width
    size = (vmax - vmin) // width + 1
    if size <= 0 or size > DENSE_MAX_SLOTS:
        return None
    return DimDomain(size=int(size), base=int(vmin), step=int(width))


def _calendar_lookup_domain(plan: CompiledQuery, op: str,
                            tstats=None) -> Optional[DimDomain]:
    """Enumerate irregular bucket-start values inside the time window (as
    _time_window gives it: the batch's time stats where the query has no
    time filter)."""
    window = _time_window(plan, tstats)
    if window is None:
        return None
    import datetime as _dt

    lo, hi = window
    # walk calendar starts; bounded by window size
    starts: List[int] = []
    t = _dt.datetime.fromtimestamp(max(lo - 86400 * 370, 0),
                                   _dt.timezone.utc)
    unit = {"GET_WEEK_START": "w", "GET_MONTH_START": "M",
            "GET_QUARTER_START": "q", "GET_YEAR_START": "y"}[op]
    s, _ = TU.apply_time_offset(t, 0, unit)
    while int(s.timestamp()) <= hi:
        starts.append(int(s.timestamp()))
        s, _ = TU.apply_time_offset(s, 1, unit)
        if len(starts) > DENSE_MAX_SLOTS:
            return None
    if not starts:
        return None
    return DimDomain(size=len(starts), kind="lookup",
                     values=np.asarray(starts, np.int64))


# calendar bucketizers whose starts come from a lookup domain
CALENDAR_STARTS = ("GET_WEEK_START", "GET_MONTH_START", "GET_QUARTER_START",
                   "GET_YEAR_START")

_CALENDAR_EXTRACT_SIZES = {
    "GET_DAY_OF_MONTH": 31,
    "GET_DAY_OF_YEAR": 366,
    "GET_MONTH_OF_YEAR": 12,
    "GET_QUARTER_OF_YEAR": 4,
}


def _underlying_column_key(ast) -> Optional[tuple]:
    found: List[tuple] = []

    def visit(node):
        if not found and isinstance(node, E.VarRef) and node.table_id == 0:
            found.append((node.table_id, node.column_id))

    E.walk(ast, visit)
    return found[0] if found else None


def _column_stats(ast, stats) -> Optional[tuple]:
    """The batch's (min, max) stats of the main-table column under ast."""
    if stats is None:
        return None
    key = _underlying_column_key(ast)
    return stats.get(key) if key is not None else None


def dimension_domain(plan: CompiledQuery, dim: DimensionPlan,
                     batch_stat=None, stats=None) -> Optional[DimDomain]:
    """Infer the bounded domain of one dimension, or None if unbounded.

    batch_stat: observed (min, max) for raw integer columns (staging-time
    statistic), enabling dense mode for e.g. uint16 city ids with max 300.
    stats: the full per-batch stat dict, for time-bucket dims.
    """
    ast = dim.expr
    if batch_stat is not None and not isinstance(batch_stat, tuple):
        batch_stat = (0, int(batch_stat))   # bare max (bench/test callers)

    # raw column reference
    if isinstance(ast, E.VarRef):
        dt_ = ast.data_type
        if dt_ == mdt.Bool:
            return DimDomain(size=2)
        if ast.enum_reverse_dict is not None:
            return DimDomain(size=max(1, len(ast.enum_reverse_dict)))
        if dt_ == mdt.Uint8:
            return DimDomain(size=256)
        if dt_ in (mdt.Uint16, mdt.Uint32, mdt.Int32, mdt.Int64, mdt.Int16):
            if batch_stat is not None and batch_stat[1] + 1 <= DENSE_MAX_SLOTS:
                if dt_ in (mdt.Int16, mdt.Int32, mdt.Int64):
                    return None  # negative values not handled densely
                return DimDomain(size=_pow2_at_least(int(batch_stat[1]) + 1))
        return None

    # time bucketizers
    if isinstance(ast, E.BinaryExpr) and ast.op == "FLOOR" and \
            isinstance(ast.rhs, E.NumberLiteral):
        lhs = ast.lhs
        # recurring: FLOOR(x % bucket, base) — bounded by bucket/base
        if isinstance(lhs, E.BinaryExpr) and lhs.op == "%" and \
                isinstance(lhs.rhs, E.NumberLiteral):
            bucket = lhs.rhs.int_val
            base = ast.rhs.int_val
            if base > 0 and bucket // base <= DENSE_MAX_SLOTS:
                return DimDomain(size=bucket // base + 1, step=base)
        # regular: FLOOR(shifted_time, width) — bounded by the time filter
        # or, absent one, by the batch's time-column stats
        return _time_bucket_domain(plan, ast.rhs.int_val,
                                   _column_stats(ast.lhs, stats))

    # recurring with trailing division: (FLOOR(x % bucket, base)) / base
    if isinstance(ast, E.BinaryExpr) and ast.op == "/" and \
            isinstance(ast.rhs, E.NumberLiteral):
        inner = dimension_domain(plan, DimensionPlan(
            expr=ast.lhs, raw=dim.raw, data_type=dim.data_type))
        if inner is not None and inner.kind == "affine":
            return DimDomain(size=inner.size, base=inner.base, step=inner.step,
                             post_div=float(ast.rhs.val))
        return None

    # bare modulo recurring: x % bucket (time of day) — usually too large
    if isinstance(ast, E.BinaryExpr) and ast.op == "%" and \
            isinstance(ast.rhs, E.NumberLiteral):
        if ast.rhs.int_val <= DENSE_MAX_SLOTS:
            return DimDomain(size=ast.rhs.int_val)
        return None

    # numeric width bucketizer: floor(x/w)*w — affine float domain from
    # the underlying column's batch (min, max) stats
    if isinstance(ast, E.Call) and ast.name == "__numeric_bucket":
        b = getattr(ast, "bucketizer", None)
        if b is not None and b.bucket_width and stats is not None:
            key = _underlying_column_key(ast.args[0])
            st = stats.get(key) if key is not None else None
            if st is not None:
                import math

                w = float(b.bucket_width)
                lo = math.floor(float(st[0]) / w)
                hi = math.floor(float(st[1]) / w)
                size = hi - lo + 1
                if 0 < size <= DENSE_MAX_SLOTS:
                    return DimDomain(size=int(size), base=lo * w, step=w)
        return None

    if isinstance(ast, E.UnaryExpr) and ast.op.startswith("GET_"):
        if ast.op in _CALENDAR_EXTRACT_SIZES:
            return DimDomain(size=_CALENDAR_EXTRACT_SIZES[ast.op])
        if ast.op in CALENDAR_STARTS:
            return _calendar_lookup_domain(plan, ast.op,
                                           _column_stats(ast.expr, stats))
        return None

    return None


@dataclass
class DensePlan:
    domains: List[DimDomain]
    strides: List[int]
    n_slots: int  # Π(size_i + 1); slot n_slots = overflow/dropped

    def decode_slots(self, slots: np.ndarray):
        """slot indices → per-dim (values, valid) numpy arrays."""
        out = []
        rem = slots.astype(np.int64)
        for dom, stride in zip(self.domains, self.strides):
            idx = rem // stride
            rem = rem % stride
            valid = idx > 0
            out.append((dom.decode(np.maximum(idx - 1, 0)), valid))
        return out


def plan_dense(plan: CompiledQuery,
               batch_int_maxes: Optional[dict] = None) -> Optional[DensePlan]:
    """Try to build a dense slot plan for all dimensions of the query."""
    if plan.measure is None:
        return None
    domains = []
    stats = {k: (v if isinstance(v, tuple) else (0, int(v)))
             for k, v in (batch_int_maxes or {}).items()}
    for dim in plan.dimensions:
        key = None
        if isinstance(dim.expr, E.VarRef):
            key = (dim.expr.table_id, dim.expr.column_id)
        dom = dimension_domain(plan, dim, stats.get(key), stats)
        if dom is None:
            return None
        domains.append(dom)
    n_slots = 1
    for d in domains:
        n_slots *= d.size + 1
        if n_slots > DENSE_MAX_SLOTS:
            return None
    strides = []
    acc = n_slots
    for d in domains:
        acc //= (d.size + 1)
        strides.append(acc)
    return DensePlan(domains=domains, strides=strides, n_slots=n_slots)
