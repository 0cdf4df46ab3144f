"""Device kernel layer of the query paths, on torch tensors.

Port of `aresdb_tpu/query/kernels.py` for the dense and the keyed (sort)
group-by, run-length archive batches, HLL distinct counts and
non-aggregate listings: the expression emitter (filters, dimensions and
measures traced into tensor ops on (value, validity) lanes, joined
columns probed through their dimension table, array ops over padded
ragged lanes), the geo filter and dimension (geo.py), the dense slot
map, the dense aggregation kernel with its 64-bit running fold, the
group-key packing, the adaptive per-batch reduce_by_key and its weighted
form for per-run lanes, the HLL register build with its 64-bit murmur
hash, the select kernel, and the numpy group-key helpers GroupTable
needs.

Every function takes its tensors on one device and returns tensors on the
same device. Eligible dense plans route to the fused kernel K1
(fused_dense.py); the others reduce through K2 or K3 (pallas_ops) or a
plain scatter, by the JAX package's routing predicates. The keyed path's
runtime-dense branch reduces through K2; its sort branch is torch.sort
and segmented sums. On the CPU the kernel wrappers take their plain
PyTorch versions.

Lanes mirror the JAX package: integers narrower than 64 bits compute in
int32 (Uint32 as two's complement), floats in float32, calendar math in
int64. Staged unsigned 16/32/64-bit columns are stored as signed tensors
of the same width (`executor._signed_view`); the emitter zero-extends
16-bit lanes.

Null semantics mirror the reference functors (query/functor.hpp): binary
ops and comparisons propagate null; AND/OR use the three-valued rules;
null measures contribute the aggregation identity.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import geo as G
from aresdb_tpu_torch.query import hll as H
from aresdb_tpu_torch.query import pallas_ops as P
from aresdb_tpu_torch.query.compiler import CompiledQuery, QueryError
from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils import tracing
from aresdb_tpu_torch.utils.torch_env import fetch_to_host

_F32_MAX = float(np.finfo(np.float32).max)
_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)
# the columns key of a geo query's staged shapes (geo.DeviceShapes)
GEO_SHAPES = (-1, 0)


class _Val:
    __slots__ = ("value", "valid")

    def __init__(self, value, valid):
        self.value = value
        self.valid = valid


class _EvalCtx:
    """Per-batch evaluation context: staged column lanes, and the joined
    tables' rows resolved lazily."""

    def __init__(self, columns, n_rows: int, device: torch.device,
                 foreign=()):
        # columns: {(table_id, column_id): (values, validity)}; a joined
        # table's entries hold its whole staged rows, not [n_rows] lanes
        self.columns = columns
        # per joined table (plan.foreign_tables order): (lut,) or
        # (sorted_keys, perm), as executor._stage_foreign_tables stages it
        self.foreign = foreign
        self.n_rows = n_rows
        self.device = device
        self._foreign_rows: Dict[int, Tuple] = {}
        self._foreign_cols: Dict[Tuple, Tuple] = {}
        self.geo_matched: Optional[Tuple] = None

    def foreign_column(self, table_id: int, column_id: int, plan,
                       values, validity):
        """One joined column as row-aligned (values, validity): the joined
        row's value where the probe hits, invalid where it misses. The
        JAX package's small-table one-hot dot and precomposed [F, 2]
        gather are TPU gather-lowering devices; this gather gives their
        validity and, where it holds, their value bits."""
        key = (table_id, column_id)
        out = self._foreign_cols.get(key)
        if out is None:
            fidx = plan.table_id_to_foreign[table_id]
            main_key = _emit(plan.foreign_tables[fidx].main_key_expr, self,
                             plan)
            rows, hit = self.foreign_row(table_id, fidx, main_key)
            out = (values[rows], validity[rows] & hit)
            self._foreign_cols[key] = out
        return out

    def foreign_row(self, table_id: int, fidx: int, main_key: _Val):
        """Main rows → (joined row index, hit): one gather through the
        dense key → row table of a small key domain, else a binary search
        of the sorted keys and the `perm` gather (the reference's device
        cuckoo probe, query/hash_lookup.cu)."""
        cached = self._foreign_rows.get(table_id)
        if cached is not None:
            return cached
        entry = self.foreign[fidx]
        key = main_key.value
        if len(entry) == 1:
            (lut,) = entry
            size = lut.shape[0]
            in_range = (key >= 0) & (key < size) & main_key.valid
            rows = lut[key.clamp(0, size - 1).long()]
            hit = in_range & (rows >= 0)
            rows = rows.clamp(min=0)
        else:
            sorted_keys, perm = entry
            key = key.to(sorted_keys.dtype).contiguous()
            pos = torch.searchsorted(sorted_keys, key).clamp(
                0, sorted_keys.shape[0] - 1)
            hit = (sorted_keys[pos] == key) & main_key.valid
            rows = perm[pos]
        self._foreign_rows[table_id] = (rows, hit)
        return rows, hit

    def full(self, value, dtype) -> torch.Tensor:
        return torch.full((self.n_rows,), value, dtype=dtype,
                          device=self.device)

    def ones(self) -> torch.Tensor:
        return torch.ones(self.n_rows, dtype=torch.bool, device=self.device)


def _dtype_for_expr_type(t: int):
    if t == E.FLOAT:
        return torch.float32
    if t == E.BOOLEAN:
        return torch.bool
    return torch.int32


def _to_numeric(v: _Val, dtype) -> _Val:
    if v.value.dtype == dtype:
        return v
    if dtype == torch.bool:
        return _Val(v.value != 0, v.valid)
    return _Val(v.value.to(dtype), v.valid)


def _f32(x) -> float:
    """A Python float that holds x rounded to float32 (exact as a scalar
    operand of float32 tensor ops)."""
    return float(np.float32(x))


def _emit(node: E.Expr, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    """Trace one AST node into tensor ops, returning (value, valid) lanes."""
    if isinstance(node, E.ParenExpr):
        return _emit(node.expr, ctx, plan)

    if isinstance(node, E.NumberLiteral):
        if node.type == E.FLOAT:
            return _Val(ctx.full(_f32(node.val), torch.float32), ctx.ones())
        if -(2**31) <= node.int_val < 2**31:
            return _Val(ctx.full(node.int_val, torch.int32), ctx.ones())
        return _Val(ctx.full(node.int_val, torch.int64), ctx.ones())

    if isinstance(node, E.BooleanLiteral):
        return _Val(ctx.full(bool(node.val), torch.bool), ctx.ones())

    if isinstance(node, E.NullLiteral):
        return _Val(ctx.full(0, torch.int32), ~ctx.ones())

    if isinstance(node, E.StringLiteral):
        if getattr(node, "uuid_lanes", None) is not None:
            # placeholder lanes; the comparison branch reads uuid_lanes
            return _Val(torch.zeros((ctx.n_rows, 2), dtype=torch.int64,
                                    device=ctx.device), ctx.ones())
        raise QueryError(
            f"string literal {node.val!r} not resolvable (non-enum context)")

    if isinstance(node, E.VarRef):
        return _emit_varref(node, ctx, plan)

    if isinstance(node, E.UnaryExpr):
        return _emit_unary(node, ctx, plan)

    if isinstance(node, E.BinaryExpr):
        return _emit_binary(node, ctx, plan)

    if isinstance(node, E.Call):
        return _emit_call(node, ctx, plan)

    if isinstance(node, E.Case):
        return _emit_case(node, ctx, plan)

    raise QueryError(f"cannot emit expression node {node!r}")


def _emit_varref(node: E.VarRef, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    entry = ctx.columns.get((node.table_id, node.column_id))
    if entry is None:
        raise QueryError(f"column {node.val!r} not staged")
    if len(entry) == 4:
        raise QueryError(
            f"array column {node.val!r} can only be used via "
            f"length()/contains()/element_at()")
    values, validity = entry
    if node.table_id > 0:
        values, validity = ctx.foreign_column(
            node.table_id, node.column_id, plan, values, validity)
    if node.data_type in (mdt.UUID, mdt.GeoPoint):
        return _Val(values, validity)  # (n, 2) lanes, special consumers only
    if node.data_type == mdt.Bool:
        return _Val(values.to(torch.bool), validity)
    if node.data_type == mdt.Float32:
        return _Val(values.to(torch.float32), validity)
    if node.data_type == mdt.Int64:
        return _Val(values.to(torch.int64), validity)
    if node.data_type in (mdt.Uint16, mdt.BigEnum):
        # staged as int16 bit views: zero-extend
        return _Val(values.to(torch.int32) & 0xFFFF, validity)
    # 32-bit lanes for all narrower ints; Uint32 columns are staged as
    # int32 bit views, i.e. two's complement (kernels._emit_varref)
    return _Val(values.to(torch.int32), validity)


def _emit_unary(node: E.UnaryExpr, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    op = node.op
    c = _emit(node.expr, ctx, plan)
    if op == "-":
        v = _to_numeric(c, _dtype_for_expr_type(node.type))
        return _Val(-v.value, v.valid)
    if op == "~":
        v = _to_numeric(c, torch.int32)
        return _Val(~v.value, v.valid)
    if op == "NOT":
        t = _truthy(c)
        return _Val(~t.value, t.valid)
    if op == "IS_NULL":
        return _Val(~c.valid, ctx.ones())
    if op == "IS_NOT_NULL":
        return _Val(c.valid, ctx.ones())
    if op == "IS_TRUE":
        t = _truthy(c)
        return _Val(t.value & t.valid, ctx.ones())
    if op == "IS_FALSE":
        t = _truthy(c)
        return _Val(~t.value & t.valid, ctx.ones())
    if op.startswith("GET_"):
        return _emit_calendar(op, c)
    raise QueryError(f"unsupported unary op {op!r}")


def _truthy(v: _Val) -> _Val:
    if v.value.dtype == torch.bool:
        return v
    return _Val(v.value != 0, v.valid)


def _common_dtype(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == torch.float32 or b.dtype == torch.float32:
        return torch.float32
    if a.dtype == torch.int64 or b.dtype == torch.int64:
        return torch.int64
    return torch.int32


def _signed64(u: int) -> int:
    """uint64 bit pattern → the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


def _rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncating remainder (C `%`, jax.lax.rem); 0 where b is 0, and for
    integers where b is -1 (a % -1 == 0, and C's `%` traps on MIN % -1)."""
    if a.dtype.is_floating_point:
        zero = b == 0
    else:
        zero = (b == 0) | (b == -1)
    return torch.where(zero, torch.zeros_like(a),
                       torch.fmod(a, torch.where(zero, torch.ones_like(b), b)))


def _emit_binary(node: E.BinaryExpr, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    op = node.op
    if op in ("AND", "OR"):
        l = _truthy(_emit(node.lhs, ctx, plan))
        r = _truthy(_emit(node.rhs, ctx, plan))
        if op == "AND":
            # null if either null (reference AndFunctor)
            return _Val(l.value & r.value, l.valid & r.valid)
        # OR: true if either valid-true; else null if either null
        true_side = (l.value & l.valid) | (r.value & r.valid)
        return _Val(true_side, true_side | (l.valid & r.valid))

    if op in ("IN", "NOT IN"):
        l = _emit(node.lhs, ctx, plan)
        if not isinstance(node.rhs, E.Call):
            raise QueryError("IN expects a value list")
        hits = ~ctx.ones()
        for arg in node.rhs.args:
            r = _emit(arg, ctx, plan)
            dt = _common_dtype(l.value, r.value)
            hits = hits | (_to_numeric(l, dt).value == _to_numeric(r, dt).value)
        if op == "NOT IN":
            hits = ~hits
        return _Val(hits, l.valid)

    l = _emit(node.lhs, ctx, plan)
    r = _emit(node.rhs, ctx, plan)

    if op in ("=", "!=", "<>", "<", "<=", ">", ">="):
        # UUID literal comparison (two 64-bit lanes)
        for b_node, a_val in ((node.rhs, l), (node.lhs, r)):
            lanes = getattr(b_node, "uuid_lanes", None)
            if lanes is not None and a_val.value.ndim == 2:
                hi, lo = lanes
                eq = (a_val.value[:, 0] == _signed64(int(hi))) & \
                    (a_val.value[:, 1] == _signed64(int(lo)))
                if op in ("!=", "<>"):
                    eq = ~eq
                elif op != "=":
                    raise QueryError("UUIDs support only =/!= comparisons")
                return _Val(eq, a_val.valid)
        # GeoPoint equality on 2-lane arrays
        if l.value.ndim == 2 or r.value.ndim == 2:
            eq = torch.all(l.value == r.value, dim=-1)
            return _Val(eq if op == "=" else ~eq, l.valid & r.valid)
        dt = _common_dtype(l.value, r.value)
        a, b = _to_numeric(l, dt).value, _to_numeric(r, dt).value
        if op == "=":
            v = a == b
        elif op in ("!=", "<>"):
            v = a != b
        elif op == "<":
            v = a < b
        elif op == "<=":
            v = a <= b
        elif op == ">":
            v = a > b
        else:
            v = a >= b
        return _Val(v, l.valid & r.valid)

    valid = l.valid & r.valid
    if op == "/":
        a = _to_numeric(l, torch.float32).value
        b = _to_numeric(r, torch.float32).value
        nz = b != 0
        q = a / torch.where(nz, b, torch.ones_like(b))
        return _Val(torch.where(nz, q, torch.zeros_like(q)), valid & nz)
    if op in ("+", "-", "*", "%", "FLOOR"):
        dt = _dtype_for_expr_type(node.type)
        if dt == torch.bool:
            dt = torch.int32
        if l.value.dtype == torch.int64 or r.value.dtype == torch.int64:
            dt = torch.int64
        a = _to_numeric(l, dt).value
        b = _to_numeric(r, dt).value
        if op == "+":
            return _Val(a + b, valid)
        if op == "-":
            return _Val(a - b, valid)
        if op == "*":
            return _Val(a * b, valid)
        # `%` truncates like C (reference ModFunctor, query/functor.hpp:260);
        # FLOOR(a, b) = a - a % b (reference FloorFunctor)
        rem = _rem(a, b)
        nz = b != 0
        return _Val(rem if op == "%" else torch.where(nz, a - rem,
                                                      torch.zeros_like(a)),
                    valid & nz)
    if op in ("&", "|", "^", "<<", ">>"):
        a = _to_numeric(l, torch.int32).value
        b = _to_numeric(r, torch.int32).value
        if op == "&":
            return _Val(a & b, valid)
        if op == "|":
            return _Val(a | b, valid)
        if op == "^":
            return _Val(a ^ b, valid)
        # shift amounts outside [0, 31] as XLA defines them
        oob = (b < 0) | (b > 31)
        sh = b.clamp(0, 31)
        if op == "<<":
            return _Val(torch.where(oob, torch.zeros_like(a), a << sh), valid)
        fill = torch.where(a < 0, torch.full_like(a, -1), torch.zeros_like(a))
        return _Val(torch.where(oob, fill, a >> sh), valid)
    raise QueryError(f"unsupported binary op {op!r}")


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _emit_call(node: E.Call, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    name = node.name
    if name == E.HOUR:
        c = _to_numeric(_emit(node.args[0], ctx, plan), torch.int32)
        return _Val(_floordiv(torch.remainder(c.value, 86400), 3600), c.valid)
    if name == E.DAY_OF_WEEK:
        # reference functor: weekday 1..7 with Monday=1 (GetDayOfWeekFunctor)
        c = _to_numeric(_emit(node.args[0], ctx, plan), torch.int32)
        days = _floordiv(c.value, 86400)
        return _Val(torch.remainder(days + 3, 7) + 1, c.valid)
    if name == E.CONVERT_TZ:
        base = _emit(node.args[0], ctx, plan)
        if len(node.args) < 2:
            return base
        off = _emit(node.args[1], ctx, plan)
        return _Val(_to_numeric(base, torch.int32).value
                    + _to_numeric(off, torch.int32).value,
                    base.valid & off.valid)
    if name == E.HEX:
        return _emit(node.args[0], ctx, plan)  # 2-lane uuid passthrough
    if name == "__numeric_bucket":
        return _emit_numeric_bucket(node, ctx, plan)
    if name in (E.LENGTH, E.CONTAINS, E.ELEMENT_AT):
        return _emit_array_op(node, ctx, plan)
    if name == "__tz_offset":
        # per-row UTC offset through the joined timezone enum rank
        # (reference timezoneLookupD, aql_processor.go:487)
        rank = _emit(node.args[0], ctx, plan)
        table = torch.as_tensor(np.asarray(node.tz_offsets, np.int32),
                                device=ctx.device)
        idx = rank.value.to(torch.int64).clamp(0, table.shape[0] - 1)
        return _Val(table[idx], rank.valid)
    raise QueryError(f"unsupported function {name!r} in kernel emitter")


def _array_entry(node: E.Call, ctx: _EvalCtx):
    arg = node.args[0]
    if not (isinstance(arg, E.VarRef) and mdt.is_array_type(arg.data_type)):
        raise QueryError(
            f"{node.name} requires an array column, got {arg}")
    entry = ctx.columns.get((arg.table_id, arg.column_id))
    if entry is None or len(entry) != 4:
        raise QueryError(f"array column {arg.val!r} not staged")
    return entry  # (items[n,L], item_valid[n,L], lengths[n], row_valid[n])


def _array_items32(items: torch.Tensor, item_type: int) -> torch.Tensor:
    """Non-float items as the JAX package's int32 lanes: 16-bit unsigned
    items, staged as int16 bit views, zero-extend; Uint32 items keep their
    two's-complement bits (an item at 2^31 or above wraps, as jnp's
    astype(int32) of uint32 does); Int64 items keep their low 32 bits."""
    out = items.to(torch.int32)
    if item_type in (mdt.Uint16, mdt.BigEnum):
        out = out & 0xFFFF
    return out


def _emit_array_op(node: E.Call, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    """Array ops over padded ragged staging (executor._pad_array_column).

    Semantics parity with the reference functors (query/functor.hpp:470-640):
    length(null array) is null; element_at supports negative (from-end)
    indices and yields null out of range or when the element is null;
    contains matches only valid elements. UUID and GeoPoint items are
    staged as (n, L, 2) lanes, UUID lanes as int64 bit views.
    """
    items, item_valid, lengths, row_valid = _array_entry(node, ctx)
    item_type = mdt.item_type(node.args[0].data_type)
    two_lane = items.ndim == 3
    name = node.name
    if name == E.LENGTH:
        return _Val(lengths.to(torch.int32), row_valid)
    if name == E.CONTAINS:
        lanes = getattr(node.args[1], "uuid_lanes", None)
        if two_lane:
            if lanes is None:
                raise QueryError(
                    "contains() over a UUID array requires a UUID literal")
            hi, lo = lanes
            eq = (items[:, :, 0] == _signed64(int(hi))) & \
                (items[:, :, 1] == _signed64(int(lo)))
            return _Val((item_valid & eq).any(dim=1), row_valid)
        needle = _emit(node.args[1], ctx, plan)
        nv = needle.value
        if items.dtype == torch.float32 or nv.dtype == torch.float32:
            a, b = items.to(torch.float32), nv.to(torch.float32)
        else:
            a, b = _array_items32(items, item_type), nv.to(torch.int32)
        hit = (item_valid & (a == b[:, None])).any(dim=1)
        return _Val(hit, row_valid & needle.valid)
    # element_at
    idx = _to_numeric(_emit(node.args[1], ctx, plan), torch.int32)
    width = items.shape[1]
    lengths32 = lengths.to(torch.int32)
    eff = torch.where(idx.value < 0, lengths32 + idx.value, idx.value)
    in_range = (eff >= 0) & (eff < lengths32)
    safe = eff.clamp(0, width - 1).long()
    if two_lane:
        value = torch.gather(items, 1, safe[:, None, None].expand(
            -1, 1, 2))[:, 0, :]
    else:
        value = torch.gather(items, 1, safe[:, None])[:, 0]
    evalid = torch.gather(item_valid, 1, safe[:, None])[:, 0]
    valid = row_valid & idx.valid & in_range & evalid
    if not two_lane and value.dtype not in (torch.float32, torch.bool):
        value = _array_items32(value, item_type)
    return _Val(value, valid)


def _emit_numeric_bucket(node: E.Call, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    c = _to_numeric(_emit(node.args[0], ctx, plan), torch.float32)
    b = node.bucketizer  # attached by compiler
    if b.bucket_width:
        w = _f32(b.bucket_width)
        return _Val(torch.floor(c.value / w) * w, c.valid)
    if b.log_base:
        base = torch.tensor(_f32(b.log_base), dtype=torch.float32,
                            device=ctx.device)
        pos = c.value > 0
        exp = torch.floor(torch.log(torch.where(pos, c.value,
                                                torch.ones_like(c.value)))
                          / torch.log(base))
        return _Val(torch.where(pos, torch.pow(base, exp),
                                torch.zeros_like(exp)), c.valid & pos)
    parts = torch.as_tensor(np.asarray(b.manual_partitions, np.float32),
                            device=ctx.device)
    idx = torch.searchsorted(parts, c.value.contiguous(), right=True)
    lower = torch.cat([torch.full((1,), -np.inf, dtype=torch.float32,
                                  device=ctx.device), parts])[idx]
    return _Val(lower, c.valid)


def _emit_case(node: E.Case, ctx: _EvalCtx, plan: CompiledQuery) -> _Val:
    dt = _dtype_for_expr_type(node.type)
    if node.else_expr is not None:
        out = _to_numeric(_emit(node.else_expr, ctx, plan), dt)
        value, valid = out.value, out.valid
    else:
        value = ctx.full(0, dt)
        valid = ~ctx.ones()
    for cond, res in reversed(node.when_thens):
        c = _truthy(_emit(cond, ctx, plan))
        r = _to_numeric(_emit(res, ctx, plan), dt)
        take = c.value & c.valid
        value = torch.where(take, r.value, value)
        valid = torch.where(take, r.valid, valid)
    return _Val(value, valid)


# ---------------------------------------------------------------------------
# calendar math (the 400-year-cycle algorithm the reference uses on device,
# query/functor.cu:71 resolveTimeBucketizer), in int64 lanes
# ---------------------------------------------------------------------------

_ABSOLUTE_ZERO_TS = -62135596800  # 0001-01-01T00:00:00Z
_DAYS_PER_400Y = 365 * 400 + 97
_DAYS_PER_100Y = 365 * 100 + 24
_DAYS_PER_4Y = 365 * 4 + 1
_DAYS_BEFORE_MONTH = np.array(
    [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334, 365], np.int64)


def _calendar_decompose(ts):
    """ts (int64 seconds) → (year_start_ts, days_into_year, year_index)."""
    t = ts - _ABSOLUTE_ZERO_TS
    days = _floordiv(t, 86400)
    n = _floordiv(days, _DAYS_PER_400Y)
    year = 400 * n
    start = n * _DAYS_PER_400Y * 86400
    days = days - _DAYS_PER_400Y * n
    n = _floordiv(days, _DAYS_PER_100Y)
    n = n - (n >> 2)
    year = year + 100 * n
    start = start + n * _DAYS_PER_100Y * 86400
    days = days - _DAYS_PER_100Y * n
    n = _floordiv(days, _DAYS_PER_4Y)
    year = year + 4 * n
    start = start + n * _DAYS_PER_4Y * 86400
    days = days - _DAYS_PER_4Y * n
    n = _floordiv(days, 365)
    n = n - (n >> 2)
    year = year + n
    days = days - 365 * n
    start = start + n * 365 * 86400
    return start + _ABSOLUTE_ZERO_TS, days, year


def _is_leap(year):
    # year here is 0-based (reference isLeapYear(year + 1))
    y = year + 1
    return (((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0))
            | (torch.remainder(y, 400) == 0))


def _days_before_month(month, leap):
    table = torch.as_tensor(_DAYS_BEFORE_MONTH, device=month.device)
    # clamped like a jnp gather; month is in [0, 12] for every input
    base = table[month.clamp(0, 12)]
    return base + (leap & (month >= 2)).to(torch.int64)


def _month_of(days, leap):
    month = _floordiv(days, 31)
    month_end = _days_before_month(month + 1, leap)
    return torch.where(days >= month_end, month + 1, month)


def _emit_calendar(op: str, c: _Val) -> _Val:
    ts = _to_numeric(c, torch.int64).value
    if op == "GET_WEEK_START":
        # reference getWeekStartTimestamp (functor.cu:207)
        four_days = 4 * 86400
        v = torch.where(ts < four_days, torch.zeros_like(ts),
                        ts - torch.remainder(ts - four_days, 7 * 86400))
        return _Val(v, c.valid)
    start, days, year = _calendar_decompose(ts)
    if op == "GET_YEAR_START":
        return _Val(start, c.valid)
    if op == "GET_DAY_OF_YEAR":
        return _Val(days, c.valid)
    leap = _is_leap(year)
    month = _month_of(days, leap)
    if op == "GET_MONTH_START":
        return _Val(start + _days_before_month(month, leap) * 86400, c.valid)
    if op == "GET_DAY_OF_MONTH":
        return _Val(days - _days_before_month(month, leap), c.valid)
    if op == "GET_MONTH_OF_YEAR":
        return _Val(month, c.valid)
    quarter = _floordiv(month, 3)
    if op == "GET_QUARTER_OF_YEAR":
        return _Val(quarter, c.valid)
    if op == "GET_QUARTER_START":
        return _Val(start + _days_before_month(quarter * 3, leap) * 86400,
                    c.valid)
    raise QueryError(f"unsupported calendar op {op!r}")


# ---------------------------------------------------------------------------
# group-key packing on the host (numpy): the canonical u64 key GroupTable
# merges dense piles on. Copied from aresdb_tpu/query/kernels.py.
# ---------------------------------------------------------------------------

def _dim_bits(data_type: int) -> int:
    if data_type == mdt.Bool:
        return 1
    return mdt.data_type_bits(data_type)


def _packing_type(d) -> int:
    """Group-key packing width type: geo dims pack as their 8-bit shape
    index, not their (UUID) formatting type."""
    return mdt.SmallEnum if d.geo_dim else d.data_type


def pack_modes(dim_types: List[int]) -> Tuple[bool, bool]:
    """(exact, sortpackable) for a dim-type list — static trace-time facts.

    exact: the u64 key embeds every dim's (value bits, valid bit) losslessly,
    so group dim values UNPACK from the group key (no iota lane in the sort,
    no [n]-sized representative-row gathers). key62: the key fits 62 bits,
    leaving room to fold the measure-validity bit into the key's low bit
    (drops the i8 sort lane — see reduce_by_key cost table)."""
    total_bits = sum(min(_dim_bits(t), 64) + 1 for t in dim_types)
    exact = total_bits <= 63 and not any(t == mdt.UUID for t in dim_types)
    key62 = total_bits <= 62 and exact
    return exact, key62


def np_pack_dim_keys(dim_values: List[np.ndarray],
                     dim_valids: List[np.ndarray],
                     dim_types: List[int]) -> np.ndarray:
    """Host-side (numpy) mirror of pack_dim_keys' EXACT branch: identical
    bit layout (valid bit below value bits per dim), so host-decoded group
    dims (e.g. dense slot tables) repack to the same canonical u64 keys the
    device kernels emit — the cross-source merge key of GroupTable.
    Callers must check pack_modes(dim_types)[0] first."""
    n = len(dim_valids[0]) if dim_valids else 0
    key = np.zeros(n, np.uint64)
    shift = 0
    for vals, valids, t in zip(dim_values, dim_valids, dim_types):
        vals = np.asarray(vals)
        valids = np.asarray(valids, bool)
        width = min(_dim_bits(t), 64)
        if vals.dtype == np.float32:
            bits = vals.view(np.uint32).astype(np.uint64)
        elif vals.dtype == np.bool_:
            bits = vals.astype(np.uint64)
        else:
            mask64 = np.uint64((1 << width) - 1 if width < 64
                               else 0xFFFFFFFFFFFFFFFF)
            bits = vals.astype(np.int64).view(np.uint64) & mask64
        bits = np.where(valids, bits, np.uint64(0))
        key |= valids.astype(np.uint64) << np.uint64(shift)
        shift += 1
        key |= bits << np.uint64(shift)
        shift += width
    return key


# ---------------------------------------------------------------------------
# group-key packing on the device: exact bit-pack when the dims fit 63 bits,
# else a splitmix64 mix. torch's uint64 lacks sort, shifts and comparisons
# on CUDA, so the canonical u64 key bits ride in int64 tensors: `k ^ _SIGN`
# turns unsigned order into signed order (the all-ones sentinel sorts
# last), right shifts mask off the sign fill, and `.view(np.uint64)` on the
# host gives the JAX package's keys bit for bit.
# ---------------------------------------------------------------------------

SENTINEL = -1                                # all-ones u64, as int64 bits
SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)   # the same key on the host
_SIGN = -(1 << 63)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1) if s else x


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _signed64(0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _signed64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _signed64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _value_bits_u64(dim_val: _Val, data_type: int) -> List[torch.Tensor]:
    """Dim value → its u64 bit pattern in int64 (two lanes for UUID)."""
    v = dim_val.value
    if data_type == mdt.UUID:
        return [v[:, 0].to(torch.int64), v[:, 1].to(torch.int64)]
    if data_type == mdt.GeoPoint:
        lat = v[:, 0].contiguous().view(torch.int32).to(torch.int64)
        lng = v[:, 1].contiguous().view(torch.int32).to(torch.int64)
        return [(lat & 0xFFFFFFFF) | (lng << 32)]
    if v.dtype == torch.float32:
        return [v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF]
    if v.dtype == torch.bool:
        return [v.to(torch.int64)]
    width = _dim_bits(data_type)
    bits = v.to(torch.int64)
    return [bits & ((1 << width) - 1) if width < 64 else bits]


def pack_dim_keys(dim_vals: List[_Val], dim_types: List[int],
                  mask: torch.Tensor) -> torch.Tensor:
    """Per-row canonical u64 group key (int64 bits); filtered rows get the
    sentinel. Per dim the valid bit sits below the value bits and a null
    dim's value bits are zero, so null sorts first (the JAX package's
    layout). The JAX package's u32 narrow keys are a TPU sort-speed device;
    here every key is 64 bits."""
    n = mask.shape[0]
    key = torch.zeros(n, dtype=torch.int64, device=mask.device)
    if dim_vals and pack_modes(dim_types)[0]:
        shift = 0
        for dv, t in zip(dim_vals, dim_types):
            if dv.value.ndim != 1 and t not in (mdt.UUID, mdt.GeoPoint):
                # element_at over a GeoPoint array: the compiler types it
                # as a 32-bit integer; the JAX package fails to broadcast
                raise QueryError("a two-lane value cannot group as "
                                 f"{mdt.DATA_TYPE_NAME.get(t, t)}")
            bits = torch.where(dv.valid, _value_bits_u64(dv, t)[0], 0)
            key = key | (dv.valid.to(torch.int64) << shift)
            shift += 1
            key = key | (bits << shift)
            shift += min(_dim_bits(t), 64)
    elif dim_vals:
        for dv, t in zip(dim_vals, dim_types):
            valid = dv.valid.to(torch.int64)
            for lane in _value_bits_u64(dv, t):
                lane = torch.where(dv.valid, lane, 0)
                key = _splitmix64(key ^ _splitmix64(lane + valid))
        # no real key may equal the sentinel
        key = torch.where(key == SENTINEL, 0, key)
    return torch.where(mask, key, SENTINEL)


def unpack_dim_keys(gkeys: torch.Tensor, dim_vals: List[_Val],
                    dim_types: List[int], slot_used: torch.Tensor):
    """Invert pack_dim_keys' exact packing: per-slot dim (values, valids)
    from the group keys, in each dim lane's dtype, each its type's value:
    sign-extended from the type's width where the type is signed,
    zero-extended where it is unsigned (a Uint8 of 200 in an int32 lane
    reads 200). Valid only when pack_modes(...)[0]. Null dims unpack as
    (0, False)."""
    values, valids = [], []
    shift = 0
    for dv, t in zip(dim_vals, dim_types):
        width = min(_dim_bits(t), 64)
        assert width < 64 and t not in (mdt.UUID, mdt.GeoPoint)
        vbit = ((gkeys >> shift) & 1) != 0
        shift += 1
        bits = (gkeys >> shift) & ((1 << width) - 1)
        shift += width
        tmpl = dv.value.dtype
        if tmpl == torch.float32:
            val = bits.to(torch.int32).view(torch.float32)
        elif tmpl == torch.bool:
            val = bits != 0
        elif tmpl.is_signed and not mdt.is_unsigned(t):
            sbit = 1 << (width - 1)
            val = ((bits ^ sbit) - sbit).to(tmpl)
        else:
            val = bits.to(tmpl)
        values.append(val)
        valids.append(vbit & slot_used)
    return values, valids


def _dim_fields(dim_types: List[int]):
    """(offset, width) of each dim's value+valid field in the exact key
    pack (pack_dim_keys layout)."""
    fields = []
    shift = 0
    for t in dim_types:
        width = min(_dim_bits(t), 64) + 1   # value bits + valid bit
        fields.append((shift, width))
        shift += width
    return fields


def dim_pack_stride(d) -> int:
    """Static value stride of a dim's packed bits: regular time bucketizers
    emit FLOOR(ts, width), so every live value is a multiple of `width`.
    Checked on the data (alignment), so a wrong hint can only send a
    batch to the sort branch, never corrupt the grouping."""
    e = getattr(d, "expr", None)
    if (isinstance(e, E.BinaryExpr) and e.op == "FLOOR"
            and isinstance(e.rhs, E.NumberLiteral) and e.rhs.int_val > 1):
        return int(e.rhs.int_val)
    return 1


# ---------------------------------------------------------------------------
# batch evaluation
# ---------------------------------------------------------------------------

def _unsigned64(values: torch.Tensor, data_type: int) -> torch.Tensor:
    """A staged integer column's values as int64, unsigned types restored
    from their signed bit views."""
    v = values.to(torch.int64)
    if data_type == mdt.Uint32:
        return v & 0xFFFFFFFF
    if data_type in (mdt.Uint16, mdt.BigEnum):
        return v & 0xFFFF
    return v


def _eval_common(plan: CompiledQuery, ctx: _EvalCtx, n_valid: int,
                 live_cutoff=None):
    """Filter mask + dim value lanes.

    live_cutoff: archiving-cutoff filter for fact-table live batches —
    rows below the cutoff already live in archive batches (reference:
    liveCustomFilter, query/aql_processor.go processBatch).
    """
    mask = torch.arange(ctx.n_rows, device=ctx.device) < n_valid
    schema = plan.main_schema.table
    if (live_cutoff is not None and schema.is_fact_table
            and (0, 0) in ctx.columns):
        tvals, _ = ctx.columns[(0, 0)]
        mask = mask & (_unsigned64(tvals, schema.columns[0].data_type)
                       >= int(live_cutoff))
    for f in plan.filters + plan.time_filter_expr:
        v = _truthy(_emit(f, ctx, plan))
        mask = mask & v.value & v.valid
    if plan.geo is not None and plan.geo.has_filter:
        matched, point_valid = _geo_matched(plan, ctx)
        inside = matched >= 0
        # null points are dropped in BOTH modes: the reference writes
        # !inOrOut into the predicate for null points so the remove-if
        # always filters them (query/iterator.hpp:1380-1388)
        mask = mask & point_valid & (~inside if plan.geo.exclude else inside)
    dim_vals = []
    for d in plan.dimensions:
        if d.geo_dim:
            matched, _ = _geo_matched(plan, ctx)
            dim_vals.append(_Val(matched, matched >= 0))
        else:
            dim_vals.append(_emit(d.expr, ctx, plan))
    return mask, dim_vals


def _geo_matched(plan: CompiledQuery, ctx: _EvalCtx):
    """Per-row (matched shape index, point validity), computed once a
    batch for the filter and the dimension. The shapes are the query's
    (executor._stage_geo), under GEO_SHAPES among the columns."""
    if ctx.geo_matched is None:
        shapes = ctx.columns.get(GEO_SHAPES)
        if shapes is None:
            raise QueryError("geo shapes not staged")
        pv = _emit(plan.geo.point_expr, ctx, plan)
        ctx.geo_matched = (G.matched(pv.value[:, 0], pv.value[:, 1],
                                     pv.valid, shapes), pv.valid)
    return ctx.geo_matched


def _measure_lane(plan: CompiledQuery, ctx: _EvalCtx) -> _Val:
    """Measure accumulator lane: float sums/avg and counts per batch in
    float32 (the fold is float64); integer sums int64; int min/max int32."""
    m = plan.measure
    mv = _emit(m.expr, ctx, plan)
    if m.agg == "count":
        dtype = torch.float32
    elif m.agg in ("sum", "avg"):
        dtype = torch.float32 if m.out_float or m.agg == "avg" else torch.int64
    else:
        dtype = torch.float32 if m.out_float else torch.int32
    return _Val(mv.value.to(dtype), mv.valid)


def dense_slot_lane(dim_vals: List[_Val], dense_plan, n_rows: int,
                    device: torch.device):
    """Per-row dense slot index + out-of-domain flag (shared by the
    unfused dense kernel and the fused kernel's plain version).

    slot = Σ (dim_idx+1) * stride with 0 = NULL per dim; `bad` marks rows
    whose VALID dim value falls outside the planned domain (dense overflow).
    """
    slot = torch.zeros(n_rows, dtype=torch.int32, device=device)
    bad = torch.zeros(n_rows, dtype=torch.bool, device=device)
    for dv, dom, stride in zip(dim_vals, dense_plan.domains,
                               dense_plan.strides):
        v = dv.value
        if v.dtype == torch.bool:
            v = v.to(torch.int32)
        elif v.dtype == torch.float32 and dom.post_div == 0.0:
            v = v.to(torch.int32)
        if dom.kind == "lookup":
            table = torch.as_tensor(dom.values, device=device).to(v.dtype)
            idx = torch.searchsorted(table, v.contiguous()).clamp(
                0, dom.size - 1)
            in_range = table[idx] == v
            idx = idx.to(torch.int32)
        elif isinstance(dom.step, float) or isinstance(dom.base, float):
            # float affine (numeric width buckets): values are exact
            # f32 multiples of step, so rounding (half to even) recovers
            # the index
            vf = v.to(torch.float32)
            idxw = torch.round((vf - _f32(dom.base))
                               / _f32(dom.step)).to(torch.int32)
            in_range = (idxw >= 0) & (idxw < dom.size)
            idx = idxw.clamp(0, dom.size - 1)
        else:
            if dom.post_div:
                # value was divided by post_div on the float path; recover
                # the integer index from the pre-division value
                v = torch.round(v * _f32(dom.post_div)).to(torch.int32)
            idxw = _floordiv(v - dom.base, max(dom.step, 1))
            in_range = (idxw >= 0) & (idxw < dom.size)
            idx = idxw.clamp(0, dom.size - 1).to(torch.int32)
        ok = dv.valid & in_range
        idxp1 = torch.where(ok, idx + 1, torch.zeros_like(idx))
        bad = bad | (dv.valid & ~in_range)
        slot = slot + idxp1 * stride
    return slot, bad


def dense_fold_epilogue(kind: str, acc, aggv, cnt, rows, overflow):
    """Fold one dense batch table into the running accumulator, IN PLACE
    (the JAX package donates the buffers; here the executor owns them).
    An overflowed batch folds as identity. Float sums and all counts
    accumulate in float64: per-batch float32 lanes are exact below 2^24,
    a cross-batch float32 accumulator would not be."""
    a_agg, a_cnt, a_rows = acc
    keep = overflow == 0
    if kind in ("sum", "count", "avg"):
        a_agg.add_(torch.where(keep, aggv, torch.zeros_like(aggv))
                   .to(a_agg.dtype))
    else:
        if aggv.dtype.is_floating_point:
            ident = _F32_MAX if kind == "min" else -_F32_MAX
        else:
            ident = _I32_MAX if kind == "min" else _I32_MIN
        folded = torch.where(keep, aggv, torch.full_like(aggv, ident))
        (torch.minimum if kind == "min" else torch.maximum)(
            a_agg, folded, out=a_agg)
    a_cnt.add_(torch.where(keep, cnt, torch.zeros_like(cnt)).to(a_cnt.dtype))
    a_rows.add_(torch.where(keep, rows, torch.zeros_like(rows))
                .to(a_rows.dtype))
    return (a_agg, a_cnt, a_rows), overflow


def dense_fold_batches(acc, tables, overflow):
    """Fold a query's K1 batch tables (float32 [N, 3, n_slots],
    fused_dense.reduce_batches) into the running float64 accumulator, IN
    PLACE, in a fixed handful of ops: an overflowed batch folds as
    identity (its slice zeroed), the others sum over the batch axis in
    float64, as dense_fold_epilogue adds them one at a time. K1 reduces
    sums, averages and counts only, so each channel adds, and with no
    accumulator yet (acc None) the sums are the accumulator."""
    tables.masked_fill_((overflow != 0).view(-1, 1, 1), 0)
    sums = tables.sum(0, dtype=torch.float64).unbind(0)
    if acc is None:
        return sums
    for a, s in zip(acc, sums):
        a.add_(s)
    return acc


def make_dense_agg_kernel(plan: CompiledQuery, n_rows: int, dense_plan,
                          device: torch.device):
    """Dense slot-indexed aggregation over one padded batch of n_rows.

    Each row maps to slot = Σ (dim_idx+1) * stride (0 = NULL per dim) in a
    fixed [0, n_slots) space (dense.DensePlan). Rows whose dim value falls
    outside the planned domain are counted in `overflow`.

    Eligible plans route to the fused kernel K1 (fused_dense.py); float
    sums, averages and counts of the others reduce through K2
    (pallas_ops.segment_sum) where `use_factored`, else through K3
    (pallas_ops.dense_segment_sum) where `use_pallas`, else through a
    plain scatter; the n_slots <= 4 and integer / min / max reductions are
    plain torch, as they are XLA ops in the JAX package.

    Signature: fn(columns, n_valid, live_cutoff, acc, foreign=()) ->
    ((agg[S], cnt[S], rows[S]) folded into acc, overflow); `foreign`
    holds the joined tables' staged probes (_EvalCtx.foreign).
    """
    from aresdb_tpu_torch.query import fused_dense as FD

    fused = FD.maybe_make_fused_kernel(plan, n_rows, dense_plan, device)
    if fused is not None:
        return fused

    agg = plan.measure.agg
    out_float = plan.measure.out_float
    n_slots = dense_plan.n_slots

    def fn(columns, n_valid, live_cutoff, foreign):
        ctx = _EvalCtx(columns, n_rows, device, foreign)
        mask, dim_vals = _eval_common(plan, ctx, n_valid, live_cutoff)
        mlane = _measure_lane(plan, ctx)
        slot, bad = dense_slot_lane(dim_vals, dense_plan, n_rows, device)

        keep = mask & ~bad
        overflow = (mask & bad).sum(dtype=torch.int32)
        mval, mvalid = mlane.value, mlane.valid & keep
        if n_slots <= 4:
            # tiny slot spaces (no-dims global aggregates, boolean dims):
            # per-slot masked reductions
            aggs, cnts, rows = [], [], []
            for s in range(n_slots):
                sel = keep & (slot == s)
                selm = sel & mvalid
                if agg in ("sum", "count", "avg"):
                    aggs.append(torch.where(selm, mval,
                                            torch.zeros_like(mval)).sum())
                else:
                    if out_float:
                        ident = _F32_MAX if agg == "min" else -_F32_MAX
                    else:
                        ident = _I32_MAX if agg == "min" else _I32_MIN
                    picked = torch.where(selm, mval,
                                         torch.full_like(mval, ident))
                    aggs.append(picked.min() if agg == "min"
                                else picked.max())
                cnts.append(selm.to(torch.float32).sum())
                rows.append(sel.to(torch.float32).sum())
            return (torch.stack(aggs), torch.stack(cnts), torch.stack(rows),
                    overflow)
        ones = mvalid.to(torch.float32)
        present = keep.to(torch.float32)
        num = n_slots + 1
        slot_n = torch.where(keep, slot, torch.full_like(slot, n_slots)).long()
        if agg in ("sum", "count", "avg") and mval.dtype == torch.float32:
            # one (n, 3) segment sum: measure, count, presence; K2, else
            # K3, else the scatter, as the JAX package routes it
            contrib = torch.where(mvalid, mval, torch.zeros_like(mval))
            stacked = torch.stack([contrib, ones, present], dim=1)
            dropped = torch.where(keep, slot, torch.full_like(slot, -1))
            if P.use_factored(n_slots, device):
                out3 = P.segment_sum(dropped, stacked, n_slots)
            elif P.use_pallas(n_slots, device):
                out3 = P.dense_segment_sum(dropped, stacked, n_slots)
            else:
                out3 = torch.zeros((num, 3), dtype=torch.float32,
                                   device=device)
                out3.index_add_(0, slot_n, stacked)
            return out3[:n_slots, 0], out3[:n_slots, 1], out3[:n_slots, 2], \
                overflow
        if agg in ("sum", "count", "avg"):
            contrib = torch.where(mvalid, mval, torch.zeros_like(mval))
            aggv = torch.zeros(num, dtype=contrib.dtype, device=device)
            aggv.index_add_(0, slot_n, contrib)
        elif agg in ("min", "max"):
            if out_float:
                pad = _F32_MAX if agg == "min" else -_F32_MAX
                empty = np.inf if agg == "min" else -np.inf
            else:
                pad = _I32_MAX if agg == "min" else _I32_MIN
                empty = pad
            contrib = torch.where(mvalid, mval, torch.full_like(mval, pad))
            aggv = torch.full((num,), empty, dtype=mval.dtype, device=device)
            aggv.scatter_reduce_(0, slot_n, contrib,
                                 reduce="amin" if agg == "min" else "amax")
        else:
            raise QueryError(f"agg {agg} has no dense kernel")
        cnt_rows = torch.zeros((num, 2), dtype=torch.float32, device=device)
        cnt_rows.index_add_(0, slot_n, torch.stack([ones, present], dim=1))
        return (aggv[:n_slots], cnt_rows[:n_slots, 0], cnt_rows[:n_slots, 1],
                overflow)

    def fn_acc(columns, n_valid, live_cutoff, acc, foreign=()):
        aggv, cnt, rows, overflow = fn(columns, n_valid, live_cutoff,
                                       foreign)
        return dense_fold_epilogue(agg, acc, aggv, cnt, rows, overflow)

    return fn_acc


def dense_acc_init(plan: CompiledQuery, n_slots: int, device: torch.device):
    """Identity accumulator for the dense kernel's running fold.

    Additive channels accumulate in float64 / int64 (see
    dense_fold_epilogue); min/max keep the per-batch lane dtype."""
    m = plan.measure
    if m.agg in ("count", "sum", "avg"):
        dt = (torch.float64 if (m.out_float or m.agg in ("avg", "count"))
              else torch.int64)
        a = torch.zeros(n_slots, dtype=dt, device=device)
    else:
        dt = torch.float32 if m.out_float else torch.int32
        if dt == torch.float32:
            ident = _F32_MAX if m.agg == "min" else -_F32_MAX
        else:
            ident = _I32_MAX if m.agg == "min" else _I32_MIN
        a = torch.full((n_slots,), ident, dtype=dt, device=device)
    return (a, torch.zeros(n_slots, dtype=torch.float64, device=device),
            torch.zeros(n_slots, dtype=torch.float64, device=device))


def run_dense_kernel(fn, plan: CompiledQuery, n_slots: int, columns,
                     n_valid, live_cutoff, device: torch.device,
                     foreign=()):
    """Single-batch convenience for tests: run a dense kernel against an
    identity accumulator and return (agg, cnt, rows, overflow)."""
    acc = dense_acc_init(plan, n_slots, device)
    (aggv, cnt, rows), overflow = fn(columns, n_valid, live_cutoff, acc,
                                     foreign)
    return aggv, cnt, rows, overflow


# ---------------------------------------------------------------------------
# the keyed (sort) group-by: per-batch reduction by canonical group key
# ---------------------------------------------------------------------------

RT_DENSE_CAP = 16384   # runtime-dense slot budget (the JAX package's)


def _rt_dense_enabled() -> bool:
    return os.environ.get("ARES_RTDENSE", "") != "0"


def _prefix_enabled() -> bool:
    """The sort path's sums and counts add over its sorted runs (the JAX
    package's prefix reduction); ARES_PREFIX=0 sends its float32 sums and
    its counts through K2, as the JAX package's factored route does
    (aresdb_tpu/query/kernels.py:57). Read at call time."""
    return os.environ.get("ARES_PREFIX", "") != "0"


def _k2_takes_runs(k_groups: int, device) -> bool:
    """Whether ARES_PREFIX=0 reduces a sorted batch of k_groups slots
    through K2: on a device where use_factored holds, up to K2's
    K2_MAX_SLOTS. Past the cap the JAX package sums through an XLA one-hot
    matmul and no Pallas kernel; the port keeps its index_add_ route."""
    return (not _prefix_enabled() and k_groups <= P.K2_MAX_SLOTS
            and P.use_factored(k_groups, device))


def _k2_runs(values: torch.Tensor, idx: torch.Tensor,
             k_groups: int) -> torch.Tensor:
    """K2 over the sorted rows: values[n, C] float32 summed by each row's
    slot into [k_groups, C] float32. Rows past k_groups (sentinel and
    overflow rows, which _scatter_index spreads over spill slots for
    index_add_) go in as -1: K2 drops a slot outside [0, n_slots) before
    it adds, so that they cost no atomic."""
    slot = torch.where(idx < k_groups, idx, -1)
    return P.segment_sum(slot, values, k_groups)


def _runtime_dense_slots(keys: torch.Tensor, dim_types: List[int],
                         dim_strides: Optional[List[int]] = None):
    """Per-batch dense-domain detection: rebase every dim's value field to
    its live min (divided by its static stride) and multiply the ranges;
    each dim's valid bit is a field of its own. One host fetch brings back
    every field's live (min, max) and alignment, and the host decides, in
    exact integers, whether the product fits RT_DENSE_CAP slots (the JAX
    package's `lax.cond` on the device).

    Returns None where it does not fit, else (slot[n] int32 with -1 =
    dropped, slot_keys[RT_DENSE_CAP] int64, slots_total). Slot order
    equals key order, so the compacted table has the sort path's layout."""
    live = keys != SENTINEL
    strides = dim_strides or [1] * len(dim_types)
    fields = []
    for (off, width), vs in zip(_dim_fields(dim_types), strides):
        fields.append((off, 1, 1))
        fields.append((off + 1, width - 1, vs))
    lanes, stats = [], []
    for off, width, vs in fields:
        mask = (1 << width) - 1
        f = (keys >> off) & mask
        if vs > 1:
            stats.append((live & (torch.remainder(f, vs) != 0)).any()
                         .to(torch.int64))
            f = torch.div(f, vs, rounding_mode="floor")
        else:
            stats.append(torch.zeros((), dtype=torch.int64,
                                     device=keys.device))
        stats.append(torch.where(live, f, mask).min())
        stats.append(torch.where(live, f, 0).max())
        lanes.append(f)
    (host,) = fetch_to_host([torch.stack(stats)])
    slots_total, stride, aligned, ranges = 1, 1, True, []
    for j, (off, width, vs) in enumerate(fields):
        misaligned, fmin, fmax = (int(x) for x in host[3 * j:3 * j + 3])
        aligned = aligned and not misaligned
        fmin = min(fmin, fmax)   # no live rows: range 1
        r = fmax - fmin + 1
        ranges.append((off, vs, fmin, r, stride))
        stride *= r
        slots_total = min(slots_total * r, 1 << 62)
    if slots_total > RT_DENSE_CAP or not aligned:
        return None
    slot = torch.zeros_like(keys)
    iota = torch.arange(RT_DENSE_CAP, dtype=torch.int64, device=keys.device)
    slot_keys = torch.zeros_like(iota)
    for f, (off, vs, fmin, r, st) in zip(lanes, ranges):
        slot = slot + (f - fmin) * st
        slot_keys = slot_keys | ((torch.remainder(
            torch.div(iota, st, rounding_mode="floor"), r) + fmin) * vs
            << off)
    slot = torch.where(live, slot, -1).to(torch.int32)
    return slot, slot_keys, slots_total


def _runtime_dense_reduce(slot, slot_keys, slots_total: int, mval, mvalid,
                          k_groups: int, stacked=None):
    """Dense branch of the adaptive group-by: K2 over the rebased slots,
    then the slot table compacted to the sort path's first-k_groups-keys
    layout. Returns (gkeys, slot_used, agg, cnt, n_groups).

    stacked: an [n, 3] float32 (measure sum, valid count, row count)
    matrix built by the caller in place of (mval, mvalid): the run-length
    path's weighted per-run lanes, whose counts are not 0/1."""
    ones_ch = ()
    if stacked is None:
        contrib = torch.where(mvalid, mval, torch.zeros_like(mval))
        stacked = torch.stack([contrib, mvalid.to(torch.float32),
                               torch.ones_like(contrib)], dim=1)
        ones_ch = (2,)
    table = P.segment_sum(slot, stacked, RT_DENSE_CAP, ones_channels=ones_ch)
    device = slot.device
    sidx = torch.arange(RT_DENSE_CAP, device=device)
    live_slot = (table[:, 2] > 0) & (sidx < slots_total)
    n_groups = live_slot.sum().to(torch.int32)
    # the first k_groups live slots, in slot (== key) order
    sel = torch.sort((~live_slot).to(torch.int32), stable=True)[1]
    m = min(k_groups, RT_DENSE_CAP)
    sel = sel[:m]
    pad = k_groups - m
    gkeys, agg_m, cnt_m = slot_keys[sel], table[sel, 0], table[sel, 1]
    if pad:
        gkeys = torch.cat([gkeys, torch.full((pad,), SENTINEL,
                                             dtype=torch.int64,
                                             device=device)])
        zeros = torch.zeros(pad, dtype=torch.float32, device=device)
        agg_m, cnt_m = torch.cat([agg_m, zeros]), torch.cat([cnt_m, zeros])
    slot_used = torch.arange(k_groups, device=device) < n_groups
    return (torch.where(slot_used, gkeys, SENTINEL), slot_used,
            torch.where(slot_used, agg_m, 0.0),
            torch.where(slot_used, cnt_m, 0.0), n_groups)


def reduce_by_key(keys, mval, mvalid, agg: str, out_float: bool,
                  k_groups: int, dim_vals: Optional[List[_Val]] = None,
                  dim_types: Optional[List[int]] = None,
                  dim_strides: Optional[List[int]] = None):
    """Adaptive group-by: where the live keys' dim ranges multiply to at
    most RT_DENSE_CAP slots, the batch reduces through K2
    (_runtime_dense_reduce), else through the sort
    (_reduce_by_key_sorted). The group table is the same either way: the
    first k_groups distinct keys in ascending key order, dims unpacked
    from the keys. The dense branch applies to float sum/count/avg with an
    exact key pack; everything else sorts.

    Returns (group_keys[K] int64, slot_used[K], agg[K], cnt[K] float32,
    n_groups, dim_values, dim_valids)."""
    rt_ok = (dim_types is not None and bool(dim_vals)
             and agg in ("sum", "count", "avg")
             and mval.dtype == torch.float32 and _rt_dense_enabled())
    if not rt_ok:
        return _reduce_by_key_sorted(keys, mval, mvalid, agg, out_float,
                                     k_groups, dim_vals, dim_types)
    rt = _runtime_dense_slots(keys, dim_types, dim_strides)
    if rt is not None:
        out = _runtime_dense_reduce(*rt, mval, mvalid, k_groups)
    else:
        out = _reduce_by_key_sorted(keys, mval, mvalid, agg, out_float,
                                    k_groups)[:5]
    gkeys, slot_used, aggv, cnt, n_groups = out
    dim_values, dim_valids = unpack_dim_keys(gkeys, dim_vals, dim_types,
                                             slot_used)
    return (gkeys, slot_used, aggv, cnt, n_groups, tuple(dim_values),
            tuple(dim_valids))


_SPILL = 1024   # spare slots that rows outside the table scatter over


def _scatter_index(seg_c: torch.Tensor, k_groups: int) -> torch.Tensor:
    """Row → output slot for a segmented add into k_groups + _SPILL slots:
    seg_c where it is a slot of the table, else one of _SPILL spare slots
    by row. Adding every dropped row (often most of a batch) into ONE
    slot would serialize its atomics on one address."""
    spill = k_groups + (torch.arange(seg_c.shape[0], device=seg_c.device)
                        & (_SPILL - 1))
    return torch.where(seg_c < k_groups, seg_c, spill)


def _segment_add(values: torch.Tensor, idx: torch.Tensor, k_groups: int,
                 dtype) -> torch.Tensor:
    out = torch.zeros(k_groups + _SPILL, dtype=dtype, device=values.device)
    return out.index_add_(0, idx, values.to(dtype))[:k_groups]


def _sorted_runs(keys: torch.Tensor, k_groups: int, secondary=None):
    """Sort rows by key (then by `secondary`, where given) and find the
    runs of equal keys. Returns (perm, sorted keys, first, live, idx,
    starts, ends): idx is each sorted row's output slot for _segment_add
    (_scatter_index); starts/ends bound each of the k_groups + 1 segments
    (the last one holds sentinel rows and groups past k_groups) in sorted
    order."""
    if secondary is None:
        perm = torch.sort(keys ^ _SIGN)[1]
    else:
        by_value = torch.sort(secondary)[1]
        perm = by_value[torch.sort(keys[by_value] ^ _SIGN, stable=True)[1]]
    skeys = keys[perm]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    live = skeys != SENTINEL
    seg = torch.cumsum(first, 0) - 1
    seg_c = torch.where(live & (seg < k_groups), seg, k_groups)
    starts = torch.searchsorted(
        seg_c, torch.arange(k_groups + 1, device=keys.device))
    ends = torch.cat([starts[1:], starts.new_full((1,), keys.shape[0])])
    return (perm, skeys, first, live, _scatter_index(seg_c, k_groups),
            starts, ends)


def _group_table(perm, skeys, first, live, starts, k_groups: int,
                 dim_vals, dim_types):
    """(gkeys, slot_used, n_groups, dim_values, dim_valids) of sorted runs.
    Unused slots carry the sentinel key, so no slot repeats a real key."""
    n = skeys.shape[0]
    start_pos = starts[:k_groups].clamp(0, n - 1)
    gkeys = skeys[start_pos]
    n_groups = (first & live).sum().to(torch.int32)
    slot_used = (torch.arange(k_groups, device=skeys.device) < n_groups) & \
        (gkeys != SENTINEL)
    gkeys = torch.where(slot_used, gkeys, SENTINEL)
    if dim_types is not None and dim_vals:
        dim_values, dim_valids = unpack_dim_keys(gkeys, dim_vals, dim_types,
                                                 slot_used)
    else:
        rep = perm[start_pos]
        dim_values = [dv.value[rep] for dv in dim_vals or []]
        dim_valids = [dv.valid[rep] & slot_used for dv in dim_vals or []]
    return gkeys, slot_used, n_groups, tuple(dim_values), tuple(dim_valids)


def _reduce_by_key_sorted(keys, mval, mvalid, agg: str, out_float: bool,
                          k_groups: int,
                          dim_vals: Optional[List[_Val]] = None,
                          dim_types: Optional[List[int]] = None):
    """Sort + segmented reduce of rows by group key (int64 bits; sentinel
    rows dropped) into a table of k_groups slots.

    A library sort (torch.sort, as lax.sort is XLA in the JAX package)
    brings each group into one contiguous run; sums and counts add over
    the runs in float64 (integer sums in int64) and round to the batch
    lanes' float32, so a NaN poisons only its own group and +/-inf
    propagate, as direct summation does. Under ARES_PREFIX=0 float32
    sums and every count add through K2 instead (_k2_takes_runs). min/max sort the measure as a
    secondary key and read each run's first or last row. With an exact
    key pack (dim_types given), dims unpack from the group keys; otherwise
    they are gathered from each group's first row.

    Returns (group_keys[K], slot_used[K], agg[K], cnt[K], n_groups,
    dim_values, dim_valids)."""
    n = keys.shape[0]
    minmax = agg in ("min", "max")
    if minmax:
        if out_float:
            ident = _F32_MAX if agg == "min" else -_F32_MAX
        else:
            ident = _I32_MAX if agg == "min" else _I32_MIN
        contrib0 = torch.where(mvalid, mval, torch.full_like(mval, ident))
        perm, skeys, first, live, idx, starts, ends = _sorted_runs(
            keys, k_groups, contrib0)
    else:
        perm, skeys, first, live, idx, starts, ends = _sorted_runs(
            keys, k_groups)
    mval, mvalid = mval[perm], mvalid[perm]
    k2 = _k2_takes_runs(k_groups, keys.device)
    if agg in ("sum", "count", "avg"):
        contrib = torch.where(mvalid, mval, torch.zeros_like(mval))
        if k2 and contrib.dtype == torch.float32:
            both = _k2_runs(torch.stack([contrib, mvalid.to(contrib.dtype)],
                                        dim=1), idx, k_groups)
            aggv, cnt = both[:, 0], both[:, 1]
        else:
            # integer sums keep their int64 accumulator, and their counts
            # their float64 one, under ARES_PREFIX=0 too
            wide = torch.float64 if contrib.dtype.is_floating_point \
                else torch.int64
            aggv = _segment_add(contrib, idx, k_groups, wide).to(
                contrib.dtype)
            cnt = _segment_add(mvalid, idx, k_groups, torch.float64)
    elif minmax:
        contrib = contrib0[perm]
        at = starts if agg == "min" else (ends - 1).clamp(min=0)
        aggv = contrib[at[:k_groups].clamp(0, n - 1)]
        empty = starts[:k_groups] >= ends[:k_groups]
        aggv = torch.where(empty, torch.full_like(aggv, ident), aggv)
        cnt = _k2_runs(mvalid.to(torch.float32)[:, None], idx,
                       k_groups)[:, 0] if k2 else \
            _segment_add(mvalid, idx, k_groups, torch.float64)
    else:
        raise QueryError(f"agg {agg} has no device kernel yet")
    gkeys, slot_used, n_groups, dim_values, dim_valids = _group_table(
        perm, skeys, first, live, starts, k_groups, dim_vals, dim_types)
    return (gkeys, slot_used, aggv, cnt.to(torch.float32), n_groups,
            dim_values, dim_valids)


def _reduce_by_key_sorted_weighted(keys, wsum, wcnt, k_groups: int,
                                   dim_vals, dim_types):
    """Weighted sort + segmented reduce: each input row carries a
    pre-summed measure (wsum) and count (wcnt), as the partial tables of
    the cross-batch merge do. Sums add in float64 (integer sums in int64)
    and keep the input dtype. Same output as _reduce_by_key_sorted."""
    perm, skeys, first, live, idx, starts, _ = _sorted_runs(keys, k_groups)
    wsum, wcnt = wsum[perm], wcnt[perm]
    wide = torch.float64 if wsum.dtype.is_floating_point else torch.int64
    aggv = _segment_add(wsum, idx, k_groups, wide).to(wsum.dtype)
    cnt = _segment_add(wcnt, idx, k_groups, torch.float64).to(wcnt.dtype)
    gkeys, slot_used, n_groups, dim_values, dim_valids = _group_table(
        perm, skeys, first, live, starts, k_groups, dim_vals, dim_types)
    return gkeys, slot_used, aggv, cnt, n_groups, dim_values, dim_valids


def reduce_by_key_weighted(keys, wsum, wcnt, wrows, k_groups: int,
                           dim_vals, dim_types, dim_strides=None):
    """Adaptive weighted group-by of per-run lanes (run-length archive
    batches): wsum, wcnt and wrows are each run's measure sum, valid
    measure rows and filter-passing rows. Routed as reduce_by_key: where
    the live keys fit RT_DENSE_CAP slots, the three lanes go through K2
    unchanged (_runtime_dense_reduce's `stacked`), else through the
    weighted sort. Same output as reduce_by_key."""
    rt_ok = (dim_types is not None and bool(dim_vals)
             and wsum.dtype == torch.float32 and _rt_dense_enabled())
    if not rt_ok:
        return _reduce_by_key_sorted_weighted(keys, wsum, wcnt, k_groups,
                                              dim_vals, dim_types)
    rt = _runtime_dense_slots(keys, dim_types, dim_strides)
    if rt is not None:
        out = _runtime_dense_reduce(
            *rt, None, None, k_groups,
            stacked=torch.stack([wsum, wcnt, wrows], dim=1))
    else:
        out = _reduce_by_key_sorted_weighted(keys, wsum, wcnt, k_groups,
                                             None, None)[:5]
    gkeys, slot_used, aggv, cnt, n_groups = out
    dim_values, dim_valids = unpack_dim_keys(gkeys, dim_vals, dim_types,
                                             slot_used)
    return (gkeys, slot_used, aggv, cnt, n_groups, tuple(dim_values),
            tuple(dim_valids))


def _run_sums(lanes: List[torch.Tensor], starts, ends) -> List[torch.Tensor]:
    """Each lane summed over every run's contiguous rows [start, end), as
    the difference of its prefix sums at the run's ends, in float32.

    Boolean lanes add in int64, exactly. A float lane adds its finite
    values in a float64 prefix (the JAX package's sorted_segment_sum
    keeps an exact float64 block prefix too) and counts its NaNs and
    infinities in int64 prefixes, so that a NaN poisons only its own run
    and an infinity propagates, as direct summation does; a float64
    prefix would spread one NaN over every later run. No atomics: a run
    holds thousands of rows, which an index_add_ on a run-id lane would
    pile onto one address each."""
    def prefix_diff(x, dtype):
        c = torch.zeros(x.shape[0] + 1, dtype=dtype, device=x.device)
        torch.cumsum(x, 0, dtype=dtype, out=c[1:])
        return c[ends] - c[starts]

    out = []
    for lane in lanes:
        if lane.dtype == torch.bool:
            out.append(prefix_diff(lane, torch.int64).to(torch.float32))
            continue
        finite = torch.isfinite(lane)
        s = prefix_diff(torch.where(finite, lane, 0.0), torch.float64)
        nan = prefix_diff(torch.isnan(lane), torch.int64) > 0
        pinf = prefix_diff(lane == np.inf, torch.int64) > 0
        ninf = prefix_diff(lane == -np.inf, torch.int64) > 0
        s = torch.where(pinf, np.inf, s)
        s = torch.where(ninf, -np.inf, s)
        s = torch.where(nan | (pinf & ninf), np.nan, s)
        out.append(s.to(torch.float32))
    return out


def make_runlen_agg_kernel(plan: CompiledQuery, n_rows: int, n_runs: int,
                           k_groups: int, spec, device: torch.device):
    """The aggregation of one run-length archive batch (runlen.py):
    fn(columns, n_valid_rows, n_valid_runs, foreign=()) -> the keyed
    kernel's 7-tuple (make_agg_kernel).

    columns holds [n_runs] lanes for spec.run_cols, [n_rows] lanes for
    spec.row_cols, (-2, 0) = (run_starts[n_runs], run_lens[n_runs])
    int32 and, for an integer row-level sum, (-2, 1) = (run_id[n_rows]
    int32, unused). A row-level float measure and the counts sum over each
    run's rows by prefix differences (_run_sums); an integer one adds in
    int64 by run id, as the JAX package's segment_sum does. Every lane
    reaching K2 is exact in float32 while a run's and a group's row counts
    stay below 2^24 in one call, which the archive chunk
    (executor.ShardExecutor.ARCHIVE_CHUNK_ROWS, 4,194,304 rows) bounds.
    Reference role: the compressed iteration of
    query/iterator.hpp:214-240."""
    filters = list(plan.filters) + list(plan.time_filter_expr)

    def fn(columns, n_valid_rows, n_valid_runs, foreign=()):
        row_ctx = _EvalCtx(columns, n_rows, device, foreign)
        run_ctx = _EvalCtx(columns, n_runs, device, foreign)
        starts, lens = (t.long() for t in columns[(-2, 0)])
        ends = starts + lens

        rmask = None
        if spec.row_filters or spec.measure_level == "row":
            rmask = torch.arange(n_rows, device=device) < n_valid_rows
            for i in spec.row_filters:
                v = _truthy(_emit(filters[i], row_ctx, plan))
                rmask = rmask & v.value & v.valid

        if spec.measure_level == "row":
            mlane = _measure_lane(plan, row_ctx)
            mvalid = mlane.valid & rmask
            if mlane.value.dtype == torch.float32:
                contrib = torch.where(mvalid, mlane.value, 0.0)
                wsum, wcnt, wrows = _run_sums([contrib, mvalid, rmask],
                                              starts, ends)
            else:
                rid, _ = columns[(-2, 1)]
                contrib = torch.where(mvalid, mlane.value,
                                      torch.zeros_like(mlane.value))
                wsum = torch.zeros(n_runs, dtype=torch.int64,
                                   device=device).index_add_(
                    0, rid.long(), contrib.to(torch.int64))
                wcnt, wrows = _run_sums([mvalid, rmask], starts, ends)
        else:
            mlane = _measure_lane(plan, run_ctx)
            if spec.row_filters:
                (wrows,) = _run_sums([rmask], starts, ends)
            else:
                wrows = lens.to(torch.float32)
            mv = mlane.valid
            wcnt = torch.where(mv, wrows, 0.0)
            value = torch.where(mv, mlane.value,
                                torch.zeros_like(mlane.value))
            wsum = value * wrows.to(value.dtype)

        runmask = torch.arange(n_runs, device=device) < n_valid_runs
        for i in spec.run_filters:
            v = _truthy(_emit(filters[i], run_ctx, plan))
            runmask = runmask & v.value & v.valid
        dim_vals = [_emit(d.expr, run_ctx, plan) for d in plan.dimensions]
        ptypes = [_packing_type(d) for d in plan.dimensions]
        # a run forms a group only if one of its rows passes every filter;
        # dropped runs contribute exact zeros, the dense branch included
        mask = runmask & (wrows > 0)
        wsum = torch.where(mask, wsum, torch.zeros_like(wsum))
        wcnt = torch.where(mask, wcnt, 0.0)
        wrows = torch.where(mask, wrows, 0.0)
        keys = pack_dim_keys(dim_vals, ptypes, mask)
        exact, _ = pack_modes(ptypes)
        return reduce_by_key_weighted(
            keys, wsum, wcnt, wrows, k_groups, dim_vals,
            dim_types=ptypes if (exact and dim_vals) else None,
            dim_strides=[dim_pack_stride(d) for d in plan.dimensions])

    return fn


def agg_batch_body(plan: CompiledQuery, n_rows: int, k_groups: int,
                   columns, n_valid, live_cutoff, device: torch.device,
                   foreign=()):
    """The per-batch keyed aggregation: filters, dims and measure, the
    group key, and reduce_by_key into k_groups slots."""
    ctx = _EvalCtx(columns, n_rows, device, foreign)
    mask, dim_vals = _eval_common(plan, ctx, n_valid, live_cutoff)
    mlane = _measure_lane(plan, ctx)
    ptypes = [_packing_type(d) for d in plan.dimensions]
    keys = pack_dim_keys(dim_vals, ptypes, mask)
    exact, _ = pack_modes(ptypes)
    return reduce_by_key(keys, mlane.value, mlane.valid, plan.measure.agg,
                         plan.measure.out_float, k_groups, dim_vals,
                         dim_types=ptypes if (exact and dim_vals) else None,
                         dim_strides=[dim_pack_stride(d)
                                      for d in plan.dimensions])


def make_agg_kernel(plan: CompiledQuery, n_rows: int, k_groups: int,
                    device: torch.device):
    """The keyed aggregation of one padded batch of n_rows:
    fn(columns, n_valid, live_cutoff, foreign=()) -> (group_keys[K]
    int64, slot_used[K], agg[K], cnt[K], n_groups, dim_values,
    dim_valids)."""

    def fn(columns, n_valid, live_cutoff, foreign=()):
        return agg_batch_body(plan, n_rows, k_groups, columns, n_valid,
                              live_cutoff, device, foreign)

    return fn


# ---------------------------------------------------------------------------
# HLL distinct counts: the 64-bit murmur hash on int64 tensors, and the
# per-batch register build
# ---------------------------------------------------------------------------

def _fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ _lsr(k, 33)
    k = k * _signed64(0xFF51AFD7ED558CCD)
    k = k ^ _lsr(k, 33)
    k = k * _signed64(0xC4CEB9FE1A85EC53)
    return k ^ _lsr(k, 33)


def murmur3_64(values: torch.Tensor, width_bytes: int) -> torch.Tensor:
    """hll.murmur3_64 on a torch lane: the first 64 bits of murmur3 x64
    128 (seed 0) of each value's low `width_bytes` bytes, as int64 bits.
    torch's uint64 lacks most ops, so the u64 arithmetic runs on int64:
    products wrap mod 2^64 with the same bits, right shifts are made
    logical, and the constants are their signed 64-bit patterns. A value
    widens as the JAX package's astype(uint64) does: integers sign-extend
    (the width mask then keeps the low bytes), floats convert with
    saturation (XLA's float -> u64: 0 below zero and for NaN, all ones
    from 2^64)."""
    if values.dtype.is_floating_point:
        f = values.to(torch.float64)
        below = 2.0 ** 63 - 1024   # the largest float64 below 2^63
        k1 = torch.where(f >= 2.0 ** 63,
                         (f - 2.0 ** 63).clamp(0.0, below).to(torch.int64)
                         | _SIGN,
                         f.clamp(0.0, below).to(torch.int64))
        k1 = torch.where(f >= 2.0 ** 64, -1, k1)
        k1 = torch.where(torch.isnan(f), 0, k1)
    else:
        k1 = values.to(torch.int64)
    if width_bytes < 8:
        k1 = k1 & ((1 << (8 * width_bytes)) - 1)
    k1 = k1 * _signed64(H._C1)
    k1 = (k1 << 31) | _lsr(k1, 33)
    k1 = k1 * _signed64(H._C2)
    h1 = k1 ^ width_bytes
    h2 = torch.full_like(h1, width_bytes)
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix64(h1) + _fmix64(h2)


def hll_value_from_hash(hashed: torch.Tensor) -> torch.Tensor:
    """hll.hll_value_from_hash on int64 hash bits: rho << 16 | group, where
    group is the hash's low 14 bits and rho the count of zero bits from
    bit 14 up, capped at 50 (int64 values below 2^32)."""
    group = hashed & (H.HLL_M - 1)
    x = _lsr(hashed, H.HLL_BITS)   # below 2^50: plain shifts from here
    rho = torch.zeros_like(hashed)
    for shift in (32, 16, 8, 4, 2, 1):
        low_zero = (x & ((1 << shift) - 1)) == 0
        rho = rho + low_zero.to(torch.int64) * shift
        x = torch.where(low_zero, x >> shift, x)
    rho = rho.clamp(max=64 - H.HLL_BITS)
    return (rho << 16) | group


def _hll_lane(plan: CompiledQuery, ctx: _EvalCtx):
    """Per-row HLL value lane -> (value int64 in [0, 2^32) with the
    measure's validity, register id, rho clamped at 254). A column marked
    as client-hashed HLL values is taken as it is; a UUID hashes as the
    XOR of its two 64-bit lanes; any other value through murmur3_64 at
    its column's byte width (4 for an expression).
    Reference: GetHLLValueFunctor (query/functor.hpp:446)."""
    expr_ast = plan.measure.expr
    is_var = isinstance(expr_ast, E.VarRef)
    is_hll_col = (is_var and expr_ast.table_id == 0
                  and expr_ast.column_id >= 0
                  and plan.main_schema.table.columns[expr_ast.column_id]
                  .hll_config.is_hll_column)
    v = _emit(expr_ast, ctx, plan)
    if is_hll_col:
        hv = v.value.to(torch.int64) & 0xFFFFFFFF
    else:
        if is_var and expr_ast.data_type == mdt.UUID:
            hashed = v.value[:, 0] ^ v.value[:, 1]
        else:
            width = mdt.data_type_bytes(expr_ast.data_type) if is_var else 4
            hashed = murmur3_64(v.value, width)
        hv = hll_value_from_hash(hashed)
    reg = hv & (H.HLL_M - 1)
    rho = (hv >> 16).clamp(max=254)
    return _Val(hv, v.valid), reg, rho


def hll_batch_body(plan: CompiledQuery, n_rows: int, k_groups: int,
                   columns, n_valid, live_cutoff, device: torch.device,
                   foreign=()):
    """One batch's HLL group-by: rows co-sorted by group key, then every
    (group, register) pair's largest rho in ONE scatter-max over
    [k_groups * 16384] registers. Returns (group_keys[K] int64,
    slot_used[K], registers[K, 16384] uint8 holding rho + 1 (0 = empty),
    cnt[K] float32 of valid measures, n_groups, dim_values, dim_valids).
    Reference: query/hll.cu HyperLogLog. The JAX package's packed
    single-operand sort (ARES_HLL_SORT=packed) is a TPU sort-operand
    device and is not carried over."""
    m = H.HLL_M
    ctx = _EvalCtx(columns, n_rows, device, foreign)
    mask, dim_vals = _eval_common(plan, ctx, n_valid, live_cutoff)
    hv, reg, rho = _hll_lane(plan, ctx)
    dim_types = [_packing_type(d) for d in plan.dimensions]
    exact, _ = pack_modes(dim_types)
    keys = pack_dim_keys(dim_vals, dim_types, mask)
    perm, skeys, first, live, idx, starts, ends = _sorted_runs(keys,
                                                               k_groups)
    sreg, srho, svalid = reg[perm], rho[perm], hv.valid[perm]
    valid_m = svalid & (idx < k_groups)
    # the other rows spread over spare slots past the last register, as
    # _scatter_index does, instead of piling on one address
    spill = k_groups * m + (torch.arange(n_rows, device=device)
                            & (_SPILL - 1))
    reg_key = torch.where(valid_m, idx * m + sreg, spill)
    # stored register = trailing-zero count + 1 (the reference's write
    # functor, query/functor.hpp:1364): 0 means empty
    registers = torch.zeros(k_groups * m + _SPILL, dtype=torch.int32,
                            device=device).scatter_reduce_(
        0, reg_key, torch.where(valid_m, srho + 1, 0).to(torch.int32),
        "amax")[:k_groups * m]
    registers = registers.to(torch.uint8).reshape(k_groups, m)
    if _k2_takes_runs(k_groups, device):
        cnt = _k2_runs(svalid.to(torch.float32)[:, None], idx,
                       k_groups)[:, 0]
    else:
        # valid measures per group from the sorted runs' prefix sums (the
        # JAX package's default prefix path): an index_add_ would pile
        # every row of a few-group query onto a few float64 atomics
        csum = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=device),
                          torch.cumsum(svalid, 0)])
        cnt = csum[ends[:k_groups]] - csum[starts[:k_groups]]
    gkeys, slot_used, n_groups, dim_values, dim_valids = _group_table(
        perm, skeys, first, live, starts, k_groups, dim_vals,
        dim_types if (exact and dim_vals) else None)
    return (gkeys, slot_used, registers, cnt.to(torch.float32), n_groups,
            dim_values, dim_valids)


def make_hll_kernel(plan: CompiledQuery, n_rows: int, k_groups: int,
                    device: torch.device):
    """fn(columns, n_valid, live_cutoff, foreign=()) -> hll_batch_body's
    group table for one padded batch of n_rows."""

    def fn(columns, n_valid, live_cutoff, foreign=()):
        return hll_batch_body(plan, n_rows, k_groups, columns, n_valid,
                              live_cutoff, device, foreign)

    return fn


# ---------------------------------------------------------------------------
# non-aggregate queries: the filter mask and dimension lanes, no reduce
# ---------------------------------------------------------------------------

def make_select_kernel(plan: CompiledQuery, n_rows: int, top_l: int,
                       device: torch.device):
    """fn(columns, n_valid, live_cutoff, foreign=()) over one padded batch.
    top_l = 0: (mask[n], dim values, dim valids) of every row. top_l > 0:
    (n_found, dims[top_l], valids[top_l]): the first top_l passing rows in
    scan order, compacted on the device so that only they reach the host;
    n_found counts every passing row and may exceed top_l.
    Reference: query/aql_nonaggr_batchexecutor.go."""

    def fn(columns, n_valid, live_cutoff, foreign=()):
        ctx = _EvalCtx(columns, n_rows, device, foreign)
        mask, dim_vals = _eval_common(plan, ctx, n_valid, live_cutoff)
        if not top_l:
            return (mask, tuple(dv.value for dv in dim_vals),
                    tuple(dv.valid for dv in dim_vals))
        # a stable sort of the inverted mask moves passing rows to the
        # front in scan order
        idx = torch.sort((~mask).to(torch.int8), stable=True)[1][:top_l]
        return (mask.sum(dtype=torch.int32),
                tuple(dv.value[idx] for dv in dim_vals),
                tuple(dv.valid[idx] for dv in dim_vals))

    return fn


# ---------------------------------------------------------------------------
# kernel cache: keyed by (plan signature, batch shape, domains, device)
# ---------------------------------------------------------------------------

def plan_signature(plan: CompiledQuery) -> str:
    """Structural key so textually-identical queries share kernels.

    Expressions print column names, so the key also carries each used
    column's id and type, of the main table and of every joined one: two
    tables of one name with other layouts (the JAX package's key omits
    this) must not share a kernel, which would read the other layout's
    columns. It also carries the UTC offsets a timezone join resolved at
    compile time, which the expressions do not print."""
    def layout(table, used):
        cols = table.columns
        return table.name + ":" + ",".join(
            f"{cols[c].name}={c}:{cols[c].data_type}" for c in used)

    parts = [layout(plan.main_schema.table, plan.used_columns),
             "|".join(str(f) for f in plan.filters),
             "|".join(str(f) for f in plan.time_filter_expr),
             "|".join(str(d.expr) for d in plan.dimensions)]
    if plan.measure:
        parts.append(f"{plan.measure.agg}:{plan.measure.expr}:{plan.measure.out_float}")
    for ft in plan.foreign_tables:
        parts.append(f"join:{ft.alias}:{ft.main_key_expr}:"
                     f"{ft.foreign_key_column}:"
                     + layout(ft.schema.table, ft.used_columns))
    if plan.geo is not None:
        g = plan.geo
        parts.append(f"geo:{g.alias}:{g.shape_column}:{g.point_expr}:"
                     f"{g.has_filter}:{g.exclude}")
    parts.append("geodims:" + ",".join(
        "1" if d.geo_dim else "0" for d in plan.dimensions))
    parts.append(f"nonagg:{plan.is_non_agg}")
    tz = []

    def visit(node):
        if isinstance(node, E.Call) and node.name == "__tz_offset":
            tz.append(np.asarray(node.tz_offsets, np.int32).tobytes().hex())

    for e in (list(plan.filters) + list(plan.time_filter_expr)
              + [d.expr for d in plan.dimensions]):
        E.walk(e, visit)
    if tz:
        parts.append("tz:" + ",".join(tz))
    return "\x01".join(parts)


def dense_signature(dense_plan) -> tuple:
    return tuple(
        (d.kind, d.size, d.base, d.step, d.post_div,
         None if d.values is None else d.values.tobytes())
        for d in dense_plan.domains)


def build_kernel(kind: str, make, *args):
    """make(*args), a kernel built in a `kernelBuild` span, counted in
    `query.kernel_builds` and timed in `query.kernel_build` (tag: kind)."""
    tags = {"kind": kind}
    with M.root().timer(M.QUERY_KERNEL_BUILD, tags), \
            tracing.span("kernelBuild", kind=kind):
        fn = make(*args)
    M.root().count(M.QUERY_KERNEL_BUILDS, tags=tags)
    return fn


class KernelCache:
    def __init__(self):
        self._cache: Dict[Tuple, object] = {}

    def get(self, key: Tuple, make, *args):
        """The kernel under key (its kind first), built by make(*args) on
        a miss."""
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = build_kernel(key[0], make, *args)
        return fn

    def dense_agg_kernel(self, plan: CompiledQuery, n_rows: int, dense_plan,
                         device: torch.device):
        return self.get(("dense", plan_signature(plan), n_rows,
                         dense_signature(dense_plan), str(device)),
                        make_dense_agg_kernel, plan, n_rows, dense_plan,
                        device)

    def agg_kernel(self, plan: CompiledQuery, n_rows: int, k_groups: int,
                   device: torch.device):
        return self.get(("agg", plan_signature(plan), n_rows, k_groups,
                         str(device)),
                        make_agg_kernel, plan, n_rows, k_groups, device)

    def select_kernel(self, plan: CompiledQuery, n_rows: int, top_l: int,
                      device: torch.device):
        return self.get(("sel", plan_signature(plan), n_rows, top_l,
                         str(device)),
                        make_select_kernel, plan, n_rows, top_l, device)

    def hll_kernel(self, plan: CompiledQuery, n_rows: int, k_groups: int,
                   device: torch.device):
        return self.get(("hll", plan_signature(plan), n_rows, k_groups,
                         str(device)),
                        make_hll_kernel, plan, n_rows, k_groups, device)

    def runlen_kernel(self, plan: CompiledQuery, n_rows: int, n_runs: int,
                      k_groups: int, spec, device: torch.device):
        return self.get(("runlen", plan_signature(plan), n_rows, n_runs,
                         k_groups, spec.key(), str(device)),
                        make_runlen_agg_kernel, plan, n_rows, n_runs,
                        k_groups, spec, device)


def round_up_pow2(n: int, minimum: int = 1024) -> int:
    c = minimum
    while c < n:
        c <<= 1
    return c
