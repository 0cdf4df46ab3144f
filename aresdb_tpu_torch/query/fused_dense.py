"""K1: the fused dense group-by kernel.

Port of `aresdb_tpu/query/fused_dense.py`. One pass over a batch's staged
columns evaluates the plan's filters, dimensions and measure, maps each
row to its dense slot, counts out-of-domain rows and reduces (measure sum,
valid-measure count, row count) per slot — the unfused dense kernel's ABI
exactly.

The Pallas body is traced per plan. Here the per-row work is EMITTED per
plan as C (`emit_cuda`, one `ares_row` function per plan) and compiled
into the fixed template `csrc/fused_dense_template.cuh`: device code only,
compiled to a cubin inside the process by NVRTC and cached by the SHA-256
of its source. One fixed launcher library (`csrc/fused_dense_launch.cu`,
built once by nvcc) loads each structure's image, checks its parameters
and launches it, so a new structure pays for one in-process compile of a
few hundred lines, which reaches no system header. The source holds the
plan's structure only: the values that move with the query's `now` or
with the data (every number literal, the time-filter bounds among them,
and each dense domain's base, size and stride) are read from a literal
block (`P.i[k]`, `P.f[k]`) that the kernel takes by value at launch. So a
moved window or a moved column range finds the cubin already built.
The divisors (a domain's step and post-division, a bucket width, a
literal divisor of `/`, `%` or FLOOR) come from the query text and stay
C constants, which keeps their division a multiply and shift. The same
source builds with g++ for the CPU test of the row logic. The plain
PyTorch version (`FusedDenseKernel.reduce_plain`) is the torch emitter,
then kernels.dense_slot_lane, then K2's plain version.

Eligibility is the JAX package's (`plan_fused`), and so are FD_MIN_ROWS
and ARES_FUSED=0 (no K1: eligible plans take the unfused dense kernel),
so the same batches reach the same kernel. A joined column of a lane type
is a kernel input like a main-table column: the wrapper resolves the
joined rows once per batch in PyTorch (`_EvalCtx.foreign_column`, the
JAX package's prologue) and hands the kernel the gathered [n] lane after
the main columns.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query import pallas_ops as P
from aresdb_tpu_torch.query.admission import PIPELINE_FACTOR
from aresdb_tpu_torch.query.compiler import CompiledQuery, QueryError
from aresdb_tpu_torch.utils import cuda_build

FD_MAX_SLOTS = 1 << 16   # FD_MAX_KHI * FD_KLO in the JAX package
_MAX_COLS = 24           # csrc/fused_dense_template.cuh ARES_MAX_COLS
# entries of a plan's literal block (ints and floats together): 2 KB of
# kernel parameters beside AresCols' 384 bytes, within the 4 KB limit
# (the template's static_assert). A plan with more bakes its literals.
MAX_LITS = 512

_4B_DTS = (mdt.Uint32, mdt.Int32)
_2B_DTS = (mdt.Uint16, mdt.BigEnum, mdt.Int16)
_1B_DTS = (mdt.Bool, mdt.Uint8, mdt.SmallEnum, mdt.Int8)

_ALLOWED_CALLS = (E.HOUR, E.DAY_OF_WEEK, E.CONVERT_TZ, "__numeric_bucket")

FD_MIN_ROWS = 1 << 16   # the JAX package's floor for the fused kernel


@dataclass
class FusedSpec:
    col_ids: List[int]   # referenced main-table columns, kernel input order
    n_slots: int
    source: str = ""     # the plan's generated kernel source (emit_cuda)
    # the literal block that source reads, in emission order (emit_cuda)
    lits_i: List[int] = field(default_factory=list)
    lits_f: List[float] = field(default_factory=list)
    # referenced joined columns (table_id, column_id, data_type), kernel
    # inputs after the main columns
    fkeys: List[Tuple[int, int, int]] = field(default_factory=list)

    def input_keys(self) -> List[Tuple[int, int]]:
        """(table_id, column_id) of each kernel input, in V[]/B[] order."""
        return ([(0, c) for c in self.col_ids]
                + [(t, c) for t, c, _ in self.fkeys])


def _domain_i32_safe(dom) -> bool:
    if dom.kind != "affine":
        return False
    if isinstance(dom.step, float) or isinstance(dom.base, float):
        return True  # float affine path computes in f32
    lo = dom.base
    hi = dom.base + dom.size * max(dom.step, 1)
    return -(2**31) < lo < 2**31 and -(2**31) < hi < 2**31


def plan_fused(plan: CompiledQuery, dense_plan) -> Optional[FusedSpec]:
    """Check kernel eligibility and build the spec (or None)."""
    m = plan.measure
    if m is None or m.agg not in ("sum", "avg", "count"):
        return None
    if m.agg == "sum" and not m.out_float:
        return None  # integer sums keep their wide accumulator
    if plan.geo is not None or not plan.dimensions:
        return None
    if any(d.geo_dim for d in plan.dimensions):
        return None
    for dom in dense_plan.domains:
        if not _domain_i32_safe(dom):
            return None
    if dense_plan.n_slots > FD_MAX_SLOTS:
        return None

    ok = [True]
    cols: List[int] = []
    fvars: List[Tuple[int, int, int]] = []  # (table_id, cid, data_type)
    lane_dts = _4B_DTS + _2B_DTS + _1B_DTS + (mdt.Float32,)

    def visit(node):
        if isinstance(node, E.VarRef):
            if node.data_type not in lane_dts:
                ok[0] = False
            elif node.table_id != 0:
                # a joined column: the wrapper materializes its [n] lane
                key = (node.table_id, node.column_id, node.data_type)
                if key not in fvars:
                    fvars.append(key)
            elif node.column_id not in cols:
                cols.append(node.column_id)
        elif isinstance(node, E.NumberLiteral):
            if node.type != E.FLOAT and not (
                    -(2**31) <= node.int_val < 2**31):
                ok[0] = False
        elif isinstance(node, E.StringLiteral):
            ok[0] = False  # UUID literal lanes need 64-bit compares
        elif isinstance(node, E.UnaryExpr):
            if node.op.startswith("GET_"):
                ok[0] = False  # calendar math needs int64 lanes
        elif isinstance(node, E.Call):
            if node.name not in _ALLOWED_CALLS and node.name != "":
                ok[0] = False  # "" = IN-list args (expr.parse_in_list)
            if node.name == "__numeric_bucket":
                b = getattr(node, "bucketizer", None)
                if b is None or not b.bucket_width:
                    ok[0] = False  # manual partitions use searchsorted

    exprs = (list(plan.filters) + list(plan.time_filter_expr)
             + [d.expr for d in plan.dimensions] + [m.expr])
    for e in exprs:
        E.walk(e, visit)
        if not ok[0]:
            return None
    if len(cols) + len(fvars) > _MAX_COLS:
        return None
    spec = FusedSpec(col_ids=sorted(cols), n_slots=dense_plan.n_slots,
                     fkeys=sorted(fvars))
    spec.source, spec.lits_i, spec.lits_f = emit_cuda(plan, dense_plan,
                                                      spec)
    return spec


# ---------------------------------------------------------------------------
# C emission of the per-row function
# ---------------------------------------------------------------------------

class _C:
    """A C value: its type ("bool", "int" or "float") and the C
    expressions of its value and validity."""

    __slots__ = ("ctype", "v", "b")

    def __init__(self, ctype: str, v: str, b: str):
        self.ctype = ctype
        self.v = v
        self.b = b


def _ctype_for_expr_type(t: int) -> str:
    if t == E.FLOAT:
        return "float"
    if t == E.BOOLEAN:
        return "bool"
    return "int"


def _c_int(v: int) -> str:
    v = int(v)
    if not -(2**31) <= v < 2**31:
        raise QueryError(f"integer literal {v} outside int32 in fused kernel")
    return "(-2147483647 - 1)" if v == -(2**31) else f"({v})"


def _c_float(x) -> str:
    f = float(np.float32(x))
    if np.isnan(f):
        return "NAN"
    if np.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    return f"({f.hex()}f)"


# staged value type of each lane data type: (C element type, C lane type)
_LOADS = {
    mdt.Float32: ("float", "float"),
    mdt.Bool: ("bool", "bool"),
    mdt.Uint32: ("int", "int"),    # two's complement, as the JAX lanes
    mdt.Int32: ("int", "int"),
    mdt.Uint16: ("unsigned short", "int"),
    mdt.BigEnum: ("unsigned short", "int"),
    mdt.Int16: ("short", "int"),
    mdt.Uint8: ("unsigned char", "int"),
    mdt.SmallEnum: ("unsigned char", "int"),
    mdt.Int8: ("signed char", "int"),
}


class _CEmitter:
    """Mirrors kernels._emit for the fused-eligible forms, one C statement
    per intermediate lane, in the same types and with the same semantics.
    With `lits`, each literal value is a read of the literal block and
    collects into `ints` / `floats`; without, a C constant."""

    def __init__(self, plan: CompiledQuery, spec: FusedSpec,
                 lits: bool = True):
        self.plan = plan
        self.lits = lits
        self.ints: List[int] = []
        self.floats: List[float] = []
        # keyed on (table_id, column_id): a joined table's column ids
        # restart at 0
        self.col_index = {key: j for j, key in enumerate(spec.input_keys())}
        self.lines: List[str] = []
        self._n = 0
        self._cols: Dict[Tuple[int, int], _C] = {}

    def int_lit(self, v: int) -> str:
        baked = _c_int(v)   # raises outside int32
        if not self.lits:
            return baked
        self.ints.append(int(v))
        return f"P.i[{len(self.ints) - 1}]"

    def float_lit(self, x) -> str:
        if not self.lits:
            return _c_float(x)
        self.floats.append(float(np.float32(x)))
        return f"P.f[{len(self.floats) - 1}]"

    def tmp(self, ctype: str, expr: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"  const {ctype} {name} = {expr};")
        return name

    def val(self, ctype: str, v: str, b: str) -> _C:
        return _C(ctype, self.tmp(ctype, v), self.tmp("bool", b))

    def to(self, c: _C, ctype: str) -> _C:
        if c.ctype == ctype:
            return c
        if ctype == "bool":
            v = f"({c.v} != 0)"
        elif ctype == "float":
            v = f"(float)({c.v})"
        elif c.ctype == "float":
            v = f"ares_f2i({c.v})"
        else:
            v = f"(int)({c.v})"
        return _C(ctype, self.tmp(ctype, v), c.b)

    def truthy(self, c: _C) -> _C:
        return c if c.ctype == "bool" else self.to(c, "bool")

    def emit(self, node: E.Expr) -> _C:
        if isinstance(node, E.ParenExpr):
            return self.emit(node.expr)
        if isinstance(node, E.NumberLiteral):
            if node.type == E.FLOAT:
                return _C("float", self.float_lit(node.val), "true")
            return _C("int", self.int_lit(node.int_val), "true")
        if isinstance(node, E.BooleanLiteral):
            return _C("bool", "true" if node.val else "false", "true")
        if isinstance(node, E.NullLiteral):
            return _C("int", "0", "false")
        if isinstance(node, E.VarRef):
            return self.column(node)
        if isinstance(node, E.UnaryExpr):
            return self.unary(node)
        if isinstance(node, E.BinaryExpr):
            return self.binary(node)
        if isinstance(node, E.Call):
            return self.call(node)
        if isinstance(node, E.Case):
            return self.case(node)
        raise QueryError(f"cannot emit expression node {node!r} in C")

    def divisor(self, node: E.Expr) -> _C:
        """The right operand of `/`, `%` or FLOOR. A literal there comes
        from the query text (a bucketizer's width, a user's divisor) and
        stays a C constant, so that its division compiles to a multiply
        and shift."""
        while isinstance(node, E.ParenExpr):
            node = node.expr
        if isinstance(node, E.NumberLiteral):
            if node.type == E.FLOAT:
                return _C("float", _c_float(node.val), "true")
            return _C("int", _c_int(node.int_val), "true")
        return self.emit(node)

    def column(self, node: E.VarRef) -> _C:
        key = (node.table_id, node.column_id)
        c = self._cols.get(key)
        if c is None:
            j = self.col_index[key]
            elem, lane = _LOADS[node.data_type]
            load = f"((const {elem}*)V[{j}])[i]"
            if elem != lane:
                load = f"({lane}){load}"
            c = self.val(lane, load, f"B[{j}][i]")
            self._cols[key] = c
        return c

    def unary(self, node: E.UnaryExpr) -> _C:
        op = node.op
        c = self.emit(node.expr)
        if op == "-":
            v = self.to(c, _ctype_for_expr_type(node.type))
            if v.ctype == "bool":
                raise QueryError("unary minus of a boolean")
            neg = f"ares_neg({v.v})" if v.ctype == "int" else f"(-{v.v})"
            return _C(v.ctype, self.tmp(v.ctype, neg), v.b)
        if op == "~":
            v = self.to(c, "int")
            return _C("int", self.tmp("int", f"(~{v.v})"), v.b)
        if op == "NOT":
            t = self.truthy(c)
            return _C("bool", self.tmp("bool", f"(!{t.v})"), t.b)
        if op == "IS_NULL":
            return _C("bool", self.tmp("bool", f"(!{c.b})"), "true")
        if op == "IS_NOT_NULL":
            return _C("bool", c.b, "true")
        if op == "IS_TRUE":
            t = self.truthy(c)
            return _C("bool", self.tmp("bool", f"({t.v} && {t.b})"), "true")
        if op == "IS_FALSE":
            t = self.truthy(c)
            return _C("bool", self.tmp("bool", f"(!{t.v} && {t.b})"), "true")
        raise QueryError(f"unsupported unary op {op!r} in fused kernel")

    @staticmethod
    def _common(a: _C, b: _C) -> str:
        return "float" if "float" in (a.ctype, b.ctype) else "int"

    def binary(self, node: E.BinaryExpr) -> _C:
        op = node.op
        if op in ("AND", "OR"):
            l = self.truthy(self.emit(node.lhs))
            r = self.truthy(self.emit(node.rhs))
            if op == "AND":
                return self.val("bool", f"({l.v} && {r.v})",
                                f"({l.b} && {r.b})")
            true_side = self.tmp("bool",
                                 f"(({l.v} && {l.b}) || ({r.v} && {r.b}))")
            return _C("bool", true_side,
                      self.tmp("bool", f"({true_side} || ({l.b} && {r.b}))"))
        if op in ("IN", "NOT IN"):
            l = self.emit(node.lhs)
            hits = "false"
            for arg in node.rhs.args:
                r = self.emit(arg)
                dt = self._common(l, r)
                hits = self.tmp("bool", f"({hits} || ({self.to(l, dt).v} == "
                                        f"{self.to(r, dt).v}))")
            if op == "NOT IN":
                hits = self.tmp("bool", f"(!{hits})")
            return _C("bool", hits, l.b)

        l = self.emit(node.lhs)
        r = self.divisor(node.rhs) if op in ("/", "%", "FLOOR") \
            else self.emit(node.rhs)
        valid = f"({l.b} && {r.b})"
        cmp_ops = {"=": "==", "!=": "!=", "<>": "!=", "<": "<", "<=": "<=",
                   ">": ">", ">=": ">="}
        if op in cmp_ops:
            dt = self._common(l, r)
            a, b = self.to(l, dt).v, self.to(r, dt).v
            return self.val("bool", f"({a} {cmp_ops[op]} {b})", valid)
        if op == "/":
            a, b = self.to(l, "float").v, self.to(r, "float").v
            nz = self.tmp("bool", f"({b} != 0.0f)")
            return self.val("float", f"({nz} ? {a} / {b} : 0.0f)",
                            f"({valid} && {nz})")
        if op in ("+", "-", "*", "%", "FLOOR"):
            dt = _ctype_for_expr_type(node.type)
            if dt == "bool":
                dt = "int"
            a, b = self.to(l, dt).v, self.to(r, dt).v
            if op in ("+", "-", "*"):
                if dt == "int":
                    fn = {"+": "ares_add", "-": "ares_sub", "*": "ares_mul"}
                    return self.val("int", f"{fn[op]}({a}, {b})", valid)
                return self.val("float", f"({a} {op} {b})", valid)
            nz = self.tmp("bool", f"({b} != 0)")
            if dt == "int":
                rem = f"ares_rem({a}, {b})"
                out = rem if op == "%" else \
                    f"({nz} ? ares_sub({a}, {rem}) : 0)"
            else:
                rem = f"({nz} ? fmodf({a}, {b}) : 0.0f)"
                out = rem if op == "%" else \
                    f"({nz} ? {a} - fmodf({a}, {b}) : 0.0f)"
            return self.val(dt, out, f"({valid} && {nz})")
        if op in ("&", "|", "^", "<<", ">>"):
            a, b = self.to(l, "int").v, self.to(r, "int").v
            if op == "<<":
                return self.val("int", f"ares_shl({a}, {b})", valid)
            if op == ">>":
                return self.val("int", f"ares_shr({a}, {b})", valid)
            return self.val("int", f"({a} {op} {b})", valid)
        raise QueryError(f"unsupported binary op {op!r} in fused kernel")

    def call(self, node: E.Call) -> _C:
        name = node.name
        if name == E.HOUR:
            c = self.to(self.emit(node.args[0]), "int")
            return _C("int", self.tmp(
                "int", f"ares_floordiv(ares_floormod({c.v}, 86400), 3600)"),
                c.b)
        if name == E.DAY_OF_WEEK:
            c = self.to(self.emit(node.args[0]), "int")
            return _C("int", self.tmp(
                "int", f"(ares_floormod(ares_add(ares_floordiv({c.v}, 86400),"
                       f" 3), 7) + 1)"), c.b)
        if name == E.CONVERT_TZ:
            base = self.emit(node.args[0])
            if len(node.args) < 2:
                return base
            off = self.to(self.emit(node.args[1]), "int")
            base = self.to(base, "int")
            return self.val("int", f"ares_add({base.v}, {off.v})",
                            f"({base.b} && {off.b})")
        if name == "__numeric_bucket":
            c = self.to(self.emit(node.args[0]), "float")
            w = _c_float(node.bucketizer.bucket_width)
            return _C("float", self.tmp("float", f"(floorf({c.v} / {w}) * {w})"),
                      c.b)
        raise QueryError(f"unsupported function {name!r} in fused kernel")

    def case(self, node: E.Case) -> _C:
        dt = _ctype_for_expr_type(node.type)
        if node.else_expr is not None:
            out = self.to(self.emit(node.else_expr), dt)
            value, valid = out.v, out.b
        else:
            value, valid = {"bool": "false", "int": "0",
                            "float": "0.0f"}[dt], "false"
        for cond, res in reversed(node.when_thens):
            c = self.truthy(self.emit(cond))
            r = self.to(self.emit(res), dt)
            take = self.tmp("bool", f"({c.v} && {c.b})")
            value = self.tmp(dt, f"({take} ? {r.v} : {value})")
            valid = self.tmp("bool", f"({take} ? {r.b} : {valid})")
        return _C(dt, value, valid)

    def slot_lane(self, dims: List[_C], dense_plan) -> Tuple[str, str]:
        """kernels.dense_slot_lane for affine domains. A domain's base and
        size and its stride move with the window and the data: literal
        block reads. Its step and post-division stay constants."""
        slot, bad = "0", "false"
        for dv, dom, stride in zip(dims, dense_plan.domains,
                                   dense_plan.strides):
            v = dv
            if v.ctype == "bool" or (v.ctype == "float"
                                     and dom.post_div == 0.0):
                v = self.to(v, "int")
            if isinstance(dom.step, float) or isinstance(dom.base, float):
                vf = self.to(v, "float").v
                idxw = self.tmp("int", f"ares_f2i(rintf(({vf} - "
                                       f"{self.float_lit(dom.base)}) / "
                                       f"{_c_float(dom.step)}))")
            else:
                if dom.post_div:
                    vf = self.to(v, "float").v
                    v = _C("int", self.tmp("int", f"ares_f2i(rintf({vf} * "
                                                  f"{_c_float(dom.post_div)}))"),
                           v.b)
                idxw = self.tmp("int", f"ares_floordiv(ares_sub({v.v}, "
                                       f"{self.int_lit(dom.base)}), "
                                       f"{max(dom.step, 1)})")
            size = self.int_lit(dom.size)
            in_range = self.tmp("bool", f"({idxw} >= 0 && {idxw} < {size})")
            idx = self.tmp("int", f"({idxw} < 0 ? 0 : ({idxw} > {size} - 1"
                                  f" ? {size} - 1 : {idxw}))")
            ok = f"({dv.b} && {in_range})"
            bad = self.tmp("bool", f"({bad} || ({dv.b} && !{in_range}))")
            slot = self.tmp("int", f"ares_add({slot}, ares_mul({ok} ? {idx} "
                                   f"+ 1 : 0, {self.int_lit(stride)}))")
        return slot, bad


def emit_cuda(plan: CompiledQuery, dense_plan, spec: FusedSpec
              ) -> Tuple[str, List[int], List[float]]:
    """(the plan's kernel source, its literal block's ints and floats):
    the fused template plus one generated `ares_row` evaluating the
    plan's filters, dimensions and measure. Two plans that differ only in
    `now` or in their domains' bases and sizes give the same source. A
    plan with more than MAX_LITS literals bakes them into the source and
    has an empty block."""
    body, ints, floats = _row_body(plan, dense_plan, spec, lits=True)
    if len(ints) + len(floats) > MAX_LITS:
        body, ints, floats = _row_body(plan, dense_plan, spec, lits=False)
    return f"""// Generated by aresdb_tpu_torch.query.fused_dense.emit_cuda.
#define ARES_NI {len(ints)}
#define ARES_NF {len(floats)}
#include "fused_dense_template.cuh"

ARES_DEV void ares_row(const void* const* V, const bool* const* B,
                       long long i, const AresLits& P, AresRow& r) {{
{body}
}}
""", ints, floats


def _row_body(plan: CompiledQuery, dense_plan, spec: FusedSpec,
              lits: bool) -> Tuple[str, List[int], List[float]]:
    """The row function's statements, and the literal block they read."""
    em = _CEmitter(plan, spec, lits)
    keep = "true"
    for f in plan.filters + plan.time_filter_expr:
        t = em.truthy(em.emit(f))
        keep = em.tmp("bool", f"({keep} && {t.v} && {t.b})")
    dims = [em.emit(d.expr) for d in plan.dimensions]
    m = em.to(em.emit(plan.measure.expr), "float")
    slot, bad = em.slot_lane(dims, dense_plan)
    em.lines += [f"  r.keep = {keep};", f"  r.bad = {bad};",
                 f"  r.slot = {slot};", f"  r.mval = {m.v};",
                 f"  r.mvalid = {m.b};"]
    return "\n".join(em.lines), em.ints, em.floats


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

class FusedDenseKernel:
    """K1 for one plan, dense plan and padded batch size. Called with the
    unfused dense kernel's ABI: fn(columns, n_valid, live_cutoff, acc,
    foreign=()) -> ((agg, cnt, rows) folded into acc, overflow). The
    executor records its batches instead (`record`) and launches a
    query's batches of one structure together (`reduce_batches`)."""

    launches = 0  # kernel launches, all instances

    def __init__(self, plan: CompiledQuery, n_rows: int, dense_plan,
                 spec: FusedSpec, device: torch.device):
        self.plan = plan
        self.n_rows = n_rows
        self.dense_plan = dense_plan
        self.spec = spec
        self.device = device
        self._kernel = None   # the structure's loaded kernel, at first launch
        # batches of one structure and literal block share a launcher call
        self.group_key = (spec.source, tuple(spec.lits_i),
                          tuple(spec.lits_f))
        # the literal block's host arrays, copied into the kernel's
        # parameters at each launch
        self._lits = ((ctypes.c_int * max(len(spec.lits_i), 1))(
                          *spec.lits_i),
                      (ctypes.c_float * max(len(spec.lits_f), 1))(
                          *spec.lits_f))

    def _device(self, columns) -> torch.device:
        cids = self.spec.col_ids
        return columns[(0, cids[0])][0].device if cids else self.device

    def _lanes(self, columns, foreign=()):
        """The kernel's inputs in V[]/B[] order: each main column as
        staged, then each joined column gathered into an [n] lane."""
        return self._main_lanes(columns) + self._joined_lanes(columns,
                                                              foreign)

    def _main_lanes(self, columns):
        return [columns[(0, cid)] for cid in self.spec.col_ids]

    def _joined_lanes(self, columns, foreign=()):
        """Each joined column gathered into an [n] lane (one probe of the
        joined table per batch; the JAX package's prologue,
        fused_dense.py:516-537)."""
        if not self.spec.fkeys:
            return []
        ctx = K._EvalCtx(columns, self.n_rows, self._device(columns),
                         foreign)
        return [ctx.foreign_column(t, c, self.plan, *columns[(t, c)])
                for t, c, _ in self.spec.fkeys]

    def reduce_plain(self, columns, n_valid: int, live_cutoff, foreign=()):
        """Plain PyTorch version: (out float32 [3, n_slots], overflow)."""
        device = self._device(columns)
        ctx = K._EvalCtx(columns, self.n_rows, device, foreign)
        mask, dim_vals = K._eval_common(self.plan, ctx, n_valid, live_cutoff)
        mlane = K._measure_lane(self.plan, ctx)
        slot, bad = K.dense_slot_lane(dim_vals, self.dense_plan, self.n_rows,
                                      device)
        keep = mask & ~bad
        mvalid = mlane.valid & keep
        stacked = torch.stack(
            [torch.where(mvalid, mlane.value, torch.zeros_like(mlane.value)),
             mvalid.to(torch.float32), keep.to(torch.float32)], dim=1)
        dropped = torch.where(keep, slot, torch.full_like(slot, -1))
        out = P.segment_sum_plain(dropped, stacked, self.spec.n_slots)
        return out.t().contiguous(), (mask & bad).sum(dtype=torch.int32)

    def _checked(self, columns, live_cutoff, foreign=(), joined=True):
        """(device, lanes, time column pointer or None) of one CUDA
        launch: the lanes' device, contiguity and length and the time
        column's type checked, else ValueError. With joined False, the
        main columns' lanes alone."""
        device = self._device(columns)
        if device.type != "cuda":
            raise ValueError(f"fused_dense: unsupported device {device}")
        lanes = self._lanes(columns, foreign) if joined else \
            self._main_lanes(columns)
        self._check_lanes(device, lanes)
        tptr = None
        schema = self.plan.main_schema.table
        if (live_cutoff is not None and schema.is_fact_table
                and (0, 0) in columns):
            tvals = columns[(0, 0)][0]
            if tvals.dtype != torch.int32 or tvals.device != device:
                raise ValueError("fused_dense: the time column must be a "
                                 f"staged Uint32 lane on {device}")
            tptr = tvals.data_ptr()
        return device, lanes, tptr

    def _check_lanes(self, device, lanes) -> None:
        for values, validity in lanes:
            for t in (values, validity):
                if t.device != device or not t.is_contiguous() or \
                        t.shape[0] != self.n_rows:
                    raise ValueError(
                        f"fused_dense: lane {tuple(t.shape)} on {t.device} "
                        f"(contiguous={t.is_contiguous()}) does not match "
                        f"[{self.n_rows}] on {device}")

    def reduce(self, columns, n_valid: int, live_cutoff, foreign=()):
        """K1: (out float32 [3, n_slots], overflow int32 scalar tensor).
        CPU tensors take the plain version; CUDA tensors launch the kernel
        or raise."""
        if self._device(columns).type == "cpu":
            return self.reduce_plain(columns, n_valid, live_cutoff, foreign)
        device, lanes, tptr = self._checked(columns, live_cutoff, foreign)
        n_slots = self.spec.n_slots
        out = torch.zeros((3, n_slots), dtype=torch.float32, device=device)
        ovf = torch.zeros(1, dtype=torch.int32, device=device)
        n_cols = len(lanes)
        vals = (ctypes.c_void_p * max(n_cols, 1))(
            *[v.data_ptr() for v, _ in lanes])
        valids = (ctypes.c_void_p * max(n_cols, 1))(
            *[b.data_ptr() for _, b in lanes])
        if self._kernel is None:
            self._kernel = structure_kernel(self.spec, device)
        stream = torch.cuda.current_stream(device)
        rc = _launcher().ares_fused_dense(
            self._kernel, len(self.spec.lits_i), len(self.spec.lits_f), vals,
            valids, n_cols, *self._lits, self.n_rows, int(n_valid), tptr,
            int(live_cutoff or 0), n_slots, out.data_ptr(), ovf.data_ptr(),
            device.index or 0, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_dense kernel launch failed: CUDA error {rc}")
        FusedDenseKernel.launches += 1
        return out, ovf[0]

    def record(self, columns, n_valid: int, live_cutoff, foreign=()
               ) -> "K1Batch":
        """One batch's launch, recorded for its query's launcher call
        (reduce_batches) in place of launching it. On CUDA its main lanes
        and time column are checked here, as `reduce` checks them, so an
        error raises at the batch that has it; its joined lanes are
        gathered at the launch (launch_lanes), so that a recorded batch
        holds no more of the card than its staged columns."""
        tptr = None
        if self._device(columns).type != "cpu":
            _, _, tptr = self._checked(columns, live_cutoff, joined=False)
        return K1Batch(self, columns, foreign, int(n_valid),
                       int(live_cutoff or 0), tptr)

    def __call__(self, columns, n_valid: int, live_cutoff, acc, foreign=()):
        out, overflow = self.reduce(columns, n_valid, live_cutoff, foreign)
        return K.dense_fold_epilogue(self.plan.measure.agg, acc, out[0],
                                     out[1], out[2], overflow)


@dataclass
class K1Batch:
    """A dense batch's K1 launch, recorded for its query's launcher call:
    its kernel (of its padded size), staged columns and joined tables'
    probes, row count and cutoff and, on CUDA, its time column's
    pointer."""
    kernel: FusedDenseKernel
    columns: dict
    foreign: tuple
    n_valid: int
    live_cutoff: int
    tptr: Optional[int] = None


def launch_calls(batches: List[K1Batch]) -> List[List[K1Batch]]:
    """A group's batches cut into launcher calls: one call for them all,
    or where the kernel reads joined lanes, which each call gathers for
    its batches (launch_lanes), PIPELINE_FACTOR batches a call: no more
    batches' gathered lanes at once than admission's estimate holds in
    flight."""
    step = PIPELINE_FACTOR if batches[0].kernel.spec.fkeys else len(batches)
    return [batches[at:at + step] for at in range(0, len(batches), step)]


def launch_lanes(rec: K1Batch) -> list:
    """A recorded batch's lanes in V[]/B[] order at its launch: its main
    columns as staged, its joined columns gathered now, those checked as
    `reduce` checks them."""
    kern = rec.kernel
    joined = kern._joined_lanes(rec.columns, rec.foreign)
    kern._check_lanes(kern._device(rec.columns), joined)
    return kern._main_lanes(rec.columns) + joined


def reduce_batches(batches: List[K1Batch]):
    """K1 over a query's batches of one structure and literal block:
    (out float32 [N, 3, n_slots], overflow int32 [N]), batch b's table and
    overflow count at b. On CUDA, ONE launcher call
    (ares_fused_dense_batches) makes one launch a batch into its slice;
    on the CPU each batch runs its kernel's `reduce` (the plain version)
    into its slice."""
    first = batches[0]
    kern = first.kernel
    n, n_slots = len(batches), kern.spec.n_slots
    device = kern._device(first.columns)
    if device.type == "cpu":
        out = torch.zeros((n, 3, n_slots), dtype=torch.float32)
        ovf = torch.zeros(n, dtype=torch.int32)
        for b, rec in enumerate(batches):
            out[b], ovf[b] = rec.kernel.reduce(rec.columns, rec.n_valid,
                                               rec.live_cutoff, rec.foreign)
        return out, ovf
    out = torch.zeros((n, 3, n_slots), dtype=torch.float32, device=device)
    ovf = torch.zeros(n, dtype=torch.int32, device=device)
    # the gathered lanes stay referenced until the call has enqueued
    # their launches on the stream
    lanes = [launch_lanes(rec) for rec in batches]
    n_cols = len(lanes[0])
    ptrs = [t.data_ptr() for ls in lanes for t, _ in ls]
    vptrs = [t.data_ptr() for ls in lanes for _, t in ls]
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    if kern._kernel is None:
        kern._kernel = structure_kernel(kern.spec, device)
    stream = torch.cuda.current_stream(device)
    rc = _launcher().ares_fused_dense_batches(
        kern._kernel, len(kern.spec.lits_i), len(kern.spec.lits_f), n,
        (p * max(len(ptrs), 1))(*ptrs), (p * max(len(vptrs), 1))(*vptrs),
        n_cols, *kern._lits,
        (ll * n)(*[rec.kernel.n_rows for rec in batches]),
        (ll * n)(*[rec.n_valid for rec in batches]),
        (p * n)(*[rec.tptr for rec in batches]),
        (ll * n)(*[rec.live_cutoff for rec in batches]),
        n_slots, out.data_ptr(), ovf.data_ptr(), device.index or 0,
        stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_dense batches' launch failed: CUDA error "
                           f"{rc}")
    FusedDenseKernel.launches += n
    return out, ovf


LAUNCH_SOURCE = "fused_dense_launch.cu"


def build_item(source: str) -> Tuple[str, str, str]:
    """cuda_build's (name, text, kind) of a structure's device image: a
    cubin NVRTC compiles in this process."""
    return ("fused_dense", source, "nvrtc")


def launcher_item() -> Tuple[str, str, str]:
    """cuda_build's (name, text, kind) of the fixed launcher library."""
    return ("fused_dense_launch", cuda_build.csrc_text(LAUNCH_SOURCE), "host")


def _launcher() -> ctypes.CDLL:
    """The launcher library, loaded once a process, with its argtypes."""
    def load():
        lib = cuda_build.load_library(*launcher_item())
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ares_fused_dense_load.argtypes = [p, i, i, i,
                                              ctypes.POINTER(p)]
        lib.ares_fused_dense_cluster.argtypes = [i, i]
        lib.ares_fused_dense.argtypes = [p, i, i, p, p, i, p, p, ll, ll, p,
                                         ll, i, p, p, i, p]
        lib.ares_fused_dense_usage.argtypes = [p, i, ctypes.POINTER(i),
                                               ctypes.POINTER(i)]
        lib.ares_fused_dense_plan.argtypes = [p, i, ll, i]
        lib.ares_fused_dense_batches.argtypes = [p, i, i, i, p, p, i, p, p,
                                                 p, p, p, p, i, p, p, i, p]
        for fn in (lib.ares_fused_dense_load, lib.ares_fused_dense_cluster,
                   lib.ares_fused_dense, lib.ares_fused_dense_usage,
                   lib.ares_fused_dense_plan, lib.ares_fused_dense_batches):
            fn.restype = i
        return lib
    return cuda_build.cached(("fused_dense launcher",), load)


def structure_kernel(spec: FusedSpec, device: torch.device) -> int:
    """The loaded kernel (a cudaKernel_t) of this plan structure: its cubin
    built if needed (the launcher too, both at once, where neither is
    built yet) and loaded once a process, a `kernelBuild` of kind
    "nvrtc"; every window and column range of the structure shares it.
    Raises where a build, the load or the check of its parameters
    fails."""
    def load():
        cuda_build.build_all([launcher_item(), build_item(spec.source)])
        image = cuda_build.load_cubin(*build_item(spec.source)[:2])
        handle = ctypes.c_void_p()
        rc = _launcher().ares_fused_dense_load(
            image, len(spec.lits_i), len(spec.lits_f), device.index or 0,
            ctypes.byref(handle))
        if rc < 0:
            raise RuntimeError(
                "fused_dense: the cubin's parameter "
                f"{'count' if rc == -100 else -rc - 1} does not match the "
                "launcher's ABI (fused_dense_template.cuh)")
        if rc != 0:
            raise RuntimeError(f"fused_dense: loading the cubin failed: CUDA "
                               f"error {rc}")
        return handle.value
    return cuda_build.cached(("fused_dense kernel", spec.source),
                             lambda: K.build_kernel("nvrtc", load))


def kernel_usage(kernel: int, device: torch.device) -> dict:
    """A loaded K1 kernel's registers a thread and local memory bytes (its
    stack frame, spills included), as its image states them: NVRTC's log
    carries ptxas's report only where its ptxas ran, not where the CUDA
    compute cache answered."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = _launcher().ares_fused_dense_usage(kernel, device.index or 0,
                                            ctypes.byref(regs),
                                            ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"fused_dense: reading the kernel's attributes "
                           f"failed: CUDA error {rc}")
    return {"registers": regs.value, "local_bytes": local.value}


def launch_plan(kernel: int, n_slots: int, n_rows: int,
                device: torch.device) -> int:
    """Sizes a launch of a loaded K1 kernel as `reduce` does, without
    launching it: the clusters of its grid (the occupancy query runs once
    a kernel and shape, then is cached)."""
    clusters = _launcher().ares_fused_dense_plan(kernel, n_slots, n_rows,
                                                 device.index or 0)
    if clusters <= 0:
        raise RuntimeError(f"fused_dense: no launch of {n_slots} slots "
                           f"({clusters})")
    return clusters


def cluster_size(n_slots: int, device: torch.device) -> int:
    """The ranks of the cluster a K1 launch over n_slots takes (0: none
    holds the table)."""
    return _launcher().ares_fused_dense_cluster(n_slots, device.index or 0)


def maybe_make_fused_kernel(plan: CompiledQuery, n_rows: int, dense_plan,
                            device: torch.device):
    # ARES_FUSED=0 turns K1 off, as in the JAX package; its "interp"
    # (interpreter mode, which the port has no counterpart of) leaves it on
    if n_rows < FD_MIN_ROWS or os.environ.get("ARES_FUSED") == "0":
        return None
    spec = plan_fused(plan, dense_plan)
    if spec is None:
        return None
    return FusedDenseKernel(plan, n_rows, dense_plan, spec, device)
