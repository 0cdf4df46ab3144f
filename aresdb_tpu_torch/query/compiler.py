"""AQL compiler: schema resolution, type inference, rewrites, plan building.

Reference: query/aql_compiler.go (Compile: readSchema → parseExprs →
processJoinConditions → processTimezone → resolveTypes → processFilters →
processTimeFilter → processMeasure → processDimensions) and
query/time_bucketizer.go (buildTimeDimensionExpr).

The output `CompiledQuery` is a backend-agnostic logical plan; the TPU kernel
emitter (kernels.py) traces its ASTs directly into one fused XLA computation
per (plan, batch-shape) pair — there is no per-AST-node kernel dispatch as in
the reference's OOPK machinery, because XLA fusion supersedes it.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.schema import TableSchema
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import time_util as TU
from aresdb_tpu_torch.query.aql import AQLQuery, Dimension

NON_AGGREGATION_QUERY_LIMIT = 1000


class QueryError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Plan dataclasses
# ---------------------------------------------------------------------------

@dataclass
class ForeignTablePlan:
    """One equi-joined dimension table.

    Reference: query/aql_compiler.go matchEquiJoin — conditions must be a
    single `main_expr = foreign.primary_key_column` equality.
    """

    alias: str
    schema: TableSchema
    main_key_expr: E.Expr          # typed expr over main table columns
    foreign_key_column: int        # pk column id in the foreign table
    table_id: int = 0              # position in the query's table list
    used_columns: List[int] = field(default_factory=list)


@dataclass
class GeoJoinPlan:
    """Geo-intersection join (reference: matchGeoJoin, aql_compiler.go:259).

    The joined dimension table provides GeoShape polygons; rows of the main
    table match by point-in-polygon. At most one geo dim (the geo table's
    primary key) may be selected; shape candidates come from an IN/=/NOT IN
    filter on that key.
    """

    alias: str
    schema: TableSchema
    shape_column: int
    pk_column: int
    pk_data_type: int
    point_expr: E.Expr
    candidates: Optional[List] = None     # pk values selecting shapes
    exclude: bool = False                 # NOT IN semantics
    has_filter: bool = False
    # populated at staging time (executor) for result formatting
    shape_values: List = field(default_factory=list)


@dataclass
class DimensionPlan:
    expr: E.Expr                   # typed AST (bucketizers already applied)
    raw: Dimension = None          # original query dimension (for formatting)
    data_type: int = 0             # memstore data type for output formatting
    enum_reverse_dict: Optional[List[str]] = None
    from_offset: int = 0
    to_offset: int = 0
    dst_switch_ts: int = 0
    geo_dim: bool = False          # value = matched shape index


@dataclass
class MeasurePlan:
    agg: str                       # 'sum'|'min'|'max'|'avg'|'count'|'hll'
    expr: Optional[E.Expr]         # argument AST (literal 1 for count)
    out_float: bool = True         # aggregate in float vs int lanes


@dataclass
class CompiledQuery:
    query: AQLQuery
    main_schema: TableSchema
    shards: List[int]
    filters: List[E.Expr]                      # ANDed row filters (typed)
    time_filter_expr: List[E.Expr]             # from/to exprs on time column
    from_ts: Optional[int] = None              # resolved [from, to) unix secs
    to_ts: Optional[int] = None
    time_column_id: int = -1                   # main-table time column (or -1)
    dimensions: List[DimensionPlan] = field(default_factory=list)
    measure: Optional[MeasurePlan] = None
    is_non_agg: bool = False
    limit: int = 0
    foreign_tables: List[ForeignTablePlan] = field(default_factory=list)
    table_id_to_foreign: Dict[int, int] = field(default_factory=dict)
    geo: Optional[GeoJoinPlan] = None
    used_columns: List[int] = field(default_factory=list)   # main table
    timezone: Optional[_dt.tzinfo] = None
    from_offset: int = 0
    to_offset: int = 0
    dst_switch_ts: int = 0
    now_ts: int = 0
    stats: Dict = field(default_factory=dict)  # per-stage timings (executor)
    uses_tz_table: bool = False
    # (column_id, op, value) matched against the archiving-sort-column
    # prefix, in sort order; the executor binary-searches sorted archive
    # batches to a candidate row range (reference: query/aql_compiler.go
    # matchPrefilters + memstore calculateBatchSizeAndStartRow)
    prefilters: List[tuple] = field(default_factory=list)


# ---------------------------------------------------------------------------
# type helpers
# ---------------------------------------------------------------------------

_UNSIGNED_DTS = (mdt.Uint8, mdt.Uint16, mdt.Uint32, mdt.SmallEnum, mdt.BigEnum)
_SIGNED_DTS = (mdt.Int8, mdt.Int16, mdt.Int32, mdt.Int64)


def _expr_type_for_dt(data_type: int) -> int:
    if data_type == mdt.Bool:
        return E.BOOLEAN
    if data_type in _UNSIGNED_DTS:
        return E.UNSIGNED
    if data_type in _SIGNED_DTS:
        return E.SIGNED
    if data_type == mdt.Float32:
        return E.FLOAT
    if data_type == mdt.GeoPoint:
        return E.GEOPOINT
    if data_type == mdt.GeoShape:
        return E.GEOSHAPE
    if mdt.is_array_type(data_type):
        return _expr_type_for_dt(mdt.item_type(data_type))
    return E.UNKNOWN_TYPE  # UUID handled specially (hex() only)


def _is_uuid_valued(node: E.Expr) -> bool:
    """VarRef of UUID type, or element_at() over a UUID[] column."""
    if isinstance(node, E.VarRef):
        return node.data_type == mdt.UUID
    return (isinstance(node, E.Call) and node.name == E.ELEMENT_AT
            and node.args and isinstance(node.args[0], E.VarRef)
            and mdt.is_array_type(node.args[0].data_type)
            and mdt.item_type(node.args[0].data_type) == mdt.UUID)


_CMP_OPS = {"=", "!=", "<>", "<", "<=", ">", ">="}
_BOOL_OPS = {"AND", "OR"}
_ARITH_OPS = {"+", "-", "*", "/", "%", "FLOOR"}
_BITWISE_OPS = {"&", "|", "^", "<<", ">>"}


TIMEZONE_TABLE_ALIAS = "__timezone_table"
_TZ_COLUMN_RE = None  # compiled lazily


class Compiler:
    """Compiles one AQLQuery against a set of runtime table schemas."""

    def __init__(self, schemas: Dict[str, TableSchema],
                 timezone_table: str = ""):
        self.schemas = schemas
        self.timezone_table = timezone_table

    # -- public --

    def compile(self, q: AQLQuery) -> CompiledQuery:
        if not q.table:
            raise QueryError("query missing table")
        main = self.schemas.get(q.table)
        if main is None:
            raise QueryError(f"unknown table {q.table!r}")
        if len(q.measures) != 1:
            # reference: query_plan expects one measure per query
            # (aql_compiler.go:802)
            raise QueryError("exactly 1 measure is required")

        cq = CompiledQuery(query=q, main_schema=main, shards=list(q.shards),
                           filters=[], time_filter_expr=[])
        # utils.Now() equivalent — the injectable clock, so frozen-clock
        # runs (reference integration_test.go SetCurrentTime) resolve
        # relative time filters against the frozen instant
        from aresdb_tpu_torch.utils import clock as _clock
        cq.now_ts = q.now or _clock.now_unix()

        # table alias map: index 0 = main table
        self._aliases: Dict[str, int] = {q.table: 0}
        self._tables: List[TableSchema] = [main]
        self._geo_table_id: Optional[int] = None
        self._process_joins(q, cq)

        # timezone: fixed ('America/New_York', '-8:00') or per-row lookup
        # ('timezone(city_id)' joining the configured timezone table —
        # reference processTimezone, aql_compiler.go:439)
        self._tz_offsets_expr: Optional[E.Expr] = None
        if q.timezone and "(" in q.timezone:
            self._process_timezone_column(q, cq)
            cq.timezone = _dt.timezone.utc
        else:
            cq.timezone = TU.parse_timezone(q.timezone) if q.timezone \
                else _dt.timezone.utc

        self._adjust_filter_to_time_filter(q, cq)
        self._process_time_filter(q, cq)
        self._process_filters(q, cq)
        self._process_measure(q, cq)
        self._process_dimensions(q, cq)
        self._collect_column_usage(cq)
        self._match_prefilters(main, cq)
        return cq

    # -- prefilters --

    @staticmethod
    def _match_prefilters(main: TableSchema, cq: CompiledQuery) -> None:
        """Match ANDed filters against the archiving-sort-column prefix.

        Reference: query/aql_compiler.go matchPrefilters — equality filters
        on a prefix of the sort columns, then at most one level of range
        filters (the resolved time range counts when the time column is the
        next sort column). Matched filters stay in the device filter list;
        the slice the executor computes is a conservative superset, so the
        fused mask keeps full correctness.
        """
        sort_cols = list(main.table.archiving_sort_columns)
        if not sort_cols:
            return
        _FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        cand: Dict[int, List[tuple]] = {}
        for f in cq.filters:
            # bool sort column used directly / negated counts as an
            # equality prefilter (reference matchPrefilters bool case)
            if isinstance(f, E.VarRef) and f.table_id == 0 and \
                    f.data_type == mdt.Bool and f.column_id >= 0:
                cand.setdefault(f.column_id, []).append(("=", 1))
                continue
            if isinstance(f, E.UnaryExpr) and f.op in ("NOT", "IS_FALSE") \
                    and isinstance(f.expr, E.VarRef) \
                    and f.expr.table_id == 0 \
                    and f.expr.data_type == mdt.Bool \
                    and f.expr.column_id >= 0:
                cand.setdefault(f.expr.column_id, []).append(("=", 0))
                continue
            if not isinstance(f, E.BinaryExpr) or \
                    f.op not in ("=", "<", "<=", ">", ">="):
                continue
            lhs, rhs, op = f.lhs, f.rhs, f.op
            if isinstance(lhs, (E.NumberLiteral, E.BooleanLiteral)) and \
                    isinstance(rhs, E.VarRef):
                lhs, rhs, op = rhs, lhs, _FLIP.get(op, op)
            if op == "=" and isinstance(lhs, E.VarRef) and \
                    isinstance(rhs, E.BooleanLiteral) and \
                    lhs.table_id == 0 and lhs.column_id >= 0:
                cand.setdefault(lhs.column_id, []).append(
                    ("=", int(bool(rhs.val))))
                continue
            if not (isinstance(lhs, E.VarRef) and
                    isinstance(rhs, E.NumberLiteral)):
                continue
            if lhs.table_id != 0 or lhs.column_id < 0:
                continue
            if mdt.is_array_type(lhs.data_type) or lhs.data_type in (
                    mdt.UUID, mdt.GeoPoint, mdt.GeoShape):
                continue
            val = rhs.val if rhs.type == E.FLOAT else rhs.int_val
            cand.setdefault(lhs.column_id, []).append((op, val))
        for cid in sort_cols:
            ops = cand.get(cid, [])
            eq = next((v for op, v in ops if op == "="), None)
            if eq is not None:
                cq.prefilters.append((cid, "=", eq))
                continue
            if cid == cq.time_column_id and (cq.from_ts or cq.to_ts):
                if cq.from_ts:
                    cq.prefilters.append((cid, ">=", cq.from_ts))
                if cq.to_ts:
                    cq.prefilters.append((cid, "<", cq.to_ts))
            else:
                for op, v in ops:
                    if op != "=":
                        cq.prefilters.append((cid, op, v))
            break

    # -- joins --

    MAX_JOINS = 8  # reference: aql_compiler.go:170

    def _process_joins(self, q: AQLQuery, cq: CompiledQuery) -> None:
        if len(q.joins) > self.MAX_JOINS:
            raise QueryError(
                f"at most {self.MAX_JOINS} foreign tables allowed, "
                f"got {len(q.joins)}")
        for j in q.joins:
            schema = self.schemas.get(j.table)
            if schema is None:
                raise QueryError(f"unknown join table {j.table!r}")
            alias = j.alias or j.table
            if alias in self._aliases:
                raise QueryError(f"duplicate table alias {alias!r}")
            if schema.table.is_fact_table:
                raise QueryError("only dimension tables can be joined")
            if len(j.conditions) != 1:
                raise QueryError(
                    "exactly 1 equi-join condition supported per join")
            cond = E.parse(j.conditions[0])
            if isinstance(cond, E.Call) and cond.name == E.GEOGRAPHY_INTERSECTS:
                self._process_geo_join(j, alias, schema, cond, cq)
                continue
            if not (isinstance(cond, E.BinaryExpr) and cond.op == "="):
                raise QueryError(f"join condition must be equality: {j.conditions[0]}")
            table_id = len(self._tables)
            self._aliases[alias] = table_id
            self._tables.append(schema)

            # one side must be foreign.pk, other side main-table expr
            pk_cols = schema.table.primary_key_columns
            if len(pk_cols) != 1:
                raise QueryError(
                    f"join table {j.table!r} must have a single-column primary key")

            def is_foreign_pk(e: E.Expr) -> bool:
                return (isinstance(e, E.VarRef) and "." in e.val
                        and e.val.split(".", 1)[0] == alias
                        and schema.column_ids.get(e.val.split(".", 1)[1]) == pk_cols[0])

            if is_foreign_pk(cond.lhs):
                main_side = cond.rhs
            elif is_foreign_pk(cond.rhs):
                main_side = cond.lhs
            else:
                raise QueryError(
                    f"join condition must reference {alias}'s primary key")
            main_side = self._resolve(main_side, allow_tables={0})
            cq.foreign_tables.append(ForeignTablePlan(
                alias=alias, schema=schema, main_key_expr=main_side,
                foreign_key_column=pk_cols[0], table_id=table_id))

    def _process_geo_join(self, j, alias: str, schema: TableSchema,
                          cond: E.Call, cq: CompiledQuery) -> None:
        """geography_intersects(geo.shape, main.point) join."""
        if cq.geo is not None:
            raise QueryError("only one geo join supported per query")
        if len(cond.args) != 2:
            raise QueryError(
                "geography_intersects requires 2 arguments (shape, point)")
        pk_cols = schema.table.primary_key_columns
        if len(pk_cols) != 1:
            raise QueryError(
                f"geo table {j.table!r} must have a single-column primary key")

        shape_col = None
        point_side = None
        for arg in cond.args:
            if isinstance(arg, E.VarRef) and "." in arg.val and \
                    arg.val.split(".", 1)[0] == alias:
                col = arg.val.split(".", 1)[1]
                cid = schema.column_ids.get(col)
                if cid is not None and \
                        schema.table.columns[cid].data_type == mdt.GeoShape:
                    shape_col = cid
                    continue
            point_side = arg
        if shape_col is None or point_side is None:
            raise QueryError(
                "geography_intersects requires the geo table's GeoShape "
                "column and a main-table GeoPoint")
        point_expr = self._resolve(point_side, allow_tables={0})
        if not (isinstance(point_expr, E.VarRef)
                and point_expr.data_type == mdt.GeoPoint):
            raise QueryError(
                "only geo point columns are allowed in geography_intersects")
        # register the alias so dims/filters can reference the geo pk
        table_id = len(self._tables)
        self._aliases[alias] = table_id
        self._tables.append(schema)
        self._geo_table_id = table_id
        cq.geo = GeoJoinPlan(
            alias=alias, schema=schema, shape_column=shape_col,
            pk_column=pk_cols[0],
            pk_data_type=schema.table.columns[pk_cols[0]].data_type,
            point_expr=point_expr)

    def _process_timezone_column(self, q: AQLQuery, cq: CompiledQuery) -> None:
        """'timezone(join_key)' → join the timezone table; time dims shift by
        the per-row offset of the joined row's timezone enum."""
        import re as _re

        m = _re.match(r"^\s*([a-z_]+)\s*\(\s*([A-Za-z0-9_.]+)\s*\)\s*$",
                      q.timezone)
        if not m:
            raise QueryError(f"cannot parse timezone {q.timezone!r}")
        tz_column, join_key = m.group(1), m.group(2)
        if not self.timezone_table:
            raise QueryError(
                "timezone column lookup requires query.timezone_table "
                "configuration")
        schema = self.schemas.get(self.timezone_table)
        if schema is None:
            raise QueryError(
                f"unknown timezone table {self.timezone_table!r}")
        if tz_column not in schema.column_ids:
            raise QueryError(
                f"unknown timezone column {tz_column!r} in "
                f"{self.timezone_table!r}")
        # reuse an existing join of the table, else append one
        alias = None
        for j in q.joins:
            if j.table == self.timezone_table:
                alias = j.alias or j.table
        if alias is None:
            from aresdb_tpu_torch.query.aql import Join as _Join

            alias = TIMEZONE_TABLE_ALIAS
            q.joins.append(_Join(
                table=self.timezone_table, alias=alias,
                conditions=[f"{join_key}={alias}.id"]))
            # join was added after _process_joins ran: process it now
            self._process_joins_single(q.joins[-1], cq)
        # offsets per enum rank, resolved now (reference prepareTimezoneTable
        # uses time.Now() offsets, aql_processor.go:487)
        import numpy as _np

        cases = schema.enum_reverse_dict(tz_column)
        offsets = _np.zeros(max(len(cases), 1), _np.int32)
        for i, name in enumerate(cases):
            try:
                tz = TU.parse_timezone(name)
                offsets[i] = TU.tz_offset_at(tz, cq.now_ts)
            except TU.TimeError:
                offsets[i] = 0
        ref = self._resolve(E.parse(f"{alias}.{tz_column}"))
        call = E.Call(name="__tz_offset", args=[ref], type=E.SIGNED)
        call.tz_offsets = offsets  # type: ignore[attr-defined]
        self._tz_offsets_expr = call
        cq.uses_tz_table = True

    def _process_joins_single(self, j, cq: CompiledQuery) -> None:
        """Process one late-added join (timezone table)."""
        schema = self.schemas[j.table]
        alias = j.alias or j.table
        cond = E.parse(j.conditions[0])
        pk_cols = schema.table.primary_key_columns
        table_id = len(self._tables)
        self._aliases[alias] = table_id
        self._tables.append(schema)

        def is_foreign_pk(e):
            return (isinstance(e, E.VarRef) and "." in e.val
                    and e.val.split(".", 1)[0] == alias
                    and schema.column_ids.get(e.val.split(".", 1)[1]) == pk_cols[0])

        main_side = cond.rhs if is_foreign_pk(cond.lhs) else cond.lhs
        main_side = self._resolve(main_side, allow_tables={0})
        cq.foreign_tables.append(ForeignTablePlan(
            alias=alias, schema=schema, main_key_expr=main_side,
            foreign_key_column=pk_cols[0], table_id=table_id))

    # -- name resolution + typing + rewrites --

    def _resolve(self, e: E.Expr, allow_tables=None) -> E.Expr:
        """Resolve VarRefs, infer types, apply enum/constant rewrites."""

        def resolve_var(node: E.Expr) -> E.Expr:
            if not isinstance(node, E.VarRef) or node.val == "*":
                return node
            name = node.val
            if "." in name:
                t_alias, col = name.split(".", 1)
                if t_alias not in self._aliases:
                    raise QueryError(f"unknown table alias {t_alias!r} in {name!r}")
                table_id = self._aliases[t_alias]
            else:
                table_id, col = 0, name
            if allow_tables is not None and table_id not in allow_tables:
                raise QueryError(f"column {name!r} not allowed in this context")
            schema = self._tables[table_id]
            cid = schema.column_ids.get(col)
            if cid is None:
                raise QueryError(
                    f"unknown column {col!r} in table {schema.table.name!r}")
            column = schema.table.columns[cid]
            node.table_id = table_id
            node.column_id = cid
            node.data_type = column.data_type
            node.type = _expr_type_for_dt(column.data_type)
            if column.is_enum_column():
                ed = schema.enum_dicts.get(column.name)
                if ed is not None:
                    node.enum_dict = ed.str_to_rank
                    node.enum_reverse_dict = ed.rank_to_str
                    node.enum_ci = ed.case_insensitive
            return node

        e = E.transform(e, resolve_var)
        return E.transform(e, self._type_and_rewrite)

    def _type_and_rewrite(self, node: E.Expr) -> E.Expr:
        """Post-order type inference + rewrites (reference Rewrite :551)."""
        if isinstance(node, E.ParenExpr):
            node.type = node.expr.type
            return node

        if isinstance(node, E.UnaryExpr):
            c = node.expr
            if node.op == "-":
                if isinstance(c, E.NumberLiteral):
                    c.val = -c.val
                    c.int_val = -c.int_val
                    c.expr = f"-{c.expr}"
                    c.type = E.FLOAT if c.type == E.FLOAT else E.SIGNED
                    return c
                node.type = E.FLOAT if c.type == E.FLOAT else E.SIGNED
            elif node.op == "~":
                # BITWISE_NOT casts its operand to unsigned and yields
                # unsigned (reference Rewrite, aql_compiler_test.go:344;
                # the emitter reinterprets lanes as int32 either way)
                node.type = E.UNSIGNED
            elif node.op in ("NOT", "IS_NULL", "IS_NOT_NULL", "IS_TRUE", "IS_FALSE"):
                node.type = E.BOOLEAN
            elif node.op in ("GET_WEEK_START", "GET_MONTH_START",
                             "GET_QUARTER_START", "GET_YEAR_START",
                             "GET_DAY_OF_MONTH", "GET_DAY_OF_YEAR",
                             "GET_MONTH_OF_YEAR", "GET_QUARTER_OF_YEAR"):
                node.type = E.UNSIGNED
            return node

        if isinstance(node, E.BinaryExpr):
            return self._type_binary(node)

        if isinstance(node, E.Call):
            return self._type_call(node)

        if isinstance(node, E.Case):
            t = E.UNKNOWN_TYPE
            for _, v in node.when_thens:
                t = max(t, v.type)
            if node.else_expr is not None:
                t = max(t, node.else_expr.type)
            node.type = t
            return node

        return node

    def _type_binary(self, node: E.BinaryExpr) -> E.Expr:
        lhs, rhs, op = node.lhs, node.rhs, node.op

        # enum translation: enum column vs string literal(s)
        if op in ("=", "!=", "<>", "IN", "NOT IN"):
            for a, b in ((lhs, rhs), (rhs, lhs)):
                if isinstance(a, E.VarRef) and a.enum_dict is not None:
                    if isinstance(b, E.StringLiteral):
                        self._translate_enum_literal(a, b)
                    elif isinstance(b, E.Call) and b.name == "":
                        for arg in b.args:
                            if isinstance(arg, E.StringLiteral):
                                self._translate_enum_literal(a, arg)
                # UUID literal: 'xxxx-...' against a UUID column (or an
                # element_at over a UUID[] column) becomes a two-lane
                # comparison handled by the kernel emitter
                if _is_uuid_valued(a) and isinstance(b, E.StringLiteral):
                    hi, lo = mdt.parse_uuid(b.val)
                    b.uuid_lanes = (hi, lo)  # type: ignore[attr-defined]

        # geopoint literal: 'point(lat,lng)' compared against geo column
        # handled at kernel level

        if op in ("IN", "NOT IN"):
            # reference expandINOp (query_context_helper.go): an empty IN
            # list fails type resolution instead of silently never matching
            if isinstance(rhs, E.Call) and not rhs.args:
                raise QueryError("empty IN list")
            node.type = E.BOOLEAN
        elif op in _CMP_OPS:
            node.type = E.BOOLEAN
        elif op in _BOOL_OPS:
            node.type = E.BOOLEAN
        elif op == "/":
            node.type = E.FLOAT
        elif op in _ARITH_OPS:
            if lhs.type == E.FLOAT or rhs.type == E.FLOAT:
                node.type = E.FLOAT
            elif lhs.type == E.SIGNED or rhs.type == E.SIGNED or op == "-":
                node.type = E.SIGNED
            else:
                node.type = E.UNSIGNED
        elif op in _BITWISE_OPS:
            node.type = E.UNSIGNED
        else:
            raise QueryError(f"unsupported binary operator {op!r}")

        # constant folding of pure-literal arithmetic
        if (isinstance(lhs, E.NumberLiteral) and isinstance(rhs, E.NumberLiteral)
                and op in _ARITH_OPS):
            return self._fold(node, lhs, rhs, op)
        return node

    @staticmethod
    def _translate_enum_literal(var: E.VarRef, lit: E.StringLiteral) -> None:
        key = lit.val.lower() if var.enum_ci else lit.val
        rank = var.enum_dict.get(key)
        # unknown enum values get an out-of-range rank so equality never
        # matches (reference Rewrite translates unknown enums similarly)
        lit.type = E.UNSIGNED
        lit.val = str(rank) if rank is not None else ""
        lit.__class__ = E.NumberLiteral  # in-place morph keeps parent links
        lit.int_val = rank if rank is not None else (1 << 31) - 1
        lit.expr = lit.val if rank is not None else "<unknown-enum>"
        # NumberLiteral dataclass field: .val should be numeric
        lit.val = float(lit.int_val)

    @staticmethod
    def _fold(node, lhs, rhs, op) -> E.NumberLiteral:
        if node.type == E.FLOAT:
            a, b = lhs.val, rhs.val
            if op == "+":
                v = a + b
            elif op == "-":
                v = a - b
            elif op == "*":
                v = a * b
            elif op == "/":
                v = a / b if b else 0.0
            elif op == "%":
                v = a % b if b else 0.0
            else:
                v = (a // b) * b if b else 0.0
            return E.NumberLiteral(val=v, int_val=int(v), expr=str(v), type=E.FLOAT)
        a, b = lhs.int_val, rhs.int_val
        if op == "+":
            v = a + b
        elif op == "-":
            v = a - b
        elif op == "*":
            v = a * b
        elif op == "%":
            v = a % b if b else 0
        else:  # FLOOR
            v = (a // b) * b if b else 0
        return E.NumberLiteral(val=float(v), int_val=v, expr=str(v), type=node.type)

    def _type_call(self, node: E.Call) -> E.Expr:
        name = node.name
        if name == "":
            node.type = E.UNKNOWN_TYPE  # IN-list container
            return node
        if name in E.AGGREGATE_CALLS:
            node.type = E.FLOAT if name in (E.SUM, E.AVG) else E.UNSIGNED
            return node
        if name == E.HEX:
            node.type = E.UNKNOWN_TYPE
            return node
        if name == E.FROM_UNIXTIME:
            # reference query_context_helper.go: from_unixtime only accepts
            # `time_col / 1000` (millisecond columns) and unwraps to the
            # column itself — storage is already in seconds
            arg = node.args[0] if node.args else None
            if (isinstance(arg, E.BinaryExpr) and arg.op == "/"
                    and isinstance(arg.rhs, E.NumberLiteral)
                    and arg.rhs.int_val == 1000
                    and isinstance(arg.lhs, E.VarRef)):
                return arg.lhs
            raise QueryError("from_unixtime must be time column / 1000")
        if name in (E.HOUR, E.DAY_OF_WEEK):
            node.type = E.UNSIGNED
            return node
        if name == E.CONVERT_TZ:
            # rewrite to col + (offset(toTz) - offset(fromTz)) at `now`
            # (reference query_context_helper.go:348-387)
            if len(node.args) != 3:
                raise QueryError("convert_tz must have 3 arguments")
            for i, label in ((1, "2nd"), (2, "3rd")):
                if not isinstance(node.args[i], E.StringLiteral):
                    raise QueryError(
                        f"{label} argument of convert_tz must be a string")
            import datetime as _dtm
            from zoneinfo import ZoneInfo

            from aresdb_tpu_torch.utils import clock as _clock
            try:
                from_tz = ZoneInfo(node.args[1].val)
                to_tz = ZoneInfo(node.args[2].val)
            except Exception as exc:
                raise QueryError(
                    f"failed to rewrite convert_tz: {exc}") from exc
            now = _dtm.datetime.fromtimestamp(_clock.now_unix(),
                                              _dtm.timezone.utc)
            offset = int(now.astimezone(to_tz).utcoffset().total_seconds()
                         - now.astimezone(from_tz).utcoffset().total_seconds())
            return E.BinaryExpr(
                op="+", lhs=node.args[0],
                rhs=E.NumberLiteral(val=float(offset), int_val=offset,
                                    expr=str(offset),
                                    type=E.SIGNED if offset < 0
                                    else E.UNSIGNED),
                type=E.UNSIGNED)
        if name == E.LENGTH:
            node.type = E.UNSIGNED
            return node
        if name == E.CONTAINS:
            node.type = E.BOOLEAN
            # contains(uuid_array, 'literal'): pre-parse the needle into
            # two uint64 lanes for the kernel emitter
            if len(node.args) == 2 and isinstance(node.args[0], E.VarRef) \
                    and mdt.is_array_type(node.args[0].data_type) \
                    and mdt.item_type(node.args[0].data_type) == mdt.UUID \
                    and isinstance(node.args[1], E.StringLiteral):
                hi, lo = mdt.parse_uuid(node.args[1].val)
                node.args[1].uuid_lanes = (hi, lo)  # type: ignore[attr-defined]
            return node
        if name == E.ELEMENT_AT:
            if node.args and isinstance(node.args[0], E.VarRef):
                node.type = _expr_type_for_dt(
                    mdt.item_type(node.args[0].data_type))
            return node
        if name == E.GEOGRAPHY_INTERSECTS:
            node.type = E.BOOLEAN
            return node
        raise QueryError(f"unknown function {name!r}")

    # -- time filter --

    def _adjust_filter_to_time_filter(self, q: AQLQuery,
                                      cq: CompiledQuery) -> None:
        """Lift `time_col >= X` / `time_col < X` row filters into the time
        filter when a fact-table query has none (reference
        adjustFilterToTimeFilter, query/aql_compiler.go:104) — this both
        enables batch-range pruning and routes the literals through
        ParseTimeFilter's raw-timestamp handling (ms epochs divide to
        seconds). Duplicate bounds on the event time column are errors.
        """
        if not q.time_filter.empty or not cq.main_schema.table.is_fact_table:
            return
        time_name = cq.main_schema.table.columns[0].name
        names = {time_name, f"{q.table}.{time_name}"}
        from_v = to_v = None
        removed = []
        for i, f in enumerate(q.filters):
            try:
                ast = E.parse(f)
            except E.ExprParseError:
                continue
            if not (isinstance(ast, E.BinaryExpr)
                    and isinstance(ast.lhs, E.VarRef)
                    and ast.lhs.val in names):
                continue
            if isinstance(ast.rhs, E.NumberLiteral):
                val = (str(ast.rhs.int_val) if ast.rhs.int_val is not None
                       else str(ast.rhs.val))
            elif isinstance(ast.rhs, E.StringLiteral):
                val = ast.rhs.val
            else:
                continue
            if ast.op == "<":
                if to_v is not None:
                    raise QueryError(
                        "Only one '<' filter allowed for event time column")
                to_v = val
                removed.append(i)
            elif ast.op == ">=":
                if from_v is not None:
                    raise QueryError(
                        "Only one '>=' filter allowed for event time column")
                from_v = val
                removed.append(i)
        if from_v is None and to_v is None:
            return
        q.time_filter.column = time_name
        q.time_filter.from_ = from_v or ""
        q.time_filter.to = to_v or ""
        for i in reversed(removed):
            del q.filters[i]

    def _process_time_filter(self, q: AQLQuery, cq: CompiledQuery) -> None:
        tf = q.time_filter
        main = cq.main_schema
        # resolve the time column
        if tf.column:
            col_expr = E.parse(tf.column)
        elif main.table.is_fact_table:
            col_expr = E.VarRef(val=main.table.columns[0].name)
        else:
            col_expr = None
        if tf.empty:
            if main.table.is_fact_table and col_expr is not None:
                cq.time_column_id = 0
            return
        if col_expr is None:
            raise QueryError("time filter requires a time column")
        if not tf.from_:
            # reference: aql_compiler.go:1009
            raise QueryError("'from' of time filter is missing")
        col_expr = self._resolve(col_expr)
        if not (isinstance(col_expr, E.VarRef) and col_expr.table_id == 0):
            # reference: aql_compiler.go:1002
            raise QueryError(
                f"timeFilter only supports the main table "
                f"{cq.main_schema.table.name!r}, got {tf.column!r}")
        cq.time_column_id = col_expr.column_id

        from_t, to_t = TU.parse_time_filter(tf.from_, tf.to, cq.timezone, cq.now_ts)
        if from_t is not None:
            cq.from_ts = from_t.ts
            cq.time_filter_expr.append(E.BinaryExpr(
                op=">=", lhs=col_expr,
                rhs=E.NumberLiteral(val=float(from_t.ts), int_val=from_t.ts,
                                    expr=str(from_t.ts), type=E.UNSIGNED),
                type=E.BOOLEAN))
        if to_t is not None:
            cq.to_ts = to_t.ts
            cq.time_filter_expr.append(E.BinaryExpr(
                op="<", lhs=col_expr,
                rhs=E.NumberLiteral(val=float(to_t.ts), int_val=to_t.ts,
                                    expr=str(to_t.ts), type=E.UNSIGNED),
                type=E.BOOLEAN))
        # timezone offsets over the query window (for bucketizers/formatting)
        if cq.from_ts is not None and cq.to_ts is not None:
            cq.from_offset, cq.to_offset, cq.dst_switch_ts = TU.dst_switch_ts(
                cq.timezone, cq.from_ts, cq.to_ts)
        elif cq.timezone is not None:
            off = TU.tz_offset_at(cq.timezone, cq.now_ts)
            cq.from_offset = cq.to_offset = off

    # -- filters --

    def _process_filters(self, q: AQLQuery, cq: CompiledQuery) -> None:
        all_filters = list(q.filters) + list(q.measures[0].filters)
        geo_filters = 0
        for f in all_filters:
            ast = E.parse(f)
            if cq.geo is not None and self._try_geo_filter(ast, cq):
                geo_filters += 1
                if geo_filters > 1:
                    raise QueryError("only one geo filter allowed")
                continue
            ast = self._resolve(ast)
            if ast.type != E.BOOLEAN and not (
                    isinstance(ast, E.VarRef) and ast.data_type == mdt.Bool):
                raise QueryError(f"filter must be boolean: {f!r}")
            cq.filters.append(ast)
        if cq.geo is not None and geo_filters == 0:
            # reference: aql_compiler.go:845 "Exact one geo filter is
            # needed if geo intersection is used during join"
            raise QueryError(
                "exactly one geo filter is needed if geo intersection "
                "is used during join")

    def _try_geo_filter(self, ast: E.Expr, cq: CompiledQuery) -> bool:
        """Classify `geo.pk IN (...)` / `=` / `NOT IN` shape filters.

        Reference: processFilters geo handling (aql_compiler.go:799) — the
        shape filter selects candidate shapes by the geo table's primary key.
        """
        geo = cq.geo
        pk_name = f"{geo.alias}." + geo.schema.table.columns[geo.pk_column].name

        def is_geo_pk(e: E.Expr) -> bool:
            return isinstance(e, E.VarRef) and e.val == pk_name

        if not isinstance(ast, E.BinaryExpr):
            return False
        if ast.op in ("IN", "NOT IN") and is_geo_pk(ast.lhs) and \
                isinstance(ast.rhs, E.Call):
            values = []
            for a in ast.rhs.args:
                if isinstance(a, E.StringLiteral):
                    values.append(mdt.parse_value(a.val, geo.pk_data_type))
                elif isinstance(a, E.NumberLiteral):
                    values.append(a.int_val)
                else:
                    raise QueryError("geo shape filter values must be literals")
            if geo.has_filter:
                raise QueryError("only one geo filter allowed per query")
            geo.candidates = values
            geo.exclude = ast.op == "NOT IN"
            geo.has_filter = True
            return True
        if ast.op == "=" and (is_geo_pk(ast.lhs) or is_geo_pk(ast.rhs)):
            lit = ast.rhs if is_geo_pk(ast.lhs) else ast.lhs
            if isinstance(lit, E.StringLiteral):
                v = mdt.parse_value(lit.val, geo.pk_data_type)
            elif isinstance(lit, E.NumberLiteral):
                v = lit.int_val
            else:
                raise QueryError("geo shape filter values must be literals")
            if geo.has_filter:
                raise QueryError("only one geo filter allowed per query")
            geo.candidates = [v]
            geo.exclude = False
            geo.has_filter = True
            return True
        return False

    # -- measure --

    def _process_measure(self, q: AQLQuery, cq: CompiledQuery) -> None:
        m = q.measures[0]
        ast = E.parse(m.expr)
        if isinstance(ast, E.NumberLiteral):
            cq.is_non_agg = True
            cq.limit = q.limit or NON_AGGREGATION_QUERY_LIMIT
            if not q.dimensions:
                # SELECT *: all non-geoshape, non-array columns
                from aresdb_tpu_torch.query.aql import Dimension as _Dim

                for col in cq.main_schema.table.columns:
                    dt_ = col.data_type
                    if col.deleted or dt_ == mdt.GeoShape or \
                            mdt.is_array_type(dt_):
                        continue
                    q.dimensions.append(_Dim(expr=col.name))
            return
        if not isinstance(ast, E.Call) or ast.name not in E.AGGREGATE_CALLS:
            raise QueryError(f"expect aggregate function, got {m.expr!r}")
        name = ast.name
        if name == E.COUNT_DISTINCT_HLL:
            name = E.HLL
        if len(ast.args) != 1:
            raise QueryError(
                f"expect 1 parameter for aggregate {name}, got {len(ast.args)}")
        if name == E.COUNT:
            arg = E.NumberLiteral(val=1.0, int_val=1, expr="1", type=E.UNSIGNED)
            cq.measure = MeasurePlan(agg="count", expr=arg, out_float=False)
            return
        arg = self._resolve(ast.args[0])
        if name == E.SUM:
            cq.measure = MeasurePlan(agg="sum", expr=arg,
                                     out_float=arg.type == E.FLOAT)
        elif name == E.AVG:
            cq.measure = MeasurePlan(agg="avg", expr=arg, out_float=True)
        elif name == E.MIN:
            cq.measure = MeasurePlan(agg="min", expr=arg,
                                     out_float=arg.type == E.FLOAT)
        elif name == E.MAX:
            cq.measure = MeasurePlan(agg="max", expr=arg,
                                     out_float=arg.type == E.FLOAT)
        elif name == E.HLL:
            cq.measure = MeasurePlan(agg="hll", expr=arg, out_float=False)
        else:
            raise QueryError(f"unsupported aggregate function: {name}")

    # -- dimensions --

    def _process_dimensions(self, q: AQLQuery, cq: CompiledQuery) -> None:
        # expand a wildcard dimension to every usable main-table column
        # (reference aql_compiler.go:412 Wildcard -> getAllColumnsDimension
        # :1252 — skips deleted / GeoShape / array columns)
        expanded = []
        for d in q.dimensions:
            if d.expr.strip() == "*":
                from aresdb_tpu_torch.query.aql import Dimension as _Dim

                for col in cq.main_schema.table.columns:
                    if col.deleted or col.data_type == mdt.GeoShape or \
                            mdt.is_array_type(col.data_type):
                        continue
                    expanded.append(_Dim(expr=col.name))
            else:
                expanded.append(d)
        q.dimensions = expanded
        for d in q.dimensions:
            plan = self._compile_dimension(d, cq)
            # aggregates have no meaning as group-by keys (the reference's
            # dimension type resolution rejects them at parse)
            bad = []

            def _check(node):
                if isinstance(node, E.Call) and                         node.name in E.AGGREGATE_CALLS:
                    bad.append(node.name)

            E.walk(plan.expr, _check)
            if bad:
                raise QueryError(
                    f"aggregate function {bad[0]!r} not allowed in a "
                    f"dimension: {d.expr!r}")
            cq.dimensions.append(plan)

    def _compile_dimension(self, d: Dimension, cq: CompiledQuery) -> DimensionPlan:
        main = cq.main_schema
        # geo dimension: the geo table's primary key (or hex() of it)
        if cq.geo is not None and d.expr:
            geo = cq.geo
            pk_name = (f"{geo.alias}."
                       + geo.schema.table.columns[geo.pk_column].name)
            expr_s = d.expr.strip()
            if expr_s == pk_name or \
                    expr_s.lower().replace(" ", "") == f"hex({pk_name})".lower():
                return DimensionPlan(
                    expr=E.VarRef(val=pk_name, type=E.UNSIGNED,
                                  table_id=self._geo_table_id,
                                  column_id=geo.pk_column,
                                  data_type=mdt.SmallEnum),
                    raw=d, data_type=geo.pk_data_type, geo_dim=True)
        if d.is_time_dimension:
            # expr defaults to the designated time column
            raw_expr = d.expr or (
                main.table.columns[0].name if main.table.is_fact_table else None)
            if raw_expr is None:
                raise QueryError("time dimension requires an expression")
            col = self._resolve(E.parse(raw_expr))
            ast = self._build_time_dimension_expr(d.time_bucketizer, col, cq)
            return DimensionPlan(
                expr=ast, raw=d, data_type=mdt.Uint32,
                from_offset=cq.from_offset, to_offset=cq.to_offset,
                dst_switch_ts=cq.dst_switch_ts)

        ast = self._resolve(E.parse(d.expr))
        if not d.numeric_bucketizer.empty:
            ast = E.Call(name="__numeric_bucket", args=[ast], type=E.FLOAT)
            ast.bucketizer = d.numeric_bucketizer  # type: ignore[attr-defined]

        data_type = mdt.Uint32
        rev = None
        if isinstance(ast, E.VarRef):
            data_type = ast.data_type
            rev = ast.enum_reverse_dict
        elif isinstance(ast, E.Call) and ast.name == E.HEX and ast.args \
                and isinstance(ast.args[0], E.VarRef) \
                and ast.args[0].data_type == mdt.UUID:
            data_type = mdt.UUID
        elif _is_uuid_valued(ast):
            # element_at over a UUID[] column renders as a dashed UUID
            # (reference dimval formatting of UUID dims)
            data_type = mdt.UUID
        elif ast.type == E.FLOAT:
            data_type = mdt.Float32
        elif ast.type == E.SIGNED:
            data_type = mdt.Int32
        elif ast.type == E.BOOLEAN:
            data_type = mdt.Bool
        return DimensionPlan(expr=ast, raw=d, data_type=data_type,
                             enum_reverse_dict=rev)

    def _build_time_dimension_expr(self, tb: str, col: E.Expr,
                                   cq: CompiledQuery) -> E.Expr:
        """Reference: buildTimeDimensionExpr (query/time_bucketizer.go:72)."""
        shifted = col
        if self._tz_offsets_expr is not None:
            shifted = E.BinaryExpr(op="+", lhs=col,
                                   rhs=self._tz_offsets_expr, type=E.SIGNED)
        elif cq.from_offset or cq.to_offset:
            if cq.from_offset != cq.to_offset and cq.dst_switch_ts:
                # col + from_offset + (col >= switch_ts) * (to-from... note the
                # reference uses offsetDiff = fromOffset - toOffset and the
                # kernel adds fromOffset then subtracts... replicate exactly:
                # timeCol + fromOffset + (timeCol >= switchTs) * offsetDiff
                diff = cq.from_offset - cq.to_offset
                shifted = E.BinaryExpr(
                    op="+", lhs=col, type=E.SIGNED,
                    rhs=E.BinaryExpr(
                        op="+", type=E.SIGNED,
                        lhs=E.NumberLiteral(val=float(cq.from_offset),
                                            int_val=cq.from_offset,
                                            expr=str(cq.from_offset),
                                            type=E.SIGNED),
                        rhs=E.BinaryExpr(
                            op="*", type=E.SIGNED,
                            lhs=E.NumberLiteral(val=float(diff), int_val=diff,
                                                expr=str(diff), type=E.SIGNED),
                            rhs=E.BinaryExpr(
                                op=">=", lhs=col, type=E.BOOLEAN,
                                rhs=E.NumberLiteral(
                                    val=float(cq.dst_switch_ts),
                                    int_val=cq.dst_switch_ts,
                                    expr=str(cq.dst_switch_ts),
                                    type=E.UNSIGNED)))))
            else:
                off = cq.from_offset
                shifted = E.BinaryExpr(
                    op="+", lhs=col, type=E.SIGNED,
                    rhs=E.NumberLiteral(val=float(off), int_val=off,
                                        expr=str(off), type=E.SIGNED))

        def lit(v: int, t=E.UNSIGNED) -> E.NumberLiteral:
            return E.NumberLiteral(val=float(v), int_val=v, expr=str(v), type=t)

        # recurring "x of y" bucketizers
        minutes = TU.parse_minutes_of_day(tb) if tb.endswith("minutes of day") else None
        rec = TU.RECURRING_BUCKETIZERS.get(tb)
        if minutes is not None:
            rec = (minutes, TU.SECONDS_PER_DAY)
        if rec is not None:
            base, bucket = rec
            adjusted = shifted
            if bucket == TU.SECONDS_PER_WEEK:
                adjusted = E.BinaryExpr(op="-", lhs=shifted,
                                        rhs=lit(TU.SECONDS_PER_4DAY),
                                        type=E.SIGNED)
            if base > 1:
                e = E.BinaryExpr(
                    op="FLOOR", type=E.UNSIGNED,
                    lhs=E.BinaryExpr(op="%", lhs=adjusted, rhs=lit(bucket),
                                     type=E.UNSIGNED),
                    rhs=lit(base))
            else:
                e = E.BinaryExpr(op="%", lhs=shifted, rhs=lit(bucket),
                                 type=E.UNSIGNED)
            if base >= TU.SECONDS_PER_DAY:
                e = E.BinaryExpr(op="/", lhs=e, rhs=lit(base, E.FLOAT),
                                 type=E.FLOAT)
            return e

        if tb in TU.RECURRING_CALENDAR_BUCKETIZERS:
            op = "GET_" + tb.upper().replace(" ", "_")
            return E.UnaryExpr(op=op, expr=shifted, type=E.UNSIGNED)

        if tb in TU.IRREGULAR_BUCKETIZERS:
            op = f"GET_{tb.upper()}_START"
            return E.UnaryExpr(op=op, expr=shifted, type=E.UNSIGNED)

        if not tb:
            # timeUnit-only dimension: raw (tz-shifted) seconds; the unit
            # division happens at formatting time (dimval.go formatTimeDimension)
            return shifted

        size, unit = TU.parse_regular_time_bucketizer(tb)
        width = TU.bucketizer_seconds(size, unit)
        return E.BinaryExpr(op="FLOOR", lhs=shifted, rhs=lit(width),
                            type=E.UNSIGNED)

    # -- column usage --

    def _collect_column_usage(self, cq: CompiledQuery) -> None:
        used: Dict[int, set] = {i: set() for i in range(len(self._tables))}

        def visit(node: E.Expr) -> None:
            if isinstance(node, E.VarRef) and node.column_id >= 0:
                used[node.table_id].add(node.column_id)

        for f in cq.filters + cq.time_filter_expr:
            E.walk(f, visit)
        for d in cq.dimensions:
            if not d.geo_dim:
                E.walk(d.expr, visit)
        if cq.measure is not None and cq.measure.expr is not None:
            E.walk(cq.measure.expr, visit)
        for ft in cq.foreign_tables:
            E.walk(ft.main_key_expr, visit)
        if cq.geo is not None:
            E.walk(cq.geo.point_expr, visit)
        if cq.time_column_id >= 0:
            used[0].add(cq.time_column_id)
        if cq.main_schema.table.is_fact_table:
            # the event time column must ALWAYS stage for fact tables: the
            # live-batch archiving-cutoff exclusion filter reads it even
            # when no expression does (kernels._eval_common live_cutoff;
            # reference liveCustomFilter always binds column 0). Without
            # this, a query whose exprs never touch column 0 would double
            # count rows present in both live and archive batches.
            used[0].add(0)
        cq.used_columns = sorted(used[0])
        cq.table_id_to_foreign = {
            ft.table_id: i for i, ft in enumerate(cq.foreign_tables)}
        for i, ft in enumerate(cq.foreign_tables):
            ft.used_columns = sorted(
                used[ft.table_id] | {ft.foreign_key_column})
