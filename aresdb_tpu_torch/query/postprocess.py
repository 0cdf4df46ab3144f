"""Result postprocessing: group table → nested JSON AQLQueryResult.

Reference: query/aql_postprocessor.go (flushResultBuffer) and
query/common/dimval.go (ReadDimension / formatTimeDimension). Dimension
values become strings ("NULL" for null), nested one map level per dimension,
with the single measure as a float (or None) leaf. Non-agg queries return
{"headers": [...], "matrixData": [[...], ...]}.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import time_util as TU
from aresdb_tpu_torch.query.compiler import CompiledQuery, DimensionPlan

NULL_STRING = "NULL"


def format_float32(v: float) -> str:
    """Mirror Go strconv.FormatFloat(float64(float32(v)), 'g', -1, 32)."""
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    # shortest repr that round-trips float32
    s = np.format_float_positional(f, unique=True, trim="-")
    # Go switches to scientific for exponent < -4 or >= 21
    av = abs(float(f))
    if av != 0 and (av < 1e-4 or av >= 1e21):
        s = np.format_float_scientific(f, unique=True, trim="-")
        # Go style: 1e+21 not 1.e+21
        s = s.replace(".e", "e")
    return s


def format_dimension(value, valid: bool, dim: DimensionPlan,
                     plan: Optional[CompiledQuery] = None) -> Optional[str]:
    """One dimension value → string (None = NULL), ReadDimension parity."""
    if not valid:
        return None
    dt = dim.data_type
    if dim.geo_dim and plan is not None and plan.geo is not None:
        idx = int(value)
        if not (0 <= idx < len(plan.geo.shape_values)):
            return None
        value = plan.geo.shape_values[idx]
        dt = plan.geo.pk_data_type
        if dt == mdt.UUID:
            # geo dimensions render the NORMALIZED uuid (uppercase hex, no
            # dashes) — reference utils.NormalizeUUIDString via
            # aql_compiler.go:965 shapeUUIDs / aql_postprocessor.go:200
            s = mdt.uuid_to_string(int(value[0]), int(value[1]))
            return s.replace("-", "").upper()
        return str(value)
    is_time = dim.raw is not None and dim.raw.is_time_dimension

    if dt == mdt.UUID:
        return mdt.uuid_to_string(int(value[0]), int(value[1]))
    if dt == mdt.GeoPoint:
        return mdt.geopoint_to_string(float(value[0]), float(value[1]))
    if dt == mdt.Float32 and not is_time:
        return format_float32(float(value))
    iv = int(value)
    if dt in (mdt.Int64, mdt.Int32, mdt.Int16, mdt.Int8, mdt.Bool):
        return str(iv)
    # unsigned path: enum translation first, then time formatting.
    # dataonly mode keeps ranks untranslated (reference ?dataonly=1,
    # aql_postprocessor.go:116 — distributed merges happen on ranks)
    rev = dim.enum_reverse_dict
    if rev is not None and not getattr(plan, "data_only", False) \
            and 0 <= iv < len(rev):
        return rev[iv]
    if is_time:
        return TU.format_time_dimension(
            iv, dim.raw.time_bucketizer, dim.raw.time_unit,
            dim.from_offset, dim.to_offset, dim.dst_switch_ts)
    return str(iv)


def _measure_value(plan: CompiledQuery, agg_value, count: int) -> Optional[float]:
    m = plan.measure
    if m.agg == "hll":
        from aresdb_tpu_torch.query import hll as H
        a = np.asarray(agg_value)
        if a.ndim == 0:
            # executor already estimated on device stats (JSON fast path)
            return float(a)
        return H.compute_estimate(a)
    if m.agg == "avg":
        if count == 0:
            return None
        # reference computes running float32 average on device; final
        # division here matches within float tolerance
        return float(np.float32(float(agg_value) / count))
    if m.agg in ("sum", "count"):
        return float(agg_value)
    # min/max: a group whose measures were all null yields the identity;
    # the reference reports that identity verbatim, so do we
    return float(agg_value)


def format_float32_column(vals: np.ndarray) -> np.ndarray:
    """Vectorized format_float32 over a float32 array → object array of
    strings (byte-identical to per-element format_float32; differential-
    tested in test_postprocess_vectorized). numpy's U-cast runs the same
    shortest-roundtrip dragon4, ~10x faster than python-level calls; the
    fixups cover where its style differs from Go's 'g' format: trailing
    '.0' on integral values, positional range up to 1e21, and NaN/Inf
    casing."""
    vals = np.asarray(vals, np.float32)
    s = vals.astype("U32").astype(object)
    # Go prints integral floats without the '.0' numpy appends
    trim = np.char.endswith(s.astype("U32"), ".0")
    if trim.any():
        idx = np.nonzero(trim)[0]
        for j in idx.tolist():
            s[j] = s[j][:-2]
    # Go stays positional below 1e21; numpy switches at 1e16
    av = np.abs(vals)
    slow = (av >= np.float32(1e16)) & (av < np.float32(1e21))
    slow |= ~np.isfinite(vals)
    if slow.any():
        for j in np.nonzero(slow)[0].tolist():
            s[j] = format_float32(vals[j])
    return s


def format_dim_column(plan: CompiledQuery, i: int, values: np.ndarray,
                      valids: np.ndarray) -> List[Optional[str]]:
    """One dimension column formatted vectorized → list[str|None].

    Strategy: format each UNIQUE value once through format_dimension (the
    parity surface) and broadcast via the inverse index — group counts are
    typically much larger than per-dimension cardinality. True-hicard
    float32 dims (unique count ~ group count) take the vectorized dragon4
    path instead."""
    dim = plan.dimensions[i]
    values = np.asarray(values)
    valids = np.asarray(valids, bool)
    g = len(valids)
    if values.ndim > 1:
        # 2-lane dims (UUID / GeoPoint): per-row python (small cardinality)
        return [format_dimension(values[j], bool(valids[j]), dim, plan)
                for j in range(g)]
    is_time = dim.raw is not None and dim.raw.is_time_dimension
    plain_float = (values.dtype == np.float32 and not is_time
                   and not dim.geo_dim)
    if plain_float and g > 4096:
        out = format_float32_column(values)
        out[~valids] = None
        return out.tolist()
    plain_int = (values.dtype.kind in "iu" and not is_time
                 and not dim.geo_dim and dim.enum_reverse_dict is None)
    if plain_int and g > 4096:
        # vectorized decimal rendering == str(int(v)) for every int dtype
        out = values.astype("U24").astype(object)
        out[~valids] = None
        return out.tolist()
    uniq, inv = np.unique(values, return_inverse=True)
    tbl = np.empty(len(uniq), object)
    for u, v in enumerate(uniq.tolist()):
        tbl[u] = format_dimension(v, True, dim, plan)
    out = tbl[inv]
    out[~valids] = None
    return out.tolist()


def measure_column(plan: CompiledQuery, aggs: np.ndarray,
                   cnts: np.ndarray) -> List[Optional[float]]:
    """Vectorized _measure_value over the finalized columns."""
    m = plan.measure
    a = np.asarray(aggs)
    if m.agg == "hll":
        from aresdb_tpu_torch.query import hll as H
        if a.ndim <= 1:
            # executor already estimated on device stats (JSON fast path)
            return np.asarray(a, np.float64).tolist()
        return [H.compute_estimate(a[j]) for j in range(len(a))]
    if m.agg == "avg":
        cnts = np.asarray(cnts)
        safe = np.maximum(cnts, 1)
        vals = (a / safe).astype(np.float32).astype(np.float64)
        return [v if c else None
                for v, c in zip(vals.tolist(), (cnts > 0).tolist())]
    return np.asarray(a, np.float64).tolist()


def build_agg_result(plan: CompiledQuery, table) -> Dict[str, Any]:
    """GroupTable → nested time-series result (AQLQueryResult.Set parity).

    Consumes the FINALIZED COLUMNAR group table: dimension formatting and
    measure conversion run vectorized per column (the python tail is one
    dict insert per group, not per-value formatting). HLL leaves are
    estimated here; the binary register pass-through for the broker /
    application/hll clients lives in hll_wire.serialize_result_table
    (reference query/hll.go SerializeHLL)."""
    result: Dict[str, Any] = {}
    n_dims = len(plan.dimensions)
    g = table.n_groups
    if g == 0:
        return result
    measures = measure_column(plan, table.aggs, table.cnts)
    if n_dims == 0:
        # no dimensions: single-value result under implicit empty key
        result[""] = measures[0]
        return result
    cols = [format_dim_column(plan, i, table.dim_values[i],
                              table.dim_valids[i])
            for i in range(n_dims)]
    last = n_dims - 1
    for j in range(g):
        node = result
        for i in range(last):
            s = cols[i][j]
            node = node.setdefault(NULL_STRING if s is None else s, {})
        s = cols[last][j]
        node[NULL_STRING if s is None else s] = measures[j]
    return result


def build_non_agg_result(plan: CompiledQuery, rows) -> Dict[str, Any]:
    headers = []
    for d in plan.dimensions:
        headers.append(d.raw.alias or (d.raw.expr or str(d.expr)))
    matrix: List[List[Any]] = []
    for row in rows:
        out = []
        for i, (value, valid) in enumerate(row):
            s = format_dimension(value, valid, plan.dimensions[i], plan)
            out.append(NULL_STRING if s is None else s)
        matrix.append(out)
    return {"headers": headers, "matrixData": matrix}
