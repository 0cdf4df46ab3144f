"""The unfused dense aggregation kernel against the JAX package.

`kernels.make_dense_agg_kernel` for plans that K1 does not take: calendar
(GET_*) dimensions in int64 lanes, whose float sums reduce through K2;
tiny slot spaces (n_slots <= 4); min/max; integer sums. Each runs on the
same numpy columns through the port (CPU tensors, plain versions) and
through the JAX package with ARES_FUSED=interp, so its float sums go
through the Pallas K2 kernel in interpret mode.

Tolerances are the JAX package's: counts, row totals, overflow, min/max
and integer sums exact; float sums within rtol=2e-4, atol=1e-3.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from aresdb_tpu import demo as JD
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.dense import plan_dense as j_plan_dense
from aresdb_tpu_torch import demo as TD
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.dense import plan_dense
from aresdb_tpu_torch.query.executor import columns_from_numpy

N_ROWS = 4096
RTOL, ATOL = 2e-4, 1e-3
CPU = torch.device("cpu")
WIDE = {"column": "request_at", "from": "1000 days ago", "to": "now"}


def _q(measure, dims, time_filter=None, filters=None):
    q = json.loads(json.dumps(JD.DEMO_QUERY))
    m = {"sqlExpression": measure}
    if filters:
        m["rowFilters"] = filters
    q["measures"] = [m]
    q["dimensions"] = [{"sqlExpression": e, "timeBucketizer": b} if b
                       else {"sqlExpression": e} for e, b in dims]
    if time_filter:
        q["timeFilter"] = time_filter
    return q


CASES = {
    # Q2 of the main path: K1 rejects GET_DAY_OF_MONTH, K2 reduces
    "day_of_month_sum": _q("sum(fare)", [("request_at", "day of month"),
                                         ("city_id", None)], WIDE),
    "month_start_sum": _q("sum(fare)", [("request_at", "month")], WIDE),
    "month_of_year_avg": _q("avg(fare)", [("request_at", "month of year"),
                                          ("status", None)], WIDE),
    "week_start_count": _q("count(*)", [("request_at", "week")], WIDE),
    "quarter_start_sum": _q("sum(fare)", [("request_at", "quarter")], WIDE),
    "day_of_year_count": _q("count(*)", [("request_at", "day of year")],
                            WIDE),
    "global_count": _q("count(*)", []),
    "status_sum_four_slots": _q("sum(fare)", [("status", None)]),
    "status_int_max_four_slots": _q("max(city_id)", [("status", None)]),
    "max_fare_by_city": _q("max(fare)", [("city_id", None)]),
    "min_fare_by_hour_city": _q("min(fare)", [("request_at", "hour"),
                                              ("city_id", None)]),
    "int_sum_by_hour": _q("sum(city_id)", [("request_at", "hour")],
                          filters=["status = 'completed'"]),
    "int_min_by_hour": _q("min(city_id)", [("request_at", "hour")]),
}


def _columns(plan, seed=13, n_cities=40):
    """The demo columns, with request_at spread over the last 1000 days
    so the calendar buckets see many months, years and a leap day."""
    cols, _ = JD.demo_columns(plan, N_ROWS, seed=seed, n_cities=n_cities)
    key = (0, plan.main_schema.column_id("request_at"))
    if key in cols:
        rng = np.random.RandomState(seed + 1)
        vals = (JD.DEMO_NOW - rng.randint(0, 1000 * 86400, N_ROWS)
                ).astype(np.uint32)
        cols[key] = (vals, cols[key][1])
    return cols


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_kernel_matches_jax(name, monkeypatch):
    monkeypatch.setenv("ARES_FUSED", "interp")
    import jax.numpy as jnp

    query = CASES[name]
    jplan, tplan = JD.demo_plan(query), TD.demo_plan(query)
    cols_np = _columns(jplan)
    stats = {}
    city_key = (0, jplan.main_schema.column_id("city_id"))
    if city_key in cols_np:
        stats[city_key] = (0, int(cols_np[city_key][0].max()))
    jdp, tdp = j_plan_dense(jplan, stats), plan_dense(tplan, stats)
    assert jdp is not None and tdp is not None
    assert jdp.n_slots == tdp.n_slots
    nv = N_ROWS - 100

    jfn = JK.make_dense_agg_kernel(jplan, N_ROWS, jdp)
    jcols = {k: (jnp.asarray(v), jnp.asarray(b))
             for k, (v, b) in cols_np.items()}
    ja, jc, jr, jo = [np.asarray(x) for x in JK.run_dense_kernel(
        jfn, jplan, jdp.n_slots, jcols, (), np.int32(nv), np.int64(0))]

    tfn = K.make_dense_agg_kernel(tplan, N_ROWS, tdp, CPU)
    assert not isinstance(tfn, FD.FusedDenseKernel)
    tcols = columns_from_numpy(cols_np, N_ROWS, CPU)
    ta, tc, tr, to = [x.numpy() for x in K.run_dense_kernel(
        tfn, tplan, tdp.n_slots, tcols, nv, 0, CPU)]

    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert int(to) == int(jo)
    assert ta.dtype == ja.dtype
    if ja.dtype.kind == "f" and tplan.measure.agg in ("sum", "avg",
                                                       "count"):
        np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(ta, ja)
    assert tr.sum() > 0


def test_calendar_math_matches_jax_over_four_centuries():
    """The int64 calendar lanes of every GET_* op, at timestamps that cross
    leap days, century years and the year-400 cycle."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    ts = np.concatenate([
        rng.randint(-(1 << 40), 1 << 40, 2000),
        np.array([0, 951782400, 951868800, 4107542399, 4107542400,
                  -2208988800, -2203891200, 86399, -1], np.int64)])
    for op in ("GET_WEEK_START", "GET_MONTH_START", "GET_QUARTER_START",
               "GET_YEAR_START", "GET_DAY_OF_MONTH", "GET_DAY_OF_YEAR",
               "GET_MONTH_OF_YEAR", "GET_QUARTER_OF_YEAR"):
        valid = np.ones(len(ts), bool)
        want = JK._emit_calendar(op, JK._Val(jnp.asarray(ts),
                                             jnp.asarray(valid)), None)
        got = K._emit_calendar(op, K._Val(torch.from_numpy(ts),
                                          torch.from_numpy(valid)))
        np.testing.assert_array_equal(got.value.numpy(),
                                      np.asarray(want.value), err_msg=op)
