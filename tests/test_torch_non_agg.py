"""Non-aggregate queries (listings) of the port against the JAX package.

The same AQL requests go to both packages' `QueryService` over stores
filled from the same upsert bytes (tests/test_torch_join.py's). Every
answer's headers and rows must be equal exactly and in order: a limit
within one batch and across batches, no limit (the compiler's default),
ORDER BY ascending and descending over a column with nulls, and a joined
dimension. The port's select kernel compacts the first passing rows of a
batch in scan order on the device, and the executor stops scanning once
the limit is collected.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.aql import AQLQuery as TQ
from aresdb_tpu_torch.query.compiler import Compiler as TC
from tests.test_torch_join import (CITIES, CITY_JOIN, NOW, TRIPS,
                                   cities_batch, services, trips_batch)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def store():
    """3,000 trips in three live batches of 1,024, and 300 cities."""
    return services([TRIPS, CITIES], [trips_batch(3000, 51),
                                      cities_batch(52)])


def _query(dims, filters=(), limit=0, sorts=(), joins=()):
    q = {"table": "trips", "now": NOW, "joins": list(joins),
         "measures": [{"sqlExpression": "1"}],
         "dimensions": [{"sqlExpression": e} for e in dims],
         "rowFilters": list(filters)}
    if limit:
        q["limit"] = limit
    if sorts:
        q["sorts"] = [{"name": n, "order": o} for n, o in sorts]
    return q


def _same(query, jsvc, tsvc):
    jr = jsvc.handle_aql({"queries": [query]})
    tr = tsvc.handle_aql({"queries": [query], "verbose": True})
    assert "errors" not in jr, jr.get("errors")
    assert "errors" not in tr, tr.get("errors")
    assert tr["results"] == jr["results"]
    return tr["results"][0], tr["context"][0]


NON_AGG = {
    "limit_in_one_batch": _query(["fare", "city_id"], ["status='rejected'"],
                                 limit=50),
    "limit_across_batches": _query(["request_at", "uuid", "status"],
                                   ["fare > 40"], limit=400),
    "default_limit": _query(["city_id", "driver"], ["fare < 2"]),
    "order_by_fare_desc": _query(["fare", "city_id"], ["status='rejected'"],
                                 limit=20, sorts=[("fare", "desc")]),
    "order_by_city_asc_then_fare": _query(
        ["city_id", "fare"], ["status='canceled'"], limit=60,
        sorts=[("city_id", "asc"), ("fare", "desc")]),
    "joined_dimension": _query(["c.name", "c.population", "fare"],
                               ["c.population > 300000"], limit=30,
                               joins=CITY_JOIN),
    "order_by_joined_column": _query(["c.population", "city_id"], limit=25,
                                     sorts=[("c.population", "asc")],
                                     joins=CITY_JOIN),
}


@pytest.mark.parametrize("name", sorted(NON_AGG))
def test_non_agg_queries_match_exactly(name, store):
    result, _ = _same(NON_AGG[name], *store)
    limit = NON_AGG[name].get("limit")
    assert result["matrixData"]
    if limit:
        assert len(result["matrixData"]) == limit


def test_scanning_stops_once_the_limit_is_collected(store):
    _, ctx = _same(NON_AGG["limit_in_one_batch"], *store)
    assert ctx["batches"] == 1
    _, ctx = _same(NON_AGG["limit_across_batches"], *store)
    assert ctx["batches"] == 3
    # ORDER BY collects past the limit: every batch is scanned
    _, ctx = _same(NON_AGG["order_by_fare_desc"], *store)
    assert ctx["batches"] == 3


def test_nulls_sort_as_the_reference_sorts_them(store):
    result, _ = _same(_query(["city_id"], ["fare > 45"], limit=400,
                             sorts=[("city_id", "asc")]), *store)
    cities = [row[0] for row in result["matrixData"]]
    assert cities[-1] == "NULL" and cities[0] != "NULL"
    result, _ = _same(_query(["city_id"], ["fare > 45"], limit=400,
                             sorts=[("city_id", "desc")]), *store)
    assert result["matrixData"][0][0] == "NULL"


@pytest.mark.parametrize("top_l", [0, 1024])
def test_select_kernel_compacts_the_first_rows_in_scan_order(top_l, store):
    tsvc = store[1]
    plan = TC(tsvc.memstore.get_schemas()).compile(
        TQ.from_json(_query(["fare", "city_id"], ["fare > 10"])))
    shard = tsvc.memstore.get_table_shard("trips", 0)
    cols, n, n_pad, _, cutoff, _ = next(
        tsvc.executor._iter_batches(plan, shard))
    fare = cols[(0, plan.main_schema.column_id("fare"))]
    want_rows = np.nonzero((fare[0] > 10).numpy() & fare[1].numpy())[0]
    fn = K.make_select_kernel(plan, n_pad, top_l, torch.device("cpu"))
    head, values, valids = fn(cols, n, cutoff)
    if top_l:
        assert int(head) == len(want_rows) and len(want_rows) > 500
        take = min(len(want_rows), top_l)
        np.testing.assert_array_equal(values[0][:take].numpy(),
                                      fare[0][want_rows[:take]].numpy())
        assert values[0].shape == (top_l,)
    else:
        np.testing.assert_array_equal(np.nonzero(head.numpy())[0], want_rows)
