"""`QueryService.handle_aql` of the port against the JAX package.

Two stores are filled from the same upsert-batch wire bytes, each through
its own package's `TableShard`. The same AQL requests go to the JAX
package's `QueryService` (with ARES_FUSED=interp, so its Pallas kernels
run in interpret mode) and to the port's `QueryService(store,
device="cpu")`. Keys must agree exactly, counts exactly, float measures
within rtol=2e-4, atol=1e-3 (the JAX package's float-sum tolerance).

The keyed (sort) path, joins, listings, HLL, archive batches, the
run-length path, SQL and composite queries have their own service tests
in test_torch_{sort_path,join,non_agg,hll,archive,runlen,sql}.py.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from aresdb_tpu import demo as JD
from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.schema import TableSchema as JTableSchema
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.common.upsert_batch import (UpsertBatchBuilder,
                                            build_columnar_upsert)
from aresdb_tpu.memstore.table_shard import TableShard as JTableShard
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common.schema import Table as TTable
from aresdb_tpu_torch.common.schema import TableSchema as TTableSchema
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch as TUpsertBatch
from aresdb_tpu_torch.memstore.table_shard import TableShard as TTableShard
from aresdb_tpu_torch.query import executor as TX
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query.service import QueryService as TQueryService

RTOL, ATOL = 2e-4, 1e-3
NOW = JD.DEMO_NOW
HOUR = 3600

TRIPS = {
    "name": "trips",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "uuid", "type": "UUID"},
        {"name": "city_id", "type": "Uint16"},
        {"name": "status", "type": "SmallEnum"},
        {"name": "fare", "type": "Float32"},
    ],
    "primaryKeyColumns": [1],
    "isFactTable": True,
    "config": {"batchSize": 64, "recordRetentionInDays": 0},
}
CITIES = {
    "name": "cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "name", "type": "BigEnum"}],
    "primaryKeyColumns": [0],
    "isFactTable": False,
    "config": {"batchSize": 64},
}
STATUSES = ["completed", "canceled", "rejected"]


class Store:
    """The store protocol the executors use: schemas and table shards."""

    def __init__(self, table_cls, schema_cls, shard_cls, schemas, batches):
        self.schemas, self.shards = {}, {}
        for js in schemas:
            ts = schema_cls(table_cls.from_json(js))
            if js["name"] == "trips":
                ts.extend_enum("status", STATUSES)
            else:
                ts.extend_enum("name", ["San Francisco", "New York",
                                        "Paris"])
            self.schemas[js["name"]] = ts
            self.shards[(js["name"], 0)] = shard_cls(ts)
        for name, buf in batches:
            self.shards[(name, 0)].save_upsert_batch(
                (JUpsertBatch if table_cls is JTable else TUpsertBatch)(buf))

    def get_schemas(self):
        return dict(self.schemas)

    def get_table_shard(self, name, shard_id=0):
        return self.shards[(name, shard_id)]


def _services(schemas, batches):
    jstore = Store(JTable, JTableSchema, JTableShard, schemas, batches)
    tstore = Store(TTable, TTableSchema, TTableShard, schemas, batches)
    jsvc = JQueryService(jstore)
    # a kernel cache of its own, so interpret-mode kernels stay here
    jsvc.executor = JX.ShardExecutor(jstore, kernel_cache=JK.KernelCache())
    return jsvc, TQueryService(tstore, device="cpu")


def _small_batches():
    """The 12 trips (and 3 cities) of tests/test_query_e2e.py."""
    rows = [(0.5, 1, 1, 0, 10.0), (0.5, 2, 1, 0, 5.5), (0.6, 3, 2, 1, 2.0),
            (0.9, 4, 2, 0, 7.25), (1.5, 5, 1, 2, None), (1.5, 6, 3, 0, 20.0),
            (1.7, 7, 1, 0, 1.75), (2.5, 8, 2, 1, 3.0), (2.5, 9, 1, 0, 12.5),
            (2.9, 10, 9, 0, 4.0), (2.2, 11, None, 0, 8.0),
            (0.1, 12, 1, None, 6.0)]
    b = UpsertBatchBuilder()
    for cid, t in enumerate((dt.Uint32, dt.UUID, dt.Uint16, dt.SmallEnum,
                             dt.Float32)):
        b.add_column(cid, t)
    for i, (h, uid, city, status, fare) in enumerate(rows):
        b.add_row()
        b.set_value(i, 0, int(NOW - h * HOUR))
        b.set_value(i, 1, (uid, 0))
        for cid, v in ((2, city), (3, status), (4, fare)):
            if v is not None:
                b.set_value(i, cid, v)
    cb = UpsertBatchBuilder()
    cb.add_column(0, dt.Uint16)
    cb.add_column(1, dt.BigEnum)
    for i, (cid, rank) in enumerate([(1, 0), (2, 1), (3, 2)]):
        cb.add_row()
        cb.set_value(i, 0, cid)
        cb.set_value(i, 1, rank)
    return [("trips", b.to_bytes()), ("cities", cb.to_bytes())]


def _random_batches(n_rows, seed, low_city_from):
    """n_rows demo trips; rows from low_city_from on have cities <= 100,
    so a live batch there plans a narrower city domain than the others."""
    rng = np.random.RandomState(seed)
    city = rng.randint(1, 301, n_rows).astype(np.uint16)
    city[low_city_from:] = rng.randint(1, 101, n_rows - low_city_from)
    keys = np.arange(1, n_rows + 1, dtype=np.uint64)
    cols = [
        (0, dt.Uint32, (NOW - rng.randint(0, 20 * HOUR, n_rows))
         .astype(np.uint32), None, 0),
        (1, dt.UUID, np.stack([keys, keys * np.uint64(7)], 1), None, 0),
        (2, dt.Uint16, city, rng.rand(n_rows) > 0.02, 0),
        (3, dt.SmallEnum, rng.randint(0, 3, n_rows).astype(np.uint8),
         rng.rand(n_rows) > 0.02, 0),
        (4, dt.Float32, (rng.rand(n_rows) * 50).astype(np.float32),
         rng.rand(n_rows) > 0.02, 0),
    ]
    return [("trips", build_columnar_upsert(cols, n_rows))]


def _flatten(result, prefix=()):
    out = {}
    for k, v in result.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _assert_same(query, jsvc, tsvc, **request):
    jr = jsvc.handle_aql({"queries": [query], **request})
    tr = tsvc.handle_aql({"queries": [query], **request})
    assert "errors" not in jr, jr.get("errors")
    assert "errors" not in tr, tr.get("errors")
    j, t = _flatten(jr["results"][0]), _flatten(tr["results"][0])
    assert sorted(t) == sorted(j)
    keys = sorted(j)
    jv = np.array([np.nan if j[k] is None else j[k] for k in keys], float)
    tv = np.array([np.nan if t[k] is None else t[k] for k in keys], float)
    if query["measures"][0]["sqlExpression"].startswith("count"):
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    return t


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def small():
    return _services([TRIPS, CITIES], _small_batches())


def _hour_dims():
    return [{"sqlExpression": "request_at", "timeBucketizer": "hour"}]


LAST_DAY = {"column": "request_at", "from": "24 hours ago",
            "to": "this quarter-hour"}

SMALL_QUERIES = {
    "count_by_hour_filtered": {
        "measures": [{"sqlExpression": "count(*)",
                      "rowFilters": ["status='completed'"]}],
        "dimensions": _hour_dims(), "timeFilter": LAST_DAY},
    "sum_fare_by_hour": {
        "measures": [{"sqlExpression": "sum(fare)",
                      "rowFilters": ["status='completed'"]}],
        "dimensions": _hour_dims(), "timeFilter": LAST_DAY},
    "count_by_enum": {"measures": [{"sqlExpression": "count(*)"}],
                      "dimensions": [{"sqlExpression": "status"}]},
    "avg_fare_global": {"measures": [{"sqlExpression": "avg(fare)",
                                      "rowFilters": ["status='completed'"]}],
                        "dimensions": []},
    "max_fare_by_city": {"measures": [{"sqlExpression": "max(fare)"}],
                         "dimensions": [{"sqlExpression": "city_id"}]},
    "min_fare_city_filter": {"measures": [{"sqlExpression": "min(fare)",
                                           "rowFilters": ["city_id=1"]}],
                             "dimensions": []},
    "numeric_filters": {"measures": [{
        "sqlExpression": "count(*)",
        "rowFilters": ["fare > 5", "city_id IN (1, 2)"]}]},
    "fare_is_null": {"measures": [{"sqlExpression": "count(*)",
                                   "rowFilters": ["fare IS NULL"]}]},
    "status_is_not_null": {"measures": [{
        "sqlExpression": "count(*)", "rowFilters": ["status IS NOT NULL"]}]},
    "numeric_bucketizer": {
        "measures": [{"sqlExpression": "count(*)",
                      "rowFilters": ["fare IS NOT NULL"]}],
        "dimensions": [{"sqlExpression": "fare",
                        "numericBucketizer": {"bucketWidth": 5.0}}]},
    "arithmetic_measure": {"measures": [{"sqlExpression": "sum(fare * 2)",
                                         "rowFilters": ["city_id = 3"]}]},
    "time_filter_last_hour": {
        "measures": [{"sqlExpression": "count(*)"}],
        "timeFilter": {"column": "request_at", "from": "1 hour ago"}},
    "uuid_literal_filter": {"measures": [{
        "sqlExpression": "sum(fare)",
        "rowFilters": [f"uuid = '{dt.uuid_to_string(6, 0)}'"]}]},
    "uuid_literal_not_equal": {"measures": [{
        "sqlExpression": "count(*)",
        "rowFilters": [f"uuid != '{dt.uuid_to_string(6, 0)}'"]}]},
    "avg_by_day_of_month_city": {
        "measures": [{"sqlExpression": "avg(fare)"}],
        "dimensions": [{"sqlExpression": "request_at",
                        "timeBucketizer": "day of month"},
                       {"sqlExpression": "city_id"}]},
}


@pytest.mark.parametrize("name", sorted(SMALL_QUERIES))
def test_dense_queries_of_the_e2e_suite_match(name, small):
    query = {"table": "trips", "now": NOW, **SMALL_QUERIES[name]}
    _assert_same(query, *small)


def test_dataonly_request_keeps_enum_ranks(small):
    query = {"table": "trips", "now": NOW, **SMALL_QUERIES["count_by_enum"]}
    ranks = _assert_same(query, *small, dataonly=True)
    names = _assert_same(query, *small)
    assert sorted(ranks) != sorted(names)


def _q2():
    q = json.loads(json.dumps(JD.DEMO_QUERY))
    q["dimensions"][0]["timeBucketizer"] = "day of month"
    return q


def _with_measure(expr):
    q = json.loads(json.dumps(JD.DEMO_QUERY))
    q["measures"] = [{"sqlExpression": expr}]
    return q


@pytest.fixture(scope="module")
def piles():
    """5000 rows in live batches of 2048; the last batch's cities stop at
    100, so its dense plan (and slot space) differs from the others'."""
    trips = dict(TRIPS, config={"batchSize": 2048,
                                "recordRetentionInDays": 0})
    return _services([trips], _random_batches(5000, 21, 4096))


@pytest.mark.parametrize("query", [JD.DEMO_QUERY, _q2(),
                                   _with_measure("avg(fare)"),
                                   _with_measure("count(*)")],
                         ids=["Q1", "Q2", "avg", "count"])
def test_headline_queries_merge_piles_of_different_slot_spaces(
        query, piles, monkeypatch):
    merges = []
    real = TX.GroupTable._merge_piles

    def spy(self, keyed):
        merges.append(len(keyed))
        return real(self, keyed)

    monkeypatch.setattr(TX.GroupTable, "_merge_piles", spy)
    result = _assert_same(query, *piles)
    assert merges == [2] and len(result) > 100


@pytest.fixture(scope="module")
def fused_store():
    """Two live batches of FD_MIN_ROWS rows each, so the port routes the
    headline query through K1 (its plain version on the CPU), as the JAX
    package routes it through its interpreted Pallas K1."""
    n = 2 * FD.FD_MIN_ROWS
    trips = dict(TRIPS, config={"batchSize": FD.FD_MIN_ROWS,
                                "recordRetentionInDays": 0})
    return _services([trips], _random_batches(n, 4, n))


def test_headline_query_through_k1_matches(fused_store, monkeypatch):
    calls = []
    real = FD.FusedDenseKernel.reduce

    def spy(self, *args):
        calls.append(self.n_rows)
        return real(self, *args)

    monkeypatch.setattr(FD.FusedDenseKernel, "reduce", spy)
    _assert_same(dict(JD.DEMO_QUERY), *fused_store)
    assert calls == [FD.FD_MIN_ROWS, FD.FD_MIN_ROWS]


def test_sort_path_plan_is_not_ported(small, monkeypatch):
    """A group-by over a dimension with no bounded domain (fare) plans no
    dense slots; the port answers it on the sort path, as the JAX package
    does. (The name is kept from when the port refused it.)"""
    runs = []
    real = TX.ShardExecutor._run_sort_batch

    def spy(self, *args, **kw):
        runs.append(args[3])
        return real(self, *args, **kw)

    monkeypatch.setattr(TX.ShardExecutor, "_run_sort_batch", spy)
    result = _assert_same({"table": "trips", "now": NOW,
                           "measures": [{"sqlExpression": "count(*)"}],
                           "dimensions": [{"sqlExpression": "fare"}]},
                          *small)
    assert runs and len(result) == 12


@pytest.mark.parametrize("query", [
    {"measures": [{"sqlExpression": "count(*)"}],
     "joins": [{"table": "cities", "alias": "c",
                "conditions": ["c.id = city_id"]}],
     "dimensions": [{"sqlExpression": "c.name"}]},
    {"measures": [{"sqlExpression": "1"}],
     "dimensions": [{"sqlExpression": "city_id"}]},
    {"measures": [{"sqlExpression": "count(*)"},
                  {"sqlExpression": "sum(fare)"}]},
    {"measures": [{"sqlExpression": "hll(uuid)"}]},
], ids=["join", "non_agg", "composite", "hll"])
def test_paths_not_ported_answer_with_an_error(query, small):
    """Joins, listings, composite queries and HLL, refused until they
    were ported, now answer as the JAX package does, exactly. (The name
    is kept from when all four were refused.)"""
    request = {"queries": [dict(query, table="trips", now=NOW)]}
    jr, tr = (svc.handle_aql(request) for svc in small)
    assert "errors" not in tr, tr.get("errors")
    assert tr == jr and tr["results"][0]


def test_overflowing_batch_is_not_answered(small, monkeypatch):
    """A dense plan that understates the city domain: both packages rerun
    the overflowed batch on the sort path and answer alike. (The name is
    kept from when the port refused it.)"""
    def narrow(real):
        def plan(plan, stats):
            stats = dict(stats or {})
            key = (0, plan.main_schema.column_id("city_id"))
            if key in stats:
                stats[key] = (0, 2)
            return real(plan, stats)
        return plan

    monkeypatch.setattr(TX, "plan_dense", narrow(TX.plan_dense))
    monkeypatch.setattr(JX, "plan_dense", narrow(JX.plan_dense))
    query = {"table": "trips", "now": NOW,
             "measures": [{"sqlExpression": "count(*)"}],
             "dimensions": [{"sqlExpression": "city_id"}]}
    result = _assert_same(query, *small)
    assert len(result) == 5   # cities 1, 2, 3, 9 and NULL
    resp = small[1].handle_aql({"queries": [query], "verbose": True})
    assert resp["context"][0]["overflowReruns"] == 1


def test_sql_is_not_ported(small):
    """SQL, refused until it was ported, answers as the JAX package does.
    (The name is kept from then.)"""
    request = {"queries": ["SELECT count(*) FROM trips"]}
    jr, tr = (svc.handle_sql(request) for svc in small)
    assert "errors" not in tr, tr.get("errors")
    assert tr == jr and tr["results"][0]


def test_joins_to_tables_of_one_name_and_another_layout_do_not_share_kernels(
        small):
    """A cities table whose name is column 2, not 1: a kernel built for
    the other cities layout would read the wrong column. The JAX
    package's key holds no joined layout."""
    swapped = {"name": "cities",
               "columns": [{"name": "id", "type": "Uint16"},
                           {"name": "population", "type": "Uint16"},
                           {"name": "name", "type": "BigEnum"}],
               "primaryKeyColumns": [0], "isFactTable": False,
               "config": {"batchSize": 64}}
    cb = UpsertBatchBuilder()
    for cid, t in enumerate((dt.Uint16, dt.Uint16, dt.BigEnum)):
        cb.add_column(cid, t)
    for i, (cid, rank) in enumerate([(1, 2), (2, 0), (3, 1)]):
        cb.add_row()
        cb.set_value(i, 0, cid)
        cb.set_value(i, 1, 7)
        cb.set_value(i, 2, rank)
    other = _services([TRIPS, swapped],
                      [_small_batches()[0], ("cities", cb.to_bytes())])
    query = {"table": "trips", "now": NOW,
             "measures": [{"sqlExpression": "sum(fare)"}],
             "joins": [{"table": "cities", "alias": "c",
                        "conditions": ["c.id = city_id"]}],
             "dimensions": [{"sqlExpression": "c.name"}]}
    answers = [_assert_same(query, *services)
               for services in (small, other, small)]
    assert answers[0] == answers[2] != answers[1]


def test_tables_of_one_name_and_another_layout_do_not_share_kernels(small):
    """A trips table whose fare is column 3, not 4: the port's services
    share one kernel cache, and a kernel built for the other layout would
    read the wrong column."""
    swapped = {
        "name": "trips",
        "columns": [{"name": "ts", "type": "Uint32"},
                    {"name": "id", "type": "Uint32"},
                    {"name": "city_id", "type": "Uint16"},
                    {"name": "fare", "type": "Float32"},
                    {"name": "status", "type": "SmallEnum"}],
        "primaryKeyColumns": [1],
        "isFactTable": True,
        "config": {"batchSize": 64, "recordRetentionInDays": 0},
    }
    rng = np.random.RandomState(2)
    n = 40
    cols = [(0, dt.Uint32, (NOW - rng.randint(0, 3 * HOUR, n))
             .astype(np.uint32), None, 0),
            (1, dt.Uint32, np.arange(1, n + 1, dtype=np.uint32), None, 0),
            (2, dt.Uint16, rng.randint(1, 5, n).astype(np.uint16), None, 0),
            (3, dt.Float32, (rng.rand(n) * 50).astype(np.float32), None, 0),
            (4, dt.SmallEnum, rng.randint(0, 3, n).astype(np.uint8), None,
             0)]
    other = _services([swapped], [("trips", build_columnar_upsert(cols, n))])
    query = {"table": "trips", "now": NOW,
             "measures": [{"sqlExpression": "sum(fare)"}]}
    for services in (small, other, small):
        _assert_same(query, *services)
