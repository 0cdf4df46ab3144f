"""Joins to dimension tables in the port, against the JAX package.

Two stores, one per package, are filled from the same upsert bytes: demo
trips and their dimension tables. The same AQL requests go to the JAX
package's `QueryService` (ARES_FUSED=interp, its Pallas kernels
interpreted) and to the port's on the CPU. Covered: the dense key -> row
table probe (cities by a Uint16 id) and the sorted-key probe (drivers by
sparse Uint32 keys), an empty dimension table, null join keys and null
dimension values, a joined column used as a dimension and in a filter, a
joined measure, the timezone table, K1 taking a joined lane, and the
staged probe's cache. Keys and counts exact, float sums within
rtol=2e-4, atol=1e-3 (the JAX package's float-sum tolerance).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.schema import TableSchema as JTableSchema
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu.memstore.table_shard import TableShard as JTableShard
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.aql import AQLQuery as JQ
from aresdb_tpu.query.compiler import Compiler as JC
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common.schema import Table as TTable
from aresdb_tpu_torch.common.schema import TableSchema as TTableSchema
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch as TUpsertBatch
from aresdb_tpu_torch.memstore.table_shard import TableShard as TTableShard
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.aql import AQLQuery as TQ
from aresdb_tpu_torch.query.compiler import Compiler as TC
from aresdb_tpu_torch.query.service import QueryService as TQueryService
from tests.test_torch_service import HOUR, NOW, STATUSES, _assert_same

TRIPS = {
    "name": "trips",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "uuid", "type": "UUID"},
        {"name": "city_id", "type": "Uint16"},
        {"name": "status", "type": "SmallEnum"},
        {"name": "fare", "type": "Float32"},
        {"name": "driver", "type": "Uint32"},
    ],
    "primaryKeyColumns": [1],
    "isFactTable": True,
    "config": {"batchSize": 1024, "recordRetentionInDays": 0},
}
CITIES = {
    "name": "cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "population", "type": "Uint32"},
                {"name": "name", "type": "BigEnum"},
                {"name": "tz", "type": "SmallEnum"}],
    "primaryKeyColumns": [0],
    "isFactTable": False,
    "config": {"batchSize": 128},
}
DRIVERS = {
    "name": "drivers",
    "columns": [{"name": "pk", "type": "Uint32"},
                {"name": "grp", "type": "Uint16"},
                {"name": "rating", "type": "Float32"}],
    "primaryKeyColumns": [0],
    "isFactTable": False,
    "config": {"batchSize": 64},
}
ENUMS = {"trips": {"status": STATUSES},
         "cities": {"name": [f"city{i}" for i in range(12)],
                    "tz": ["America/New_York", "Asia/Tokyo", "",
                           "Not/AZone"]}}


class Store:
    """The store protocol the executors use, over one package's classes."""

    def __init__(self, table_cls, schema_cls, shard_cls, batch_cls, schemas,
                 batches):
        self.schemas, self.shards = {}, {}
        for js in schemas:
            ts = schema_cls(table_cls.from_json(js))
            for col, cases in ENUMS.get(js["name"], {}).items():
                ts.extend_enum(col, cases)
            self.schemas[js["name"]] = ts
            self.shards[(js["name"], 0)] = shard_cls(ts)
        for name, buf in batches:
            self.shards[(name, 0)].save_upsert_batch(batch_cls(buf))

    def get_schemas(self):
        return dict(self.schemas)

    def get_table_shard(self, name, shard_id=0):
        return self.shards[(name, shard_id)]


def services(schemas, batches, timezone_table=""):
    jstore = Store(JTable, JTableSchema, JTableShard, JUpsertBatch, schemas,
                   batches)
    tstore = Store(TTable, TTableSchema, TTableShard, TUpsertBatch, schemas,
                   batches)
    jsvc = JQueryService(jstore, timezone_table=timezone_table)
    # a kernel cache of its own, so interpret-mode kernels stay here
    jsvc.executor = JX.ShardExecutor(jstore, kernel_cache=JK.KernelCache())
    return jsvc, TQueryService(tstore, device="cpu",
                               timezone_table=timezone_table)


def trips_batch(n, seed, n_cities=320, driver_keys=None):
    """n trips over 20 hours; cities 1..n_cities (2% null), drivers drawn
    from driver_keys and some unknown keys (5% null)."""
    rng = np.random.RandomState(seed)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    if driver_keys is None:
        driver_keys = np.arange(1, 50, dtype=np.uint32)
    drivers = rng.choice(np.concatenate(
        [driver_keys, rng.randint(0, 1 << 30, 8).astype(np.uint32)]), n)
    cols = [
        (0, dt.Uint32, (NOW - rng.randint(0, 20 * HOUR, n)).astype(np.uint32),
         None, 0),
        (1, dt.UUID, np.stack([keys, keys * np.uint64(7)], 1), None, 0),
        (2, dt.Uint16, rng.randint(1, n_cities + 1, n).astype(np.uint16),
         rng.rand(n) > 0.02, 0),
        (3, dt.SmallEnum, rng.randint(0, 3, n).astype(np.uint8),
         rng.rand(n) > 0.02, 0),
        (4, dt.Float32, (rng.rand(n) * 50).astype(np.float32),
         rng.rand(n) > 0.02, 0),
        (5, dt.Uint32, drivers.astype(np.uint32), rng.rand(n) > 0.05, 0),
    ]
    return ("trips", build_columnar_upsert(cols, n))


def cities_batch(seed, n=300):
    """Cities 1..n (trips also name 301..320, which miss): populations
    with 10% null, names over 12 enum ranks, timezones over 4 ranks."""
    rng = np.random.RandomState(seed)
    cols = [(0, dt.Uint16, np.arange(1, n + 1, dtype=np.uint16), None, 0),
            (1, dt.Uint32, rng.randint(1000, 400_000, n).astype(np.uint32),
             rng.rand(n) > 0.1, 0),
            (2, dt.BigEnum, rng.randint(0, 12, n).astype(np.uint16), None, 0),
            (3, dt.SmallEnum, rng.randint(0, 4, n).astype(np.uint8), None,
             0)]
    return ("cities", build_columnar_upsert(cols, n))


def drivers_batch(keys, seed):
    rng = np.random.RandomState(seed)
    n = len(keys)
    cols = [(0, dt.Uint32, keys, None, 0),
            (1, dt.Uint16, rng.randint(0, 6, n).astype(np.uint16), None, 0),
            (2, dt.Float32, (rng.rand(n) * 5).astype(np.float32),
             rng.rand(n) > 0.2, 0)]
    return ("drivers", build_columnar_upsert(cols, n))


SPARSE_DRIVERS = (np.random.RandomState(5).choice(100_000, 40, replace=False)
                  * 97 + 5_000_000).astype(np.uint32)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def store():
    """3,000 trips in three live batches, 300 cities (keys 1..300: the
    dense lookup probe), 40 drivers with keys past 2^22 (the sorted-key
    probe)."""
    return services([TRIPS, CITIES, DRIVERS],
                    [trips_batch(3000, 41, driver_keys=SPARSE_DRIVERS),
                     cities_batch(42), drivers_batch(SPARSE_DRIVERS, 43)])


CITY_JOIN = [{"table": "cities", "alias": "c",
              "conditions": ["c.id = city_id"]}]
DRIVER_JOIN = [{"table": "drivers", "alias": "d",
                "conditions": ["d.pk = driver"]}]


def _query(measure, dims=(), filters=(), joins=CITY_JOIN, **extra):
    return {"table": "trips", "now": NOW, "joins": joins,
            "measures": [{"sqlExpression": measure,
                          "rowFilters": list(filters)}],
            "dimensions": [{"sqlExpression": e, "timeBucketizer": b} if b
                           else {"sqlExpression": e} for e, b in dims],
            **extra}


JOIN_QUERIES = {
    "count_by_joined_enum": _query("count(*)", [("c.name", None)]),
    "sum_by_city_with_joined_filter": _query(
        "sum(fare)", [("request_at", "hour"), ("city_id", None)],
        ["c.population > 200000"]),
    "joined_dim_and_filter": _query(
        "count(*)", [("c.population", None)],
        ["c.population < 100000", "status = 'completed'"]),
    "joined_value_is_null": _query("count(*)", [("status", None)],
                                   ["c.population IS NULL"]),
    "joined_measure": _query("sum(c.population)", [("status", None)]),
    "avg_by_joined_name_and_hour": _query(
        "avg(fare)", [("c.name", None), ("request_at", "hour")]),
    "sorted_probe_by_group": _query("count(*)", [("d.grp", None)],
                                    joins=DRIVER_JOIN),
    "sorted_probe_float_measure": _query("sum(d.rating)", [("status", None)],
                                         joins=DRIVER_JOIN),
    "two_joins": _query("count(*)", [("c.name", None), ("d.grp", None)],
                        ["d.rating > 1"], joins=CITY_JOIN + DRIVER_JOIN),
}


@pytest.mark.parametrize("name", sorted(JOIN_QUERIES))
def test_join_queries_match(name, store):
    result = _assert_same(JOIN_QUERIES[name], *store)
    assert len(result) >= 2


def test_probes_are_the_lookup_table_and_the_sorted_keys(store):
    tsvc = store[1]
    p = TC(tsvc.memstore.get_schemas()).compile(
        TQ.from_json(JOIN_QUERIES["two_joins"]))
    (lut, cities), (sorted_probe, drivers) = \
        tsvc.executor._stage_foreign_tables(p)
    assert len(lut) == 1 and lut[0].shape == (302,)
    assert int(lut[0][0]) == -1 and int(lut[0][1]) == 0
    keys, perm = sorted_probe
    assert keys.shape == perm.shape == (40,)
    assert bool((keys[1:] >= keys[:-1]).all())
    # staged once per table version: the second query reuses both
    again = tsvc.executor._stage_foreign_tables(p)
    assert again[0] is not None and again[0][0] is lut
    assert again[1][0] is sorted_probe


def test_foreign_column_gives_the_jax_bits_for_both_probes(store):
    """_EvalCtx.foreign_column of both packages over the same staged
    columns and probes: the JAX package takes its one-hot dot (301 keys)
    and its sorted probe; the port's gathers give the same values where
    the probe hits, and the same validity everywhere."""
    jsvc, tsvc = store
    q = JOIN_QUERIES["two_joins"]
    jp = JC(jsvc.memstore.get_schemas()).compile(JQ.from_json(q))
    tp = TC(tsvc.memstore.get_schemas()).compile(TQ.from_json(q))
    jforeign = jsvc.executor._stage_foreign_tables(jp)
    tforeign = tsvc.executor._stage_foreign_tables(tp)
    shard = tsvc.memstore.get_table_shard("trips", 0)
    batch_cols, n, n_pad, _, _, _ = next(
        tsvc.executor._iter_batches(tp, shard))
    tcols, tidx = tsvc.executor._with_foreign(tp, tforeign, batch_cols)
    jcols = {}
    for key, (v, b) in batch_cols.items():
        col = tp.main_schema.table.columns[key[1]]
        want = {dt.Uint32: np.uint32, dt.Uint16: np.uint16,
                dt.UUID: np.uint64}.get(col.data_type)
        v = v.numpy()
        jcols[key] = (jnp.asarray(v.view(want) if want else v),
                      jnp.asarray(b.numpy()))
    for ft, (_, fcols) in zip(jp.foreign_tables, jforeign):
        for (_, cid), pair in fcols.items():
            jcols[(ft.table_id, cid)] = pair
    jctx = JK._EvalCtx(jcols, tuple(f[0] for f in jforeign), n_pad)
    tctx = K._EvalCtx(tcols, n_pad, tsvc.device, tidx)
    checked = 0
    for ft in tp.foreign_tables:
        for cid in ft.used_columns:
            key = (ft.table_id, cid)
            jv, jb = jctx.foreign_column(*key, jp, *jcols[key])
            tv, tb = tctx.foreign_column(*key, tp, *tcols[key])
            jb = np.asarray(jb)
            np.testing.assert_array_equal(tb.numpy(), jb)
            tv = tv.numpy()
            jv = np.asarray(jv)
            np.testing.assert_array_equal(tv[jb].view(jv.dtype)
                                          if tv.dtype != jv.dtype
                                          else tv[jb], jv[jb])
            assert jb.any() and not jb.all()
            checked += 1
    assert checked == 5   # cities' id and name, drivers' pk, grp, rating


def test_empty_dimension_table_matches_nothing():
    svcs = services([TRIPS, CITIES], [trips_batch(700, 44)])
    result = _assert_same(_query("count(*)", [("c.name", None)]), *svcs)
    assert list(result) == [("NULL",)]
    result = _assert_same(_query("sum(fare)", [("status", None)],
                                 ["c.population > 5"]), *svcs)
    assert result == {}


def test_timezone_table_shifts_hour_buckets():
    svcs = services([TRIPS, CITIES], [trips_batch(1500, 45), cities_batch(46)],
                    timezone_table="cities")
    q = _query("count(*)", [("request_at", "hour")], joins=[],
               timezone="tz(city_id)")
    result = _assert_same(q, *svcs)
    utc = _assert_same(_query("count(*)", [("request_at", "hour")], joins=[]),
                       *svcs)
    assert sorted(result) != sorted(utc)
    # with the timezone table joined by the query as well
    q = _query("avg(fare)", [("request_at", "day of week"),
                             ("c.name", None)], timezone="tz(city_id)")
    assert len(_assert_same(q, *svcs)) > 12


@pytest.fixture(scope="module")
def fused_store():
    """Two live batches of FD_MIN_ROWS rows, so both packages route the
    joined headline query through K1 (the port's plain version here)."""
    n = 2 * FD.FD_MIN_ROWS
    trips = dict(TRIPS, config={"batchSize": FD.FD_MIN_ROWS,
                                "recordRetentionInDays": 0})
    return services([trips, CITIES], [trips_batch(n, 47), cities_batch(48)])


def test_joined_filter_goes_through_k1_with_a_joined_lane(fused_store,
                                                          monkeypatch):
    calls = []
    real = FD.FusedDenseKernel.reduce

    def spy(self, columns, n_valid, live_cutoff, foreign=()):
        calls.append((self.spec.fkeys, len(self._lanes(columns, foreign))))
        return real(self, columns, n_valid, live_cutoff, foreign)

    monkeypatch.setattr(FD.FusedDenseKernel, "reduce", spy)
    q = _query("sum(fare)", [("request_at", "hour"), ("city_id", None)],
               ["c.population > 200000", "status = 'completed'"],
               timeFilter={"column": "request_at", "from": "24 hours ago",
                           "to": "this quarter-hour"})
    result = _assert_same(q, *fused_store)
    # (table 1, population, Uint32): one joined lane after 4 main columns
    assert calls == [([(1, 1, dt.Uint32)], 5)] * 2
    assert len(result) > 1000


def test_timezone_offsets_resolved_at_two_dates_do_not_share_a_kernel():
    """The timezone join resolves each zone's UTC offset when the query
    compiles (America/New_York: -5 h in January, -4 h in July), and the
    expressions do not print them: the same query at the two dates must
    not share a kernel. The port's services share one kernel cache; each
    answer is held against a fresh JAX service, whose kernel cache would
    reuse January's offsets in July."""
    batches = [trips_batch(1500, 49), cities_batch(50)]
    port = services([TRIPS, CITIES], batches, timezone_table="cities")[1]
    answers = []
    for now in (1_579_000_000, 1_594_000_000):   # January, July 2020
        q = _query("count(*)", [("request_at", "hour")], joins=[],
                   timezone="tz(city_id)", now=now)
        jsvc = services([TRIPS, CITIES], batches,
                        timezone_table="cities")[0]
        answers.append(_assert_same(q, jsvc, port))
    assert sorted(answers[0]) != sorted(answers[1])
