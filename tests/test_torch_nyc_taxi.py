"""The nyc_taxi deployment on the port, on the CPU at a tiny size.

A seeded draw of `portbench/configs/nyc_taxi.json` (6 held days of 2,000
trips, all 51 columns, among them Int8, Int16, BigEnum and GeoPoint) is
loaded through `TableShard.save_upsert_batch` and the Archiver, as the
benchmark's set-up loads it, and `QueryService` answers the benchmark's
queries 1-4, compared by group with `portbench/reference/engine.py`.
Queries 1-4 have no time filter: query 3's year domain comes from each
batch's time stats (dense), and query 4, whose days hold absurd
distances, takes the sort route. A batch whose stats are stale overflows
its year domain and reruns on the sort route with the same answer.

The same upserts also go through the JAX package's `TableShard` and
`Archiver`, and its `QueryService` (ARES_FUSED=interp, its Pallas
kernels interpreted) answers queries 1-4: the port's answers, on its
planned routes, forced onto the sort route and with stale stats, agree
with it by group. On its keyed route the JAX package reads an unsigned
8-bit dim back sign-extended (a passenger_count of 200 groups as -56), as
the port did before; the comparison reads its keys as their type's
value. A second draw, with distances of 10^6-10^7 miles, holds query 4
against the JAX package alone: the harness's reference cannot lay its
table over such a span.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.schema import TableSchema as JTableSchema
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.diskstore.local_diskstore import LocalDiskStore as JDisk
from aresdb_tpu.memstore.archiving import Archiver as JArchiver
from aresdb_tpu.memstore.table_shard import TableShard as JTableShard
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JMeta
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch
from aresdb_tpu_torch.query import dense as D
from aresdb_tpu_torch.query import executor as X
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import Compiler
from aresdb_tpu_torch.query.service import QueryService
from aresdb_tpu_torch.utils import metrics as M
from portbench import bench
from portbench.reference import engine as RE
from portbench.reference import nyc_taxi as N
from tests.test_torch_archive import Store

SEED = 2 ** 31 + 23
SCALE = {"rows_per_day": 2000, "day_stride": 400, "days_held": 6,
         "upsert_rows": 4096, "batchSize": 4096}
QUERIES = ["Q1", "Q2", "Q3", "Q4"]
YEAR = 366 * 86400


def _cell(absurd_log10=None):
    cell = bench.Cell("nyc_taxi.four_queries", scale=SCALE)
    cell.config = copy.deepcopy(cell.config)
    # a few absurd distances and passenger counts a day, as a full day
    # holds
    cell.config["assumed"]["trip_distance_absurd_share"] = 2e-3
    cell.config["assumed"]["passenger_count_beyond_share"] = 2e-3
    if absurd_log10 is not None:
        cell.config["assumed"]["trip_distance_absurd_log10"] = absurd_log10
    return cell


def _load(tmp_path_factory, cell):
    dep = cell.gen.generate(cell.config, SEED, 0)
    root = str(tmp_path_factory.mktemp("nyc_taxi"))
    return dep, bench.Daemon(cell, dep, root, "cpu", lambda s: None)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    cell = _cell()
    dep, daemon = _load(tmp_path_factory, cell)
    try:
        yield cell, dep, daemon
    finally:
        daemon.stop()


def _ask(svc, cell, name):
    resp = svc.handle_aql({"queries": [cell.queries[name]["aql"]],
                           "verbose": 1})
    assert not resp.get("errors"), resp
    return resp["results"][0], resp["context"][0]


@pytest.mark.parametrize("name", QUERIES)
def test_the_four_queries_answer_as_the_reference(loaded, name):
    cell, dep, daemon = loaded
    svc = QueryService(daemon.ms, device="cpu")
    got, stats = _ask(svc, cell, name)
    spec = cell.queries[name]["spec"]
    want = RE.answer(spec, dep.rows, dep.now)
    c = RE.compare(spec, got, want)
    assert c["group_mismatch"] == 0 and c["count_mismatch"] == 0, c
    assert c["sum_rel_err"] < cell.traffic["limits"]["sum_rel_err"], c
    assert stats["batches"] == cell.config["days_held"] + 1  # + the write head
    keyed = stats["sortBatches"]
    if name == "Q4":
        assert keyed == stats["batches"]
        assert stats["sortExec"] > 0.0 and stats["sortMerge"] > 0.0
    else:
        assert keyed == 0 and stats["sortExec"] == 0.0


def test_every_row_is_archived_in_a_day_batch_a_held_day(loaded):
    cell, dep, daemon = loaded
    shard = daemon.ms.get_table_shard(cell.config["table"]["name"])
    version = shard.archive_store.get_current_version()
    assert version.archiving_cutoff == dep.cutoff
    assert len(version.batches) == cell.config["days_held"]
    assert dep.n_archived == len(dep.rows)


def _q3_plan(daemon, cell):
    q = AQLQuery.from_json(cell.queries["Q3"]["aql"])
    return Compiler(daemon.ms.get_schemas()).compile(q)


def test_q3_without_a_time_filter_plans_dense_from_the_batch_stats(loaded):
    cell, dep, daemon = loaded
    plan = _q3_plan(daemon, cell)
    assert plan.from_ts is None and plan.to_ts is None
    t = dep.rows.columns["pickup_datetime"]
    day = (int(t[0]), int(t[cell.config["rows_per_day"] - 1]))
    assert D.plan_dense(plan, {}) is None       # no time stats, no domain
    dense = D.plan_dense(plan, {(0, 0): day})
    assert dense is not None
    passengers, years = dense.domains
    assert passengers.size == 256 and years.kind == "lookup"
    assert RE.day_seconds("2009-01-01") in years.values.tolist()
    assert dense.n_slots == 257 * (years.size + 1)
    assert (0, 0) in X.ShardExecutor._dense_stat_keys(plan)


def _stale_time_stats(monkeypatch):
    """Each batch's time-column stats two years before its rows."""
    real = X.ShardExecutor._column_stat

    def stale(self, stats, stat_keys, cid, *args):
        real(self, stats, stat_keys, cid, *args)
        if cid == 0 and (0, 0) in stats:
            lo, hi = stats[(0, 0)]
            stats[(0, 0)] = (lo - 2 * YEAR, hi - 2 * YEAR)

    monkeypatch.setattr(X.ShardExecutor, "_column_stat", stale)


def test_stale_time_stats_overflow_and_rerun_on_the_sort_route(
        loaded, monkeypatch):
    cell, dep, daemon = loaded
    fresh, fresh_stats = _ask(QueryService(daemon.ms, device="cpu"), cell,
                              "Q3")
    assert fresh_stats["overflowReruns"] == 0
    _stale_time_stats(monkeypatch)
    got, stats = _ask(QueryService(daemon.ms, device="cpu"), cell, "Q3")
    # every archive day overflows; the write head's rows all lie before
    # the live cutoff, so none of them can
    days = cell.config["days_held"]
    assert stats["overflowReruns"] == stats["sortBatches"] == days
    assert RE.flatten(got) == RE.flatten(fresh)
    assert any(int(k[0]) >= 128 for k in RE.flatten(got))


@pytest.mark.parametrize("name,value,lane", [
    ("Uint8", 200, torch.int32), ("SmallEnum", 255, torch.int32),
    ("Uint16", 40000, torch.int32), ("Uint32", 3_000_000_000, torch.int64),
    ("Uint32", 3_000_000_000, torch.int32), ("Int8", -5, torch.int32),
    ("Int16", -300, torch.int32), ("Int32", -7, torch.int32)])
def test_an_exact_group_key_reads_back_its_type_s_value(name, value, lane):
    """A keyed table's dim, unpacked from an exact key, reads as its
    type's value: zero-extended where the type is unsigned and its lane
    wider (a passenger_count of 200, a year start past 2038),
    sign-extended where the type is signed; a lane of the type's own
    width keeps the bits it held."""
    t = dt.data_type_from_string(name)
    held = torch.tensor([value], dtype=torch.int64).to(lane)
    dim = K._Val(held, torch.ones(1, dtype=torch.bool))
    one = torch.ones(1, dtype=torch.bool)
    keys = K.pack_dim_keys([dim], [t], one)
    (vals,), _ = K.unpack_dim_keys(keys, [dim], [t], one)
    assert vals.dtype == lane
    own_width = name == "Uint32" and lane == torch.int32
    assert int(vals[0]) == (int(held[0]) if own_width else value)


def _counter(name):
    return M.root().snapshot()["counters"].get(name, 0)


def test_the_sort_route_counts_its_batches_and_ladder_reruns_on_metrics(
        loaded, monkeypatch):
    """A capacity below Q4's groups a day: every archive day climbs the
    ladder once (the write head holds no row in range), and the answer
    stands."""
    cell, dep, daemon = loaded
    monkeypatch.setattr(X, "DEFAULT_GROUP_CAPACITY", 16)
    sorts0 = _counter(M.QUERY_SORT_BATCHES)
    ladder0 = _counter(M.QUERY_LADDER_RERUNS)
    got, stats = _ask(QueryService(daemon.ms, device="cpu"), cell, "Q4")
    assert stats["sortBatches"] == stats["batches"]
    assert stats["ladderReruns"] == cell.config["days_held"]
    assert _counter(M.QUERY_SORT_BATCHES) - sorts0 == stats["sortBatches"]
    assert _counter(M.QUERY_LADDER_RERUNS) - ladder0 == stats["ladderReruns"]
    spec = cell.queries["Q4"]["spec"]
    c = RE.compare(spec, got, RE.answer(spec, dep.rows, dep.now))
    assert c["group_mismatch"] == 0 and c["count_mismatch"] == 0, c


def test_the_new_encoding_decodes_exactly(loaded):
    """Int8, Int16, BigEnum and GeoPoint go to the frozen encoder as
    lanes of their width; the port reads back every column's values,
    nulls and type."""
    cell, dep, _ = loaded
    idx = np.arange(0, 3000, 7)
    batch = UpsertBatch(N.encode(cell.config, dep.rows, idx))
    types = {c["name"]: c["type"] for c in cell.config["table"]["columns"]}
    assert batch.num_rows == len(idx)
    for cid, col in enumerate(batch.columns):
        name = cell.config["table"]["columns"][cid]["name"]
        assert col.data_type == dt.data_type_from_string(types[name])
        want = dep.rows.columns[name][idx]
        valid = dep.rows.valid.get(name)
        if valid is not None:
            assert np.array_equal(col.validity, valid[idx])
            keep = valid[idx].reshape((-1,) + (1,) * (want.ndim - 1))
            want = np.where(keep, want, 0)
        assert np.array_equal(np.asarray(col.values).view(want.dtype), want)


def _jax_answers(cell, dep, root, names):
    """{query: the JAX package's answer} over the same upserts, ingested
    by its own TableShard and archived by its own Archiver."""
    schema = JTableSchema(JTable.from_json(cell.config["table"]))
    for col, cases in cell.config["enums"].items():
        schema.extend_enum(col, cases)
    meta, disk = JMeta(root), JDisk(root)
    shard = JTableShard(schema, diskstore=disk, metastore=meta)
    for blob in dep.upserts():
        shard.save_upsert_batch(JUpsertBatch(blob))
    assert JArchiver(shard, meta, disk).archive(dep.cutoff) \
        .rows_archived == len(dep.rows)
    store = Store(shard, schema)
    svc = JQueryService(store)
    # a kernel cache of its own, so interpret-mode kernels stay here
    svc.executor = JX.ShardExecutor(store, kernel_cache=JK.KernelCache())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ARES_FUSED", "interp")
        for name in names:
            resp = svc.handle_aql({"queries": [cell.queries[name]["aql"]]})
            assert not resp.get("errors"), resp
            out[name] = resp["results"][0]
    return out


@pytest.fixture(scope="module")
def jax_answers(loaded, tmp_path_factory):
    cell, dep, _ = loaded
    return _jax_answers(cell, dep, str(tmp_path_factory.mktemp("jax")),
                        QUERIES)


def _dim_types(cell, name):
    cols = {c["name"]: c["type"] for c in cell.config["table"]["columns"]}
    return [cols[d["sqlExpression"]]
            for d in cell.queries[name]["aql"]["dimensions"]]


def _as_typed(cell, name, answer) -> dict:
    """The JAX package's answer, flattened, its Uint8 keys read as their
    type's value."""
    kinds = _dim_types(cell, name)
    out = {}
    for key, v in RE.flatten(answer).items():
        out[tuple(str(int(k) % 256) if t == "Uint8" else k
                  for k, t in zip(key, kinds))] = v
    return out


def _assert_as_jax(cell, name, got, jax_answer):
    spec = cell.queries[name]["spec"]
    c = RE.compare(spec, got, _as_typed(cell, name, jax_answer))
    assert c["group_mismatch"] == 0 and c["count_mismatch"] == 0, c
    assert c["sum_rel_err"] < cell.traffic["limits"]["sum_rel_err"], c


ROUTES = [(q, "planned") for q in QUERIES] + \
    [(q, "sort") for q in QUERIES] + [("Q3", "stale")]


@pytest.mark.parametrize("name,route", ROUTES)
def test_the_four_queries_answer_as_the_jax_package(
        loaded, jax_answers, monkeypatch, name, route):
    """The port on its planned routes, on the sort route for every batch
    (no dense plan), and with stale time stats (query 3's overflow
    reruns), against the JAX package's answer: groups and counts exact,
    averages within the cell's limit. The JAX package answers query 3 on
    its keyed route, with passenger counts of 128 and more sign-extended."""
    cell, dep, daemon = loaded
    if route == "sort":
        monkeypatch.setattr(X, "plan_dense", lambda *a, **k: None)
    elif route == "stale":
        _stale_time_stats(monkeypatch)
    got, stats = _ask(QueryService(daemon.ms, device="cpu"), cell, name)
    if route == "sort":
        assert stats["sortBatches"] == stats["batches"]
    elif route == "stale":
        assert stats["overflowReruns"] == cell.config["days_held"]
    _assert_as_jax(cell, name, got, jax_answers[name])
    if name != "Q1":    # Q1 groups by cab_type
        assert any(int(k[0]) >= 128 for k in RE.flatten(got))
        raw = RE.flatten(jax_answers[name])
        assert any(int(k[0]) < 0 for k in raw) == (name == "Q3")


@pytest.fixture(scope="module")
def loaded_far(tmp_path_factory):
    """Distances of 10^6-10^7 miles, as the raw TLC files reach."""
    cell = _cell(absurd_log10=[6, 7])
    dep, daemon = _load(tmp_path_factory, cell)
    try:
        yield cell, dep, daemon
    finally:
        daemon.stop()


def test_q4_at_millions_of_miles_takes_the_same_route_and_answers_as_jax(
        loaded, loaded_far, tmp_path_factory):
    """Query 4's keys are hashed (its three dims pass 64 bits whatever
    the distances) and every batch takes the sort route, at 10^2-10^5
    miles as at 10^6-10^7; there the port agrees with the JAX package."""
    cell, dep, daemon = loaded_far
    plan = Compiler(daemon.ms.get_schemas()).compile(
        AQLQuery.from_json(cell.queries["Q4"]["aql"]))
    assert not K.pack_modes([K._packing_type(d)
                             for d in plan.dimensions])[0]
    miles = dep.rows.columns["trip_distance"]
    assert miles.max() >= 1e6
    routes = []
    for c, d in ((loaded[0], loaded[2]), (cell, daemon)):
        got, stats = _ask(QueryService(d.ms, device="cpu"), c, "Q4")
        routes.append((stats["sortBatches"] == stats["batches"],
                       stats["overflowReruns"]))
    assert routes == [(True, 0), (True, 0)]
    want = _jax_answers(cell, dep, str(tmp_path_factory.mktemp("jax_far")),
                        ["Q4"])["Q4"]
    _assert_as_jax(cell, "Q4", got, want)
    assert max(int(k[2]) for k in RE.flatten(got)) >= 10 ** 6
