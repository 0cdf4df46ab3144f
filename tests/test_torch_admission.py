"""Admission and the query deadline of the port, against the JAX package.

estimate_query_memory is host code of the plan and the store: on the same
upserts (and the same archived day) it must equal the JAX package's
byte for byte for every plan kind. The gate (DeviceMemoryManager) and the
deadline mirror tests/test_admission.py; the multi-device DevicePool
has its own tests in test_torch_device_pool.py.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from aresdb_tpu.common.schema import Table as JaxTable
from aresdb_tpu.common.upsert_batch import UpsertBatch as JaxUpsertBatch
from aresdb_tpu.diskstore.local_diskstore import \
    LocalDiskStore as JaxDiskStore
from aresdb_tpu.memstore.archiving import Archiver as JaxArchiver
from aresdb_tpu.memstore.memstore import MemStore as JaxMemStore
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JaxMetaStore
from aresdb_tpu.query import admission as JA
from aresdb_tpu.query.aql import AQLQuery as JaxAQLQuery
from aresdb_tpu.query.compiler import Compiler as JaxCompiler
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                  build_columnar_upsert)
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.archiving import Archiver
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.query import admission as A
from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import Compiler
from aresdb_tpu_torch.query.service import QueryService

NOW = 1_600_000_000
DAY = 86400
FACT = {
    "name": "adm_trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "uuid", "type": "UUID"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 1000, "recordRetentionInDays": 0}}
DIM = {
    "name": "adm_cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "population", "type": "Uint32"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 64}}


def _q(measure, dims=(), **extra):
    return {"table": "adm_trips", "now": NOW,
            "measures": [{"sqlExpression": measure}],
            "dimensions": [{"sqlExpression": d} for d in dims], **extra}


PLANS = {
    "dense": _q("sum(fare)", ["city_id"]),
    "keyed": _q("sum(fare)", ["id % 997", "city_id"]),
    "join": _q("count(*)", ["c.population"],
               joins=[{"table": "adm_cities", "alias": "c",
                       "conditions": ["c.id = city_id"]}]),
    "hll": _q("countdistincthll(id)", ["city_id"]),
    "listing": {"table": "adm_trips", "now": NOW,
                "measures": [{"sqlExpression": "1"}],
                "dimensions": [{"sqlExpression": "fare"},
                               {"sqlExpression": "uuid"}], "limit": 10},
    "time filter": _q("count(*)", timeFilter={
        "column": "request_at", "from": "6 hours ago"}),
}
COUNT_Q = PLANS["time filter"]


def _upserts(n=2500):
    rng = np.random.RandomState(3)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    trips = build_columnar_upsert(
        [(0, mdt.Uint32, (NOW - 1 - rng.randint(0, 2 * DAY, n))
          .astype(np.uint32), None, 0),
         (1, mdt.Uint32, keys.astype(np.uint32), None, 0),
         (2, mdt.Uint16, rng.randint(0, 40, n).astype(np.uint16), None, 0),
         (3, mdt.UUID, np.stack([keys, keys * np.uint64(7919)], 1), None,
          0),
         (4, mdt.Float32, (rng.rand(n) * 50).astype(np.float32),
          rng.rand(n) > 0.05, 0)], n, arrival_time=NOW)
    cities = build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(40, dtype=np.uint16), None, 0),
         (1, mdt.Uint32, np.arange(40, dtype=np.uint32) * 1000, None, 0)],
        40, arrival_time=NOW)
    return trips, cities


def _stores(tmp_path, archived: bool):
    """The port's and the JAX package's MemStore over the same upserts,
    the first of the two days archived in both where asked."""
    trips, cities = _upserts()
    out = []
    for pkg in ("port", "jax"):
        root = str(tmp_path / pkg)
        if pkg == "port":
            ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
            tables, batch, archiver = (Table, UpsertBatch, Archiver)
        else:
            ms = JaxMemStore(JaxMetaStore(root), JaxDiskStore(root))
            tables, batch, archiver = (JaxTable, JaxUpsertBatch,
                                       JaxArchiver)
        for schema in (FACT, DIM):
            ms.create_table(tables.from_json(schema))
        ms.init_shards()
        ms.handle_ingestion("adm_trips", 0, batch(trips))
        ms.handle_ingestion("adm_cities", 0, batch(cities))
        if archived:
            archiver(ms.get_table_shard("adm_trips"), ms.metastore,
                     ms.diskstore).archive(NOW - DAY)
        out.append(ms)
    return out


@pytest.fixture
def store(tmp_path):
    """The port's MemStore alone, nothing archived."""
    ms, jms = _stores(tmp_path, archived=False)
    yield ms
    for m in (ms, jms):
        m.host_memory_manager.stop()
        m.redolog_master.stop_all()


@pytest.mark.parametrize("archived", [False, True],
                         ids=["live", "archived"])
@pytest.mark.parametrize("kind", list(PLANS))
def test_estimate_equals_the_jax_packages(tmp_path, kind, archived):
    ms, jms = _stores(tmp_path, archived)
    try:
        q = PLANS[kind]
        plan = Compiler(ms.get_schemas()).compile(AQLQuery.from_json(q))
        jplan = JaxCompiler(jms.get_schemas()).compile(
            JaxAQLQuery.from_json(q))
        got = A.estimate_query_memory(plan, ms)
        assert got == JA.estimate_query_memory(jplan, jms)
        if kind == "hll":
            assert got == A.HLL_QUERY_REQUIRED_BYTES
        else:
            assert 0 < got < 1 << 20
    finally:
        for m in (ms, jms):
            m.host_memory_manager.stop()
            m.redolog_master.stop_all()


def test_over_budget_rejected_immediately():
    mgr = A.DeviceMemoryManager(total_bytes=1000, utilization=1.0)
    t0 = time.perf_counter()
    with pytest.raises(A.AdmissionError, match="budget"):
        mgr.reserve(2000, timeout=30)
    assert time.perf_counter() - t0 < 1.0


def test_reserve_blocks_until_release():
    mgr = A.DeviceMemoryManager(total_bytes=1000, utilization=1.0)
    mgr.reserve(800)
    order = []

    def second():
        mgr.reserve(800, timeout=10)
        order.append("admitted")
        mgr.release(800)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.2)
    assert order == []
    assert mgr.stats()["waiting"] == 1
    mgr.release(800)
    t.join(timeout=5)
    assert not t.is_alive() and order == ["admitted"]
    assert mgr.stats()["inUseBytes"] == 0


def test_reserve_timeout():
    mgr = A.DeviceMemoryManager(total_bytes=1000, utilization=1.0)
    mgr.reserve(900)
    with pytest.raises(A.AdmissionError, match="timed out"):
        mgr.reserve(900, timeout=0.2)
    mgr.release(900)
    assert mgr.stats() == {"budgetBytes": 1000, "inUseBytes": 0,
                           "running": 0, "waiting": 0}


def test_concurrent_oversized_queries_serialize(store):
    """Four queries each estimated at more than half the budget queue and
    run one at a time; none fails."""
    plan = Compiler(store.get_schemas()).compile(
        AQLQuery.from_json(COUNT_Q))
    est = A.estimate_query_memory(plan, store)
    mgr = A.DeviceMemoryManager(total_bytes=int(est * 1.5), utilization=1.0,
                                default_timeout=30)
    svc = QueryService(store, device="cpu", device_manager=mgr)
    want = svc.handle_aql({"queries": [COUNT_Q]})
    peak, results = [], []

    def run():
        results.append(svc.handle_aql({"queries": [COUNT_Q]}))
        peak.append(mgr.stats()["running"])

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert results == [want] * 4 and "errors" not in want
    assert max(peak) <= 1
    assert mgr.stats()["inUseBytes"] == 0


def test_query_timeout_expired(store):
    svc = QueryService(store, device="cpu", query_timeout=1e-9)
    r = svc.handle_aql({"queries": [COUNT_Q]})
    assert r["errors"] == ["query timed out"]
    r = svc.handle_sql({"queries": [
        f"SELECT count(*) FROM adm_trips WHERE aql_now(request_at, {NOW})"]})
    assert r["errors"] == ["query timed out"]


def test_query_timeout_generous_passes(store):
    r = QueryService(store, device="cpu", query_timeout=300).handle_aql(
        {"queries": [COUNT_Q]})
    assert "errors" not in r
    assert r == QueryService(store, device="cpu").handle_aql(
        {"queries": [COUNT_Q]})


@pytest.mark.parametrize("fault", ["compile", "deadline"])
def test_admission_released_on_query_error(store, fault):
    """A query that fails before admission (an unknown column) or after
    it (past its deadline, in the executor) leaves nothing reserved."""
    mgr = A.DeviceMemoryManager(total_bytes=1 << 40, utilization=1.0)
    if fault == "compile":
        svc = QueryService(store, device="cpu", device_manager=mgr)
        q = _q("sum(no_such_col)")
    else:
        svc = QueryService(store, device="cpu", device_manager=mgr,
                           query_timeout=1e-9)
        q = COUNT_Q
    r = svc.handle_aql({"queries": [q]})
    assert r.get("errors")
    assert mgr.stats()["inUseBytes"] == 0 and mgr.stats()["running"] == 0


def test_admission_errors_are_answers_on_every_route(store):
    """A budget below a query's estimate answers an error in the AQL, SQL
    and application/hll responses alike; the verbose context of an
    admitted query carries memoryRequired."""
    from aresdb_tpu_torch.query import hll_wire as W

    small = QueryService(store, device="cpu", device_manager=(
        A.DeviceMemoryManager(total_bytes=1000, utilization=1.0)))
    r = small.handle_aql({"queries": [COUNT_Q]})
    assert "budget" in r["errors"][0]
    r = small.handle_sql({"queries": [
        f"SELECT count(*) FROM adm_trips WHERE aql_now(request_at, {NOW})"]})
    assert "budget" in r["errors"][0]
    frame = small.handle_aql_hll({"queries": [PLANS["hll"]]})
    assert b"budget" in frame and frame[:4] == W.HLLQueryResults(
        ).get_bytes()[:4]
    big = QueryService(store, device="cpu", device_manager=(
        A.DeviceMemoryManager(total_bytes=1 << 40, utilization=1.0)))
    r = big.handle_aql({"queries": [COUNT_Q], "verbose": True})
    plan = Compiler(store.get_schemas()).compile(AQLQuery.from_json(COUNT_Q))
    assert r["context"][0]["memoryRequired"] == A.estimate_query_memory(
        plan, store)
    assert r["context"][0]["memoryRequired"] >= \
        r["context"][0]["peakBatchStagedBytes"] > 0


def test_device_memory_budget(monkeypatch):
    """ARES_DEVICE_MEMORY overrides; a cpu device takes 16 GiB; the
    default device is cuda, which this machine lacks."""
    monkeypatch.delenv("ARES_DEVICE_MEMORY", raising=False)
    assert A.device_memory_budget(0.95, "cpu") == int((16 << 30) * 0.95)
    assert A.DeviceMemoryManager(utilization=0.5, device="cpu").budget == \
        8 << 30
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        A.device_memory_budget()
    monkeypatch.setenv("ARES_DEVICE_MEMORY", str(1 << 30))
    assert A.device_memory_budget(0.95) == int((1 << 30) * 0.95)
    assert A.DeviceMemoryManager(device="cpu").budget == int(
        (1 << 30) * 0.95)
    assert A.device_memory_budget(1.5, "cpu") == int((1 << 30) * 0.95)


def test_a_cards_memory_splits_between_the_column_cache_and_admission(
        monkeypatch):
    """On a CUDA device the column cache takes DEVICE_CACHE_SHARE of the
    card's total memory (torch.cuda.mem_get_info, as the admission budget
    reads it) and the admission budget the rest of its 0.95, so that the
    two together stay within the card; each cached device holds its own
    budget, least recently used entries out first; `cpu` keeps 4 GiB."""
    import torch

    from aresdb_tpu_torch.query import executor as X

    total = 80 << 30
    monkeypatch.delenv("ARES_DEVICE_MEMORY", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (total // 2, total))
    card = torch.device("cuda", 0)
    assert A.DEVICE_CACHE_SHARE == 0.25
    assert A.device_cache_budget(card) == total // 4
    assert A.device_cache_budget("cpu") == 4 << 30
    assert A._per_device_budget(card, 0.95, 0) == \
        int(total * 0.95) - total // 4
    assert A._per_device_budget(card, 0.95, 0) + \
        A.device_cache_budget(card) <= total
    cache = X.DeviceColumnCache()
    assert cache.budget(card) == total // 4
    assert cache.budget(torch.device("cpu")) == 4 << 30
    # a budget of two entries' bytes on the card: the third staged evicts
    # the least recently used, and the cpu's entries are not the card's
    monkeypatch.setattr(A, "DEVICE_CACHE_SHARE", 2 * 4096 / total)
    cache = X.DeviceColumnCache()
    one = lambda: (torch.zeros(1024, dtype=torch.float32),)  # noqa: E731
    for key in ("a", "b"):
        cache.get_or_stage(card, (key,), one)
    cache.get_or_stage(torch.device("cpu"), ("c",), one)
    cache.get_or_stage(card, ("a",), one)      # a hit: "b" is now oldest
    cache.get_or_stage(card, ("d",), one)
    assert sorted(cache._entries) == [("cpu", "c"), ("cuda:0", "a"),
                                      ("cuda:0", "d")]
    assert cache.stats() == {"entries": 3, "bytes": 3 * 4096, "hits": 1,
                             "misses": 4}
