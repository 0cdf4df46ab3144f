"""Query-level multi-device placement of the port (admission.DevicePool)
against the JAX package's.

One counterpart for each test of tests/test_device_pool.py, the port's
pool over a list of `cpu` devices where the JAX package's runs over its
8 host devices: most-free-first placement, the over-budget early exit,
the FIFO wait, the timeout, `preferred` (`?device=`), the lease entering
its device, and concurrent queries through QueryService each on a lease
of its own, answering as the JAX package does. The pool's `stats()` keys
equal the JAX package's, and `/dbg/devices` shows a server's pool.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.request

import pytest
import torch

from aresdb_tpu.query import admission as JA
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.query import admission as A
from aresdb_tpu_torch.query.admission import AdmissionError, DevicePool
from aresdb_tpu_torch.query.service import QueryService
from aresdb_tpu_torch.utils import metrics as M
from tests.test_torch_admission import COUNT_Q, PLANS, _stores

CPU = torch.device("cpu")


def _pool(n=4, budget=1000):
    return DevicePool(devices=[CPU] * n, total_bytes=budget, utilization=1.0)


def _jax_pool(n=4, budget=1000):
    import jax

    return JA.DevicePool(devices=jax.local_devices()[:n], total_bytes=budget,
                         utilization=1.0)


def test_acquire_spreads_under_load():
    pool = _pool(4)
    leases = [pool.acquire(100) for _ in range(4)]
    assert sorted(lease.index for lease in leases) == [0, 1, 2, 3]
    st = pool.stats()
    assert all(d["running"] == 1 for d in st["devices"])
    for lease in leases:
        pool.release(lease.index, lease.nbytes)
    assert all(d["running"] == 0 for d in pool.stats()["devices"])
    # the JAX package's pool places the same sequence alike
    jpool = _jax_pool(4)
    assert [jpool.acquire(100).index for _ in range(4)] == \
        [lease.index for lease in leases]


def test_over_budget_rejected_immediately():
    pool = _pool(2, budget=100)
    with pytest.raises(AdmissionError, match="per-device budget"):
        pool.acquire(101)
    assert pool.stats()["waiting"] == 0


def test_waits_for_release_then_proceeds():
    pool = _pool(2, budget=100)
    l1 = pool.acquire(100)
    l2 = pool.acquire(100)  # second device
    assert (l1.index, l2.index) == (0, 1)
    got = {}

    def waiter():
        lease = pool.acquire(100, timeout=5)
        got["index"] = lease.index
        pool.release(lease.index, lease.nbytes)

    th = threading.Thread(target=waiter)
    th.start()
    deadline = time.time() + 5
    while pool.stats()["waiting"] != 1 and time.time() < deadline:
        time.sleep(0.01)
    assert pool.stats()["waiting"] == 1
    pool.release(l1.index, l1.nbytes)
    th.join(timeout=5)
    assert got["index"] == l1.index
    pool.release(l2.index, l2.nbytes)
    assert pool.stats()["waiting"] == 0


def test_timeout_raises_and_counts_a_failed_query():
    pool = _pool(1, budget=100)
    lease = pool.acquire(100)
    key = "query_failed{component=query}"
    failed = M.root().snapshot()["counters"].get(key, 0)
    with pytest.raises(AdmissionError, match="timed out"):
        pool.acquire(100, timeout=0.1)
    assert M.root().snapshot()["counters"][key] == failed + 1
    pool.release(lease.index, lease.nbytes)


def test_lease_enters_its_device_and_releases(monkeypatch):
    """The lease of a CUDA entry makes that device the thread's current
    one while it is held (torch.cuda.device, the port's counterpart of
    jax.default_device); a `cpu` entry enters nothing. Exiting releases
    the reservation either way."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(("enter", dev))
        yield
        entered.append(("exit", dev))

    monkeypatch.setattr(torch.cuda, "device", device)
    cuda1 = torch.device("cuda", 1)
    pool = DevicePool(devices=[torch.device("cuda", 0), cuda1],
                      total_bytes=1000, utilization=1.0)
    l0 = pool.acquire(10)
    with pool.acquire(10) as lease:  # second-least-loaded => device 1
        assert lease.index == 1 and lease.device == cuda1
        assert entered == [("enter", cuda1)]
    assert entered == [("enter", cuda1), ("exit", cuda1)]
    pool.release(l0.index, l0.nbytes)
    assert all(d["running"] == 0 for d in pool.stats()["devices"])
    entered.clear()
    cpu_pool = _pool(2)
    with cpu_pool.acquire(10) as lease:
        assert lease.device == CPU
    assert entered == []
    assert cpu_pool.stats()["devices"][0]["inUseBytes"] == 0


def test_query_service_places_concurrent_queries_on_distinct_devices(
        tmp_path, monkeypatch):
    """4 concurrent queries through each package's QueryService with a
    pool of 4 devices: every lease is served, each query's context names
    its device, every answer equals the JAX package's and the
    single-device one. Each of the port's queries waits, inside its
    lease, until all 4 have one, so the leases overlap: a short query
    could otherwise hand its lease back before the next thread takes
    one, and most-free-first placement would then reuse entry 0."""
    monkeypatch.setenv("ARES_FUSED", "interp")
    ms, jms = _stores(tmp_path, archived=False)
    try:
        # 16 GiB a device: an HLL query reserves 10 GiB
        pool = _pool(4, budget=1 << 34)
        svc = QueryService(ms, device="cpu", device_pool=pool,
                           admission_timeout=10)
        jpool = _jax_pool(4, budget=1 << 34)
        jsvc = JQueryService(jms, device_pool=jpool, admission_timeout=10)
        single = QueryService(ms, device="cpu").handle_aql(
            {"queries": [dict(COUNT_Q)]})
        n_threads = 4
        seen = {"port": [], "jax": []}
        errs = []
        held = threading.Barrier(n_threads, timeout=30)

        def holding(execute):
            def run(*args, **kwargs):
                out = execute(*args, **kwargs)
                held.wait()
                return out
            return run

        for side, service in (("port", svc), ("jax", jsvc)):
            barrier = threading.Barrier(n_threads)

            def run_one(service=service, side=side):
                try:
                    barrier.wait(timeout=10)
                    resp = service.handle_aql(
                        {"queries": [dict(COUNT_Q)], "verbose": True})
                    assert "errors" not in resp, resp
                    seen[side].append(resp)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            with pytest.MonkeyPatch.context() as mp:
                if side == "port":
                    for e in svc.pool_executors:
                        mp.setattr(e, "execute", holding(e.execute))
                threads = [threading.Thread(target=run_one)
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
        assert not errs, errs
        assert len(seen["port"]) == len(seen["jax"]) == n_threads
        for resp, jresp in zip(seen["port"], seen["jax"]):
            assert resp["results"] == jresp["results"] == single["results"]
        assert sorted(r["context"][0]["device"] for r in seen["port"]) == \
            [0, 1, 2, 3]
        # the JAX package writes its device before execute resets the
        # stats (ROADMAP section 3)
        assert all("device" not in r["context"][0] for r in seen["jax"])
        for p in (pool, jpool):
            st = p.stats()
            assert st["waiting"] == 0
            assert all(d["running"] == 0 and d["inUseBytes"] == 0
                       for d in st["devices"])
            assert sum(d["served"] for d in st["devices"]) == n_threads
        # every pool entry ran one query on an executor of its own
        assert [e.device for e in svc.pool_executors] == [CPU] * 4
        assert all(e._k_hints is svc.executor._k_hints
                   for e in svc.pool_executors)
        # a binary HLL frame takes a lease too
        frame = svc.handle_aql_hll({"queries": [PLANS["hll"]]})
        assert frame == jsvc.handle_aql_hll({"queries": [PLANS["hll"]]})
        assert b"requires" not in frame
        assert sum(d["served"] for d in pool.stats()["devices"]) == 5
    finally:
        for m in (ms, jms):
            m.host_memory_manager.stop()
            m.redolog_master.stop_all()


def test_preferred_device_honored_and_falls_back():
    """?device=N semantics (device_manager.go:193): the preferred device
    is used when its budget fits, otherwise placement falls back to
    most-free-first instead of failing."""
    pool = _pool(4, budget=1000)
    lease = pool.acquire(100, preferred=2)
    assert lease.index == 2
    # fill device 2 completely; preferring it now falls back elsewhere
    filler = pool.acquire(900, preferred=2)
    assert filler.index == 2
    spill = pool.acquire(100, preferred=2)
    assert spill.index != 2
    # out-of-range preference is ignored, not an error
    wild = pool.acquire(100, preferred=99)
    assert 0 <= wild.index < 4


def test_stats_keys_equal_the_jax_packages():
    pool, jpool = _pool(3), _jax_pool(3)
    lease, jlease = pool.acquire(100), jpool.acquire(100)
    st, jst = pool.stats(), jpool.stats()
    assert sorted(st) == sorted(jst)
    assert [sorted(d) for d in st["devices"]] == \
        [sorted(d) for d in jst["devices"]]
    for key in ("inUseBytes", "running", "served", "budgetBytes"):
        assert [d[key] for d in st["devices"]] == \
            [d[key] for d in jst["devices"]], key
    assert [d["platform"] for d in st["devices"]] == ["cpu"] * 3
    assert st["perDeviceBudgetBytes"] == jst["perDeviceBudgetBytes"] == 1000
    pool.release(lease.index, lease.nbytes)
    jpool.release(jlease.index, jlease.nbytes)


def test_budget_of_a_cpu_entry_is_the_fallback(monkeypatch):
    monkeypatch.delenv("ARES_DEVICE_MEMORY", raising=False)
    pool = DevicePool(devices=[CPU, CPU], utilization=0.5)
    assert pool.budgets == [A.CPU_MEMORY_BYTES // 2] * 2
    monkeypatch.setenv("ARES_DEVICE_MEMORY", str(1 << 30))
    assert DevicePool(devices=[CPU]).budget == int((1 << 30) * 0.95)


def test_dbg_devices_shows_an_injected_pool(tmp_path):
    from aresdb_tpu_torch.api.server import ApiServer
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore

    ms = MemStore(DiskMetaStore(str(tmp_path)),
                  LocalDiskStore(str(tmp_path)))
    srv = ApiServer(ms, port=0, device="cpu")
    # on the CPU the daemon builds no pool; a multi-GPU host would
    assert srv.ctx.device_pool is None
    port = srv.start_background()
    try:
        def get():
            with urllib.request.urlopen(
                    f"http://localhost:{port}/dbg/devices") as r:
                return json.loads(r.read())

        assert "pool" not in get()
        srv.ctx.device_pool = _pool(2)
        out = get()
        assert out["devices"] == [{"id": 0, "platform": "cpu",
                                   "kind": "cpu"}]
        assert out["pool"] == srv.ctx.device_pool.stats()
        assert len(out["pool"]["devices"]) == 2
    finally:
        srv.stop()
        ms.host_memory_manager.stop()
        ms.redolog_master.stop_all()
