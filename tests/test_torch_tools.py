"""The port's tools that run no query path: `utils/gorand.py` and
`utils/racetool.py`.

`GoRand` must give the JAX package's streams for several seeds, and seed
1 Go's own first Int63, 5577006791947779410. `racetool` must find a
lock-order cycle, pass a consistent order and work under a Condition, as
tests/test_race_harness.py holds the JAX package's; and its lifecycle
storm (ingest, archive, backfill and count queries under chaos) runs on
the port's MemStore, Archiver and LocalDiskStore copies, with the port's
QueryService on the CPU reading.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from aresdb_tpu.utils.gorand import GoRand as JaxGoRand
# imported before any racetool.instrument(): torch's import makes the
# multiprocessing resource tracker's lock, which must stay a plain one
from aresdb_tpu_torch.query.service import QueryService
from aresdb_tpu_torch.utils import racetool
from aresdb_tpu_torch.utils.gorand import GoRand

GO_SEED1_INT63 = 5577006791947779410


@pytest.mark.parametrize("seed", (0, 1, 7, 42, -3, 89482311, 2**40 + 5))
def test_gorand_streams_equal_the_jax_packages(seed):
    want, got = JaxGoRand(seed), GoRand(seed)
    for draw, args in (("int63", ()), ("uint64", ()), ("int31", ()),
                       ("int63n", (86400,)), ("int63n", (1 << 20,)),
                       ("int31n", (1000,)), ("intn", (7,)),
                       ("intn", (2**40,)), ("float64", ())):
        w = [getattr(want, draw)(*args) for _ in range(300)]
        assert [getattr(got, draw)(*args) for _ in range(300)] == w, draw


def test_gorand_seed_1_is_gos():
    assert GoRand(1).int63() == GO_SEED1_INT63


def test_gorand_refuses_a_bound_below_one_alike():
    for draw in ("int63n", "int31n", "intn"):
        with pytest.raises(ValueError) as want:
            getattr(JaxGoRand(1), draw)(0)
        with pytest.raises(ValueError) as got:
            getattr(GoRand(1), draw)(0)
        assert str(got.value) == str(want.value)


def test_lock_order_inversion_detected():
    racetool.reset()
    with racetool.instrument():
        a = threading.Lock()
        b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for target in (t1, t2):
        th = threading.Thread(target=target)
        th.start()
        th.join()
    with pytest.raises(AssertionError, match="potential deadlock"):
        racetool.check()
    racetool.reset()


def test_a_three_lock_cycle_is_detected():
    racetool.reset()
    with racetool.instrument():
        locks = [threading.Lock() for _ in range(3)]
    for i in range(3):
        with locks[i]:
            with locks[(i + 1) % 3]:
                pass
    with pytest.raises(AssertionError, match="potential deadlock"):
        racetool.check()
    racetool.reset()


def test_consistent_order_passes():
    racetool.reset()
    with racetool.instrument():
        a = threading.Lock()
        b = threading.RLock()
    for _ in range(3):
        with a:
            with b:
                with b:
                    pass
    racetool.check()
    racetool.reset()


def test_condition_compatible_with_instrumented_lock():
    racetool.reset()
    with racetool.instrument():
        lk = threading.RLock()
    cond = threading.Condition(lk)
    hit = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hit.append(1)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert hit == [1]
    racetool.reset()


DAY = 86400
BASE_T = 1_600_000_000 - (1_600_000_000 % DAY)
NOW = BASE_T + 3 * DAY
SCHEMA = {
    "name": "race_trips",
    "columns": [{"name": "ts", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [0],
    "isFactTable": True,
    "config": {"batchSize": 256, "recordRetentionInDays": 0},
}


def _batch(ids, ts, fares):
    from aresdb_tpu_torch.common import data_types as dt
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      build_columnar_upsert)

    return UpsertBatch(build_columnar_upsert([
        (0, dt.Uint32, np.asarray(ts, np.uint32), None, 0),
        (1, dt.Uint32, np.asarray(ids, np.uint32), None, 0),
        (2, dt.Float32, np.asarray(fares, np.float32), None, 0)], len(ids)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lifecycle_storm_under_chaos_on_the_ports_store(seed, tmp_path):
    """tests/test_race_harness.py's storm over the port's copies: exact
    final count, reader counts never above the total, no exception, and
    no lock-order cycle in the storage engine."""
    racetool.reset()
    with racetool.instrument():
        from aresdb_tpu_torch.common.schema import Table
        from aresdb_tpu_torch.diskstore.local_diskstore import \
            LocalDiskStore
        from aresdb_tpu_torch.memstore.archiving import Archiver
        from aresdb_tpu_torch.memstore.memstore import MemStore
        from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore

        ms = MemStore(DiskMetaStore(str(tmp_path)),
                      LocalDiskStore(str(tmp_path)))
        ms.create_table(Table.from_json(SCHEMA))
        ms.init_shards()
    shard = ms.get_table_shard("race_trips")
    svc = QueryService(ms, device="cpu")
    arch = Archiver(shard, ms.metastore, ms.diskstore)
    count = {"queries": [{"table": "race_trips", "now": NOW,
                          "measures": [{"sqlExpression": "count(*)"}]}]}

    rng = np.random.RandomState(100 + seed)
    stop = threading.Event()
    errors, counts = [], []
    n_rounds, chunk = 12, 200
    total_rows = n_rounds * chunk

    def ingester():
        try:
            for r in range(n_rounds):
                ids = np.arange(r * chunk, (r + 1) * chunk)
                ts = BASE_T + rng.randint(0, 2 * DAY, chunk)
                shard.save_upsert_batch(_batch(ids, ts, rng.rand(chunk)))
        except Exception as e:  # noqa: BLE001
            errors.append(("ingest", e))

    def archiver():
        try:
            for i in range(4):
                arch.archive(BASE_T + DAY // 2 * (i + 1))
                time.sleep(0.01)
            arch.backfill()
        except Exception as e:  # noqa: BLE001
            errors.append(("archive", e))

    def reader():
        try:
            while not stop.is_set():
                resp = svc.handle_aql(count)
                if "errors" in resp:
                    errors.append(("query", resp["errors"]))
                    return
                counts.append(sum(resp["results"][0].values() or [0.0]))
        except Exception as e:  # noqa: BLE001
            errors.append(("reader", e))

    try:
        with racetool.chaos(seed=seed, p_sleep=0.02, max_sleep=5e-5):
            threads = [threading.Thread(target=f, name=n)
                       for n, f in [("ingest", ingester),
                                    ("arch", archiver), ("read", reader)]]
            for t in threads:
                t.start()
            threads[0].join(timeout=120)
            threads[1].join(timeout=120)
            stop.set()
            threads[2].join(timeout=120)

        assert not errors, errors
        assert counts and all(c <= total_rows for c in counts), max(counts)
        arch.backfill()
        final = svc.handle_aql(count)
        assert sum(final["results"][0].values()) == total_rows
        racetool.check()
    finally:
        racetool.reset()
        ms.host_memory_manager.stop()
        ms.redolog_master.stop_all()
