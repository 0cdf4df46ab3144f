"""The smoke's drive phases on the CPU, and the faults they found.

`chip_smoke.py` runs the JAX package's deployments of `tools/drive_*.py`
on the card as phases of its own: phase_hundredm (drive_100m: a
MemStore under a host budget that evicts), phase_crash (drive_crash: a
SIGKILLed daemon), phase_rf2 (drive_rf2: replica factor 2, a node
killed), phase_migrate_live (drive_migrate_live: a shard moved under
ingest and archiving), phase_soak (drive_soak: writes, re-upserts,
queries and jobs at once) and phase_controller_ha (drive_controller_ha:
the leader of two controller processes SIGKILLed, then the other
SIGSTOPped, under a querier). Each runs here at a small size on `cpu`, its
own checks asserting inside it, with the kernel wrappers counting their
plain versions as launches (the `cpu_rehearsal` fixture of
test_torch_chip_smoke.py, imported). phase_hundredm's seven answers are held
against the JAX package's drive over the same rows, under the same
budget and the same tightening. Each test has a deadline of its own
(`_within`), and each phase kills the processes it starts.

The faults: a restart after a backfill lost the live rows of the redo
log before the backfill's checkpoint (the JAX package keeps that
fault), and an upsert to a shard that a datanode had listed but not yet
replayed shared the replay's write cursor.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import chip_smoke as S
from aresdb_tpu.common import data_types as jdt
from aresdb_tpu.common.schema import Table as JaxTable
from aresdb_tpu.common.upsert_batch import UpsertBatch as JaxUpsertBatch
from aresdb_tpu.common.upsert_batch import \
    build_columnar_upsert as jax_upsert
from aresdb_tpu.diskstore.local_diskstore import \
    LocalDiskStore as JaxDiskStore
from aresdb_tpu.memstore import archive_store as JAS
from aresdb_tpu.memstore.archiving import Archiver as JaxArchiver
from aresdb_tpu.memstore.memstore import MemStore as JaxMemStore
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JaxMetaStore
from aresdb_tpu.query.service import QueryService as JaxQueryService
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                  build_columnar_upsert)
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.archiving import Archiver
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from test_torch_chip_smoke import cpu_rehearsal  # noqa: F401 — a fixture

HUNDREDM_ROWS = 1 << 18
HUNDREDM_BATCH = 1 << 16
HUNDREDM_BUDGET = 1_000_000     # below the archive's 2 MB at this size
REL = 2.0 ** -17                # the reference's float sum error


def _within(deadline: float, fn, *args, **kw):
    """fn(*args, **kw) on a thread, failing the test unless it ends
    within `deadline` seconds; its exception is raised here."""
    out, err = [], []

    def run():
        try:
            out.append(fn(*args, **kw))
        except BaseException as e:  # noqa: BLE001 — raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(deadline)
    if t.is_alive():
        raise AssertionError(f"{fn.__name__} did not end within "
                             f"{deadline} s")
    if err:
        raise err[0]
    return out[0]


def _jax_hundredm(root: str) -> tuple:
    """tools/drive_100m.py's steps on the JAX package over the phase's
    rows (chip_smoke.hundredm_rows): the same budget, the Archiver after
    the second shape, the same tightening before the seventh. Returns
    ({shape: answer}, columns evicted)."""
    evicted = [0]
    real = JAS.ArchiveBatch.evict_column

    def evict_column(self, column_id):
        out = real(self, column_id)
        evicted[0] += bool(out)
        return out

    ms = JaxMemStore(JaxMetaStore(root), JaxDiskStore(root),
                     total_memory_bytes=HUNDREDM_BUDGET)
    JAS.ArchiveBatch.evict_column = evict_column
    try:
        ms.create_table(JaxTable.from_json(dict(
            S.HUNDREDM_SCHEMA_JSON, config={"batchSize": HUNDREDM_BATCH,
                                            "recordRetentionInDays": 0})))
        ms.init_shards()
        ms.get_schemas()["trips"].extend_enum("status", S.STATUSES)
        hmm = ms.host_memory_manager
        hmm.start()
        shard = ms.get_table_shard("trips")
        for ts, ids, city, status, fare in S.hundredm_rows(
                HUNDREDM_ROWS, S.HUNDREDM_SEED, HUNDREDM_BATCH):
            shard.save_upsert_batch(JaxUpsertBatch(jax_upsert(
                [(0, jdt.Uint32, ts, None, 0), (1, jdt.Uint32, ids, None, 0),
                 (2, jdt.Uint16, city, None, 0),
                 (3, jdt.SmallEnum, status, None, 0),
                 (4, jdt.Float32, fare, None, 0)], len(ids))))
        svc = JaxQueryService(ms)
        answers = {}
        for name, (q, env, _) in S.hundredm_queries().items():
            if name.startswith("archive") and not any(
                    a.startswith("archive") for a in answers):
                JaxArchiver(shard, ms.metastore, ms.diskstore).archive(
                    S.HUNDREDM_BASE + 4 * S.DAY)
            if name.endswith("after eviction"):
                hmm.total_memory_bytes = int(
                    hmm.get_reserved_memory() * S.HUNDREDM_TIGHTEN)
                hmm.trigger_eviction()
                time.sleep(0.5)
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                resp = svc.handle_aql({"queries": [q]})
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            assert "errors" not in resp, (name, resp)
            answers[name] = resp["results"][0]
        return answers, evicted[0]
    finally:
        JAS.ArchiveBatch.evict_column = real
        hmm.stop()
        ms.redolog_master.stop_all()


def test_phase_hundredm_evicts_and_answers_as_the_jax_package(
        cpu_rehearsal, monkeypatch, tmp_path, capsys):
    """262,144 rows in upserts of 65,536 under a 1 MB budget, below the
    archive's footprint: the seven shapes equal the numpy oracle inside
    the phase, with K1's launches on the live and archive shapes and K2's
    on the run-length shape asserted there; columns evict and reload; and
    the JAX package's drive over the same rows, under the same budget and
    tightening, gives the same seven answers (counts exactly, sums within
    2^-17)."""
    launches, _, port = _within(120, S.phase_hundredm, HUNDREDM_ROWS,
                                S.HUNDREDM_SEED, warm=1, device="cpu",
                                batch_rows=HUNDREDM_BATCH,
                                budget=HUNDREDM_BUDGET)
    out = capsys.readouterr().out
    assert "every shape equals the numpy oracle" in out
    evicted = int(out.split("hundredm: ")[-1].split(" columns evicted")[0])
    assert evicted >= 1
    # 4 live batches, then 1 live batch and 4 archive chunks: K1 on each
    # of both runs of the 5 dense shapes; K2 on the 4 run-length chunks
    # and on the 200k-group shape's live batch
    assert launches == {"K1": 2 * 4 * 2 + 3 * 2 * 5 + 2 * 1,
                        "K2": 2 * 4 + 2 * 1, "K3": 0}
    monkeypatch.delenv("ARES_FACTORED")
    monkeypatch.delenv("ARES_PALLAS")
    monkeypatch.setenv("ARES_FUSED", "interp")
    jax_answers, jax_evicted = _within(240, _jax_hundredm,
                                       str(tmp_path / "jax"))
    assert jax_evicted >= 1
    assert list(jax_answers) == list(port)
    for name, want in jax_answers.items():
        got, ref = S.flatten(port[name]), S.flatten(want)
        assert set(got) == set(ref), name
        for k, v in ref.items():
            if "count" in name:
                assert got[k] == v, (name, k)
            else:
                assert got[k] == pytest.approx(v, rel=REL), (name, k)


def test_phase_crash_holds_every_acked_row(capsys):
    """cmd.aresd on `cpu`, 4 acked upserts of 4,096 rows, a fifth in
    flight when the daemon is SIGKILLed: the restarted daemon holds every
    acked row (with the fifth, or without it) and takes 1,000 more."""
    got = _within(120, S.phase_crash, 0, device="cpu", upserts=4,
                  upsert_rows=4096, timeout=60)
    assert got["acked"] == 4 * 4096 and got["restart_s"] > 0
    out = capsys.readouterr().out
    assert "every acked row held" in out
    assert "1000 more rows counted" in out


def test_phase_rf2_answers_after_a_replica_is_killed(capsys):
    """Two datanode processes on `cpu` holding both shards at replica
    factor 2 (16,384 rows a shard): the broker's count and sum by id % 16
    equal the oracle, and again after dn0 is SIGKILLed."""
    got = _within(150, S.phase_rf2, 0, device="cpu", shard_rows=1 << 14,
                  timeout=60)
    assert 0 < got["failover_s"] <= S.RF2_FAILOVER_S
    assert "equal the oracle again" in capsys.readouterr().out


def test_phase_migrate_live_moves_a_shard_with_no_row_lost(cpu_rehearsal,
                                                          capsys):
    """dn0 in this process owning both shards under a writer and an
    archiving thread; dn1 joins and a rebalance moves a shard to it: the
    moved shard's rows on dn1 equal those on dn0 before with the rows
    acked between, below and at or above its cutoff, and the broker's
    count and sum equal the acks. On the parent tree the shard lost live
    rows on dn1 (both faults of this file)."""
    got = _within(120, S.phase_migrate_live, 0, device="cpu",
                  moves=S.MIGRATE_MOVES[:1], settle_s=1.0)
    assert len(got["moves"]) == 1 and got["acked"] > 0
    assert "no row lost or duplicated" in capsys.readouterr().out


def test_phase_controller_ha_fails_over_with_no_row_lost(cpu_rehearsal,
                                                         capsys):
    """Two controller processes in an election, dn0 and dn1 in this
    process on `cpu` (16,384 rows a shard): the querier counts no error
    and no wrong answer while the leader is SIGKILLed, rows are added,
    the killed one restarts and takes over from the other, SIGSTOPped;
    the paused controller answers a write 503 on waking, and the new
    leader lists the three tables. On the parent tree the promoted
    controller listed no datanode, and the querier's answers failed."""
    got = _within(150, S.phase_controller_ha, 0, device="cpu",
                  shard_rows=1 << 14, timeout=60)
    assert len(got["failover_s"]) == 2
    assert all(0 < s <= 30 for s in got["failover_s"])
    q = got["querier"]
    assert q["pairs"] > 0 and q["errors"] == 0 and q["wrong"] == 0
    out = capsys.readouterr().out
    assert "answers stale_write 503" in out
    assert "['cities', 'during_pause', 'trips']" in out


def test_phase_soak_meets_the_oracle(cpu_rehearsal, capsys):
    """8 s of writes, re-upserts of old ids, counts, joins and archiving,
    backfill and snapshot jobs at once against an ApiServer on `cpu`:
    no error, and the final count, sum and join equal the oracle."""
    got = _within(120, S.phase_soak, 0, device="cpu", seconds=8.0)
    assert got["rows"] > 0 and got["backfilled"] > 0
    assert got["cache"]["misses"] > 0
    assert "equals the unique acked ids" in capsys.readouterr().out


TABLE_T = {"name": "t", "columns": [
    {"name": "ts", "type": "Uint32"}, {"name": "id", "type": "Uint32"},
    {"name": "v", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 4096, "recordRetentionInDays": 0}}
NOW = 1_600_000_000


def _restart_after_backfill(root, pkg) -> tuple:
    """(live rows, archived rows) of t before and after a restart: 10
    live rows, 10 archived, then 5 late rows backfilled."""
    (MS, Meta, Disk, Tab, UB, build, dt, Arch) = pkg
    ms = MS(Meta(root), Disk(root))
    ms.create_table(Tab.from_json(TABLE_T))
    ms.init_shards()

    def upsert(ts, ids):
        n = len(ids)
        ms.handle_ingestion("t", 0, UB(build(
            [(0, dt.Uint32, np.full(n, ts, np.uint32), None, 0),
             (1, dt.Uint32, np.asarray(ids, np.uint32), None, 0),
             (2, dt.Float32, np.ones(n, np.float32), None, 0)], n)))

    def counts(store):
        sh = store.get_table_shard("t")
        version = sh.archive_store.get_current_version()
        live = sum(int((b.column(0).values[:n] >= version.archiving_cutoff)
                       .sum())
                   for _, n, b in sh.live_store.snapshot_columns([0]))
        return live, sum(b.size for b in version.batches.values())

    upsert(NOW - 100, range(10))                 # live
    upsert(NOW - 90_000, range(10, 20))          # archived next
    shard = ms.get_table_shard("t")
    Arch(shard, ms.metastore, ms.diskstore).archive(NOW - 86_400)
    upsert(NOW - 90_000, range(20, 25))          # late: the backfill queue
    assert Arch(shard, ms.metastore, ms.diskstore).backfill() == 5
    before = counts(ms)
    ms.host_memory_manager.stop()
    ms.redolog_master.stop_all()
    again = MS(Meta(root), Disk(root))
    again.fetch_schema()
    again.init_shards()
    after = counts(again)
    again.host_memory_manager.stop()
    again.redolog_master.stop_all()
    return before, after


def test_a_restart_after_a_backfill_keeps_the_live_rows_before_it(tmp_path):
    """The redo log replays from its first file left on disk; the
    batches up to the backfill progress requeue no late row (the
    backfill applied them). The JAX package replays from the backfill
    progress only, and the live rows of the batches before it are gone
    after the restart (ROADMAP section 3)."""
    port = _restart_after_backfill(
        str(tmp_path / "port"),
        (MemStore, DiskMetaStore, LocalDiskStore, Table, UpsertBatch,
         build_columnar_upsert, mdt, Archiver))
    assert port == ((10, 15), (10, 15))
    ref = _restart_after_backfill(
        str(tmp_path / "jax"),
        (JaxMemStore, JaxMetaStore, JaxDiskStore, JaxTable, JaxUpsertBatch,
         jax_upsert, jdt, JaxArchiver))
    assert ref == ((10, 15), (0, 15))


def test_an_upsert_waits_for_its_shards_replay(tmp_path, monkeypatch):
    """A datanode lists a bootstrapped shard before it replays the
    shard's redo log (MemStore.add_table_shard, then _recover_shard), so
    an upsert can reach the shard mid-replay; it waits on the shard's
    writer lock until the replay ends, and every row is there after."""
    root = str(tmp_path)
    ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
    ms.create_table(Table.from_json(TABLE_T))
    ms.init_shards()

    def batch(lo, n):
        return UpsertBatch(build_columnar_upsert(
            [(0, mdt.Uint32, np.full(n, NOW, np.uint32), None, 0),
             (1, mdt.Uint32, np.arange(lo, lo + n, dtype=np.uint32), None,
              0), (2, mdt.Float32, np.ones(n, np.float32), None, 0)], n))

    for i in range(4):
        ms.handle_ingestion("t", 0, batch(1000 * i, 1000))
    ms.host_memory_manager.stop()
    ms.redolog_master.stop_all()

    again = MemStore(DiskMetaStore(root), LocalDiskStore(root))
    again.fetch_schema()
    shard = again.add_table_shard("t", 0)
    replaying, resume = threading.Event(), threading.Event()
    real = shard.redolog_manager.iterate

    def iterate(*args):
        for i, item in enumerate(real(*args)):
            if i == 1:
                replaying.set()
                assert resume.wait(10)
            yield item

    monkeypatch.setattr(shard.redolog_manager, "iterate", iterate)
    replay = threading.Thread(target=again._recover_shard, args=(shard,))
    replay.start()
    assert replaying.wait(10)
    upsert = threading.Thread(
        target=again.handle_ingestion, args=("t", 0, batch(4000, 1000)))
    upsert.start()
    upsert.join(0.5)
    waited = upsert.is_alive()
    resume.set()
    replay.join(10)
    upsert.join(10)
    assert waited, "the upsert ran beside the replay"
    assert shard.live_store.rows_visible() == 5000
    again.host_memory_manager.stop()
    again.redolog_master.stop_all()
