"""The port's durable `MemStore` (redo log and recovery) against the JAX
package's.

Each package's `MemStore` takes the same upsert bytes through
`handle_ingestion` (one redo-log append each) into a fact table with a
GeoPoint and an array column and a zones dimension table, then archives
two of the fact table's three days. Both packages write the same redo-log
bytes. The port's store is then closed and recovered by a new `MemStore`
over the same directory (`fetch_schema`, `init_shards`: archive metadata
and cutoff, then the redo log replayed from the backfill progress), and a
JAX `MemStore` recovers from a copy of the port's directory. The
recovered port store answers every query exactly as before the restart,
and as the JAX package does over the same bytes.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.common.upsert_batch import UpsertBatchBuilder
from aresdb_tpu.diskstore.local_diskstore import LocalDiskStore as JDisk
from aresdb_tpu.memstore.archiving import Archiver as JArchiver
from aresdb_tpu.memstore.memstore import MemStore as JMemStore
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JMeta
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common.schema import Table as TTable
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch as TUpsertBatch
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore as TDisk
from aresdb_tpu_torch.memstore.archiving import Archiver as TArchiver
from aresdb_tpu_torch.memstore.memstore import MemStore as TMemStore
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore as TMeta
from aresdb_tpu_torch.query.service import QueryService as TQueryService

NOW = 1_600_000_000
DAY = 86400
BASE = NOW - NOW % DAY - 3 * DAY
CUTOFF = BASE + 2 * DAY
REL = 2.0 ** -17

TRIPS = {
    "name": "trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "fare", "type": "Float32"},
                {"name": "pickup", "type": "GeoPoint"},
                {"name": "tags", "type": "ArrayInt32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 512, "recordRetentionInDays": 0}}
ZONES = {"name": "zones",
         "columns": [{"name": "id", "type": "Uint16"},
                     {"name": "shape", "type": "GeoShape"}],
         "primaryKeyColumns": [0], "isFactTable": False,
         "config": {"batchSize": 16}}
ZJOIN = [{"table": "zones", "alias": "z",
          "conditions": ["geography_intersects(z.shape, pickup)"]}]
QUERIES = {
    "sum_by_city": {"measures": [{"sqlExpression": "sum(fare)"}],
                    "dimensions": [{"sqlExpression": "city_id"}]},
    "contains_by_length": {"measures": [{"sqlExpression": "sum(fare)",
                                         "rowFilters": ["contains(tags, 7)"]}],
                           "dimensions": [{"sqlExpression": "length(tags)"}]},
    "last_tag": {"measures": [{"sqlExpression": "count(*)"}],
                 "dimensions": [{"sqlExpression": "element_at(tags, -1)"}]},
    "geo_by_zone": {"joins": ZJOIN,
                    "measures": [{"sqlExpression": "count(*)"}],
                    "dimensions": [{"sqlExpression": "z.id"}],
                    "rowFilters": ["z.id IN (1, 2)"]},
    "listing": {"measures": [{"sqlExpression": "1"}],
                "dimensions": [{"sqlExpression": "id"},
                               {"sqlExpression": "fare"}],
                "rowFilters": ["city_id = 3"], "limit": 5},
}


def upserts(n=2400, per=400, seed=1):
    """(trips' upsert bytes in time order, zones' upsert bytes). Fares are
    multiples of 1/8 below 50, so every float32 partial sum is exact and
    the sums do not depend on how recovery lays the rows into batches."""
    rng = np.random.RandomState(seed)
    ts = np.sort(BASE + rng.randint(0, 3 * DAY, n))
    out = []
    for lo in range(0, n, per):
        b = UpsertBatchBuilder()
        for cid, t in enumerate((dt.Uint32, dt.Uint32, dt.Uint16, dt.Float32,
                                 dt.GeoPoint, dt.ArrayInt32)):
            b.add_column(cid, t)
        for r, i in enumerate(range(lo, min(lo + per, n))):
            b.add_row()
            b.set_value(r, 0, int(ts[i]))
            b.set_value(r, 1, i)
            b.set_value(r, 2, int(rng.randint(0, 8)))
            b.set_value(r, 3, rng.randint(0, 400) / 8)
            if rng.rand() > 0.05:
                b.set_value(r, 4, (float(np.float32(rng.rand() * 40)),
                                   float(np.float32(rng.rand() * 40))))
            b.set_value(r, 5, rng.randint(0, 10, rng.randint(0, 5)).tolist())
        out.append(b.to_bytes())
    z = UpsertBatchBuilder()
    z.add_column(0, dt.Uint16)
    z.add_column(1, dt.GeoShape)
    for r, (key, wkt) in enumerate(
            [(1, "POLYGON((0 0, 0 10, 10 10, 10 0, 0 0))"),
             (2, "POLYGON((20 20, 20 30, 30 30, 30 20, 20 20))")]):
        z.add_row()
        z.set_value(r, 0, key)
        z.set_value(r, 1, dt.parse_geoshape(wkt))
    return out, z.to_bytes()


PORT = (TMemStore, TMeta, TDisk, TTable, TUpsertBatch, TArchiver)
JAX = (JMemStore, JMeta, JDisk, JTable, JUpsertBatch, JArchiver)


def open_store(side, root):
    """A MemStore over root, recovered from what the directory holds."""
    memstore_cls, meta_cls, disk_cls = side[:3]
    ms = memstore_cls(meta_cls(root), disk_cls(root))
    ms.fetch_schema()
    ms.init_shards()
    return ms


def fill(side, root, trips, zones):
    """A new MemStore under root: both tables created, every upsert
    through handle_ingestion, the trips' first two days archived."""
    memstore_cls, meta_cls, disk_cls, table_cls, batch_cls, archiver_cls \
        = side
    ms = memstore_cls(meta_cls(root), disk_cls(root))
    for js in (TRIPS, ZONES):
        ms.create_table(table_cls.from_json(js))
    ms.init_shards()
    for buf in trips:
        ms.handle_ingestion("trips", 0, batch_cls(buf))
    ms.handle_ingestion("zones", 0, batch_cls(zones))
    archiver_cls(ms.get_table_shard("trips"), ms.metastore,
                 ms.diskstore).archive(CUTOFF)
    return ms


def close(ms):
    ms.host_memory_manager.stop()
    ms.redolog_master.stop_all()


def answers(svc):
    out = {}
    for name, q in QUERIES.items():
        resp = svc.handle_aql({"queries": [dict(q, table="trips", now=NOW)]})
        assert "errors" not in resp, (name, resp.get("errors"))
        out[name] = resp["results"][0]
    return out


def jax_service(ms):
    svc = JQueryService(ms)
    svc.executor = JX.ShardExecutor(ms, kernel_cache=JK.KernelCache())
    return svc


def redo_bytes(root):
    """Every redo-log file's bytes under root, by table and shard."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if "redolog" not in dirpath:
            continue
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                out.setdefault(os.path.relpath(dirpath, root), []).append(
                    fh.read())
    return out


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def recovered(tmp_path_factory):
    root = tmp_path_factory.mktemp("memstore")
    trips, zones = upserts()
    port_root, jax_root = str(root / "port"), str(root / "jax")
    ms = fill(PORT, port_root, trips, zones)
    before = answers(TQueryService(ms, device="cpu"))
    shard = ms.get_table_shard("trips")
    archived_days = dict(shard.archive_store.get_current_version().batches)
    close(ms)
    jms = fill(JAX, jax_root, trips, zones)
    jax_own = answers(jax_service(jms))
    close(jms)
    copy = str(root / "copy")
    shutil.copytree(port_root, copy)
    after_ms = open_store(PORT, port_root)
    after = answers(TQueryService(after_ms, device="cpu"))
    jax_ms = open_store(JAX, copy)
    jax_after = answers(jax_service(jax_ms))
    yield dict(before=before, after=after, jax_own=jax_own,
               jax_after=jax_after, days=archived_days, store=after_ms,
               port_root=port_root, jax_root=jax_root)
    close(after_ms)
    close(jax_ms)


def test_both_packages_write_the_same_redo_log_bytes(recovered):
    port, jax = (redo_bytes(recovered[k]) for k in ("port_root", "jax_root"))
    assert port and port == jax


def test_recovery_restores_the_archive_and_the_live_rows(recovered):
    shard = recovered["store"].get_table_shard("trips")
    version = shard.archive_store.get_current_version()
    assert version.archiving_cutoff == CUTOFF
    assert sorted(version.batches) == sorted(recovered["days"])
    assert len(recovered["days"]) == 2
    assert shard.live_store.rows_visible() > 0
    zones = recovered["store"].get_table_shard("zones")
    assert zones.live_store.rows_visible() == 2


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_recovered_store_answers_as_before(recovered, name):
    assert recovered["after"][name] == recovered["before"][name]
    assert recovered["before"][name]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_jax_memstore_over_the_ports_bytes_answers_alike(recovered, name):
    for want in (recovered["jax_after"][name], recovered["jax_own"][name]):
        got = recovered["after"][name]
        if name in ("sum_by_city", "contains_by_length"):
            assert set(got) == set(want)
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=REL, abs=1e-3), k
        else:
            assert got == want
