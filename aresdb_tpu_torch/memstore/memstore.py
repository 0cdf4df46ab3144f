"""MemStore facade: tables, shards, ingestion entry, recovery.

Reference: memstore/memstore.go (MemStore interface :37-73, memStoreImpl),
memstore/recovery.go (InitShards/PlayRedoLog), memstore/schema.go FetchSchema.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.common.schema import Table, TableSchema
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.host_memory import HostMemoryManager
from aresdb_tpu_torch.memstore.table_shard import IngestionStats, TableShard
from aresdb_tpu_torch.memstore.vector_party import ArchiveVectorParty
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.redolog.manager import RedoLogManagerMaster


class MemStore:
    def __init__(self, metastore: DiskMetaStore, diskstore: LocalDiskStore,
                 total_memory_bytes: int = 0, redo_log_config=None,
                 kafka_transport=None, namespace: str = ""):
        self.metastore = metastore
        self.diskstore = diskstore
        self.redolog_master = RedoLogManagerMaster(
            diskstore, metastore, redo_log_config,
            transport=kafka_transport, namespace=namespace)
        self.schemas: Dict[str, TableSchema] = {}
        self.shards: Dict[Tuple[str, int], TableShard] = {}
        self.host_memory_manager = HostMemoryManager(self, total_memory_bytes)
        self.lock = threading.RLock()

    # ------------------------------------------------------------------
    # schema
    # ------------------------------------------------------------------

    def fetch_schema(self) -> None:
        """Load all table schemas + enum dictionaries from the metastore."""
        with self.lock:
            for name in self.metastore.list_tables():
                table = self.metastore.get_table(name)
                ts = self.schemas.get(name)
                if ts is None:
                    ts = TableSchema(table)
                    self.schemas[name] = ts
                else:
                    old = ts.table
                    ts.set_table(table)
                    # NEWLY deleted columns: drop the enum dict and purge
                    # shard data (reference applyTableSchema,
                    # memstore/schema.go: delete(EnumDicts) + DeleteColumn)
                    for cid, col in enumerate(table.columns):
                        newly_deleted = col.deleted and (
                            cid >= len(old.columns)
                            or not old.columns[cid].deleted)
                        if newly_deleted:
                            ts.enum_dicts.pop(col.name, None)
                            self.delete_column_data(name, cid)
                    # preload newly-configured preloading windows
                    # (reference schema watcher -> TriggerPreload)
                    if self.host_memory_manager is not None:
                        self.host_memory_manager.handle_table_update(old, table)
                for col in table.columns:
                    if col.deleted:
                        continue
                    if col.is_enum_column():
                        cases = self.metastore.get_enum_cases(name, col.name)
                        ts.enum_dicts[col.name].extend(cases)

    def create_table(self, table: Table) -> TableSchema:
        self.metastore.create_table(table)
        ts = TableSchema(table)
        with self.lock:
            self.schemas[table.name] = ts
        return ts

    def get_schema(self, table: str) -> TableSchema:
        ts = self.schemas.get(table)
        if ts is None:
            raise KeyError(f"unknown table {table!r}")
        return ts

    def get_schemas(self) -> Dict[str, TableSchema]:
        return dict(self.schemas)

    # ------------------------------------------------------------------
    # shards
    # ------------------------------------------------------------------

    def add_table_shard(self, table: str, shard_id: int = 0) -> TableShard:
        with self.lock:
            key = (table, shard_id)
            if key in self.shards:
                return self.shards[key]
            schema = self.get_schema(table)
            cfg = schema.table.config
            redolog = self.redolog_master.new_redolog_manager(
                table, shard_id, cfg)
            shard = TableShard(schema, shard_id, diskstore=self.diskstore,
                               metastore=self.metastore,
                               redolog_manager=redolog,
                               host_memory_manager=self.host_memory_manager)
            self.shards[key] = shard
            return shard

    def get_table_shard(self, table: str, shard_id: int = 0) -> TableShard:
        shard = self.shards.get((table, shard_id))
        if shard is None:
            raise KeyError(f"no shard {shard_id} for table {table!r}")
        return shard

    def delete_column_data(self, table: str, column_id: int) -> None:
        """Drop a tombstoned column's data in every shard: live VPs,
        archive VPs, and disk files (reference TableShard.DeleteColumn,
        memstore/table_shard.go:107)."""
        for (tname, sid) in list(self.shards):
            if tname != table:
                continue
            shard = self.get_table_shard(tname, sid)
            with shard.live_store.lock:
                batches = list(shard.live_store.batches.values())
            for b in batches:
                with b._columns_lock:
                    b.columns.pop(column_id, None)
            version = shard.archive_store.get_current_version()
            for ab in version.batches.values():
                ab.evict_column(column_id)
            if self.diskstore is not None:
                self.diskstore.delete_column(tname, sid, column_id)

    def remove_table_shard(self, table: str, shard_id: int) -> None:
        with self.lock:
            shard = self.shards.pop((table, shard_id), None)
            if shard is not None:
                self.redolog_master.stop(table, shard_id)

    def list_shards(self) -> List[Tuple[str, int]]:
        return sorted(self.shards)

    # ------------------------------------------------------------------
    # ingestion (reference: memstore/ingestion.go HandleIngestion)
    # ------------------------------------------------------------------

    def handle_ingestion(self, table: str, shard_id: int,
                         batch: UpsertBatch) -> IngestionStats:
        shard = self.get_table_shard(table, shard_id)
        return shard.save_upsert_batch(batch)

    # ------------------------------------------------------------------
    # recovery (reference: memstore/recovery.go:218 InitShards)
    # ------------------------------------------------------------------

    def init_shards(self, shard_assignments: Optional[List[Tuple[str, int]]] = None
                    ) -> None:
        """Create shards and replay redo logs / load snapshots + archives."""
        import time as _time

        from aresdb_tpu_torch.utils import metrics as M

        if shard_assignments is None:
            shard_assignments = [(t, 0) for t in sorted(self.schemas)]
        for table, shard_id in shard_assignments:
            t0 = _time.perf_counter()
            shard = self.add_table_shard(table, shard_id)
            self._recover_shard(shard)
            M.root().record_timer(M.RECOVERY_LATENCY,
                                  _time.perf_counter() - t0,
                                  {"table": table, "shard": str(shard_id)})
        # start the host-memory workers and enqueue a startup preload sweep,
        # like the reference's Start() + preloading goroutines
        # (host_memory_manager.go:209) — queries work immediately either way
        # (lazy load), preloading just warms the host cache
        if self.host_memory_manager is not None:
            self.host_memory_manager.start()
            self.host_memory_manager.trigger_preload_sweep()

    def _recover_shard(self, shard: TableShard) -> None:
        table = shard.schema.table.name
        sid = shard.shard_id
        fact = shard.schema.table.is_fact_table

        # archive metadata + cutoff (fact tables)
        if fact:
            shard.archive_store.load_metadata()
            cutoff = shard.archive_store.get_current_version().archiving_cutoff
            shard.live_store.archiving_cutoff_high_watermark = cutoff
            shard.live_store.primary_key.update_event_time_cutoff(cutoff)
            # every redo log left on disk replays: a batch before the
            # backfill progress may hold live rows (at or past the
            # cutoff), which no archive holds; only its late rows, which
            # the backfill applied, are not queued again (skip_backfill)
            backfilled = self.metastore.get_backfill_progress(table, sid)
            redo_file, offset = 0, 0
        else:
            # dimension table: load latest snapshot, then replay from there
            redo_file, offset, _, _ = self.metastore.get_snapshot_progress(table, sid)
            self._load_snapshot(shard, redo_file, offset)

        replayed = 0
        # the writer lock holds off an upsert to a shard that is listed
        # before its replay ends (a datanode's bootstrap): one applied
        # beside the replay would share its write cursor
        with shard.writer_lock:
            for rf, off, payload in shard.redolog_manager.iterate(
                    redo_file, offset):
                batch = UpsertBatch(payload)
                shard.apply_upsert_batch(
                    batch, recovery=True, redo_file=rf, batch_offset=off,
                    skip_backfill=fact and (rf, off) <= tuple(backfilled))
                max_et = shard._max_event_time(batch)
                if max_et:
                    shard.redolog_manager.update_max_event_time(max_et, rf)
                replayed += 1
            shard.live_store.advance_last_read_record()
        # kafka-backed managers keep consuming the topic after replay
        # (reference ingestion half of the kafka Iterator)
        if hasattr(shard.redolog_manager, "start_streaming"):
            shard.redolog_manager.start_streaming(shard)

    def _load_snapshot(self, shard: TableShard, redo_file: int,
                       offset: int) -> None:
        """Rebuild a dimension table's live store from its last snapshot."""
        if redo_file == 0 and offset == 0:
            return
        table = shard.schema.table.name
        sid = shard.shard_id
        from aresdb_tpu_torch.memstore.primary_key import build_keys

        batch_ids = self.diskstore.list_snapshot_batches(table, sid, redo_file, offset)
        for bid in batch_ids:
            col_ids = self.diskstore.list_snapshot_batch_columns(
                table, sid, redo_file, offset, bid)
            if not col_ids:
                continue
            vps = {}
            n = 0
            for cid in col_ids:
                data = self.diskstore.read_snapshot_column(
                    table, sid, redo_file, offset, bid, cid)
                vp = ArchiveVectorParty.from_bytes(data)
                vps[cid] = vp
                n = max(n, vp.num_rows)
            # write rows back into the live store
            recs = shard.live_store.allocate_records(n)
            dest_batches = np.asarray([r.batch_id for r in recs])
            dest_idx = np.asarray([r.index for r in recs])
            for dbid in np.unique(dest_batches):
                live_batch = shard.live_store.get_batch(int(dbid))
                m = dest_batches == dbid
                src = np.nonzero(m)[0]
                dst = dest_idx[m]
                for cid, vp in vps.items():
                    lvp = live_batch.get_or_create_column(cid)
                    if vp.is_list:
                        lvp.write_rows(dst, None, vp.validity[src],
                                       [vp.list_values[int(r)] for r in src])
                    else:
                        lvp.write_rows(dst, vp.values[src], vp.validity[src])
            # rebuild the primary key from snapshot rows
            key_ids = shard.schema.table.primary_key_columns
            key_cols = [vps[cid].values for cid in key_ids]
            keys = build_keys(key_cols, n)
            pk = shard.live_store.primary_key
            for i, key in enumerate(keys):
                pk.find_or_insert(key, recs[i], 0)
        shard.live_store.advance_last_read_record()
