"""TableShard: per-(table, shard) storage container + ingestion path.

Reference: memstore/table_shard.go, memstore/ingestion.go
(HandleIngestion -> saveUpsertBatch -> ApplyUpsertBatch -> insertPrimaryKeys
-> writeBatchRecords), memstore/backfill_manager.go, snapshot_manager.go.

TPU-first design: the reference applies upsert batches row by row
(ingestion.go:364 writeBatchRecords); here classification is a single python
pass over packed keys and all column writes are vectorized numpy scatters
grouped by destination live batch, so ingestion cost is dominated by the PK
dict, not per-value interpretation.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.common.schema import TableSchema
from aresdb_tpu_torch.common.upsert_batch import (
    UPDATE_FORCE_OVERWRITE,
    UPDATE_OVERWRITE_NOT_NULL,
    UPDATE_WITH_ADDITION,
    UPDATE_WITH_MAX,
    UPDATE_WITH_MIN,
    UpsertBatch,
)
from aresdb_tpu_torch.memstore.archive_store import ArchiveStore
from aresdb_tpu_torch.memstore.common import RecordID
from aresdb_tpu_torch.memstore.live_store import LiveStore
from aresdb_tpu_torch.memstore.primary_key import (
    build_keys,
    key_columns_from_batch_columns,
)
from aresdb_tpu_torch.utils import clock, tracing


class IngestionStats:
    def __init__(self):
        self.inserted = 0
        self.updated = 0
        self.backfilled = 0
        self.skipped_retention = 0
        self.skipped_null_pk = 0
        self.skipped_future = 0


class BackfillManager:
    """Bounded queue of late (pre-cutoff) records awaiting backfill.

    Reference: memstore/backfill_manager.go BackfillManager (bounded buffer
    with backpressure; checkpoints (redoFile, offset)).
    """

    def __init__(self, max_buffer_bytes: int):
        self.max_buffer_bytes = max_buffer_bytes
        self.queue: List[Tuple[UpsertBatch, np.ndarray]] = []
        self.current_buffer_bytes = 0
        self.last_redo_file = 0
        self.last_batch_offset = 0
        self.lock = threading.RLock()
        self.not_full = threading.Condition(self.lock)

    def append(self, batch: UpsertBatch, rows: np.ndarray,
               redo_file: int, batch_offset: int,
               timeout: Optional[float] = None, force: bool = False) -> bool:
        with self.not_full:
            est = int(rows.size) * max(1, len(batch.buffer) // max(1, batch.num_rows))
            while (not force
                   and self.current_buffer_bytes + est > self.max_buffer_bytes
                   and self.queue):
                if not self.not_full.wait(timeout=timeout):
                    return False
            self.queue.append((batch, rows))
            self.current_buffer_bytes += est
            self.last_redo_file = redo_file
            self.last_batch_offset = batch_offset
            return True

    def drain(self) -> Tuple[List[Tuple[UpsertBatch, np.ndarray]], int, int]:
        with self.not_full:
            q = self.queue
            self.queue = []
            self.current_buffer_bytes = 0
            self.not_full.notify_all()
            return q, self.last_redo_file, self.last_batch_offset

    def qualifies_for_backfill(self) -> bool:
        return bool(self.queue)


class SnapshotManager:
    """Tracks dimension-table mutations for snapshot scheduling.

    Reference: memstore/snapshot_manager.go.
    """

    def __init__(self, threshold: int, interval_minutes: int):
        self.threshold = threshold
        self.interval_minutes = interval_minutes
        self.num_mutations = 0
        self.last_redo_file = 0
        self.last_batch_offset = 0
        self.last_record = RecordID(0, 0)
        self.last_snapshot_time = clock.now()
        self.lock = threading.RLock()

    def apply_upsert_batch(self, redo_file: int, offset: int, num_mutations: int,
                           record: RecordID) -> None:
        with self.lock:
            self.num_mutations += num_mutations
            self.last_redo_file = redo_file
            self.last_batch_offset = offset
            self.last_record = record

    def qualify_for_snapshot(self) -> bool:
        with self.lock:
            if self.num_mutations == 0:
                return False
            if self.num_mutations >= self.threshold:
                return True
            age_minutes = (clock.now() - self.last_snapshot_time) / 60.0
            return age_minutes >= self.interval_minutes

    def done(self, redo_file: int, offset: int, applied_mutations: int) -> None:
        with self.lock:
            self.num_mutations -= applied_mutations
            self.last_snapshot_time = clock.now()


class TableShard:
    def __init__(self, schema: TableSchema, shard_id: int = 0,
                 diskstore=None, metastore=None, redolog_manager=None,
                 host_memory_manager=None):
        self.schema = schema
        self.shard_id = shard_id
        self.diskstore = diskstore
        self.metastore = metastore
        self.redolog_manager = redolog_manager
        self.live_store = LiveStore(schema)
        self.archive_store = ArchiveStore(
            schema, shard_id, diskstore=diskstore, metastore=metastore,
            host_memory_manager=host_memory_manager)
        cfg = schema.table.config
        self.backfill_manager: Optional[BackfillManager] = (
            BackfillManager(cfg.backfill_max_buffer_size)
            if schema.table.is_fact_table else None)
        self.snapshot_manager: Optional[SnapshotManager] = (
            None if schema.table.is_fact_table else
            SnapshotManager(cfg.snapshot_threshold, cfg.snapshot_interval_minutes))
        self.writer_lock = threading.RLock()
        # per-(table, shard) scoped reporter (reference TableShardReporter,
        # utils/metrics.go:1113)
        from aresdb_tpu_torch.utils import metrics as M

        self.reporter = M.root().scoped(table=schema.table.name,
                                        shard=str(shard_id))

    # ------------------------------------------------------------------
    # ingestion entry point (reference: memstore/ingestion.go:25-175)
    # ------------------------------------------------------------------

    def save_upsert_batch(self, batch: UpsertBatch,
                          recovery: bool = False,
                          redo_file: int = 0, batch_offset: int = 0
                          ) -> IngestionStats:
        """Apply one upsert batch (and, unless recovering, append it to
        the redo log), in a `saveUpsertBatch` span over `redoLogAppend`
        and `applyUpsertBatch`."""
        with tracing.span("saveUpsertBatch") as span:
            if span is not None:
                span.attrs.update(rows=batch.num_rows, recovery=recovery)
            return self._save_upsert_batch(batch, recovery, redo_file,
                                           batch_offset)

    def _save_upsert_batch(self, batch: UpsertBatch, recovery: bool,
                           redo_file: int, batch_offset: int
                           ) -> IngestionStats:
        from aresdb_tpu_torch.utils import metrics as M

        t_lock = clock.now()
        with self.writer_lock:
            self.reporter.record_timer(M.INGESTION_WRITELOCK_AQUIRE_TIME,
                                       clock.now() - t_lock)
            wal_thread = None
            wal_out: list = []
            if not recovery and self.redolog_manager is not None:
                # WAL append runs CONCURRENTLY with classification +
                # column writes (the file write and the native classify
                # both release the GIL); both must complete before the
                # batch is acknowledged, and the backfill/snapshot
                # consumers of the redolog position join first. A crash
                # between apply and WAL completion loses only an UNACKED
                # batch — same contract as the sequential order
                # (drive_crash.py validates acked rows only).
                import threading as _threading

                max_et = self._max_event_time(batch)

                def _append():
                    try:
                        with tracing.span("redoLogAppend"):
                            wal_out.append(self.redolog_manager.append(
                                batch.buffer, max_et))
                    except BaseException as e:  # noqa: BLE001
                        wal_out.append(e)

                # the append's span lies under this batch's
                wal_thread = _threading.Thread(
                    target=contextvars.copy_context().run, args=(_append,),
                    name="wal-append")
                wal_thread.start()

            def redo_pos():
                if wal_thread is not None:
                    wal_thread.join()
                    out = wal_out[0]
                    if isinstance(out, BaseException):
                        raise out
                    return out
                return redo_file, batch_offset

            try:
                with tracing.span("applyUpsertBatch"):
                    stats = self.apply_upsert_batch(
                        batch, recovery=recovery, redo_file=redo_file,
                        batch_offset=batch_offset, redo_pos=redo_pos)
            except Exception:
                if wal_thread is not None:
                    wal_thread.join()
                self.reporter.count(M.INGESTED_ERROR_BATCHES)
                raise
            redo_file, batch_offset = redo_pos()
            self.live_store.advance_last_read_record()
            # post application (reference ingestion.go:143)
            if self.snapshot_manager is not None:
                self.snapshot_manager.apply_upsert_batch(
                    redo_file, batch_offset, batch.num_rows,
                    self.live_store.last_read_record)
            self._report_ingestion(batch, stats, recovery)
            return stats

    def _report_ingestion(self, batch: UpsertBatch, stats: IngestionStats,
                          recovery: bool) -> None:
        """Per-batch scoped emission mirroring the reference's ingestion
        reporters (memstore/ingestion.go:143-175)."""
        from aresdb_tpu_torch.utils import metrics as M

        r = self.reporter
        n = batch.num_rows
        if recovery:
            r.count(M.INGESTED_RECOVERY_BATCHES)
            r.gauge(M.RECOVERY_UPSERT_BATCH_SIZE, n)
            if stats.skipped_retention:
                r.count(M.RECOVERY_IGNORED_RECORDS, stats.skipped_retention)
        else:
            r.count(M.INGESTED_UPSERT_BATCHES)
            r.gauge(M.UPSERT_BATCH_SIZE, n)
        r.count(M.INGESTED_RECORDS, n)
        r.count(M.APPENDED_RECORDS, stats.inserted)
        r.count(M.UPDATED_RECORDS, stats.updated)
        skipped = (stats.skipped_null_pk + stats.skipped_retention
                   + stats.skipped_future)
        if skipped:
            r.count(M.INGEST_SKIPPED_RECORDS, skipped)
        if stats.skipped_null_pk:
            r.count(M.PRIMARY_KEY_MISSING, stats.skipped_null_pk)
        if stats.skipped_retention:
            r.count(M.RECORDS_OUT_OF_RETENTION, stats.skipped_retention)
        if stats.skipped_future:
            r.count(M.RECORDS_FROM_FUTURE, stats.skipped_future)
        if n:
            r.gauge(M.DUPLICATE_RECORD_RATIO, stats.updated / n)
        if stats.backfilled:
            r.count(M.BACKFILL_RECORDS, stats.backfilled)
            r.gauge(M.BACKFILL_RECORDS_RATIO, stats.backfilled / max(1, n))
        bm = self.backfill_manager
        if bm is not None:
            r.gauge(M.BACKFILL_BUFFER_SIZE, bm.current_buffer_bytes)
            r.gauge(M.BACKFILL_BUFFER_NUM_RECORDS,
                    sum(len(rows) for _, rows in bm.queue))
            r.gauge(M.BACKFILL_BUFFER_FILL_RATIO,
                    bm.current_buffer_bytes / max(1, bm.max_buffer_bytes))

    def _max_event_time(self, batch: UpsertBatch) -> int:
        if not self.schema.table.is_fact_table or batch.num_rows == 0:
            return 0
        for col in batch.columns:
            if col.column_id == 0 and col.values is not None:
                return int(col.values.max()) if len(col.values) else 0
        return 0

    def apply_upsert_batch(self, batch: UpsertBatch, recovery: bool = False,
                           redo_file: int = 0, batch_offset: int = 0,
                           redo_pos=None,
                           skip_backfill: bool = False) -> IngestionStats:
        """Classify rows (insert/update/backfill/skip) and write columns.

        redo_pos: optional resolver for the (redo_file, batch_offset)
        position when the WAL append runs concurrently (save_upsert_batch);
        consulted only on the backfill path. skip_backfill: the batch's
        late rows are in the archive already (a replayed batch at or
        before the backfill progress): they are not queued again.

        Reference: ApplyUpsertBatch + insertPrimaryKeys + writeBatchRecords
        (memstore/ingestion.go:76-494).
        """
        if redo_pos is None:
            def redo_pos():
                return redo_file, batch_offset
        stats = IngestionStats()
        schema = self.schema
        n = batch.num_rows
        if n == 0:
            return stats
        cols_by_id = {c.column_id: c for c in batch.columns}
        self._validate_batch_schema(batch)

        fact = schema.table.is_fact_table
        event_times = None
        if fact:
            tcol = cols_by_id.get(0)
            if tcol is None or tcol.values is None:
                if not schema.table.config.allow_missing_event_time:
                    raise ValueError(
                        "fact table upsert batch must carry the event time column")
                from aresdb_tpu_torch.utils import metrics as _M

                self.reporter.count(_M.TIME_COLUMN_MISSING)
                event_times = np.zeros(n, dtype=np.int64)
            else:
                if not tcol.validity.all() and not schema.table.config.allow_missing_event_time:
                    raise ValueError("event time column contains nulls")
                event_times = tcol.values.astype(np.int64)

        key_ids = schema.table.primary_key_columns
        key_cols, key_valid = key_columns_from_batch_columns(key_ids, cols_by_id, n)

        cutoff = self.live_store.archiving_cutoff_high_watermark
        retention_days = schema.table.config.record_retention_in_days
        retention_ts = 0
        future_ts = 0
        if fact:
            now = int(clock.now_unix())
            # reference ingestion.go:239 — retention is DAY-granular
            # (eventDay < nowDay - retentionDays) and records from the
            # future (eventTime > now) are skipped (:254)
            if retention_days > 0:
                retention_ts = (now // 86400 - retention_days) * 86400
            future_ts = now

        pk = self.live_store.primary_key

        # native fast path: the entire row classification runs in one C++
        # call against the cuckoo index (reference: Go insertPrimaryKeys over
        # the C-memory index); python only does vectorized column writes
        from aresdb_tpu_torch.memstore.native_primary_key import NativePrimaryKey
        if isinstance(pk, NativePrimaryKey):
            return self._apply_native(
                batch, cols_by_id, key_cols, key_valid, event_times, fact,
                cutoff, retention_ts, future_ts, stats, recovery, redo_pos,
                skip_backfill)

        keys = build_keys(key_cols, n)
        insert_rows: List[int] = []
        pending: Dict[bytes, int] = {}  # key -> ordinal in insert_rows
        update_rows: List[int] = []
        update_dests: List[RecordID] = []
        late_update_rows: List[int] = []  # updates of rows inserted this batch
        late_update_slots: List[int] = []
        backfill_rows: List[int] = []

        for i in range(n):
            if not key_valid[i]:
                stats.skipped_null_pk += 1
                continue
            et = int(event_times[i]) if fact else 0
            if retention_ts and et < retention_ts:
                stats.skipped_retention += 1
                continue
            if future_ts and et > future_ts:
                stats.skipped_future += 1
                continue
            key = keys[i]
            slot = pending.get(key)
            if slot is not None:
                late_update_rows.append(i)
                late_update_slots.append(slot)
                continue
            existing = pk.find(key)
            if existing is not None:
                update_rows.append(i)
                update_dests.append(existing)
                continue
            if fact and cutoff > 0 and et < cutoff:
                backfill_rows.append(i)
                continue
            pending[key] = len(insert_rows)
            insert_rows.append(i)

        # allocate destinations for inserts and register them in the PK
        recs = self.live_store.allocate_records(len(insert_rows))
        for key, slot in pending.items():
            row = insert_rows[slot]
            et = int(event_times[row]) if fact else 0
            pk.find_or_insert(key, recs[slot], et)

        # resolve late updates to their just-allocated destinations
        update_rows.extend(late_update_rows)
        update_dests.extend(recs[s] for s in late_update_slots)

        self._write_inserts(batch, cols_by_id, insert_rows, recs)
        self._write_updates(batch, update_rows, update_dests)

        stats.inserted = len(insert_rows)
        stats.updated = len(update_rows)
        stats.backfilled = len(backfill_rows)

        if backfill_rows and self.backfill_manager is not None and \
                not skip_backfill:
            # During recovery, a late row past the backfill-progress
            # checkpoint was NOT yet backfilled — it must be re-queued or
            # it is silently lost (reference: memstore/recovery.go replays
            # into the backfill manager).
            # force=True: no backfill job consumes the queue mid-replay.
            rf, bo = redo_pos()
            self.backfill_manager.append(
                batch, np.asarray(backfill_rows, dtype=np.int64),
                rf, bo, force=recovery)
        return stats

    CLASSIFY_CHUNK = 1 << 19   # pipeline granularity: big enough that the
                               # per-chunk python overhead amortizes, small
                               # enough for 4+ overlap stages per 2M batch

    def _apply_native(self, batch: UpsertBatch, cols_by_id, key_cols,
                      key_valid, event_times, fact: bool, cutoff: int,
                      retention_ts: int, future_ts: int,
                      stats: IngestionStats,
                      recovery: bool, redo_pos=None,
                      skip_backfill: bool = False) -> IngestionStats:
        """Batch-classified ingestion via the C++ cuckoo index."""
        from aresdb_tpu_torch.memstore.native_primary_key import build_key_matrix

        n = batch.num_rows
        ls = self.live_store
        pk = ls.primary_key
        km = build_key_matrix(key_cols, n)
        et = event_times if fact else None
        CH = self.CLASSIFY_CHUNK
        # grow the index ONCE for the whole batch: per-chunk presizing
        # re-doubles the tables mid-batch (each doubling re-inserts every
        # key; measured 3.1 vs 5.7 M keys/s at 512k chunks over 16M rows)
        pk.reserve(n)
        all_backfill = []

        def classify(lo, hi, state):
            a, db, di, cnts = pk.classify_batch(
                km[lo:hi], key_valid[lo:hi], None if et is None else et[lo:hi],
                cutoff if fact else 0, retention_ts,
                future_ts if fact else 0,
                state[0], state[1], ls.batch_size)
            state[0], state[1] = int(cnts[5]), int(cnts[6])
            return a, db, di, cnts

        def consume(lo, a, db, di, cnts):
            # advance the write cursor FIRST: it materializes the live
            # batches this chunk's dest records point into
            ls.set_next_write_record(int(cnts[5]), int(cnts[6]))
            stats.inserted += int(cnts[0])
            stats.updated += int(cnts[1])
            stats.backfilled += int(cnts[2])
            stats.skipped_retention += int(cnts[3])
            stats.skipped_null_pk += int(cnts[4])
            stats.skipped_future += int(cnts[7])
            insert_rows = np.nonzero(a == 1)[0]
            update_rows = np.nonzero(a == 2)[0]
            self._write_rows_arrays(batch, lo + insert_rows,
                                    db[insert_rows], di[insert_rows],
                                    inserts=True)
            self._write_rows_arrays(batch, lo + update_rows,
                                    db[update_rows], di[update_rows],
                                    inserts=False)
            bf = np.nonzero(a == 3)[0]
            if len(bf):
                all_backfill.append(lo + bf)

        state = list(ls.next_write_record)
        if n <= CH:
            consume(0, *classify(0, n, state))
        else:
            # two-stage pipeline: the C++ classify (GIL released by
            # ctypes) of chunk i+1 overlaps the numpy/native column
            # writes of chunk i. Chunks classify IN ORDER on one worker
            # thread — the cuckoo index and the next-write cursor are
            # carried sequentially through `state`.
            from concurrent.futures import ThreadPoolExecutor

            spans = [(lo, min(lo + CH, n)) for lo in range(0, n, CH)]
            with ThreadPoolExecutor(1) as ex:
                futs = [ex.submit(classify, lo, hi, state)
                        for lo, hi in spans]
                for (lo, _), fut in zip(spans, futs):
                    consume(lo, *fut.result())

        backfill_rows = (np.concatenate(all_backfill)
                         if all_backfill else np.zeros(0, np.int64))
        if len(backfill_rows) and self.backfill_manager is not None and \
                not skip_backfill:
            # see apply_upsert_batch: recovery must re-queue late rows
            rf, bo = redo_pos() if redo_pos is not None else (0, 0)
            self.backfill_manager.append(
                batch, backfill_rows.astype(np.int64), rf,
                bo, force=recovery)
        return stats

    def _write_rows_arrays(self, batch: UpsertBatch, rows: np.ndarray,
                           dest_batches: np.ndarray, dest_idx: np.ndarray,
                           inserts: bool) -> None:
        """Columnar writes grouped by destination live batch (array form)."""
        if len(rows) == 0:
            return
        for bid in np.unique(dest_batches):
            live_batch = self.live_store.get_batch(int(bid))
            m = dest_batches == bid
            src = rows[m]
            dst = dest_idx[m]
            if inserts:
                for col in batch.columns:
                    vp = live_batch.get_or_create_column(col.column_id)
                    if col.is_array:
                        vp.write_rows(dst, None, col.validity[src],
                                      [col.array_values[int(r)] for r in src])
                    elif self._native_insert(vp, col, dst, src):
                        pass  # fused native gather+scatter (GIL released)
                    else:
                        vp.write_rows(dst, col.values[src], col.validity[src])
            else:
                flat = dest_batches[m].astype(np.int64) * (1 << 32) + dst
                has_dups = len(np.unique(flat)) != len(flat)
                for col in batch.columns:
                    if col.column_id in self.schema.table.primary_key_columns:
                        continue
                    vp = live_batch.get_or_create_column(col.column_id)
                    if has_dups or col.is_array:
                        self._apply_update_sequential(vp, col, src, dst)
                    else:
                        self._apply_update_vectorized(vp, col, src, dst)

    @staticmethod
    def _native_insert(vp, col, dst: np.ndarray, src: np.ndarray) -> bool:
        """Insert-path column write through the native fused
        gather+scatter (native.scatter_rows): dst rows of the live VP get
        src rows of the decoded batch column without numpy's intermediate
        gather temp (profiled at ~35% of the non-classify ingest cost).
        Returns False (caller falls back to write_rows) when the arrays
        don't qualify."""
        from aresdb_tpu_torch import native as _native

        values = col.values
        if values is None or vp.values is None:
            return False
        if vp.values.dtype != values.dtype or \
                vp.values.shape[1:] != values.shape[1:]:
            return False
        if not (vp.values.flags["C_CONTIGUOUS"]
                and values.flags["C_CONTIGUOUS"]
                and vp.validity.flags["C_CONTIGUOUS"]
                and col.validity.flags["C_CONTIGUOUS"]):
            return False
        if not _native.available():
            return False
        dst64 = np.ascontiguousarray(dst, np.int64)
        src64 = np.ascontiguousarray(src, np.int64)
        if not _native.scatter_rows(vp.values, values, dst64, src64):
            return False
        _native.scatter_rows(vp.validity, col.validity, dst64, src64)
        vp.version += 1
        return True

    def _validate_batch_schema(self, batch: UpsertBatch) -> None:
        columns = self.schema.table.columns
        seen = set()
        for c in batch.columns:
            if c.column_id >= len(columns):
                raise ValueError(f"column id {c.column_id} out of schema range")
            if c.column_id in seen:
                raise ValueError(f"duplicate column id {c.column_id} in batch")
            seen.add(c.column_id)
            expected = columns[c.column_id].data_type
            if c.data_type != expected:
                raise ValueError(
                    f"column {c.column_id} type mismatch: batch has "
                    f"0x{c.data_type:08x}, schema has 0x{expected:08x}")

    # ------------------------------------------------------------------
    # columnar writes
    # ------------------------------------------------------------------

    def _write_inserts(self, batch: UpsertBatch, cols_by_id,
                       rows: List[int], recs: List[RecordID]) -> None:
        if not rows:
            return
        rows_np = np.asarray(rows, dtype=np.int64)
        dest_batches = np.asarray([r.batch_id for r in recs], dtype=np.int64)
        dest_idx = np.asarray([r.index for r in recs], dtype=np.int64)
        for bid in np.unique(dest_batches):
            live_batch = self.live_store.get_batch(int(bid))
            m = dest_batches == bid
            src = rows_np[m]
            dst = dest_idx[m]
            for col in batch.columns:
                vp = live_batch.get_or_create_column(col.column_id)
                if col.is_array:
                    vp.write_rows(dst, None, col.validity[src],
                                  [col.array_values[int(r)] for r in src])
                else:
                    vp.write_rows(dst, col.values[src], col.validity[src])

    def _write_updates(self, batch: UpsertBatch, rows: List[int],
                       dests: List[RecordID]) -> None:
        if not rows:
            return
        rows_np = np.asarray(rows, dtype=np.int64)
        dest_batches = np.asarray([r.batch_id for r in dests], dtype=np.int64)
        dest_idx = np.asarray([r.index for r in dests], dtype=np.int64)

        # detect duplicate destinations; order-dependent combines fall back to
        # a sequential path for correctness
        flat = dest_batches * (1 << 32) + dest_idx
        has_dups = len(np.unique(flat)) != len(flat)

        for bid in np.unique(dest_batches):
            live_batch = self.live_store.get_batch(int(bid))
            m = dest_batches == bid
            src = rows_np[m]
            dst = dest_idx[m]
            for col in batch.columns:
                # primary key columns are immutable on update
                if col.column_id in self.schema.table.primary_key_columns:
                    continue
                vp = live_batch.get_or_create_column(col.column_id)
                if has_dups or col.is_array:
                    self._apply_update_sequential(vp, col, src, dst)
                else:
                    self._apply_update_vectorized(vp, col, src, dst)

    @staticmethod
    def _apply_update_vectorized(vp, col, src: np.ndarray, dst: np.ndarray) -> None:
        vp.version += 1
        mode = col.update_mode
        new_valid = col.validity[src]
        if col.is_array:
            raise AssertionError("arrays use the sequential path")
        new_vals = col.values[src]
        if mode == UPDATE_FORCE_OVERWRITE:
            vp.values[dst] = new_vals
            vp.validity[dst] = new_valid
            return
        if mode == UPDATE_OVERWRITE_NOT_NULL:
            sel = new_valid
            vp.values[dst[sel]] = new_vals[sel]
            vp.validity[dst[sel]] = True
            return
        # arithmetic merges: treat old null as identity
        sel = new_valid
        d = dst[sel]
        nv = new_vals[sel]
        old_valid = vp.validity[d]
        old_vals = vp.values[d]
        if mode == UPDATE_WITH_ADDITION:
            base = np.where(old_valid, old_vals, np.zeros_like(old_vals))
            vp.values[d] = base + nv
        elif mode == UPDATE_WITH_MIN:
            big = np.full_like(old_vals, dt.agg_identity(old_vals.dtype, "min"))
            vp.values[d] = np.minimum(np.where(old_valid, old_vals, big), nv)
        elif mode == UPDATE_WITH_MAX:
            small = np.full_like(old_vals, dt.agg_identity(old_vals.dtype, "max"))
            vp.values[d] = np.maximum(np.where(old_valid, old_vals, small), nv)
        else:
            raise ValueError(f"unsupported update mode {mode}")
        vp.validity[d] = True

    @staticmethod
    def _apply_update_sequential(vp, col, src: np.ndarray, dst: np.ndarray) -> None:
        vp.version += 1
        mode = col.update_mode
        for s, d in zip(src.tolist(), dst.tolist()):
            valid = bool(col.validity[s])
            if col.is_array:
                if mode == UPDATE_FORCE_OVERWRITE:
                    vp.list_values[d] = col.array_values[s]
                    vp.validity[d] = valid
                elif valid:
                    vp.list_values[d] = col.array_values[s]
                    vp.validity[d] = True
                continue
            newv = col.values[s]
            if mode == UPDATE_FORCE_OVERWRITE:
                vp.values[d] = newv
                vp.validity[d] = valid
            elif mode == UPDATE_OVERWRITE_NOT_NULL:
                if valid:
                    vp.values[d] = newv
                    vp.validity[d] = True
            elif valid:
                old_valid = bool(vp.validity[d])
                old = vp.values[d]
                if mode == UPDATE_WITH_ADDITION:
                    vp.values[d] = (old if old_valid else 0) + newv
                elif mode == UPDATE_WITH_MIN:
                    vp.values[d] = min(old, newv) if old_valid else newv
                elif mode == UPDATE_WITH_MAX:
                    vp.values[d] = max(old, newv) if old_valid else newv
                else:
                    raise ValueError(f"unsupported update mode {mode}")
                vp.validity[d] = True

    # ------------------------------------------------------------------

    def read_value(self, record: RecordID, column_id: int):
        b = self.live_store.get_batch(record.batch_id)
        return b.read_value(column_id, record.index)
