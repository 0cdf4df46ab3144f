"""Host memory budgeting: managed (archive, evictable) vs unmanaged bytes.

Reference: memstore/host_memory_manager.go (HostMemoryManager: Start/Stop
worker goroutines :209-243, TriggerPreload on column-config change :245,
TriggerEviction :258, eviction by (priority, preloading-zone, batchID)
:406-525, GetArchiveMemoryUsageByTableShard :271, unmanaged = live store +
PK always resident).

Design: two daemon worker threads stand in for the reference's preload and
eviction goroutines. Preload jobs are queued (a config change enqueues the
affected column; startup enqueues a full sweep); eviction is a level-
triggered event so redundant triggers coalesce. All loading goes through
``ArchiveBatch.request_column`` — the same lazy-load path queries use — so
preloading only warms the cache and never changes results.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Tuple

from aresdb_tpu_torch.utils import clock


class _PreloadJob:
    __slots__ = ("table", "column_id", "old_days", "new_days")

    def __init__(self, table: Optional[str], column_id: int,
                 old_days: int, new_days: int):
        self.table = table          # None = full sweep over all tables
        self.column_id = column_id
        self.old_days = old_days
        self.new_days = new_days


class HostMemoryManager:
    def __init__(self, memstore, total_memory_bytes: int = 0):
        self.memstore = memstore
        self.total_memory_bytes = total_memory_bytes  # 0 = unlimited
        self.unmanaged_bytes = 0
        self.managed_bytes = 0
        # (table, shard, batch_id, column_id) -> bytes
        self._objects: Dict[Tuple[str, int, int, int], int] = {}
        self.lock = threading.RLock()
        self._preload_q: "queue.Queue[Optional[_PreloadJob]]" = queue.Queue()
        self._evict_event = threading.Event()
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    # -- lifecycle (reference Start :209 / Stop :238) --------------------

    def start(self) -> None:
        """Spawn the preload and eviction workers (idempotent)."""
        with self.lock:
            if self._started:
                return
            self._started = True
        for fn, name in ((self._preload_worker, "ares-hmm-preload"),
                         (self._evict_worker, "ares-hmm-evict")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        with self.lock:
            if not self._started:
                return
            self._started = False
        self._stop.set()
        self._preload_q.put(None)
        self._evict_event.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._stop.clear()

    # -- accounting ------------------------------------------------------

    def report_unmanaged_space_usage_change(self, delta: int) -> None:
        with self.lock:
            self.unmanaged_bytes += delta

    def report_managed_object(self, table: str, shard: int, batch_id: int,
                              column_id: int, nbytes: int) -> None:
        key = (table, shard, batch_id, column_id)
        with self.lock:
            old = self._objects.get(key, 0)
            self._objects[key] = nbytes
            self.managed_bytes += nbytes - old
            if nbytes == 0:
                self._objects.pop(key, None)
        if nbytes > old:  # shrink can't push us over budget
            self.trigger_eviction()

    def get_reserved_memory(self) -> int:
        return self.unmanaged_bytes + self.managed_bytes

    # -- triggers (reference TriggerPreload :245 / TriggerEviction :258) --

    def trigger_preload(self, table: str, column_id: int,
                        old_days: int, new_days: int) -> None:
        """Async-load a column's newly-preloading batches after its
        preloadingDays config grew (shrinks are handled by eviction)."""
        self._preload_q.put(_PreloadJob(table, column_id, old_days, new_days))
        if not self._started:
            self._drain_preload_queue()

    def trigger_preload_sweep(self) -> None:
        """Async full preload sweep (startup / post-archiving)."""
        self._preload_q.put(_PreloadJob(None, -1, 0, 0))
        if not self._started:
            self._drain_preload_queue()

    def trigger_eviction(self) -> None:
        if self._started:
            self._evict_event.set()
        else:
            self._try_evict()

    def handle_table_update(self, old_table, new_table) -> None:
        """Diff column configs and trigger preload where preloadingDays
        grew (reference: the schema-change watcher calling TriggerPreload,
        host_memory_manager.go:371 handleColumnPreloadingDaysChange)."""
        old_cols = {c.name: c for c in old_table.columns}
        for cid, col in enumerate(new_table.columns):
            if col.deleted:
                continue
            old = old_cols.get(col.name)
            old_days = old.config.preloading_days if old is not None else 0
            if col.config.preloading_days > old_days:
                self.trigger_preload(new_table.name, cid, old_days,
                                     col.config.preloading_days)

    # -- preload ----------------------------------------------------------

    def preload_all(self) -> int:
        """Synchronous full sweep: load archive columns inside their
        configured preloading windows. Returns columns loaded."""
        return self._run_preload(_PreloadJob(None, -1, 0, 0))

    def _preload_worker(self) -> None:
        while not self._stop.is_set():
            job = self._preload_q.get()
            if job is None or self._stop.is_set():
                return
            try:
                self._run_preload(job)
            except Exception:  # noqa: BLE001 — a preload failure must
                pass           # never kill the worker; queries lazy-load

    def _drain_preload_queue(self) -> None:
        while True:
            try:
                job = self._preload_q.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                self._run_preload(job)

    def _run_preload(self, job: _PreloadJob) -> int:
        today = int(clock.now_unix() // 86400)
        loaded = 0
        for table, shard_id in self.memstore.list_shards():
            if job.table is not None and table != job.table:
                continue
            try:
                shard = self.memstore.get_table_shard(table, shard_id)
                schema = shard.schema
            except KeyError:
                continue
            if not schema.table.is_fact_table:
                continue
            version = shard.archive_store.get_current_version()
            for cid, col in enumerate(schema.table.columns):
                if job.table is not None and cid != job.column_id:
                    continue
                days = (job.new_days if job.table is not None
                        else col.config.preloading_days)
                old_days = job.old_days if job.table is not None else 0
                if col.deleted or days <= 0:
                    continue
                for bid, batch in version.batches.items():
                    age = today - bid
                    # config-change jobs only load the NEW part of the
                    # window; the old part is already resident (or evicted
                    # on purpose) — reference :371
                    if age < days and (job.table is None or age >= old_days):
                        if batch.request_column(cid) is not None:
                            loaded += 1
        return loaded

    # -- eviction ----------------------------------------------------------

    def _evict_worker(self) -> None:
        while not self._stop.is_set():
            self._evict_event.wait()
            if self._stop.is_set():
                return
            self._evict_event.clear()
            try:
                self._try_evict()
            except Exception:  # noqa: BLE001
                pass

    def _try_evict(self) -> None:
        """Evict archive columns when over budget.

        Eviction order matches the reference's globalPriorityComparator
        (host_memory_manager.go:525): outside-preloading-zone before
        inside (dominant key), then lowest column priority, then oldest
        batch, then LARGEST object first on full ties.
        """
        if self.total_memory_bytes <= 0:
            return
        # Build the candidate list under our lock, but do the actual
        # evictions OUTSIDE it: evict_column takes the batch lock and
        # reports back through report_managed_object (accounting is
        # centralized in ArchiveBatch), while lazy loads take the batch
        # lock first — holding hmm.lock across evict_column would be a
        # lock-order inversion against request_column.
        with self.lock:
            if self.get_reserved_memory() <= self.total_memory_bytes:
                return
            today = int(clock.now_unix() // 86400)
            candidates = []
            for (table, shard, batch_id, column_id), nbytes in self._objects.items():
                try:
                    schema = self.memstore.get_schema(table)
                    col = schema.table.columns[column_id]
                    priority = col.config.priority
                    in_preload = (today - batch_id) < col.config.preloading_days
                except Exception:
                    priority, in_preload = 0, False
                candidates.append(
                    (((1 if in_preload else 0), priority, batch_id, -nbytes),
                     (table, shard, batch_id, column_id), nbytes))
            candidates.sort(key=lambda c: c[0])
        for _, key, nbytes in candidates:
            with self.lock:
                if self.get_reserved_memory() <= self.total_memory_bytes:
                    break
                if key not in self._objects:
                    continue
            table, shard, batch_id, column_id = key
            evicted = False
            try:
                ts = self.memstore.get_table_shard(table, shard)
                version = ts.archive_store.get_current_version()
                batch = version.batches.get(batch_id)
                if batch is not None:
                    # reports 0 back to us when bytes were actually held
                    evicted = batch.evict_column(column_id)
            except Exception:
                pass
            if not evicted:
                # batch vanished (version swap / purge): drop stale entry
                with self.lock:
                    stale = self._objects.pop(key, None)
                    if stale:
                        self.managed_bytes -= stale

    # -- reporting (reference GetArchiveMemoryUsageByTableShard :271) ------

    def get_archive_memory_usage_by_table_shard(self) -> Dict[str, Dict[str, Dict[str, Dict[str, int]]]]:
        """Per table.shard -> column name -> {preloaded, nonPreloaded, live}
        byte counts, for the /dbg host-memory panel."""
        today = int(clock.now_unix() // 86400)
        out: Dict[str, Dict[str, Dict[str, Dict[str, int]]]] = {}
        with self.lock:
            objects = dict(self._objects)
        for (table, shard, batch_id, column_id), nbytes in objects.items():
            try:
                schema = self.memstore.get_schema(table)
                col = schema.table.columns[column_id]
            except Exception:
                continue
            key = f"{table}_{shard}"
            cols = out.setdefault(table, {}).setdefault(key, {})
            cu = cols.setdefault(col.name,
                                 {"preloaded": 0, "nonPreloaded": 0, "live": 0})
            if (today - batch_id) < col.config.preloading_days:
                cu["preloaded"] += nbytes
            else:
                cu["nonPreloaded"] += nbytes
        # live (unmanaged) bytes per shard
        for table, shard_id in self.memstore.list_shards():
            try:
                shard = self.memstore.get_table_shard(table, shard_id)
            except KeyError:
                continue
            live = shard.live_store.bytes_estimate()
            if live:
                key = f"{table}_{shard_id}"
                cols = out.setdefault(table, {}).setdefault(key, {})
                cu = cols.setdefault(
                    "__live__", {"preloaded": 0, "nonPreloaded": 0, "live": 0})
                cu["live"] += live
        return out
