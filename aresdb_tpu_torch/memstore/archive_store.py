"""ArchiveStore: immutable, versioned, day-partitioned archive batches.

Reference: memstore/archive_store.go (ArchiveStore/ArchiveStoreVersion/
ArchiveBatch, batchID = days since epoch, lazy column load from disk,
copy-on-write version swap after archiving).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from aresdb_tpu_torch.common.schema import TableSchema
from aresdb_tpu_torch.memstore.vector_party import ArchiveVectorParty


class ArchiveBatch:
    """One day's archived data (columns lazily loaded from disk)."""

    def __init__(self, batch_id: int, version: int, seq: int, size: int,
                 store: "ArchiveStore"):
        self.batch_id = batch_id
        self.version = version
        self.seq = seq
        self.size = size  # row count
        self.store = store
        self.columns: Dict[int, Optional[ArchiveVectorParty]] = {}
        self.lock = threading.RLock()

    def request_column(self, column_id: int) -> Optional[ArchiveVectorParty]:
        """Get (lazily loading) one column; None means all-default."""
        with self.lock:
            if column_id in self.columns:
                return self.columns[column_id]
            vp = None
            if self.store.diskstore is not None:
                data = self.store.diskstore.read_archive_column(
                    self.store.schema.table.name, self.store.shard_id,
                    self.batch_id, self.version, self.seq, column_id)
                if data is not None:
                    vp = ArchiveVectorParty.from_bytes(data)
            self.set_column(column_id, vp)
            return vp

    def _report(self, column_id: int, nbytes: int) -> None:
        """Account this column's host bytes with the HostMemoryManager.

        All residency changes (lazy load, archiving set, eviction, purge)
        flow through here so managed accounting can't drift (reference:
        host_memory_manager.go ReportManagedObject callers)."""
        hmm = self.store.host_memory_manager
        if hmm is not None:
            hmm.report_managed_object(
                self.store.schema.table.name, self.store.shard_id,
                self.batch_id, column_id, nbytes)

    def set_column(self, column_id: int, vp: Optional[ArchiveVectorParty]) -> None:
        with self.lock:
            self.columns[column_id] = vp
        self._report(column_id, vp.bytes_estimate() if vp is not None else 0)

    def evict_column(self, column_id: int) -> bool:
        """Drop one column; returns True if bytes were released."""
        with self.lock:
            present = self.columns.pop(column_id, None) is not None
        if present:
            self._report(column_id, 0)
        return present

    def release(self) -> None:
        """Drop all loaded columns and zero their accounting (purge path)."""
        with self.lock:
            loaded = [cid for cid, vp in self.columns.items()
                      if vp is not None]
            self.columns.clear()
        for cid in loaded:
            self._report(cid, 0)


class ArchiveStoreVersion:
    """Immutable snapshot of the archive store at one archiving cutoff."""

    def __init__(self, cutoff: int, store: "ArchiveStore"):
        self.archiving_cutoff = cutoff
        self.store = store
        self.batches: Dict[int, ArchiveBatch] = {}
        self.lock = threading.RLock()

    def request_batch(self, batch_id: int) -> ArchiveBatch:
        with self.lock:
            b = self.batches.get(batch_id)
            if b is None:
                b = ArchiveBatch(batch_id, self.archiving_cutoff, 0, 0, self.store)
                self.batches[batch_id] = b
            return b

    def get_batch_ids_for_range(self, start_ts: int, end_ts: int) -> List[int]:
        """Batch ids (days) whose data may overlap [start_ts, end_ts)."""
        from aresdb_tpu_torch.memstore.common import SECONDS_PER_DAY
        with self.lock:
            lo = start_ts // SECONDS_PER_DAY if start_ts > 0 else -(2**31)
            hi = (end_ts - 1) // SECONDS_PER_DAY if end_ts > 0 else 2**31
            return sorted(b for b in self.batches if lo <= b <= hi)


class ArchiveStore:
    def __init__(self, schema: TableSchema, shard_id: int,
                 diskstore=None, metastore=None, host_memory_manager=None):
        self.schema = schema
        self.shard_id = shard_id
        self.diskstore = diskstore
        self.metastore = metastore
        self.host_memory_manager = host_memory_manager
        self.current_version = ArchiveStoreVersion(0, self)
        self.lock = threading.RLock()

    def get_current_version(self) -> ArchiveStoreVersion:
        with self.lock:
            return self.current_version

    def swap_version(self, new_version: ArchiveStoreVersion) -> None:
        """Publish a new version after archiving (reference: archive_store.go)."""
        with self.lock:
            self.current_version = new_version

    def load_metadata(self) -> None:
        """Populate batch list from the metastore (recovery path)."""
        if self.metastore is None:
            return
        cutoff = self.metastore.get_archiving_cutoff(
            self.schema.table.name, self.shard_id)
        version = ArchiveStoreVersion(cutoff, self)
        batches = self.metastore.get_archive_batches(
            self.schema.table.name, self.shard_id, cutoff)
        for bid, (ver, seq, size) in batches.items():
            version.batches[bid] = ArchiveBatch(bid, ver, seq, size, self)
        self.swap_version(version)
