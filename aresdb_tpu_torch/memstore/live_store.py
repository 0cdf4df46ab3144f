"""LiveStore: append-only live batches backed by redo logs.

Reference: memstore/live_store.go (LiveStore/LiveBatch, watermark protocol:
NextWriteRecord allocates, AdvanceLastReadRecord publishes rows to queries).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.common.schema import TableSchema
from aresdb_tpu_torch.memstore.common import BASE_BATCH_ID, RecordID
from aresdb_tpu_torch.memstore.primary_key import make_primary_key
from aresdb_tpu_torch.memstore.vector_party import LiveVectorParty


class LiveBatch:
    """One pre-allocated batch of the live store."""

    def __init__(self, batch_id: int, capacity: int, schema: TableSchema):
        self.batch_id = batch_id
        self.capacity = capacity
        self.schema = schema
        self.columns: Dict[int, LiveVectorParty] = {}
        # guards columns-dict MUTATION and whole-dict ITERATION (the
        # memory reporter iterates .values() from its own thread);
        # single-key reads stay lock-free (atomic under the GIL)
        self._columns_lock = threading.Lock()

    def get_or_create_column(self, column_id: int) -> LiveVectorParty:
        vp = self.columns.get(column_id)
        if vp is None:
            with self._columns_lock:
                vp = self.columns.get(column_id)
                if vp is None:
                    col = self.schema.table.columns[column_id]
                    vp = LiveVectorParty(self.capacity, col.data_type)
                    self.columns[column_id] = vp
        return vp

    def column_parties(self) -> List[LiveVectorParty]:
        with self._columns_lock:
            return list(self.columns.values())

    def column(self, column_id: int) -> Optional[LiveVectorParty]:
        return self.columns.get(column_id)

    def read_value(self, column_id: int, row: int) -> Any:
        vp = self.columns.get(column_id)
        if vp is None:
            return None
        return vp.read_value(row)


class LiveStore:
    """Live (unarchived, uncompressed) part of a table shard.

    Watermarks (reference live_store.go:80-86 lock protocol):
      next_write_record: first unallocated slot (writer only)
      last_read_record:  rows before this are visible to queries
    """

    def __init__(self, schema: TableSchema, batch_size: Optional[int] = None):
        self.schema = schema
        self.batch_size = batch_size or schema.table.config.batch_size
        self.batches: Dict[int, LiveBatch] = {}
        self.next_write_record = RecordID(BASE_BATCH_ID, 0)
        self.last_read_record = RecordID(BASE_BATCH_ID, 0)
        self.archiving_cutoff_high_watermark = 0
        self.backfill_cutoff = 0
        has_event_time = schema.table.is_fact_table
        self.primary_key = make_primary_key(schema.primary_key_bytes, has_event_time)
        self.lock = threading.RLock()

    # ------------------------------------------------------------------
    # batch management
    # ------------------------------------------------------------------

    def get_batch_ids(self) -> List[int]:
        """Batch ids visible for reads, in id order."""
        with self.lock:
            last = self.last_read_record
            ids = sorted(b for b in self.batches if b < last.batch_id)
            if last.index > 0 and last.batch_id in self.batches:
                ids.append(last.batch_id)
            return ids

    def visible_rows_in_batch(self, batch_id: int) -> int:
        last = self.last_read_record
        if batch_id < last.batch_id:
            return self.batches[batch_id].capacity
        if batch_id == last.batch_id:
            return last.index
        return 0

    def get_batch(self, batch_id: int) -> LiveBatch:
        return self.batches[batch_id]

    def _get_or_create_batch(self, batch_id: int) -> LiveBatch:
        # must hold self.lock (RLock, so locked callers nest fine):
        # readers iterate self.batches under the lock, and an unlocked
        # insert here raced them to "dictionary changed size during
        # iteration" (caught by test_race_harness's lifecycle storm)
        with self.lock:
            b = self.batches.get(batch_id)
            if b is None:
                b = LiveBatch(batch_id, self.batch_size, self.schema)
                self.batches[batch_id] = b
            return b

    # ------------------------------------------------------------------
    # record allocation (reference live_store.go AdvanceNextWriteRecord)
    # ------------------------------------------------------------------

    def allocate_records(self, count: int) -> List[RecordID]:
        """Allocate `count` consecutive slots, spilling across batches."""
        out: List[RecordID] = []
        batch_id, index = self.next_write_record
        for _ in range(count):
            if index >= self.batch_size:
                batch_id += 1
                index = 0
            self._get_or_create_batch(batch_id)
            out.append(RecordID(batch_id, index))
            index += 1
        self.next_write_record = RecordID(batch_id, index)
        return out

    def set_next_write_record(self, batch_id: int, index: int) -> None:
        """Install an externally-allocated write position (native classify),
        creating any batches the allocation spilled into."""
        cur = self.next_write_record.batch_id
        for bid in range(cur, batch_id + 1):
            self._get_or_create_batch(bid)
        self.next_write_record = RecordID(batch_id, index)

    def advance_last_read_record(self) -> None:
        """Publish all written rows to queries."""
        with self.lock:
            self.last_read_record = self.next_write_record

    def purge_batches_before(self, batch_id_exclusive: int, index: int = 0) -> int:
        """Drop fully-archived batches (reference: PurgeBatches)."""
        purged = 0
        with self.lock:
            for bid in sorted(self.batches):
                if bid < batch_id_exclusive:
                    del self.batches[bid]
                    purged += 1
        return purged

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def rows_visible(self) -> int:
        total = 0
        for bid in self.get_batch_ids():
            total += self.visible_rows_in_batch(bid)
        return total

    def bytes_estimate(self) -> int:
        total = self.primary_key.allocated_bytes()
        with self.lock:
            batches = list(self.batches.values())
        for b in batches:
            for vp in b.column_parties():
                if vp.values is not None:
                    total += vp.values.nbytes
                total += vp.validity.nbytes
        return total

    def snapshot_columns(self, column_ids: List[int]):
        """Read-visible (batch_id, n_rows, {col: LiveVectorParty}) triples."""
        out = []
        with self.lock:
            for bid in self.get_batch_ids():
                n = self.visible_rows_in_batch(bid)
                if n > 0:
                    out.append((bid, n, self.batches[bid]))
        return out
