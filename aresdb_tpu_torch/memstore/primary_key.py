"""Primary key index: key bytes -> RecordID, with optional event-time TTL.

Capability parity with the reference CuckooIndex (memstore/cuckoo_index.go:66,
memstore/common/primary_key.go): FindOrInsert / Update / Delete semantics,
eventTime-based lazy expiration, and size reporting.

TPU-native design departure: the reference shares its cuckoo bucket memory
layout between the Go writer and a GPU probe kernel (query/hash_lookup.cu).
On TPU the join probe instead uses a per-snapshot sorted key table probed
with vectorized searchsorted (see query/join.py), so the host index only
needs to be a fast exact map. The default backend is a python dict (C++
open-addressing backend is a planned optimization); keys are the packed
little-endian concatenation of the primary-key column values, built
vectorized in build_keys().
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.memstore.common import RecordID


def build_keys(columns: List[np.ndarray], n: int) -> List[bytes]:
    """Build per-row packed key bytes from primary-key column arrays.

    Each array is (n,) scalar or (n, 2) for UUID/GeoPoint lanes; bytes are
    the little-endian concatenation in column order (matching the reference's
    key layout in memstore/ingestion.go insertPrimaryKeys).
    """
    if not columns:
        return [b""] * n
    if n == 0:
        # reshape(0, -1) cannot infer the trailing dim of an empty array
        return []
    buffers = []
    for col in columns:
        c = np.ascontiguousarray(col[:n])
        buffers.append(c.reshape(n, -1).view(np.uint8).reshape(n, -1))
    packed = np.hstack(buffers)
    width = packed.shape[1]
    raw = packed.tobytes()
    return [raw[i * width:(i + 1) * width] for i in range(n)]


def make_primary_key(key_bytes: int, has_event_time: bool = False):
    """Native C++ cuckoo index when available, python dict fallback.

    Disable the native backend with ARES_NATIVE=0. ARES_PK_PARTS picks the
    native variant: a hash-partitioned index (2/4/8/16 partitions) whose
    batch classification runs one thread per partition with
    byte-identical results (every row resolves inline in row order
    within its partition — no fallback path); 1 = single serial table.
    Default 8: the probe loop is DRAM-latency bound, so oversubscribing
    threads past the core count keeps hiding stalls — measured on a
    4-core host at 16M keys, end-to-end ingest with WAL: serial 1.9,
    parts=2 2.8, parts=4 ~3.1, parts=8 ~3.4 M rows/s (parts=16 within
    noise of 8).
    """
    import os

    if os.environ.get("ARES_NATIVE", "1") != "0":
        try:
            from aresdb_tpu_torch.memstore.native_primary_key import NativePrimaryKey

            mode = os.environ.get("ARES_PK_PARTS", "8")
            parts = 8 if mode == "auto" else int(mode)
            return NativePrimaryKey(key_bytes, has_event_time, parts=parts)
        except (RuntimeError, OSError, ValueError):
            pass
    return PrimaryKey(key_bytes, has_event_time)


class PrimaryKey:
    """Exact-map primary key index with event-time TTL (python fallback)."""

    def __init__(self, key_bytes: int, has_event_time: bool = False):
        self.key_bytes = key_bytes
        self.has_event_time = has_event_time
        self._map: Dict[bytes, RecordID] = {}
        # event time per key for TTL expiry (fact tables only)
        self._event_times: Optional[Dict[bytes, int]] = (
            {} if has_event_time else None)
        self.eviction_threshold: int = 0  # unix ts; keys older are expired

    def __len__(self) -> int:
        return len(self._map)

    def allocated_bytes(self) -> int:
        # rough: key bytes + 16 bytes record id + dict overhead estimate
        per = self.key_bytes + 16 + 64
        return per * len(self._map)

    def update_event_time_cutoff(self, cutoff: int) -> None:
        """Advance the TTL threshold (reference: UpdateEventTimeCutoff)."""
        self.eviction_threshold = cutoff

    def _is_expired(self, key: bytes) -> bool:
        if self._event_times is None or self.eviction_threshold == 0:
            return False
        et = self._event_times.get(key)
        return et is not None and et < self.eviction_threshold

    def find(self, key: bytes) -> Optional[RecordID]:
        rec = self._map.get(key)
        if rec is None:
            return None
        if self._is_expired(key):
            del self._map[key]
            self._event_times.pop(key, None)
            return None
        return rec

    def find_or_insert(self, key: bytes, record_id: RecordID,
                       event_time: int = 0) -> Tuple[bool, RecordID]:
        """Returns (existing, record_id_in_index).

        When the key already exists, returns its current RecordID; otherwise
        inserts record_id and returns it.
        """
        if self._event_times is not None and self.eviction_threshold \
                and event_time < self.eviction_threshold:
            # reference cuckoo_index.go FindOrInsert: event time below the
            # TTL cutoff is an error (the row belongs to backfill)
            raise ValueError("event time is older than the TTL cutoff")
        existing = self.find(key)
        if existing is not None:
            return True, existing
        self._map[key] = record_id
        if self._event_times is not None:
            self._event_times[key] = event_time
        return False, record_id

    def update(self, key: bytes, record_id: RecordID) -> bool:
        if key in self._map:
            self._map[key] = record_id
            return True
        return False

    def delete(self, key: bytes) -> None:
        self._map.pop(key, None)
        if self._event_times is not None:
            self._event_times.pop(key, None)

    def items(self) -> Iterable[Tuple[bytes, RecordID]]:
        return self._map.items()

    def clear(self) -> None:
        self._map.clear()
        if self._event_times is not None:
            self._event_times.clear()


def key_columns_from_batch_columns(
        schema_key_ids: List[int],
        batch_cols_by_column_id: Dict[int, "object"],
        n: int) -> Tuple[List[np.ndarray], np.ndarray]:
    """Extract PK column value arrays (and combined validity) from a decoded
    upsert batch, in schema PK order. Raises if a PK column is missing."""
    cols = []
    valid = np.ones(n, dtype=bool)
    for cid in schema_key_ids:
        col = batch_cols_by_column_id.get(cid)
        if col is None:
            raise ValueError(f"upsert batch missing primary key column {cid}")
        if col.values is None:
            raise ValueError(f"primary key column {cid} cannot be an array type")
        cols.append(col.values)
        valid &= col.validity
    return cols, valid
