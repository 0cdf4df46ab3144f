"""Native cuckoo-index PrimaryKey backend + batch classification.

Wraps aresdb_tpu_torch/native/cuckoo_index.cpp behind the same interface as the
Python PrimaryKey (memstore/primary_key.py), plus `classify_batch` which
executes the whole per-row insertPrimaryKeys loop
(reference: memstore/ingestion.go:172) in one native call.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch import native
from aresdb_tpu_torch.memstore.common import RecordID


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativePrimaryKey:
    """ctypes wrapper over the C++ cuckoo index."""

    def __init__(self, key_bytes: int, has_event_time: bool = False,
                 init_buckets: int = 1024, parts: int = 1):
        """parts in {2, 4, 8, 16} selects the hash-partitioned index
        (pk2_* family) whose classify_batch runs its probe/insert loop
        on `parts` threads with byte-identical results to the serial
        table; parts=1 is the single serial table."""
        lib = native.load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if parts not in (1, 2, 4, 8, 16):
            raise RuntimeError(f"unsupported parts={parts}")
        self._lib = lib
        pre = "pk2_" if parts > 1 else "cuckoo_"
        self.parts = parts
        if parts > 1:
            self._new = lambda kb, et, ib: lib.pk2_new(kb, et, ib, parts)
        else:
            self._new = lib.cuckoo_new
        self._free = getattr(lib, pre + "free")
        self._size = getattr(lib, pre + "size")
        self._bytes = getattr(lib, pre + "bytes")
        self._set_cutoff = getattr(lib, pre + "set_cutoff")
        self._find = getattr(lib, pre + "find")
        self._find_or_insert = getattr(lib, pre + "find_or_insert")
        self._update = getattr(lib, pre + "update")
        self._delete = getattr(lib, pre + "delete")
        self._classify = getattr(lib, pre + "classify")
        self._dump = getattr(lib, pre + "dump")
        self.key_bytes = max(1, key_bytes)
        self.has_event_time = has_event_time
        self.eviction_threshold = 0
        self._h = self._new(self.key_bytes, int(has_event_time),
                            init_buckets)
        if not self._h:
            raise RuntimeError("cuckoo_new failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._size(self._h))

    def allocated_bytes(self) -> int:
        return int(self._bytes(self._h))

    def update_event_time_cutoff(self, cutoff: int) -> None:
        self.eviction_threshold = cutoff
        self._set_cutoff(self._h, ctypes.c_uint32(cutoff))

    def reserve(self, extra: int) -> None:
        """Grow once for `extra` incoming keys: chunked classification
        would otherwise re-double the tables several times mid-batch
        (each doubling re-inserts every key)."""
        fn = (self._lib.pk2_reserve if self.parts > 1
              else self._lib.cuckoo_reserve)
        fn(self._h, ctypes.c_int64(extra))

    def _key_buf(self, key: bytes) -> np.ndarray:
        b = np.frombuffer(key.ljust(self.key_bytes, b"\0")[:self.key_bytes],
                          dtype=np.uint8)
        return np.ascontiguousarray(b)

    def find(self, key: bytes) -> Optional[RecordID]:
        batch = ctypes.c_int32()
        index = ctypes.c_uint32()
        if self._find(self._h, _u8p(self._key_buf(key)),
                                 ctypes.byref(batch), ctypes.byref(index)):
            return RecordID(batch.value, index.value)
        return None

    def find_or_insert(self, key: bytes, record_id: RecordID,
                       event_time: int = 0) -> Tuple[bool, RecordID]:
        batch = ctypes.c_int32()
        index = ctypes.c_uint32()
        existing = self._find_or_insert(
            self._h, _u8p(self._key_buf(key)),
            ctypes.c_int32(record_id.batch_id),
            ctypes.c_uint32(record_id.index),
            ctypes.c_uint32(event_time & 0xFFFFFFFF),
            ctypes.byref(batch), ctypes.byref(index))
        if existing < 0:
            # reference cuckoo_index.go FindOrInsert: event time below the
            # TTL cutoff is an error (the row belongs to backfill)
            raise ValueError("event time is older than the TTL cutoff")
        return bool(existing), RecordID(batch.value, index.value)

    def update(self, key: bytes, record_id: RecordID) -> bool:
        return bool(self._update(
            self._h, _u8p(self._key_buf(key)),
            ctypes.c_int32(record_id.batch_id),
            ctypes.c_uint32(record_id.index)))

    def delete(self, key: bytes) -> None:
        self._delete(self._h, _u8p(self._key_buf(key)))

    def items(self) -> Iterable[Tuple[bytes, RecordID]]:
        n = len(self)
        if n == 0:
            return []
        keys = np.zeros((n, self.key_bytes), np.uint8)
        batches = np.zeros(n, np.int32)
        indexes = np.zeros(n, np.uint32)
        got = self._dump(
            self._h, _u8p(keys),
            batches.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indexes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(n))
        return [(keys[i].tobytes(), RecordID(int(batches[i]), int(indexes[i])))
                for i in range(got)]

    def clear(self) -> None:
        self._free(self._h)
        self._h = self._new(self.key_bytes,
                                       int(self.has_event_time), 1024)

    # ------------------------------------------------------------------

    def classify_batch(self, key_matrix: np.ndarray, key_valid: np.ndarray,
                       event_times: Optional[np.ndarray], cutoff: int,
                       retention_ts: int, future_ts: int, next_batch: int,
                       next_index: int, batch_capacity: int):
        """One native call classifying all rows of an upsert batch.

        Returns (actions u8[n], dest_batch i32[n], dest_index u32[n],
                 counts[8]) where counts = [inserted, updated, backfilled,
                 retention, nullpk, new_next_batch, new_next_index, future].
        """
        n = len(key_valid)
        km = np.ascontiguousarray(key_matrix, np.uint8)
        kv = np.ascontiguousarray(key_valid, np.uint8)
        et = (np.ascontiguousarray(event_times, np.int64)
              if event_times is not None else None)
        actions = np.zeros(n, np.uint8)
        out_batch = np.zeros(n, np.int32)
        out_index = np.zeros(n, np.uint32)
        counts = np.zeros(8, np.int32)
        self._classify(
            self._h, _u8p(km), ctypes.c_int(n), _u8p(kv),
            et.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            if et is not None else None,
            ctypes.c_int64(cutoff), ctypes.c_int64(retention_ts),
            ctypes.c_int64(future_ts),
            ctypes.c_int32(next_batch), ctypes.c_uint32(next_index),
            ctypes.c_uint32(batch_capacity),
            _u8p(actions),
            out_batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return actions, out_batch, out_index, counts


def build_key_matrix(columns: List[np.ndarray], n: int) -> np.ndarray:
    """Packed (n, key_bytes) uint8 key matrix (vectorized)."""
    if not columns:
        return np.zeros((n, 1), np.uint8)
    buffers = []
    for col in columns:
        c = np.ascontiguousarray(col[:n])
        buffers.append(c.reshape(n, -1).view(np.uint8).reshape(n, -1))
    return np.ascontiguousarray(np.hstack(buffers))
