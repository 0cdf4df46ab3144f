"""Vector parties: one column of one batch.

Reference capabilities: memstore/common/vector_party.go (modes 0-3),
memstore/live_vector_party.go, memstore/archive_vector_party.go,
memstore/common/vector_party_serializer.go (magic 0xFADEFACE).

TPU-first design notes:
- Columns are numpy arrays (values, bool validity, optional uint32 counts)
  instead of bit-packed C buffers; validity is byte-per-row so it can be
  staged to TPU and used directly as a mask lane.
- Archive mode 3 (run-length by sorted columns) stores cumulative counts; for
  query execution the expanded view is materialized once per (batch, column)
  on the host and cached, trading host memory for static-shape TPU iteration
  (see SURVEY.md §7 'Mode-3 compressed iteration').
- UUID and GeoPoint are 2-lane arrays (n, 2).
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional

import numpy as np

from aresdb_tpu_torch.common import data_types as dt

# Serialization magic kept identical to the reference VP files for easy
# identification of column data files (vector_party_serializer.go).
VP_MAGIC = 0xFADEFACE
VP_VERSION = 1

_UID_COUNTER = [0]


def _next_uid() -> int:
    _UID_COUNTER[0] += 1
    return _UID_COUNTER[0]


MODE_ALL_DEFAULT = 0
MODE_ALL_PRESENT = 1
MODE_HAS_NULLS = 2
MODE_COMPRESSED = 3  # sorted archive columns with counts


def _values_shape(n: int, data_type: int):
    return (n, 2) if dt.lanes(data_type) == 2 else (n,)


class LiveVectorParty:
    """Mutable pre-allocated column for a live batch.

    Reference: memstore/live_vector_party.go cLiveVectorParty.
    """

    def __init__(self, capacity: int, data_type: int,
                 default_value: Optional[Any] = None):
        self.data_type = data_type
        self.capacity = capacity
        self.default_value = default_value
        # uid + version key device staging caches (uid is never reused,
        # unlike id() after garbage collection)
        self.uid = _next_uid()
        self.version = 0
        if dt.is_array_type(data_type) or data_type == dt.GeoShape:
            # variable-length columns are python-object backed in live store
            self.list_values: Optional[List[Any]] = [None] * capacity
            self.values = None
        else:
            self.list_values = None
            self.values = np.zeros(_values_shape(capacity, data_type),
                                   dtype=dt.numpy_dtype(data_type))
        self.validity = np.zeros(capacity, dtype=bool)

    @property
    def is_list(self) -> bool:
        return self.list_values is not None

    def write_rows(self, indexes: np.ndarray, values: Optional[np.ndarray],
                   validity: np.ndarray, list_values: Optional[List[Any]] = None
                   ) -> None:
        """Vectorized scatter of decoded upsert-batch rows into this column."""
        self.version += 1
        if self.is_list:
            for i, idx in enumerate(indexes):
                self.list_values[int(idx)] = (
                    list_values[i] if validity[i] else None
                )
            self.validity[indexes] = validity
            return
        self.values[indexes] = values
        self.validity[indexes] = validity

    def read_value(self, index: int) -> Any:
        if self.is_list:
            return self.list_values[index]
        if not self.validity[index]:
            return None
        v = self.values[index]
        if dt.lanes(self.data_type) == 2:
            return (v[0].item(), v[1].item())
        return v.item()

    def slice(self, n: int) -> "ArchiveVectorParty":
        """Immutable snapshot of the first n rows (used by archiving/snapshot)."""
        if self.is_list:
            return ArchiveVectorParty(
                self.data_type, values=None, validity=self.validity[:n].copy(),
                list_values=list(self.list_values[:n]))
        return ArchiveVectorParty(
            self.data_type, values=self.values[:n].copy(),
            validity=self.validity[:n].copy())


class ArchiveVectorParty:
    """Immutable column, optionally run-length compressed (mode 3).

    For mode 3, `counts` holds cumulative row counts of length len(values)+1
    (counts[0] == 0, counts[-1] == num_rows), matching the reference's
    count-vector semantics (memstore/vector_party.go mode 3).
    """

    def __init__(self, data_type: int, values: Optional[np.ndarray],
                 validity: np.ndarray, counts: Optional[np.ndarray] = None,
                 list_values: Optional[List[Any]] = None,
                 num_rows: Optional[int] = None):
        self.data_type = data_type
        self.values = values
        self.validity = validity
        self.counts = counts
        self.list_values = list_values
        if num_rows is not None:
            self.num_rows = num_rows
        elif counts is not None:
            self.num_rows = int(counts[-1])
        else:
            self.num_rows = len(validity)
        self.uid = _next_uid()
        self._expanded_cache: Optional["ArchiveVectorParty"] = None

    @property
    def is_list(self) -> bool:
        return self.list_values is not None

    @property
    def is_compressed(self) -> bool:
        return self.counts is not None

    @property
    def mode(self) -> int:
        if self.is_compressed:
            return MODE_COMPRESSED
        if not self.validity.any():
            return MODE_ALL_DEFAULT
        if self.validity.all():
            return MODE_ALL_PRESENT
        return MODE_HAS_NULLS

    def bytes_estimate(self) -> int:
        total = self.validity.nbytes if self.validity is not None else 0
        if self.values is not None:
            total += self.values.nbytes
        if self.counts is not None:
            total += self.counts.nbytes
        if self.list_values is not None:
            total += sum(64 for _ in self.list_values)
        return total

    def expanded(self) -> "ArchiveVectorParty":
        """Decompress mode 3 into a row-per-entry view (cached).

        This is the host-side Expand equivalent of the reference's
        binary-search iterator (query/iterator.hpp:214-240) — TPU kernels get
        a flat, static-shape column.
        """
        if not self.is_compressed:
            return self
        if self._expanded_cache is None:
            runs = np.diff(self.counts.astype(np.int64))
            values = np.repeat(self.values, runs, axis=0)
            validity = np.repeat(self.validity, runs)
            self._expanded_cache = ArchiveVectorParty(
                self.data_type, values=values, validity=validity)
        return self._expanded_cache

    def read_value(self, row: int) -> Any:
        """Logical row accessor (resolves compression)."""
        vp = self.expanded() if self.is_compressed else self
        if vp.is_list:
            return vp.list_values[row]
        if not vp.validity[row]:
            return None
        v = vp.values[row]
        if dt.lanes(self.data_type) == 2:
            return (v[0].item(), v[1].item())
        return v.item()

    # ------------------------------------------------------------------
    # serialization: [u32 magic][u32 version][u32 data_type][u8 mode]
    # [u8 is_list][u16 reserved][i64 num_rows][i64 num_entries]
    # [validity bytes][values raw LE][counts raw u32] ; list VPs store a
    # u32-length-prefixed ArrayValue blob per entry.
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        n_entries = len(self.validity)
        header = struct.pack(
            "<IIIBBHqq", VP_MAGIC, VP_VERSION, self.data_type, self.mode,
            1 if self.is_list else 0, 0, self.num_rows, n_entries)
        parts = [header, self.validity.astype(np.uint8).tobytes()]
        if self.is_list:
            from aresdb_tpu_torch.common.upsert_batch import _serialize_array_value
            item_dt = dt.item_type(self.data_type)
            for v in self.list_values:
                blob = _serialize_array_value(v, item_dt) if v is not None else b""
                parts.append(struct.pack("<I", len(blob)))
                parts.append(blob)
        else:
            parts.append(np.ascontiguousarray(self.values).tobytes())
        if self.counts is not None:
            parts.append(self.counts.astype(np.uint32).tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ArchiveVectorParty":
        magic, version, data_type, mode, is_list, _, num_rows, n_entries = (
            struct.unpack_from("<IIIBBHqq", data, 0))
        if magic != VP_MAGIC:
            raise ValueError(f"bad vector party magic 0x{magic:08x}")
        if version != VP_VERSION:
            raise ValueError(f"unsupported vector party version {version}")
        off = struct.calcsize("<IIIBBHqq")
        validity = np.frombuffer(data, dtype=np.uint8, count=n_entries,
                                 offset=off).astype(bool)
        off += n_entries
        values = None
        list_values = None
        if is_list:
            from aresdb_tpu_torch.common.upsert_batch import _deserialize_array_value
            item_dt = dt.item_type(data_type)
            list_values = []
            mv = memoryview(data)
            for i in range(n_entries):
                (blen,) = struct.unpack_from("<I", data, off)
                off += 4
                if blen == 0:
                    list_values.append(None)
                else:
                    list_values.append(_deserialize_array_value(mv[off:off + blen], item_dt))
                    off += blen
        else:
            npdt = dt.numpy_dtype(data_type)
            shape = _values_shape(n_entries, data_type)
            count = int(np.prod(shape)) if n_entries else 0
            values = np.frombuffer(data, dtype=npdt, count=count,
                                   offset=off).reshape(shape).copy()
            off += values.nbytes
        counts = None
        if mode == MODE_COMPRESSED:
            counts = np.frombuffer(data, dtype=np.uint32, count=n_entries + 1,
                                   offset=off).copy()
        return cls(data_type, values=values, validity=validity, counts=counts,
                   list_values=list_values, num_rows=num_rows)
