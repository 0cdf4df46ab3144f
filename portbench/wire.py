"""A frozen copy of the columnar upsert encoder.

The wire bytes that set-up and the senders post come from here and not
from the port's `common/upsert_batch.py`, so that a change to the port
cannot move the yardstick. The layout is AresDB's upsert batch
(memstore/common/upsert_batch.go:119-151):

    [uint32] version (0xFEED0001)  [int32] rows  [uint16] columns
    <14 reserved bytes>  [uint32] arrival time
    [uint32] column end offsets (columns + 1)
    [uint32] enum dict lengths, reserved, data types (a column each)
    [uint16] column ids  [uint8] flags (mode & 7 | update mode << 3)
    a column's payload: its null bits (LSB first) where it has nulls,
    padded to 8, then its values; the whole padded to 8.

Standard library and numpy only.
"""

from __future__ import annotations

import struct
import time

import numpy as np

V1 = 0xFEED0001
ALL_VALUES_DEFAULT = 0
ALL_VALUES_PRESENT = 1
HAS_NULL_VECTOR = 2

# AresDB's data type codes (memstore/common/data_type.go)
Bool = 0x00000001
Uint8 = 0x00020008
Uint16 = 0x00040010
Uint32 = 0x00060020
Float32 = 0x00070020
SmallEnum = 0x00080008
UUID = 0x000A0080

TYPE_CODES = {"Bool": Bool, "Uint8": Uint8, "Uint16": Uint16,
              "Uint32": Uint32, "Float32": Float32, "SmallEnum": SmallEnum,
              "UUID": UUID}
LANE_DTYPE = {Uint8: np.uint8, Uint16: np.uint16, Uint32: np.uint32,
              Float32: np.float32, SmallEnum: np.uint8, UUID: np.uint64}


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


def _pack_bits(flags: np.ndarray) -> bytes:
    return np.packbits(flags.astype(np.uint8), bitorder="little").tobytes()


def _column_header_size(num_cols: int) -> int:
    return (num_cols + 1) * 4 + num_cols * 4 * 3 + num_cols * 2 + num_cols


def encode(columns, num_rows: int, arrival_time=None) -> bytes:
    """The upsert batch of `columns`, a list of (column id, data type code,
    values, validity or None, update mode): values (n,) or, for UUID,
    (n, 2) uint64 lanes."""
    num_cols = len(columns)
    header_size = 4 + 24 + _column_header_size(num_cols)
    payloads, modes = [], []
    for (_cid, dtype, values, validity, _um) in columns:
        v = np.ascontiguousarray(values)
        all_valid = validity is None or bool(np.all(validity))
        prefix = b""
        mode = ALL_VALUES_PRESENT
        if not all_valid:
            mode = HAS_NULL_VECTOR
            prefix = _pack_bits(np.ascontiguousarray(validity, dtype=bool))
            prefix += b"\x00" * ((-len(prefix)) % 8)
        if dtype == Bool:
            body = _pack_bits(v.astype(bool))
        else:
            body = v.astype(np.dtype(LANE_DTYPE[dtype]).newbyteorder("<"),
                            copy=False).tobytes()
        payloads.append(prefix + body)
        modes.append(mode)

    size = header_size
    starts = []
    for pl in payloads:
        size = _align(size, 8) if pl else size
        starts.append(size)
        size += len(pl)
    end_of_data = size
    buf = bytearray(_align(size, 8))
    struct.pack_into("<I", buf, 0, V1)
    struct.pack_into("<i", buf, 4, num_rows)
    struct.pack_into("<H", buf, 8, num_cols)
    arrival = int(time.time()) if arrival_time is None else arrival_time
    struct.pack_into("<I", buf, 24, arrival & 0xFFFFFFFF)
    h = 28
    type_off = h + (num_cols + 1) * 4 + num_cols * 8
    id_off = type_off + num_cols * 4
    mode_off = id_off + num_cols * 2
    for i, ((cid, dtype, _v, _b, um), pl) in enumerate(zip(columns,
                                                           payloads)):
        struct.pack_into("<I", buf, h + i * 4, starts[i])
        buf[starts[i]:starts[i] + len(pl)] = pl
        struct.pack_into("<I", buf, type_off + i * 4, dtype)
        struct.pack_into("<H", buf, id_off + i * 2, cid)
        struct.pack_into("<B", buf, mode_off + i,
                         (modes[i] & 0x7) | ((um & 0x7) << 3))
    struct.pack_into("<I", buf, h + num_cols * 4, end_of_data)
    return bytes(buf)
