"""Binary HLL wire format: the `application/hll` response surface.

Byte-level parity with the reference format:
 - query/common/hll.go:30-69 — magic 0xACED0102, per-result framing,
   HLLData block layout (header, dim value vector, count vector, hll
   vector), enum dicts delimited by "\\u0000\\n".
 - query/common/hll.go:871 HLLDataWriter.SerializeHeader, :84
   CalculateSizes, :119 CalculateEnumCasesBytes.
 - query/common/hll.go:583 ParseHLLQueryResults, :371
   parseTimeseriesHLLResult, :327 readHLL (sparse records are
   u32 = rho<<16 | register_index; dense blocks are 16KiB rho bytes).
 - query/common/dimval.go:122 GetDimensionStartOffsets and
   dim_util.go:43 DimValResVectorSize — dim values sorted by byte width
   (16/8/4/2/1), null bytes one per dim per row after all values.
 - query/hll.go:28 SerializeHLL (PostprocessAsHLLData,
   query/aql_postprocessor.go:164): data types / enum reverse dicts per
   query dimension, timezone fix-up for time dimensions.
 - query/common/hll.go:943 HLLQueryResults writer framing.

The serializer consumes the executor's finished group table (registers per
group) instead of device vectors — the TPU kernel already materializes
[K, 16384] register planes, so serialization is one numpy pass.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import hll as H

HLL_MAGIC_V1 = 0xACED0101  # OldHLLDataHeader (query/common/hll.go:32)
HLL_MAGIC_V2 = 0xACED0102  # HLLDataHeader (query/common/hll.go:34)
ENUM_DELIMITER = b"\x00\n"
DENSE_DATA_LENGTH = 1 << 14          # 16KiB dense register block
DENSE_THRESHOLD = DENSE_DATA_LENGTH // 4  # >= 4096 non-zero => dense
CONTENT_TYPE = "application/hll"

_WIDTH_ORDER = (16, 8, 4, 2, 1)  # DimCountsPerDimWidth bucket widths


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclass
class HLL:
    """Sparse/dense HLL registers (reference HLL struct, hll.go:139)."""

    sparse_data: Optional[List[Tuple[int, int]]] = None  # (index, rho)
    dense_data: Optional[bytes] = None
    non_zero_registers: int = 0

    @classmethod
    def from_registers(cls, registers: np.ndarray) -> "HLL":
        registers = np.asarray(registers, np.uint8)
        nz = int(np.count_nonzero(registers))
        if nz >= DENSE_THRESHOLD:
            return cls(dense_data=registers.tobytes(), non_zero_registers=nz)
        idx = np.nonzero(registers)[0]
        return cls(sparse_data=list(zip(idx.tolist(),
                                        registers[idx].tolist())),
                   non_zero_registers=nz)

    def registers(self) -> np.ndarray:
        if self.dense_data is not None:
            return np.frombuffer(self.dense_data, np.uint8).copy()
        regs = np.zeros(H.HLL_M, np.uint8)
        for idx, rho in self.sparse_data or []:
            regs[idx] = max(regs[idx], rho)
        return regs

    def merge(self, other: "HLL") -> "HLL":
        return HLL.from_registers(
            np.maximum(self.registers(), other.registers()))

    def compute(self) -> float:
        return H.compute_estimate(self.registers())

    def canonical(self) -> "HLL":
        """Form whose encode matches the count-vector branch in readHLL:
        sparse iff non_zero < DENSE_THRESHOLD (ConvertToSparse semantics,
        query/common/hll.go:183)."""
        if (self.non_zero_registers < DENSE_THRESHOLD) == (
                self.dense_data is None):
            return self
        return HLL.from_registers(self.registers())

    def encode_binary(self) -> bytes:
        """Wire body bytes (EncodeBinary, hll.go:690): dense verbatim, sparse
        4-byte padded records rho<<16|index."""
        if self.dense_data is not None:
            return self.dense_data
        out = np.zeros(len(self.sparse_data or []), "<u4")
        for i, (idx, rho) in enumerate(self.sparse_data or []):
            out[i] = (rho << 16) | idx
        return out.tobytes()

    def __eq__(self, other):
        if not isinstance(other, HLL):
            return NotImplemented
        return np.array_equal(self.registers(), other.registers())


@dataclass
class HLLDimensionSpec:
    """Per-query-dimension wire metadata."""

    data_type: int                      # mdt 0xCCWWWW code
    enum_dict: Optional[List[str]] = None
    is_time: bool = False
    from_offset: int = 0
    to_offset: int = 0
    dst_switch_ts: int = 0


# ---------------------------------------------------------------------------
# serializer
# ---------------------------------------------------------------------------

def dimension_vector_index(dim_specs: List[HLLDimensionSpec]) -> List[int]:
    """Query-dim → width-sorted vector slot (sortDimensionColumns,
    query/aql_compiler.go:1341): stable by query order within each width."""
    index = [0] * len(dim_specs)
    ordered = 0
    for width in _WIDTH_ORDER:
        for i, spec in enumerate(dim_specs):
            if mdt.data_type_bytes(spec.data_type) == width:
                index[i] = ordered
                ordered += 1
    return index


def _num_dims_per_width(dim_specs: List[HLLDimensionSpec]) -> List[int]:
    counts = [0] * len(_WIDTH_ORDER)
    for spec in dim_specs:
        counts[_WIDTH_ORDER.index(mdt.data_type_bytes(spec.data_type))] += 1
    return counts


def _dim_value_bytes(value, dt: int) -> bytes:
    nb = mdt.data_type_bytes(dt)
    if dt == mdt.UUID:
        v = np.asarray(value).reshape(2).astype(np.uint64)
        return v.astype("<u8").tobytes()
    if dt == mdt.GeoPoint:
        v = np.asarray(value).reshape(2).astype(np.float32)
        return v.astype("<f4").tobytes()
    if dt == mdt.Float32:
        return struct.pack("<f", float(value))
    iv = int(value)
    fmt = {1: "B", 2: "H", 4: "I", 8: "Q"}[nb]
    signed = dt in (mdt.Int8, mdt.Int16, mdt.Int32, mdt.Int64, mdt.Bool)
    if signed:
        fmt = fmt.lower()
    else:
        iv &= (1 << (8 * nb)) - 1
    return struct.pack("<" + fmt, iv)


def adjust_offset(from_offset: int, to_offset: int, switch_ts: int,
                  value: int) -> int:
    """utils.AdjustOffset — subtract the applicable tz offset around a DST
    switch."""
    if switch_ts and value >= switch_ts:
        return value - to_offset
    return value - from_offset


def serialize_hll_block(rows: List[Tuple[List[Any], List[bool], HLL]],
                        dim_specs: List[HLLDimensionSpec]) -> bytes:
    """One query's HLLData block (SerializeHLL, query/hll.go:28).

    rows: (dim_values, dim_valids, hll) per result row. Empty rows →
    empty payload (PostprocessAsHLLData, aql_postprocessor.go:166).
    """
    if not rows:
        return b""
    n = len(rows)
    n_dims = len(dim_specs)
    counts_per_width = _num_dims_per_width(dim_specs)
    vec_index = dimension_vector_index(dim_specs)

    # --- header ---
    out = bytearray()
    # production parity: every dimension gets an enum-dict entry, empty for
    # non-enum dims (PostprocessAsHLLData fills reverseDicts for all dims)
    enum_entries = [(i, spec.enum_dict or []) for i, spec in
                    enumerate(dim_specs)]
    out.append(len(enum_entries))
    out += bytes(counts_per_width)
    out += b"\x00" * (_align8(len(out)) - len(out))
    # result_size / padded raw dim vector length
    value_bytes = sum(mdt.data_type_bytes(s.data_type) for s in dim_specs)
    raw_dim_len = _align8(value_bytes * n + n_dims * n)
    out += struct.pack("<II", n, raw_dim_len)
    out += bytes(vec_index)
    out += b"\x00" * (_align8(len(out)) - len(out))
    for spec in dim_specs:
        out += struct.pack("<I", spec.data_type)
    out += b"\x00" * (_align8(len(out)) - len(out))
    for dim_idx, cases in enum_entries:
        body = b"".join(c.encode() + ENUM_DELIMITER for c in cases)
        padded = _align8(len(body))
        out += struct.pack("<IH2x", padded, dim_idx)
        out += body + b"\x00" * (padded - len(body))

    # --- dim value vector: values by width-sorted slot, then null bytes ---
    order = sorted(range(n_dims), key=lambda i: vec_index[i])
    for i in order:
        dt = dim_specs[i].data_type
        spec = dim_specs[i]
        for dims, valids, _ in rows:
            v = dims[i]
            if spec.is_time and valids[i] and (spec.from_offset or
                                               spec.to_offset):
                v = adjust_offset(spec.from_offset, spec.to_offset,
                                  spec.dst_switch_ts, int(v))
                v = min(max(v, 0), 0xFFFFFFFF)
            if not valids[i] or v is None:
                v = (0, 0) if dt in (mdt.UUID, mdt.GeoPoint) else 0
            out += _dim_value_bytes(v, dt)
    for i in order:
        for dims, valids, _ in rows:
            out.append(1 if valids[i] else 0)
    out += b"\x00" * (_align8(len(out)) - len(out))

    # --- count vector (u16 non-zero register counts per row) ---
    hlls = [hll.canonical() for _, _, hll in rows]
    for hll in hlls:
        out += struct.pack("<H", hll.non_zero_registers & 0xFFFF)
    out += b"\x00" * (_align8(len(out)) - len(out))

    # --- hll vector ---
    for hll in hlls:
        out += hll.encode_binary()
    out += b"\x00" * (_align8(len(out)) - len(out))
    return bytes(out)


class HLLQueryResults:
    """Multi-query response framing (query/common/hll.go:943)."""

    def __init__(self):
        self._buf = bytearray(struct.pack("<I4x", HLL_MAGIC_V2))

    def write_result(self, block: bytes) -> None:
        self._buf += struct.pack("<IB3x", len(block), 0)
        self._buf += block

    def write_error(self, err: str) -> None:
        data = err.encode()
        self._buf += struct.pack("<IB3x", len(data), 1)
        self._buf += data
        # reference quirk (hll.go:1004): pads 8 bytes iff len%8 == 0
        padding = (8 - (len(data) & 7)) & 8
        self._buf += b"\x00" * padding

    def get_bytes(self) -> bytes:
        return bytes(self._buf)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("hll buffer truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def align(self, to: int = 8) -> None:
        rem = self.pos % to
        if rem:
            self.read(to - rem)

    def eof(self) -> bool:
        return self.pos >= len(self.data)


def _dim_start_offsets(counts_per_width: List[int], vec_slot: int,
                       n: int) -> Tuple[int, int]:
    """GetDimensionStartOffsets (dimval.go:122)."""
    value_offset = 0
    start = 0
    for width, cnt in zip(_WIDTH_ORDER, counts_per_width):
        if start + cnt > vec_slot:
            value_offset += (vec_slot - start) * n * width
            break
        start += cnt
        value_offset += cnt * n * width
    value_bytes = sum(w * c for w, c in zip(_WIDTH_ORDER, counts_per_width))
    null_offset = (value_bytes + vec_slot) * n
    return value_offset, null_offset


def _read_dimension(buf: bytes, value_offset: int, null_offset: int,
                    row: int, dt: int,
                    enum_dict: Optional[List[str]]) -> Optional[str]:
    """ReadDimension (dimval.go:36) — wire value → result string."""
    if buf[null_offset + row] == 0:
        return None
    nb = mdt.data_type_bytes(dt)
    off = value_offset + nb * row
    raw = buf[off:off + nb]
    if dt == mdt.Float32:
        from aresdb_tpu_torch.query.postprocess import format_float32
        return format_float32(struct.unpack("<f", raw)[0])
    if dt == mdt.UUID:
        lo, hi = struct.unpack("<QQ", raw)
        return mdt.uuid_to_string(lo, hi)
    if dt == mdt.GeoPoint:
        lat, lng = struct.unpack("<ff", raw)
        return mdt.geopoint_to_string(lat, lng)
    signed = dt in (mdt.Int64, mdt.Int32, mdt.Int16, mdt.Int8, mdt.Bool)
    fmt = {1: "B", 2: "H", 4: "I", 8: "Q"}[nb]
    iv = struct.unpack("<" + (fmt.lower() if signed else fmt), raw)[0]
    if signed:
        return str(iv)
    if enum_dict and 0 <= iv < len(enum_dict):
        return enum_dict[iv]
    return str(iv)


def parse_hll_block(block: bytes, magic: int = HLL_MAGIC_V2,
                    ignore_enum: bool = False) -> Dict[str, Any]:
    """One HLLData block → nested result with HLL leaves
    (parseTimeseriesHLLResult, query/common/hll.go:371; old-format variant
    :216)."""
    if not block:
        return {}
    r = _Reader(block)
    if magic == HLL_MAGIC_V1:
        # old header: [four-byte dims][two-byte][one-byte][num enums]
        # then result_size immediately (parseOldTimeseriesHLLResult,
        # query/common/hll.go:216)
        counts_per_width = [0, 0, r.u8(), r.u8(), r.u8()]
        num_enum_columns = r.u8()
    else:
        num_enum_columns = r.u8()
        counts_per_width = [r.u8() for _ in range(5)]
        r.align(8)
    total_dims = sum(counts_per_width)
    n = r.u32()
    raw_dim_len = r.u32()
    if magic == HLL_MAGIC_V1:
        r.read(4)
    vec_slots = [r.u8() for _ in range(total_dims)]
    r.align(8)
    data_types = []
    for _ in range(total_dims):
        data_types.append(r.u32())
    r.align(8)
    enum_dicts: Dict[int, List[str]] = {}
    for _ in range(num_enum_columns):
        nbytes = r.u32()
        dim_idx = r.u16()
        r.read(2)
        raw = r.read(nbytes)
        # Go parity: split by the delimiter and drop the final element
        # (alignment padding or empty tail)
        enum_dicts[dim_idx] = [c.decode()
                               for c in raw.split(ENUM_DELIMITER)[:-1]]

    header = r.pos
    dim_vec = block[header:header + raw_dim_len]
    padded_count_len = _align8(2 * n)
    count_off = header + raw_dim_len
    hll_off = count_off + padded_count_len

    result: Dict[str, Any] = {}
    cur = hll_off
    for row in range(n):
        dim_strs: List[Optional[str]] = []
        for d in range(total_dims):
            voff, noff = _dim_start_offsets(counts_per_width, vec_slots[d], n)
            dim_strs.append(_read_dimension(
                dim_vec, voff, noff, row, data_types[d],
                None if ignore_enum else enum_dicts.get(d)))
        count = struct.unpack("<H", block[count_off + 2 * row:
                                          count_off + 2 * row + 2])[0]
        if count < DENSE_THRESHOLD:
            sparse = []
            for _ in range(count):
                rec = struct.unpack("<I", block[cur:cur + 4])[0]
                sparse.append((rec & 0xFFFF, (rec >> 16) & 0xFF))
                cur += 4
            hll = HLL(sparse_data=sparse, non_zero_registers=count)
        else:
            dense = block[cur:cur + DENSE_DATA_LENGTH]
            cur += DENSE_DATA_LENGTH
            # the count vector only signals dense; true non-zero count is
            # recomputed from the block (readHLL, query/common/hll.go:327)
            hll = HLL(dense_data=bytes(dense),
                      non_zero_registers=int(np.count_nonzero(
                          np.frombuffer(dense, np.uint8))))
        node = result
        if not dim_strs:
            result[""] = hll
            continue
        for i, s in enumerate(dim_strs):
            key = "NULL" if s is None else s
            if i == len(dim_strs) - 1:
                node[key] = hll
            else:
                node = node.setdefault(key, {})
    return result


def parse_hll_query_results(data: bytes, ignore_enum: bool = False
                            ) -> Tuple[List[Optional[Dict[str, Any]]],
                                       List[Optional[str]]]:
    """ParseHLLQueryResults (query/common/hll.go:583) →
    ([result-or-None...], [error-or-None...])."""
    r = _Reader(data)
    magic = r.u32()
    if magic not in (HLL_MAGIC_V1, HLL_MAGIC_V2):
        raise ValueError(f"header {magic:#x} does not match HLLDataHeader")
    r.read(4)
    results: List[Optional[Dict[str, Any]]] = []
    errors: List[Optional[str]] = []
    while not r.eof():
        if len(r.data) - r.pos < 8:
            break
        size = r.u32()
        is_err = r.u8()
        r.read(3)
        payload = r.read(size)
        if is_err:
            errors.append(payload.decode())
            results.append(None)
            # mirror the writer's error padding quirk
            padding = (8 - (size & 7)) & 8
            if len(r.data) - r.pos >= padding:
                r.read(padding)
        else:
            results.append(parse_hll_block(bytes(payload), magic,
                                           ignore_enum))
            errors.append(None)
    return results, errors


def compute_hll_result(result: Any) -> Any:
    """Replace HLL leaves with numeric estimates (ComputeHLLResult,
    query/common/hll.go:505)."""
    if isinstance(result, dict):
        return {k: compute_hll_result(v) for k, v in result.items()}
    if isinstance(result, HLL):
        return result.compute()
    return result


def merge_hll_trees(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Merge nested HLL results in place (register max — HLL.Merge,
    query/common/hll.go:146)."""
    for k, v in src.items():
        if isinstance(v, dict):
            merge_hll_trees(dst.setdefault(k, {}), v)
        else:
            cur = dst.get(k)
            dst[k] = v if cur is None else cur.merge(v)


def parse_hll_block_meta(block: bytes, magic: int = HLL_MAGIC_V2
                         ) -> List[HLLDimensionSpec]:
    """Dim specs (query order) recovered from a serialized block — lets the
    broker re-serialize a merged tree without recompiling the query."""
    if not block:
        return []
    r = _Reader(block)
    if magic == HLL_MAGIC_V1:
        counts_per_width = [0, 0, r.u8(), r.u8(), r.u8()]
        num_enum_columns = r.u8()
    else:
        num_enum_columns = r.u8()
        counts_per_width = [r.u8() for _ in range(5)]
        r.align(8)
    total_dims = sum(counts_per_width)
    r.u32()
    r.u32()
    if magic == HLL_MAGIC_V1:
        r.read(4)
    for _ in range(total_dims):
        r.u8()
    r.align(8)
    data_types = [r.u32() for _ in range(total_dims)]
    r.align(8)
    enum_dicts: Dict[int, List[str]] = {}
    for _ in range(num_enum_columns):
        nbytes = r.u32()
        dim_idx = r.u16()
        r.read(2)
        raw = r.read(nbytes)
        enum_dicts[dim_idx] = [c.decode()
                               for c in raw.split(ENUM_DELIMITER)[:-1]]
    return [HLLDimensionSpec(data_type=dt, enum_dict=enum_dicts.get(i) or None)
            for i, dt in enumerate(data_types)]


def _value_from_string(s: str, dt: int, enum_dict: Optional[List[str]]):
    """Inverse of _read_dimension (ValueFromString / enum forward lookup in
    BuildVectorsFromHLLResult, query/common/hll.go:1060)."""
    if enum_dict:
        try:
            return enum_dict.index(s)
        except ValueError:
            return 0
    if dt == mdt.UUID:
        import uuid as _uuid
        b = _uuid.UUID(s).bytes
        return np.array([int.from_bytes(b[:8], "little"),
                         int.from_bytes(b[8:], "little")], np.uint64)
    if dt == mdt.GeoPoint:
        lat, lng = mdt.parse_geopoint(s.replace(",", " ").replace("  ", " "))
        return np.array([lat, lng], np.float32)
    if dt == mdt.Float32:
        return float(s)
    return int(s)


def serialize_from_tree(tree: Dict[str, Any],
                        dim_specs: List[HLLDimensionSpec]) -> bytes:
    """Nested string→HLL tree → HLLData block (BuildVectorsFromHLLResult,
    query/common/hll.go:1007): keys visited in sorted order."""
    rows: List[Tuple[List[Any], List[bool], HLL]] = []

    def walk(node, dims, valids):
        if isinstance(node, HLL):
            rows.append((list(dims), list(valids), node))
            return
        i = len(dims)
        if i >= len(dim_specs):
            # zero-dimension result: single leaf under the implicit "" key
            leaf = node.get("")
            if isinstance(leaf, HLL):
                rows.append((list(dims), list(valids), leaf))
            return
        spec = dim_specs[i]
        for key in sorted(node.keys()):
            if key == "NULL":
                value, valid = 0, False
            else:
                value, valid = _value_from_string(
                    key, spec.data_type, spec.enum_dict), True
            walk(node[key], dims + [value], valids + [valid])

    if tree:
        walk(tree, [], [])
    return serialize_hll_block(rows, dim_specs)


# ---------------------------------------------------------------------------
# plan integration
# ---------------------------------------------------------------------------

def dim_specs_from_plan(plan) -> List[HLLDimensionSpec]:
    """Wire dim specs for a compiled query (PostprocessAsHLLData,
    query/aql_postprocessor.go:170: data type + enum reverse dict + time
    dims per query dimension)."""
    specs = []
    for d in plan.dimensions:
        if d.geo_dim and plan.geo is not None:
            cases = []
            for sv in plan.geo.shape_values:
                if plan.geo.pk_data_type == mdt.UUID:
                    cases.append(mdt.uuid_to_string(int(sv[0]), int(sv[1])))
                else:
                    cases.append(str(sv))
            specs.append(HLLDimensionSpec(data_type=mdt.SmallEnum,
                                          enum_dict=cases))
            continue
        is_time = d.raw is not None and d.raw.is_time_dimension
        specs.append(HLLDimensionSpec(
            data_type=d.data_type,
            enum_dict=list(d.enum_reverse_dict) if d.enum_reverse_dict else None,
            is_time=is_time,
            from_offset=getattr(d, "from_offset", 0) or 0,
            to_offset=getattr(d, "to_offset", 0) or 0,
            dst_switch_ts=getattr(d, "dst_switch_ts", 0) or 0))
    return specs


def serialize_result_table(plan, table) -> bytes:
    """Executor group table (columnar) → HLLData block."""
    specs = dim_specs_from_plan(plan)
    rows = []
    n_dims = len(table.dim_values)
    dvals = []
    for dv in table.dim_values:
        dvals.append([tuple(x) for x in dv.tolist()]
                     if dv.ndim > 1 else dv.tolist())
    dvalids = [b.tolist() for b in table.dim_valids]
    regs = np.asarray(table.aggs)
    for j in range(table.n_groups):
        hll = HLL.from_registers(regs[j])
        rows.append(([dvals[d][j] for d in range(n_dims)],
                     [bool(dvalids[d][j]) for d in range(n_dims)], hll))
    return serialize_hll_block(rows, specs)
