"""Data type system.

Capability parity with the reference type system
(reference: memstore/common/data_type.go:44-72): the same 13 scalar types and
array variants, with the same 32-bit encoding so that serialized artifacts
(upsert batches, redo logs, schema JSON) interoperate:

    bits  0-15: width of the (item) type in bits
    bits 16-23: base type id
    bit     24: array flag

TPU-side storage dtypes differ from the reference's raw C buffers: columns are
held as numpy/JAX arrays (values + bool validity), with UUID as 2x uint64
lanes and GeoPoint as 2x float32 lanes so they stay kernel-friendly.
"""

from __future__ import annotations

import math
import re
import uuid as _uuid
from typing import Any, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Type encoding (wire-compatible with reference data_type.go)
# ---------------------------------------------------------------------------

ARRAY_FLAG = 0x01000000

Unknown = 0x00000000
Bool = 0x00000001
Int8 = 0x00010008
Uint8 = 0x00020008
Int16 = 0x00030010
Uint16 = 0x00040010
Int32 = 0x00050020
Uint32 = 0x00060020
Float32 = 0x00070020
SmallEnum = 0x00080008
BigEnum = 0x00090010
UUID = 0x000A0080
GeoPoint = 0x000B0040
GeoShape = 0x000C0000
Int64 = 0x000D0040

ArrayBool = ARRAY_FLAG | Bool
ArrayInt8 = ARRAY_FLAG | Int8
ArrayUint8 = ARRAY_FLAG | Uint8
ArrayInt16 = ARRAY_FLAG | Int16
ArrayUint16 = ARRAY_FLAG | Uint16
ArrayInt32 = ARRAY_FLAG | Int32
ArrayUint32 = ARRAY_FLAG | Uint32
ArrayFloat32 = ARRAY_FLAG | Float32
ArraySmallEnum = ARRAY_FLAG | SmallEnum
ArrayBigEnum = ARRAY_FLAG | BigEnum
ArrayUUID = ARRAY_FLAG | UUID
ArrayGeoPoint = ARRAY_FLAG | GeoPoint
ArrayInt64 = ARRAY_FLAG | Int64

DATA_TYPE_NAME = {
    Unknown: "Unknown",
    Bool: "Bool",
    Int8: "Int8",
    Uint8: "Uint8",
    Int16: "Int16",
    Uint16: "Uint16",
    Int32: "Int32",
    Uint32: "Uint32",
    Float32: "Float32",
    SmallEnum: "SmallEnum",
    BigEnum: "BigEnum",
    UUID: "UUID",
    GeoPoint: "GeoPoint",
    GeoShape: "GeoShape",
    Int64: "Int64",
    ArrayBool: "ArrayBool",
    ArrayInt8: "ArrayInt8",
    ArrayUint8: "ArrayUint8",
    ArrayInt16: "ArrayInt16",
    ArrayUint16: "ArrayUint16",
    ArrayInt32: "ArrayInt32",
    ArrayUint32: "ArrayUint32",
    ArrayFloat32: "ArrayFloat32",
    ArraySmallEnum: "ArraySmallEnum",
    ArrayBigEnum: "ArrayBigEnum",
    ArrayUUID: "ArrayUUID",
    ArrayGeoPoint: "ArrayGeoPoint",
    ArrayInt64: "ArrayInt64",
}

NAME_TO_DATA_TYPE = {v: k for k, v in DATA_TYPE_NAME.items() if k != Unknown}

_VALID_TYPES = frozenset(DATA_TYPE_NAME) - {Unknown}


def data_type_from_string(name: str) -> int:
    """Parse a schema type name: 'Uint32', 'ArrayInt8', or the reference's
    suffix form 'Int8[]' (memstore/common/data_type.go DataTypeFromString
    accepts both spellings in schema JSON)."""
    if name.endswith("[]"):
        name = "Array" + name[:-2]
    try:
        return NAME_TO_DATA_TYPE[name]
    except KeyError:
        raise ValueError(f"unknown data type name: {name!r}") from None


def new_data_type(value: int) -> int:
    """Validate a 32-bit type code (reference: data_type.go NewDataType)."""
    if value not in _VALID_TYPES:
        raise ValueError(f"invalid data type code: 0x{value:08x}")
    return value


def is_array_type(dt: int) -> bool:
    return bool(dt & ARRAY_FLAG)


def item_type(dt: int) -> int:
    """Element type of an array type."""
    return dt & ~ARRAY_FLAG


def data_type_bits(dt: int) -> int:
    """Bits per value (per item for arrays). Bool is 1 bit on the wire."""
    return dt & 0xFFFF


def data_type_bytes(dt: int) -> int:
    """Bytes per value, rounding bool up to 1 (reference DataTypeBytes)."""
    return max(1, data_type_bits(dt) // 8)


def is_numeric(dt: int) -> bool:
    return dt in (Int8, Uint8, Int16, Uint16, Int32, Uint32, Int64, Float32)


def is_enum_type(dt: int) -> bool:
    return dt in (SmallEnum, BigEnum)


def is_signed(dt: int) -> bool:
    return dt in (Int8, Int16, Int32, Int64)


def is_unsigned(dt: int) -> bool:
    return dt in (Uint8, Uint16, Uint32, SmallEnum, BigEnum)


def is_float(dt: int) -> bool:
    return dt == Float32


def is_go_type(dt: int) -> bool:
    """Types without a single numeric lane (UUID/GeoPoint/GeoShape/arrays)."""
    return dt in (UUID, GeoPoint, GeoShape) or is_array_type(dt)


# ---------------------------------------------------------------------------
# numpy storage dtype mapping
# ---------------------------------------------------------------------------

_NUMPY_DTYPES = {
    Bool: np.dtype(np.bool_),
    Int8: np.dtype(np.int8),
    Uint8: np.dtype(np.uint8),
    Int16: np.dtype(np.int16),
    Uint16: np.dtype(np.uint16),
    Int32: np.dtype(np.int32),
    Uint32: np.dtype(np.uint32),
    Float32: np.dtype(np.float32),
    SmallEnum: np.dtype(np.uint8),
    BigEnum: np.dtype(np.uint16),
    Int64: np.dtype(np.int64),
}


def numpy_dtype(dt: int) -> np.dtype:
    """Storage dtype for one scalar lane of this type.

    UUID is stored as shape (n, 2) uint64, GeoPoint as shape (n, 2) float32
    (lat, lng); those return the lane dtype.
    """
    base = item_type(dt) if is_array_type(dt) else dt
    if base in _NUMPY_DTYPES:
        return _NUMPY_DTYPES[base]
    if base == UUID:
        return np.dtype(np.uint64)
    if base == GeoPoint:
        return np.dtype(np.float32)
    raise ValueError(f"no numpy dtype for {DATA_TYPE_NAME.get(dt, hex(dt))}")


def lanes(dt: int) -> int:
    """Number of numpy lanes per value (UUID/GeoPoint are 2-lane)."""
    base = item_type(dt) if is_array_type(dt) else dt
    return 2 if base in (UUID, GeoPoint) else 1


# ---------------------------------------------------------------------------
# Value parsing (ingestion): accepts the same external representations the
# reference accepts (reference: data_type.go ValueFromString / ConvertToXXX).
# ---------------------------------------------------------------------------

_GEOPOINT_RE = re.compile(
    r"^\s*point\s*\(\s*(-?[0-9.eE+-]+)[\s,]+(-?[0-9.eE+-]+)\s*\)\s*$",
    re.IGNORECASE,
)

_INT_BOUNDS = {
    Int8: (-(2**7), 2**7 - 1),
    Uint8: (0, 2**8 - 1),
    Int16: (-(2**15), 2**15 - 1),
    Uint16: (0, 2**16 - 1),
    Int32: (-(2**31), 2**31 - 1),
    Uint32: (0, 2**32 - 1),
    Int64: (-(2**63), 2**63 - 1),
    SmallEnum: (0, 2**8 - 1),
    BigEnum: (0, 2**16 - 1),
}


def parse_uuid(value: Any) -> Tuple[int, int]:
    """Parse UUID into (hi, lo) uint64 lanes (little-endian halves)."""
    if isinstance(value, (tuple, list)) and len(value) == 2:
        return int(value[0]) & 0xFFFFFFFFFFFFFFFF, int(value[1]) & 0xFFFFFFFFFFFFFFFF
    if isinstance(value, bytes):
        if len(value) != 16:
            raise ValueError(f"UUID bytes must be 16 long, got {len(value)}")
        b = value
    else:
        b = _uuid.UUID(str(value)).bytes
    hi = int.from_bytes(b[:8], "little")
    lo = int.from_bytes(b[8:], "little")
    return hi, lo


def uuid_to_string(hi: int, lo: int) -> str:
    b = int(hi).to_bytes(8, "little") + int(lo).to_bytes(8, "little")
    return str(_uuid.UUID(bytes=b))


def parse_geopoint(value: Any) -> Tuple[float, float]:
    """WKT 'Point(lng lat)' / 'Point(lng,lat)' → internal (lat, lng).

    Tuples/lists are taken as already-internal (lat, lng). Mirrors the
    reference's GeoPointFromString (data_type.go:443): WKT order is
    longitude first, storage order is [lat, lng], and ranges are
    validated (lng in [-180, 180], lat in [-90, 90])."""
    if isinstance(value, (tuple, list)) and len(value) == 2:
        return float(value[0]), float(value[1])
    m = _GEOPOINT_RE.match(str(value))
    if not m:
        raise ValueError(f"invalid GeoPoint: {value!r}")
    lng, lat = float(m.group(1)), float(m.group(2))
    if not -180.0 <= lng <= 180.0:
        raise ValueError(
            f"invalid point, longitude should be in [-180, 180], got {lng}")
    if not -90.0 <= lat <= 90.0:
        raise ValueError(
            f"invalid point, latitude should be in [-90, 90], got {lat}")
    return lat, lng


def geopoint_to_string(lat: float, lng: float) -> str:
    # reference human-readable output is "Point(lng,lat)" with 4 decimals
    # (data_value.go:298 ConvertToHumanReadable)
    return f"Point({lng:.4f},{lat:.4f})"


def parse_value(value: Any, dt: int) -> Optional[Any]:
    """Convert an external value to its storage representation.

    Returns None for null. Scalars return python ints/floats/bools;
    UUID/GeoPoint return 2-tuples; arrays return lists of items.
    Raises ValueError on unconvertible input.
    """
    if value is None:
        return None
    if isinstance(value, str) and value.strip().lower() == "null":
        # reference ValueFromString treats the literal "null" as null for
        # every type (memstore/common/data_value.go ValueFromString)
        return None
    if is_array_type(dt):
        items = value
        if isinstance(value, str):
            # JSON-style array string
            import json

            items = json.loads(value)
        if items is None:
            return None
        return [parse_value(v, item_type(dt)) for v in items]

    if dt == Bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            if value in (0, 1):
                return bool(value)
            raise ValueError(f"invalid bool: {value!r}")
        s = str(value).strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0"):
            return False
        raise ValueError(f"invalid bool: {value!r}")

    if dt in _INT_BOUNDS:
        if isinstance(value, str):
            s = value.strip()
            iv = int(s, 0) if s.lower().startswith("0x") else int(float(s)) if "." in s else int(s)
        elif isinstance(value, bool):
            iv = int(value)
        elif isinstance(value, float):
            if not value.is_integer():
                raise ValueError(f"non-integral value for int column: {value!r}")
            iv = int(value)
        else:
            iv = int(value)
        lo, hi = _INT_BOUNDS[dt]
        if not (lo <= iv <= hi):
            raise ValueError(
                f"value {iv} out of range for {DATA_TYPE_NAME[dt]} [{lo},{hi}]"
            )
        return iv

    if dt == Float32:
        return float(value)

    if dt == UUID:
        return parse_uuid(value)

    if dt == GeoPoint:
        return parse_geopoint(value)

    if dt == GeoShape:
        return parse_geoshape(value)

    raise ValueError(f"cannot parse value for type {DATA_TYPE_NAME.get(dt, hex(dt))}")


_POLY_SPLIT_RE = re.compile(r"\),\s*\(")


def parse_geoshape(value: Any) -> List[List[Tuple[float, float]]]:
    """Parse 'POLYGON ((lng lat, lng lat, ...), (...))' into rings of
    (lat, lng) float pairs (reference: GeoShapeFromString,
    memstore/common/data_type.go:482 — note the lng-lat input order).
    Also accepts an already-parsed list of rings.
    """
    if isinstance(value, (list, tuple)):
        return [[(float(p[0]), float(p[1])) for p in ring] for ring in value]
    s = str(value).lower().strip().strip("polygon() ")
    rings = []
    for ring_str in _POLY_SPLIT_RE.split(s):
        ring = []
        for pair in ring_str.split(","):
            parts = pair.split()
            if len(parts) != 2:
                raise ValueError(f"invalid point format {pair!r}")
            lng, lat = float(parts[0]), float(parts[1])
            if not (-180 <= lng <= 180):
                raise ValueError(f"invalid longitude {lng}")
            if not (-90 <= lat <= 90):
                raise ValueError(f"invalid latitude {lat}")
            ring.append((lat, lng))
        rings.append(ring)
    return rings


def serialize_geoshape(shape: List[List[Tuple[float, float]]]) -> bytes:
    """GoDataValue stream layout (reference GeoShapeGo.Write):
    u32 numPolygons, then per polygon u32 numPoints + (f32 lat, f32 lng)*."""
    import struct as _struct

    parts = [_struct.pack("<I", len(shape))]
    for ring in shape:
        parts.append(_struct.pack("<I", len(ring)))
        for lat, lng in ring:
            parts.append(_struct.pack("<ff", lat, lng))
    return b"".join(parts)


def deserialize_geoshape(buf) -> List[List[Tuple[float, float]]]:
    import struct as _struct

    (n_poly,) = _struct.unpack_from("<I", buf, 0)
    off = 4
    shape = []
    for _ in range(n_poly):
        (n_pts,) = _struct.unpack_from("<I", buf, off)
        off += 4
        ring = []
        for _ in range(n_pts):
            lat, lng = _struct.unpack_from("<ff", buf, off)
            off += 8
            ring.append((lat, lng))
        shape.append(ring)
    return shape


def default_value(dt: int) -> Any:
    """Zero value used for mode-0 columns."""
    if dt == Bool:
        return False
    if dt == Float32:
        return 0.0
    if dt == UUID:
        return (0, 0)
    if dt == GeoPoint:
        return (0.0, 0.0)
    if is_array_type(dt):
        return []
    return 0


def value_to_human(value: Any, dt: int) -> Any:
    """Render a stored value back to the human-readable form used in results."""
    if value is None:
        return None
    if dt == UUID:
        return uuid_to_string(*value)
    if dt == GeoPoint:
        return geopoint_to_string(*value)
    if dt == Bool:
        return bool(value)
    if dt == Float32:
        f = float(value)
        return f
    if is_array_type(dt):
        return [value_to_human(v, item_type(dt)) for v in value]
    return value


def agg_identity(dt_np: np.dtype, agg: str) -> Any:
    """Identity element for masked aggregation on TPU."""
    if agg in ("sum", "count", "avg", "hll"):
        return np.zeros((), dtype=dt_np)
    if agg == "min":
        if np.issubdtype(dt_np, np.floating):
            return np.array(np.inf, dtype=dt_np)
        return np.array(np.iinfo(dt_np).max, dtype=dt_np)
    if agg == "max":
        if np.issubdtype(dt_np, np.floating):
            return np.array(-np.inf, dtype=dt_np)
        return np.array(np.iinfo(dt_np).min, dtype=dt_np)
    raise ValueError(f"unknown agg {agg}")


def float_is_finite(x: float) -> bool:
    return math.isfinite(x)
