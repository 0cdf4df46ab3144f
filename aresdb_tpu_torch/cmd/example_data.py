"""Deterministic example-data generators (reference: examples/utils).

The reference's example/integration tooling generates its datasets from
templated CSVs with a FIXED PRNG (`rand.New(rand.NewSource(0))`,
examples/utils/example_utils.go:25), which makes the integration suite's
query goldens exact. `gen_arraytest_batches` reproduces
ingestDataForArrayTestTable (example_utils.go:68-99) bit-for-bit using the
Go-exact PRNG in utils/gorand: 2 CSV records ({time-1d}, {time-2d}) x 2
batches x 1000 rows, arraySize cycling j%5, array item i = i*10 with item
3 null (example_utils.go:125-164). Only the time column draws from the
seeded stream (the reference's row uuids come from crypto/rand, so any
unique values preserve the goldens).
"""

from __future__ import annotations

from typing import List

from aresdb_tpu_torch.utils.gorand import GoRand

ARRAYTEST_COLUMNS = [
    "request_at", "uuid", "city_id", "status", "fare",
    "array_bool", "array_int8", "array_uint8", "array_int16",
    "array_uint16", "array_int32", "array_uint32",
    "array_smallenum", "array_bigenum", "array_uuid", "array_geopoint",
]

_ARRAY_TYPES = ["bool", "int8", "uint8", "int16", "uint16", "int32",
                "uint32", "smallenum", "bigenum", "uuid", "geopoint"]


def _array_item(val_type: str, i: int) -> str:
    """generateArrayItemValue (example_utils.go:140-164)."""
    if i == 3:
        return "null"
    if val_type == "bool":
        return '"true"' if i % 2 == 0 else '"false"'
    if val_type in ("int8", "int16", "int32", "uint8", "uint16", "uint32"):
        return f'"{i * 10}"'
    if val_type == "smallenum":
        return f'"enum_value_{i}"'
    if val_type == "bigenum":
        return f'"enum_value_{i * 10}"'
    if val_type == "uuid":
        return f'"12000000-0000-0000-0100-{i * 10:012d}"'
    if val_type == "geopoint":
        return f'"point(-{float(i * 10):.6f} {float(i * 10):.6f})"'
    raise ValueError(val_type)


def _array_val(val_type: str, size: int):
    """generateArrayValue: nil for size 0, else items 1..size-1 as a JSON
    array string (example_utils.go:125-138)."""
    if size == 0:
        return None
    return "[" + ",".join(_array_item(val_type, i)
                          for i in range(1, size)) + "]"


def gen_arraytest_batches(now: int) -> List[List[list]]:
    """4 insert batches of 1000 rows each, in reference row order.

    Row order IS the PRNG draw order: each row consumes exactly one
    Int63n for its request_at template.
    """
    rng = GoRand(0)
    batches = []
    counter = 0
    for days in (1, 2):  # CSV records: {time-1d} then {time-2d}
        duration = days * 86400
        start = now - duration
        for _ in range(2):  # batches=2
            rows = []
            for j in range(1000):  # batchRows=1000
                size = j % 5
                t = start + rng.int63n(duration)
                counter += 1
                row = [t,
                       f"00000000-0000-0000-0000-{counter:012d}",
                       size,
                       f"status_{size}",
                       1.01 * size]
                row += [_array_val(at, size) for at in _ARRAY_TYPES]
                rows.append(row)
            batches.append(rows)
    return batches
