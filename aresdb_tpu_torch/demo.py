"""Synthetic demo plan + data for compile checks and benchmarking.

Builds the canonical AQL workload from the reference's examples/1k_trips
(count/sum of trips filtered by status, grouped by hour + dimension) against
synthetic columns, without touching disk.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.schema import Table, TableSchema
from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import CompiledQuery, Compiler

DEMO_NOW = 1_600_000_000

TRIPS_SCHEMA_JSON = {
    "name": "trips",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "uuid", "type": "UUID"},
        {"name": "city_id", "type": "Uint16"},
        {"name": "status", "type": "SmallEnum"},
        {"name": "fare", "type": "Float32"},
    ],
    "primaryKeyColumns": [1],
    "isFactTable": True,
}

DEMO_QUERY = {
    "table": "trips",
    "measures": [{"sqlExpression": "sum(fare)",
                  "rowFilters": ["status='completed'"]}],
    "dimensions": [
        {"sqlExpression": "request_at", "timeBucketizer": "hour"},
        {"sqlExpression": "city_id"},
    ],
    "timeFilter": {"column": "request_at",
                   "from": "24 hours ago", "to": "this quarter-hour"},
    "now": DEMO_NOW,
}


def demo_schema() -> TableSchema:
    ts = TableSchema(Table.from_json(TRIPS_SCHEMA_JSON))
    ts.extend_enum("status", ["completed", "canceled", "rejected"])
    return ts


def demo_plan(query: dict = None) -> CompiledQuery:
    schema = demo_schema()
    compiler = Compiler({"trips": schema})
    return compiler.compile(AQLQuery.from_json(query or DEMO_QUERY))


def demo_columns(plan: CompiledQuery, n_rows: int, seed: int = 7,
                 n_cities: int = 300) -> Tuple[Dict, int]:
    """Synthetic staged columns for the plan (numpy; caller device-puts).

    Group cardinality ≈ 20 hours × n_cities; size the kernel's group
    capacity accordingly.
    """
    rng = np.random.RandomState(seed)
    cols = {}
    for cid in plan.used_columns:
        col = plan.main_schema.table.columns[cid]
        if col.name == "request_at":
            vals = (DEMO_NOW - rng.randint(0, 20 * 3600, n_rows)).astype(np.uint32)
        elif col.name == "city_id":
            vals = rng.randint(1, 1 + n_cities, n_rows).astype(np.uint16)
        elif col.name == "status":
            vals = rng.randint(0, 3, n_rows).astype(np.uint8)
        elif col.name == "fare":
            vals = (rng.rand(n_rows) * 50).astype(np.float32)
        elif col.name == "uuid":
            vals = rng.randint(0, 1 << 62, (n_rows, 2)).astype(np.uint64)
        else:
            vals = np.zeros(n_rows, mdt.numpy_dtype(col.data_type))
        validity = rng.rand(n_rows) > 0.02
        cols[(0, cid)] = (vals, validity)
    return cols, n_rows
