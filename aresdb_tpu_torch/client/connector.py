"""Connector: Insert(table, columnNames, rows) → UpsertBatch → POST /data.

Reference: client/connector.go (Connector.Insert :149 — validates primary
keys and the time column, auto-extends enums with case-insensitivity and
disableAutoExpand handling, computes HLL values client-side :200, builds the
UpsertBatch and POSTs per shard) and client/schema.go (cached schema
handler).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from aresdb_tpu_torch.utils import http_client

from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.common.upsert_batch import (
    UPDATE_FORCE_OVERWRITE,
    UPDATE_OVERWRITE_NOT_NULL,
    UpsertBatchBuilder,
)
from aresdb_tpu_torch.query import hll as H


class ConnectorError(Exception):
    pass


class _SchemaCache:
    """Cached table schemas + enum dictionaries fetched over HTTP."""

    def __init__(self, host: str, port: int, session, ttl_seconds: int = 300):
        self.base = f"http://{host}:{port}"
        self.session = session
        self.ttl = ttl_seconds
        self.lock = threading.RLock()
        self._tables: Dict[str, tuple] = {}   # name -> (Table, fetched_at)
        self._enums: Dict[tuple, Dict[str, int]] = {}

    def table(self, name: str) -> Table:
        with self.lock:
            hit = self._tables.get(name)
            if hit and time.time() - hit[1] < self.ttl:
                return hit[0]
        r = self.session.get(f"{self.base}/schema/tables/{name}")
        if r.status_code == 404:
            raise ConnectorError(f"unknown table {name!r}")
        r.raise_for_status()
        table = Table.from_json(r.json())
        with self.lock:
            self._tables[name] = (table, time.time())
        return table

    def enum_dict(self, table: str, column: str) -> Dict[str, int]:
        key = (table, column)
        with self.lock:
            if key in self._enums:
                return self._enums[key]
        r = self.session.get(
            f"{self.base}/schema/tables/{table}/columns/{column}/enum-cases")
        r.raise_for_status()
        cases = r.json()
        with self.lock:
            self._enums[key] = {c: i for i, c in enumerate(cases)}
            return self._enums[key]

    def extend_enum(self, table: str, column: str,
                    cases: List[str]) -> List[int]:
        r = self.session.post(
            f"{self.base}/schema/tables/{table}/columns/{column}/enum-cases",
            json={"enumCases": cases})
        r.raise_for_status()
        ranks = r.json()
        with self.lock:
            d = self._enums.setdefault((table, column), {})
            for c, rank in zip(cases, ranks):
                d[c] = rank
        return ranks


class Connector:
    def __init__(self, host: str = "localhost", port: int = 9374,
                 session=None):
        self.host = host
        self.port = port
        self.session = session or http_client.Session()
        self.schema = _SchemaCache(host, port, self.session)

    # ------------------------------------------------------------------

    def insert(self, table_name: str, column_names: Sequence[str],
               rows: Sequence[Sequence[Any]],
               update_modes: Optional[Sequence[int]] = None,
               shard_id: int = 0) -> Dict[str, int]:
        """Insert rows; returns ingestion stats from the server."""
        payload = self.build_batch(table_name, column_names, rows,
                                   update_modes)
        resp = self.session.post(
            f"http://{self.host}:{self.port}/data/{table_name}/{shard_id}",
            data=payload,
            headers={"Content-Type": "application/octet-stream"})
        if resp.status_code != 200:
            raise ConnectorError(f"ingestion failed: {resp.text}")
        return resp.json()

    def build_batch(self, table_name: str, column_names: Sequence[str],
                    rows: Sequence[Sequence[Any]],
                    update_modes: Optional[Sequence[int]] = None) -> bytes:
        """Build the upsert-batch wire bytes without posting them —
        shared by HTTP ingestion and the Kafka sink (which produces the
        same bytes to the redolog topic, sink/kafka.go:46)."""
        if not column_names:
            raise ConnectorError("no columns")
        table = self.schema.table(table_name)
        col_ids = {c.name: i for i, c in enumerate(table.columns)}
        for name in column_names:
            if name not in col_ids:
                raise ConnectorError(
                    f"unknown column {name!r} in table {table_name!r}")
        # primary key / time column presence (reference checkPrimaryKeys /
        # checkTimeColumnExistence)
        provided = {col_ids[n] for n in column_names}
        for pk in table.primary_key_columns:
            if pk not in provided:
                raise ConnectorError(
                    f"primary key column {table.columns[pk].name!r} missing")
        if table.is_fact_table and 0 not in provided:
            raise ConnectorError("fact table time column missing")

        b = UpsertBatchBuilder()
        modes = list(update_modes or [UPDATE_OVERWRITE_NOT_NULL] *
                     len(column_names))
        for name, mode in zip(column_names, modes):
            cid = col_ids[name]
            col = table.columns[cid]
            # overwrite-only restrictions (reference connector.go:405-417):
            # dim tables, primary-key columns, archiving sort columns, and
            # non-arithmetic data types only support overwrite modes
            overwrite_only = (
                not table.is_fact_table
                or cid in table.primary_key_columns
                or cid in (table.archiving_sort_columns or [])
                or col.data_type not in _ARITHMETIC_TYPES)
            if overwrite_only and mode > UPDATE_FORCE_OVERWRITE:
                raise ConnectorError(
                    f"column {name!r} only supports overwrite")
            # HLL columns travel as their computed Uint32 hll value
            # (reference DataTypeForColumn, data_type.go:202)
            wire_dt = (dt.Uint32 if col.hll_config.is_hll_column
                       else col.data_type)
            b.add_column(cid, wire_dt, mode)

        # pre-translate enum columns (batch the dictionary extensions);
        # array-of-enum columns translate per item
        enum_cols = {}
        for ci, name in enumerate(column_names):
            col = table.columns[col_ids[name]]
            if col.is_enum_column():
                enum_cols[ci] = col

        for ci, col in enum_cols.items():
            values = set()
            for r in rows:
                v = r[ci]
                if v is None:
                    continue
                if col.is_array and isinstance(v, str):
                    import json as _json
                    v = _json.loads(v)
                items = v if col.is_array else [v]
                values.update(str(x) for x in items if x is not None)
            if col.case_insensitive:
                values = {v.lower() for v in values}
            known = self.schema.enum_dict(table_name, col.name)
            new = sorted(v for v in values if v not in known)
            if new and not col.disable_auto_expand:
                self.schema.extend_enum(table_name, col.name, new)

        # client-side row abandonment (reference abandonRows): rows with a
        # null primary key, a null fact-table time column, or a non-string
        # scalar enum value are skipped — the rest of the batch still ships
        pk_positions = [i for i, n in enumerate(column_names)
                        if col_ids[n] in table.primary_key_columns]
        time_pos = None
        if table.is_fact_table:
            for i, n in enumerate(column_names):
                if col_ids[n] == 0:
                    time_pos = i
        out_row = 0
        for r_i, row in enumerate(rows):
            if len(row) != len(column_names):
                raise ConnectorError(
                    f"row {r_i} has {len(row)} values, expected "
                    f"{len(column_names)}")
            if any(row[i] is None for i in pk_positions):
                continue
            if time_pos is not None and row[time_pos] is None:
                continue
            if any(not isinstance(row[ci], str) and row[ci] is not None
                   and not col.is_array
                   for ci, col in enum_cols.items()):
                continue
            b.add_row()
            for ci, value in enumerate(row):
                if value is None:
                    continue
                col = table.columns[col_ids[column_names[ci]]]
                b.set_value(out_row, ci, self._convert(table_name, col, value))
            out_row += 1

        return b.to_bytes()

    def insert_columns(self, table_name: str, columns: Dict[str, "np.ndarray"],
                       validity: Optional[Dict[str, "np.ndarray"]] = None,
                       shard_id: int = 0) -> Dict[str, int]:
        """Bulk columnar insert: numpy arrays straight to the wire format.

        ~180x faster than row-wise insert() for large loads; values must
        already be in storage form (enum ranks, numeric types).
        """
        from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert

        table = self.schema.table(table_name)
        col_ids = {c.name: i for i, c in enumerate(table.columns)}
        n = None
        spec = []
        validity = validity or {}
        for name, values in columns.items():
            if name not in col_ids:
                raise ConnectorError(f"unknown column {name!r}")
            cid = col_ids[name]
            if n is None:
                n = len(values)
            elif len(values) != n:
                raise ConnectorError("column length mismatch")
            spec.append((cid, table.columns[cid].data_type, values,
                         validity.get(name), UPDATE_OVERWRITE_NOT_NULL))
        if n is None:
            raise ConnectorError("no columns")
        blob = build_columnar_upsert(spec, n)
        resp = self.session.post(
            f"http://{self.host}:{self.port}/data/{table_name}/{shard_id}",
            data=blob,
            headers={"Content-Type": "application/octet-stream"})
        if resp.status_code != 200:
            raise ConnectorError(f"ingestion failed: {resp.text}")
        return resp.json()

    # ------------------------------------------------------------------

    def _convert(self, table_name: str, col, value: Any):
        if col.hll_config.is_hll_column:
            return _compute_hll_value(col.data_type, value)
        if col.is_array:
            if value is None:
                return None
            if isinstance(value, str):
                # JSON-encoded array string, e.g. '["10","20",null]' — the
                # reference connector accepts these for array columns
                # (memstore/common ConvertToArrayValue; the examples data
                # generator emits them, examples/utils/example_utils.go:129)
                import json as _json
                value = _json.loads(value)
            item_dt = dt.item_type(col.data_type)
            out = []
            for item in value:
                if item is None:
                    out.append(None)
                elif col.is_enum_column():
                    out.append(self._enum_rank(table_name, col, item))
                else:
                    out.append(dt.parse_value(item, item_dt))
            return out
        if col.is_enum_column():
            return self._enum_rank(table_name, col, value)
        return dt.parse_value(value, col.data_type)

    def _enum_rank(self, table_name: str, col, value: Any) -> int:
        s = str(value)
        if col.case_insensitive:
            s = s.lower()
        d = self.schema.enum_dict(table_name, col.name)
        rank = d.get(s)
        if rank is None:
            # unseen + disableAutoExpand → default rank 0
            return 0
        return rank

    # ------------------------------------------------------------------

    def query_aql(self, query: Dict[str, Any]) -> Dict[str, Any]:
        r = self.session.post(
            f"http://{self.host}:{self.port}/query/aql",
            json={"queries": [query]})
        r.raise_for_status()
        return r.json()

    def query_sql(self, sql: str) -> Dict[str, Any]:
        r = self.session.post(
            f"http://{self.host}:{self.port}/query/sql",
            json={"queries": [sql]})
        r.raise_for_status()
        return r.json()

    def create_table(self, schema_json: Dict[str, Any]) -> None:
        r = self.session.post(
            f"http://{self.host}:{self.port}/schema/tables", json=schema_json)
        if r.status_code != 200:
            raise ConnectorError(f"create table failed: {r.text}")


# types whose update modes may exceed force-overwrite (reference
# IsOverwriteOnlyDataType complement: uint8..int32 + float32)
_ARITHMETIC_TYPES = frozenset((dt.Uint8, dt.Int8, dt.Uint16, dt.Int16,
                               dt.Uint32, dt.Int32, dt.Float32))


def _compute_hll_value(data_type: int, value: Any) -> int:
    """Client-side HLL value (reference client/connector.go:200)."""
    if data_type == dt.UUID:
        hi, lo = dt.parse_uuid(value)
        hashed = np.uint64(hi) ^ np.uint64(lo)
    elif data_type in (dt.Uint32, dt.Int32, dt.Int64):
        width = dt.data_type_bytes(data_type)
        hashed = H.murmur3_64(np.asarray([int(value)], np.int64), width)[0]
    else:
        raise ConnectorError(
            f"invalid type 0x{data_type:x} for fast hll value")
    return int(H.hll_value_from_hash(np.asarray([hashed], np.uint64))[0])
