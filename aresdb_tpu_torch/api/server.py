"""REST API server: query, data, schema, enum, health, debug endpoints.

Reference: api/ (query_handler.go /query/aql + /query/sql with a bounded
worker pool :95, data_handler.go /data/{table}/{shard}, schema_handler.go,
enum_handler.go, health, debug_handler.go's inspection + manual-job
endpoints) wired by cmd/aresd/cmd/cmd.go:270-283.

Port of `aresdb_tpu/api/server.py` on the standard library's
`http.server`: the same routes, status codes and JSON bodies, with
tornado's request semantics kept where a client can see them (arguments
take the last value, stripped; a malformed JSON body or `q` is a 400 with
tornado's HTML error page; an unmatched path is a 404, a method the
handler lacks a 405, an uncaught exception a 500). Every request runs on
a thread of its own; the `/query/*` handlers and the peer-session open run
on a pool of QUERY_WORKERS threads, and the handlers that mutate shared
schemas (tables, columns, enums) and the job triggers hold one lock, as
the JAX package runs them one at a time on its IOLoop.
"""

from __future__ import annotations

import contextvars
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import torch

from aresdb_tpu_torch.api.httpbase import (HTTPError, Handler, Service,
                                           compile_routes)
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch
from aresdb_tpu_torch.query.admission import (DeviceMemoryManager,
                                              DevicePool)
from aresdb_tpu_torch.query.service import QueryService
from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils import tracing
from aresdb_tpu_torch.utils.torch_env import resolve_device

QUERY_WORKERS = 8


class _Base(Handler):
    def query_body(self) -> Dict[str, Any]:
        """Request body, with the `q` query parameter taking precedence —
        the reference's GET query form (api/common/query_request.go:46,
        query_handler.go:136 json-decodes `q` over the body)."""
        qparam = self.get_argument("q", "")
        if qparam:
            try:
                return json.loads(qparam)
            except json.JSONDecodeError as e:
                raise HTTPError(400, f"invalid json: {e}")
        return self.json_body()

    def run_query(self, fn, *args):
        """fn(*args) on the query pool, waited for. While tracing, its
        wait for a worker is a `queue` span and the call a `service` span,
        both under this request's: the worker runs in a copy of this
        thread's context, which a pool thread does not inherit."""
        if not tracing.active:
            return self.ctx.query_pool.submit(fn, *args).result()
        queued = tracing.begin("queue")

        def call():
            tracing.finish(queued)
            with tracing.span("service"):
                return fn(*args)
        return self.ctx.query_pool.submit(
            contextvars.copy_context().run, call).result()


class ServerContext:
    def __init__(self, memstore, scheduler=None, timezone_table: str = "",
                 query_config=None, device=None):
        self.memstore = memstore
        self.scheduler = scheduler
        self.device = resolve_device(device)
        util = 0.95
        choose_timeout = 30.0
        query_timeout = 0.0
        if query_config is not None:
            util = getattr(query_config, "device_memory_utilization", 0.95)
            ct = getattr(query_config, "device_choosing_timeout", -1)
            choose_timeout = float(ct) if ct and ct > 0 else 30.0
            query_timeout = float(
                getattr(query_config, "query_timeout", 0) or 0)
        self.device_manager = DeviceMemoryManager(
            utilization=util, default_timeout=choose_timeout,
            device=self.device)
        # multi-GPU hosts get query-level placement: each admitted query
        # pins to one GPU (reference query/device_manager.go); mesh
        # batches over every GPU stay opt-in via ARES_MESH
        self.device_pool = None
        if (self.device.type == "cuda" and torch.cuda.device_count() > 1
                and os.environ.get("ARES_MESH", "") != "1"):
            self.device_pool = DevicePool(utilization=util,
                                          default_timeout=choose_timeout)
        self.health_off = False
        self.datanode = None   # the DataNode that runs this server, if any
        self.query_service = QueryService(memstore, device=self.device,
                                          timezone_table=timezone_table,
                                          device_manager=self.device_manager,
                                          query_timeout=query_timeout,
                                          device_pool=self.device_pool)
        self.query_pool = ThreadPoolExecutor(
            max_workers=QUERY_WORKERS, thread_name_prefix="ares-query")
        # torch.profiler must start and stop on one thread
        self.profiler_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ares-profiler")
        self.profiler = None
        self.trace_dir = None   # where /dbg/trace/stop writes
        self.lock = threading.Lock()
        self.metrics = M.root()

    def close(self) -> None:
        self.query_pool.shutdown(wait=True)
        self.profiler_thread.shutdown(wait=True)


class HealthHandler(_Base):
    def get(self):
        if self.ctx.health_off:
            return self.write_error_json(503, "health check turned off")
        self.finish("OK")

    def head(self):
        if self.ctx.health_off:
            return self.write_error_json(503, "health check turned off")
        self.finish()


class HealthSwitchHandler(_Base):
    """Drain support (reference: api/debug_handler.go HealthSwitch —
    POST /health/{on|off} flips the liveness probe so load balancers
    stop routing before a restart)."""

    def post(self, on_or_off: str):
        if on_or_off not in ("on", "off"):
            return self.write_error_json(400, "use on or off")
        self.ctx.health_off = on_or_off == "off"
        self.write_json({"message": f"health {on_or_off}"})


class AQLHandler(_Base):
    def get(self):
        """GET form: the request body rides the `q` query parameter
        (reference api/query_handler.go:67 registers GET+POST and :136
        JSON-decodes `q` over the body)."""
        self.post()

    def post(self):
        self.ctx.metrics.count(M.QUERY_RECEIVED)
        body = self.query_body()
        # Accept: application/hll → binary register pass-through
        # (api/query_handler.go:76,382 HLLQueryResponseWriter)
        if "application/hll" in self.request.headers.get("Accept", ""):
            from aresdb_tpu_torch.query import hll_wire as W

            with self.ctx.metrics.timer(M.QUERY_LATENCY):
                blob = self.run_query(
                    self.ctx.query_service.handle_aql_hll, body)
            self.ctx.metrics.count(M.QUERY_SUCCEEDED)
            self.set_header("Content-Type", W.CONTENT_TYPE)
            return self.finish(bytes(blob))
        # query params (api/common/query_request.go:36-52): dataonly keeps
        # enum dims as untranslated ranks, verbose/debug/profiling request
        # per-stage stats (profiling maps to stage timings — the torch
        # profiler itself is driven via /dbg/profiler), device prefers a
        # device, timeout overrides the device-choosing wait
        data_only = self.get_argument("dataonly", "") not in ("", "0")
        if (self.get_argument("verbose", "") not in ("", "0")
                or self.get_argument("debug", "") not in ("", "0")
                or self.get_argument("profiling", "")):
            body["verbose"] = 1
        try:
            device = int(self.get_argument("device", "-1"))
            timeout = float(self.get_argument("timeout", "0"))
        except ValueError:
            return self.write_error_json(400, "device/timeout must be "
                                              "numeric")
        with self.ctx.metrics.timer(M.QUERY_LATENCY):
            resp = self.run_query(
                lambda: self.ctx.query_service.handle_aql(
                    body, data_only=data_only, device=device,
                    admission_timeout=timeout if timeout > 0 else None))
        if resp.get("errors"):
            self.ctx.metrics.count(M.QUERY_FAILED)
        else:
            self.ctx.metrics.count(M.QUERY_SUCCEEDED)
        self.write_json(resp)


class SQLHandler(_Base):
    def get(self):
        self.post()

    def post(self):
        self.ctx.metrics.count(M.QUERY_RECEIVED)
        body = self.query_body()
        if (self.get_argument("verbose", "") not in ("", "0")
                or self.get_argument("debug", "") not in ("", "0")):
            body["verbose"] = 1
        with self.ctx.metrics.timer(M.QUERY_LATENCY):
            resp = self.run_query(self.ctx.query_service.handle_sql, body)
        self.write_json(resp)


class DataHandler(_Base):
    def post(self, table: str, shard: str):
        """Binary upsert batch ingestion (reference api/data_handler.go:47)."""
        try:
            batch = UpsertBatch(self.request.body)
        except Exception as e:
            return self.write_error_json(400, f"bad upsert batch: {e}")
        try:
            stats = self.ctx.memstore.handle_ingestion(
                table, int(shard), batch)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        except ValueError as e:
            return self.write_error_json(400, str(e))
        self.ctx.metrics.count(M.INGESTED_UPSERT_BATCHES,
                               tags={"table": table, "shard": shard})
        self.ctx.metrics.count(M.INGESTED_RECORDS, batch.num_rows,
                               tags={"table": table, "shard": shard})
        self.write_json({
            "inserted": stats.inserted,
            "updated": stats.updated,
            "backfilled": stats.backfilled,
        })


class TablesHandler(_Base):
    serialized = True

    def get(self):
        self.write_json(sorted(self.ctx.memstore.get_schemas()))

    def post(self):
        body = self.json_body()
        try:
            table = Table.from_json(body)
            self.ctx.memstore.create_table(table)
            self.ctx.memstore.add_table_shard(table.name, 0)
        except ValueError as e:
            return self.write_error_json(400, str(e))
        self.write_json({"message": "table created"}, status=200)


class TableHandler(_Base):
    serialized = True

    def get(self, name: str):
        try:
            schema = self.ctx.memstore.get_schema(name)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        self.write_json(schema.table.to_json())

    def put(self, name: str):
        """Full-table update, or config-only update when the body has no
        'columns' (reference api/schema_handler.go UpdateTableConfig takes
        a bare TableConfig)."""
        body = self.json_body()
        try:
            if "columns" not in body:
                import copy

                schema = self.ctx.memstore.get_schema(name)
                t = copy.deepcopy(schema.table)
                new_json = t.to_json()
                new_json["config"] = body
                table = Table.from_json(new_json)
                table.version = t.version + 1
            else:
                table = Table.from_json(body)
                if table.name != name:
                    return self.write_error_json(400, "table name mismatch")
            self.ctx.memstore.metastore.update_table(table)
            self.ctx.memstore.get_schema(name).set_table(table)
        except (KeyError, ValueError) as e:
            return self.write_error_json(400, str(e))
        self.write_json({"message": "table updated"})

    def delete(self, name: str):
        try:
            self.ctx.memstore.get_schema(name)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        self.ctx.memstore.remove_table_shard(name, 0)
        self.ctx.memstore.metastore.delete_table(name)
        self.ctx.memstore.schemas.pop(name, None)
        self.write_json({"message": "table deleted"})


class ColumnsHandler(_Base):
    serialized = True

    def post(self, table: str):
        """Add a column (reference api/schema_handler.go AddColumn): body
        is {"column": {...}, "addToArchivingSortOrder": bool}; the new
        column appends at the next column id and may extend the archiving
        sort order. Validated by the shared schema validator through
        metastore.update_table."""
        body = self.json_body()
        col_json = body.get("column") or body  # bare column json accepted
        ms = self.ctx.memstore
        try:
            schema = ms.get_schema(table)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        import copy

        t = copy.deepcopy(schema.table)
        new_json = t.to_json()
        new_json["columns"].append(col_json)
        if body.get("addToArchivingSortOrder"):
            new_json.setdefault("archivingSortColumns", list(
                t.archiving_sort_columns or []))
            new_json["archivingSortColumns"].append(
                len(new_json["columns"]) - 1)
        try:
            new_table = Table.from_json(new_json)
            new_table.version = t.version + 1
            if ms.metastore is not None:
                ms.metastore.update_table(new_table)
            schema.set_table(new_table)
        except (KeyError, ValueError) as e:
            return self.write_error_json(400, str(e))
        self.write_json({"message": f"column added to {table}"})


class ColumnHandler(_Base):
    serialized = True

    def put(self, table: str, column: str):
        """Update a column's config (reference schema_handler.go
        UpdateColumn — only the ColumnConfig may change)."""
        body = self.json_body()
        ms = self.ctx.memstore
        try:
            schema = ms.get_schema(table)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        cid = schema.column_ids.get(column)
        if cid is None:
            return self.write_error_json(404, f"unknown column {column!r}")
        import copy

        t = copy.deepcopy(schema.table)
        new_json = t.to_json()
        new_json["columns"][cid]["config"] = body
        try:
            new_table = Table.from_json(new_json)
            new_table.version = t.version + 1
            if ms.metastore is not None:
                ms.metastore.update_table(new_table)
            old_table = schema.table
            schema.set_table(new_table)
            if getattr(ms, "host_memory_manager", None) is not None:
                ms.host_memory_manager.handle_table_update(old_table,
                                                           new_table)
        except (KeyError, ValueError) as e:
            return self.write_error_json(400, str(e))
        self.write_json({"message": f"column {column} updated"})

    def delete(self, table: str, column: str):
        """Delete (tombstone) a column (reference api/schema_handler.go
        DeleteColumn + memstore TableShard.DeleteColumn)."""
        ms = self.ctx.memstore
        try:
            schema = ms.get_schema(table)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        cid = schema.column_ids.get(column)
        if cid is None:
            return self.write_error_json(404, f"unknown column {column!r}")
        if not schema.get_column_deletable(cid):
            return self.write_error_json(
                400, f"column {column!r} cannot be deleted (primary key or "
                     f"time column)")
        t = schema.table
        t.columns[cid].deleted = True
        t.version += 1
        if ms.metastore is not None:
            ms.metastore.update_table(t)
        schema.set_table(t)
        # reference applyTableSchema also drops the enum dict of a
        # deleted enum column (memstore/schema.go delete(EnumDicts))
        schema.enum_dicts.pop(column, None)
        ms.delete_column_data(table, cid)
        self.write_json({"message": f"column {column} deleted"})


class EnumHandler(_Base):
    serialized = True

    def get(self, table: str, column: str):
        try:
            schema = self.ctx.memstore.get_schema(table)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        self.write_json(schema.enum_reverse_dict(column))

    def post(self, table: str, column: str):
        body = self.json_body()
        cases = body.get("enumCases", [])
        try:
            schema = self.ctx.memstore.get_schema(table)
            ranks = schema.extend_enum(column, cases)
            if self.ctx.memstore.metastore is not None:
                self.ctx.memstore.metastore.extend_enum_cases(
                    table, column, cases)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        self.write_json(ranks)


class ShardsDebugHandler(_Base):
    def get(self):
        out = []
        for table, shard_id in self.ctx.memstore.list_shards():
            shard = self.ctx.memstore.get_table_shard(table, shard_id)
            ls = shard.live_store
            out.append({
                "table": table,
                "shard": shard_id,
                "rowsVisible": ls.rows_visible(),
                "liveBatches": len(ls.batches),
                "primaryKeys": len(ls.primary_key),
                "archivingCutoff": ls.archiving_cutoff_high_watermark,
                "archiveBatches": len(
                    shard.archive_store.get_current_version().batches),
                "bytesEstimate": ls.bytes_estimate(),
            })
        self.write_json(out)


class ShardDebugHandler(_Base):
    def get(self, table: str, shard: str):
        try:
            s = self.ctx.memstore.get_table_shard(table, int(shard))
        except KeyError as e:
            return self.write_error_json(404, str(e))
        ls = s.live_store
        version = s.archive_store.get_current_version()
        self.write_json({
            "liveStore": {
                "batchSize": ls.batch_size,
                "batches": {str(b): ls.visible_rows_in_batch(b)
                            for b in ls.get_batch_ids()},
                "lastReadRecord": [ls.last_read_record.batch_id,
                                   ls.last_read_record.index],
                "primaryKeys": len(ls.primary_key),
                "archivingCutoff": ls.archiving_cutoff_high_watermark,
            },
            "archiveStore": {
                "cutoff": version.archiving_cutoff,
                "batches": {str(b): {"size": ab.size, "version": ab.version,
                                     "seq": ab.seq}
                            for b, ab in version.batches.items()},
            },
        })


class BatchInspectHandler(_Base):
    """Batch / vector-party inspection (reference: debug_handler.go
    ShowBatch + LoadVectorParty/EvictVectorParty)."""

    def get(self, table: str, shard: str, batch: str, column: str = None):
        try:
            s = self.ctx.memstore.get_table_shard(table, int(shard))
        except KeyError as e:
            return self.write_error_json(404, str(e))
        bid = int(batch)
        schema = s.schema
        if bid < 0:        # live batch
            b = s.live_store.batches.get(bid)
            if b is None:
                return self.write_error_json(404, f"no live batch {bid}")
            get_col = b.column
            size = s.live_store.visible_rows_in_batch(bid)
        else:              # archive day batch
            version = s.archive_store.get_current_version()
            ab = version.batches.get(bid)
            if ab is None:
                return self.write_error_json(404, f"no archive batch {bid}")
            get_col = ab.request_column
            size = ab.size
        if column is None:
            cols = {}
            for cid, cs in enumerate(schema.table.columns):
                vp = get_col(cid)
                if vp is None:
                    continue
                cols[cs.name] = {
                    "dataType": f"0x{cs.data_type:06x}",
                    "bytes": getattr(vp, "bytes_estimate", lambda: 0)(),
                    "compressed": bool(getattr(vp, "is_compressed", False)),
                }
            return self.write_json({"batch": bid, "rows": size,
                                    "columns": cols})
        cid = schema.column_ids.get(column)
        if cid is None:
            return self.write_error_json(404, f"unknown column {column!r}")
        vp = get_col(cid)
        if vp is None:
            return self.write_json({"column": column, "allDefault": True})
        off = max(0, int(self.get_argument("offset", "0")))
        n = min(max(0, size - off),
                min(1000, int(self.get_argument("rows", "20"))))
        sample = [vp.read_value(off + i) for i in range(n)]
        self.write_json({"column": column, "rows": size, "offset": off,
                         "bytes": getattr(vp, "bytes_estimate", lambda: 0)(),
                         "sample": [None if v is None else str(v)
                                    for v in sample]})

    def delete(self, table: str, shard: str, batch: str, column: str = None):
        """Evict an archive column from host memory (lazy-reloads)."""
        try:
            s = self.ctx.memstore.get_table_shard(table, int(shard))
        except KeyError as e:
            return self.write_error_json(404, str(e))
        bid = int(batch)
        if bid < 0 or column is None:
            return self.write_error_json(400, "evict needs an archive batch "
                                              "and a column")
        cid = s.schema.column_ids.get(column)
        if cid is None:
            return self.write_error_json(404, f"unknown column {column!r}")
        version = s.archive_store.get_current_version()
        ab = version.batches.get(bid)
        if ab is None:
            return self.write_error_json(404, f"no archive batch {bid}")
        ab.evict_column(cid)
        self.write_json({"message": f"evicted {column} of batch {bid}"})


class BackfillQueueHandler(_Base):
    """Peek the backfill queue (reference: debug_handler.go
    ReadBackfillQueueUpsertBatch)."""

    def get(self, table: str, shard: str, offset: str):
        try:
            s = self.ctx.memstore.get_table_shard(table, int(shard))
        except KeyError as e:
            return self.write_error_json(404, str(e))
        bm = s.backfill_manager
        if bm is None:
            return self.write_error_json(404, "no backfill manager")
        i = int(offset)
        with bm.lock:
            queue = list(bm.queue)
        if i >= len(queue):
            return self.write_error_json(404,
                                         f"offset {i} >= {len(queue)}")
        entry = queue[i]
        batch = entry[0] if isinstance(entry, tuple) else entry
        self.write_json({
            "offset": i, "queued": len(queue),
            "numRows": batch.num_rows,
            "columns": [c.column_id for c in batch.columns]})


class PrimaryKeyLookupHandler(_Base):
    """Debug PK probe (reference: api/debug_handler.go LookupPrimaryKey —
    /dbg/{table}/{shard}/primary-keys?key=v1,v2 → RecordID)."""

    def get(self, table: str, shard: str):
        import numpy as np

        from aresdb_tpu_torch.common import data_types as dtm

        try:
            s = self.ctx.memstore.get_table_shard(table, int(shard))
        except KeyError as e:
            return self.write_error_json(404, str(e))
        schema = s.schema
        pk_ids = schema.table.primary_key_columns
        values = [v for v in self.get_query_argument("key", "").split(",") if v]
        if len(values) != len(pk_ids):
            return self.write_error_json(
                400, f"expected {len(pk_ids)} comma-separated key values "
                     f"for columns "
                     f"{[schema.table.columns[c].name for c in pk_ids]}")
        parts = []
        for raw, cid in zip(values, pk_ids):
            col = schema.table.columns[cid]
            try:
                if col.is_enum_column():
                    rank = schema.enum_dicts[col.name].get(raw)
                    if rank is None:
                        return self.write_json({"found": False})
                    parsed = rank
                else:
                    parsed = dtm.parse_value(raw, col.data_type)
            except (ValueError, TypeError) as e:
                return self.write_error_json(400, str(e))
            if parsed is None:
                return self.write_error_json(400, f"bad key value {raw!r}")
            arr = np.asarray([parsed], dtm.numpy_dtype(col.data_type))
            parts.append(arr.view(np.uint8).tobytes())
        rec = s.live_store.primary_key.find(b"".join(parts))
        if rec is None:
            return self.write_json({"found": False})
        self.write_json({"found": True, "batchID": rec.batch_id,
                         "index": rec.index})


class JobsDebugHandler(_Base):
    def get(self, job_type: str = ""):
        """All job statuses, or one job type's (reference
        api/debug_handler.go:77 ShowJobStatus at /dbg/jobs/{jobType})."""
        if self.ctx.scheduler is None:
            return self.write_json({})
        statuses = self.ctx.scheduler.job_statuses()
        if job_type:
            statuses = {k: v for k, v in statuses.items()
                        if k.rsplit("/", 1)[-1] == job_type}
        self.write_json(statuses)


class JobTriggerHandler(_Base):
    serialized = True

    def post(self, table: str, shard: str, job: str):
        if self.ctx.scheduler is None:
            return self.write_error_json(400, "scheduler not running")
        try:
            result = self.ctx.scheduler.run_job(table, int(shard), job)
        except (KeyError, ValueError) as e:
            return self.write_error_json(400, str(e))
        self.write_json({"job": job, "result": result})


class DevicesDebugHandler(_Base):
    def get(self):
        """The devices of the server's device type: every CUDA device, or
        the CPU; and the device pool's state where the server has one."""
        if self.ctx.device.type == "cuda":
            devices = [{"id": i, "platform": "gpu",
                        "kind": torch.cuda.get_device_name(i)}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        out = {"devices": devices}
        if self.ctx.device_pool is not None:
            # per-device placement + admission state (reference
            # query/device_manager.go DeviceInfos)
            out["pool"] = self.ctx.device_pool.stats()
        self.write_json(out)


class HostMemoryDebugHandler(_Base):
    def get(self):
        hmm = self.ctx.memstore.host_memory_manager
        self.write_json({
            "reserved": hmm.get_reserved_memory(),
            "unmanaged": hmm.unmanaged_bytes,
            "managed": hmm.managed_bytes,
            "budget": hmm.total_memory_bytes,
            # reference GetArchiveMemoryUsageByTableShard
            # (host_memory_manager.go:271)
            "usage": hmm.get_archive_memory_usage_by_table_shard(),
        })


class MetricsHandler(_Base):
    def get(self):
        self.write_json(self.ctx.metrics.snapshot())


class DeviceStatsHandler(_Base):
    """Admission-gate state (reference: query/device_manager.go DeviceInfos
    surfaced via /debug; here one device's byte budget)."""

    def get(self):
        self.write_json(self.ctx.device_manager.stats())


class RedologBrowserHandler(_Base):
    """Debug browsing of redolog files / upsert batches.

    Reference: memstore/redo_log_browser.go:28 exposed through
    api/debug_handler.go (ListRedoLogs / ListUpsertBatches / ReadUpsertBatch).
    """

    def get(self, table: str, shard: str, rest: str = ""):
        ms = self.ctx.memstore
        sid = int(shard)
        try:
            sh = ms.get_table_shard(table, sid)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        rm = sh.redolog_manager
        if rm is None:
            return self.write_json([])
        # accept both the short form /redologs/{creation}[/{offset}] and
        # the reference's exact shape
        # /redologs/{creation}/upsertbatches[/{offset}]
        # (api/debug_handler.go:92-94)
        parts = [p for p in rest.split("/") if p and p != "upsertbatches"]
        if not parts:
            # list redolog files
            return self.write_json(ms.diskstore.list_logs(table, sid))
        creation = int(parts[0])
        batches = []
        for rf, off, payload in rm.iterate(creation, 0):
            if rf != creation:
                continue
            if len(parts) >= 2 and off == int(parts[1]):
                b = UpsertBatch(payload)
                rows = []
                for r in range(min(b.num_rows, 100)):
                    rows.append([c.get_value(r) for c in b.columns])
                return self.write_json({
                    "numRows": b.num_rows,
                    "columns": [c.column_id for c in b.columns],
                    "rows": rows,
                })
            batches.append({"offset": off, "bytes": len(payload)})
        if len(parts) >= 2:
            return self.write_error_json(404, "no such batch offset")
        self.write_json(batches)


class DeviceCacheDebugHandler(_Base):
    def get(self):
        from aresdb_tpu_torch.query.executor import GLOBAL_DEVICE_CACHE
        self.write_json(GLOBAL_DEVICE_CACHE.stats())


class BootstrapRetryHandler(_Base):
    """Re-trigger peer bootstrap for shards the node failed to acquire
    (reference api/debug_handler.go:97 bootstrapRetry)."""

    def post(self):
        node = self.ctx.datanode
        if node is None:
            return self.write_error_json(
                404, "not running in distributed datanode mode")
        retried = node.retry_bootstrap()
        self.write_json({"retried": retried})


class TraceHandler(_Base):
    """The daemon's own spans (`utils/tracing.py`), each request's from
    the HTTP read to the card's wait: start records them; stop writes them
    as a Chrome trace JSON, in CLOCK_MONOTONIC microseconds, into the
    directory start was given. Starting twice, stopping with none started,
    or a directory that cannot be made is a 400, before any span is
    spent."""

    serialized = True

    def post(self, action: str):
        if action == "start":
            d = self.json_body().get(
                "dir", os.path.join(tempfile.gettempdir(), "ares-spans"))
            try:
                os.makedirs(d, exist_ok=True)
                tracing.start(tracing.DEFAULT_CAPACITY)
            except (OSError, RuntimeError) as e:
                return self.write_error_json(400, str(e))
            self.ctx.trace_dir = d
            return self.write_json({"message": f"spans to {d}"})
        try:
            spans = tracing.stop()
        except RuntimeError as e:
            return self.write_error_json(400, str(e))
        path = tracing.write_chrome_trace(spans, self.ctx.trace_dir,
                                          tracing.dropped())
        self.write_json({"message": "spans written", "path": path,
                         "spans": len(spans), "dropped": tracing.dropped()})


class ProfilerHandler(_Base):
    """torch.profiler capture (parity: cudaProfilerStart/Stop via
    /dbg/profiler, reference cgoutils/memory.go:160 + debug_handler): start
    traces the CPU and, on a CUDA server, the card; stop writes a Chrome
    trace JSON into the directory start was given. Starting twice, or
    stopping with no trace running, is a 400."""

    def post(self, action: str):
        if action == "start":
            d = self.json_body().get(
                "dir", os.path.join(tempfile.gettempdir(), "ares-profile"))
            try:
                self.ctx.profiler_thread.submit(self._start, d).result()
            except RuntimeError as e:
                return self.write_error_json(400, str(e))
            self.write_json({"message": f"tracing to {d}"})
        else:
            try:
                self.ctx.profiler_thread.submit(self._stop).result()
            except RuntimeError as e:
                return self.write_error_json(400, str(e))
            self.write_json({"message": "trace stopped"})

    def _start(self, d: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        if self.ctx.profiler is not None:
            raise RuntimeError("Profile has already been started. "
                               "Only one profile may be run at a time.")
        acts = [ProfilerActivity.CPU]
        if self.ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        self.ctx.profiler = (prof, d)

    def _stop(self) -> None:
        if self.ctx.profiler is None:
            raise RuntimeError("No profile started")
        prof, d = self.ctx.profiler
        self.ctx.profiler = None
        prof.stop()
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            d, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))


_DEBUG_HTML = """<!doctype html><html><head><title>aresdb_tpu_torch debug</title>
<style>
body{font-family:ui-monospace,monospace;margin:0;background:#fafafa;color:#222}
#nav{background:#1a2744;color:#fff;padding:0 1em;display:flex;align-items:center}
#nav b{margin-right:1.5em;padding:10px 0}
#nav a{color:#9fb3d9;text-decoration:none;padding:12px 14px;cursor:pointer}
#nav a.on{color:#fff;background:#2d4373}
#page{padding:1.2em 1.6em}
table{border-collapse:collapse;background:#fff;margin:.5em 0}
td,th{border:1px solid #ccc;padding:4px 10px;text-align:left}
th{background:#eef1f7}
h2{margin:.8em 0 .2em;font-size:1.05em}
button{font-family:inherit;padding:3px 10px;margin:2px;cursor:pointer}
textarea{width:100%;height:90px;font-family:inherit;font-size:13px}
pre{background:#fff;border:1px solid #ccc;padding:8px;overflow:auto}
.err{color:#b00020}.ok{color:#0a7d38}
input,select{font-family:inherit;padding:3px 6px}
</style></head><body>
<div id=nav><b>aresdb_tpu</b></div><div id=page>loading...</div>
<script>
const TABS=["Overview","Jobs","Memory","Schema","Storage","Query","Metrics","Redologs","Node","Profiler"];
let cur="Overview";
async function j(u,opt){const r=await fetch(u,opt);
  const t=await r.text();try{return JSON.parse(t)}catch(e){return t}}
function esc(x){return String(x).replace(/&/g,"&amp;").replace(/</g,"&lt;")}
function tbl(headers,rows){let h="<table><tr>"+headers.map(c=>`<th>${esc(c)}</th>`).join("")+"</tr>";
  for(const r of rows)h+="<tr>"+r.map(c=>`<td>${c}</td>`).join("")+"</tr>";return h+"</table>"}
function nav(){document.getElementById("nav").innerHTML="<b>aresdb_tpu</b>"+
  TABS.map(t=>`<a class="${t===cur?"on":""}" onclick="go('${t}')">${t}</a>`).join("")}
function go(t){cur=t;nav();render()}
async function render(){
  const p=document.getElementById("page");
  try{p.innerHTML=await PAGES[cur]()}catch(e){p.innerHTML=`<pre class=err>${esc(e)}</pre>`}
  if(cur==="Overview"||cur==="Jobs"||cur==="Memory")
    clearTimeout(window.__t),window.__t=setTimeout(()=>{if(cur)render()},5000);
}
const PAGES={
 async Overview(){
  const shards=await j("/dbg/shards"),devices=await j("/dbg/devices");
  let h="<h2>Table shards</h2>"+tbl(
    ["table","shard","rows visible","live batches","primary keys",
     "archiving cutoff","archive batches",""],
    shards.map(s=>[esc(s.table),s.shard,s.rowsVisible,s.liveBatches,
      s.primaryKeys,s.archivingCutoff,s.archiveBatches,
      `<button onclick="detail('${esc(s.table)}',${s.shard})">detail</button>`]));
  h+="<div id=detail></div><h2>Devices</h2><pre>"+esc(JSON.stringify(devices,null,1))+"</pre>";
  return h},
 async Jobs(){
  const jobs=await j("/dbg/jobs"),shards=await j("/dbg/shards");
  let h="<h2>Job statuses</h2>"+tbl(
    ["job","last run","runs","last duration (s)","last result"],
    Object.entries(jobs).map(([k,v])=>[esc(k),
      v.lastRun?new Date(v.lastRun*1000).toISOString():"-",
      v.numRuns??0,(v.lastDuration??0).toFixed(3),
      esc(JSON.stringify(v.lastResult??""))]));
  h+="<h2>Trigger</h2>";
  for(const s of shards){h+=`<div>${esc(s.table)}/${s.shard}: `+
    ["archiving","backfill","snapshot","purge"].map(x=>
      `<button onclick="trig('${esc(s.table)}',${s.shard},'${x}')">${x}</button>`).join("")+"</div>"}
  return h+"<pre id=trigout></pre>"},
 async Memory(){
  const hm=await j("/dbg/host-memory"),dc=await j("/dbg/device-cache");
  return "<h2>Host memory</h2><pre>"+esc(JSON.stringify(hm,null,1))+
    "</pre><h2>Device column cache (HBM residency)</h2><pre>"+
    esc(JSON.stringify(dc,null,1))+"</pre>"},
 async Schema(){
  const names=await j("/schema/tables");let h="<h2>Tables</h2>";
  for(const n of names){const t=await j("/schema/tables/"+n);
    h+=`<h2>${esc(n)} ${t.isFactTable?"(fact)":"(dimension)"}</h2>`+tbl(
      ["id","column","type","default","deleted","pk","sort"],
      t.columns.map((c,i)=>[i,esc(c.name),esc(c.type),
        c.defaultValue===undefined||c.defaultValue===null?"":esc(c.defaultValue),
        c.deleted?"yes":"",t.primaryKeyColumns.includes(i)?"yes":"",
        (t.archivingSortColumns||[]).includes(i)?"yes":""]))}
  return h},
 async Query(){
  return `<h2>Query console</h2>
  <select id=qmode><option>SQL</option><option>AQL</option></select>
  <label><input type=checkbox id=qverbose> verbose</label>
  <button onclick="runq()">Run</button>
  <textarea id=qtext>SELECT count(*) FROM </textarea>
  <div id=qout></div>`},
 async Metrics(){
  const m=await j("/metrics");
  return "<h2>Counters</h2>"+tbl(["name","value"],
      Object.entries(m.counters||{}).map(([k,v])=>[esc(k),v]))+
    "<h2>Gauges</h2>"+tbl(["name","value"],
      Object.entries(m.gauges||{}).map(([k,v])=>[esc(k),v]))+
    "<h2>Timers</h2>"+tbl(["name","count","avg (ms)","max (ms)"],
      Object.entries(m.timers||{}).map(([k,v])=>[esc(k),v.count,
        (1e3*(v.avg??0)).toFixed(2),(1e3*(v.max??0)).toFixed(2)]))},
 async Redologs(){
  const shards=await j("/dbg/shards");let h="<h2>Redo logs</h2>";
  for(const s of shards){const files=await j(`/dbg/${s.table}/${s.shard}/redologs`);
    h+=`<h2>${esc(s.table)}/${s.shard}</h2><pre>`+esc(JSON.stringify(files,null,1))+"</pre>"}
  return h},
 async Storage(){
  const shards=await j("/dbg/shards");
  const opts=shards.map(s=>`<option>${esc(s.table)}/${s.shard}</option>`).join("");
  return `<h2>Batch inspector</h2>
  <div>shard <select id=bshard>${opts}</select>
  batch id <input id=bid size=12 placeholder="-1 = live batch 0">
  <button onclick="inspectBatch()">inspect</button></div>
  <div>column <input id=bcol size=14>
  offset <input id=boff size=6 value=0> rows <input id=bn size=6 value=20>
  <button onclick="sampleVP()">sample values</button>
  <button onclick="evictVP()">evict from host memory</button></div>
  <pre id=bout></pre>
  <h2>Primary-key lookup</h2>
  <div>shard <select id=pkshard>${opts}</select>
  key <input id=pkkey size=30 placeholder="v1,v2">
  <button onclick="pkLookup()">lookup</button></div><pre id=pkout></pre>
  <h2>Backfill queue</h2>
  <div>shard <select id=bfshard>${opts}</select>
  offset <input id=bfoff size=6 value=0>
  <button onclick="peekBackfill()">peek</button></div><pre id=bfout></pre>`},
 async Node(){
  const health=await fetch("/health");
  return `<h2>Health drain switch</h2>
  <p>liveness probe now: <b class=${health.ok?"ok":"err"}>${health.status}</b>
  (load balancers drain the node when off — reference
  debug_handler HealthSwitch)</p>
  <button onclick="healthSwitch('on')">on</button>
  <button onclick="healthSwitch('off')">off</button>
  <pre id=hout></pre>
  <h2>Peer bootstrap</h2>
  <button onclick="bootstrapRetry()">retry failed shards</button>
  <pre id=bsout></pre>`},
 async Profiler(){
  return `<h2>torch profiler</h2>
  <div>trace dir <input id=pdir size=40>
  <button onclick="prof('start')">start</button>
  <button onclick="prof('stop')">stop</button></div>
  <p>Captured traces (Chrome trace JSON) load in Perfetto.</p>
  <pre id=pout></pre>`},
};
async function detail(t,s){
  const d=await j(`/dbg/${t}/${s}`);
  document.getElementById("detail").innerHTML=
    `<h2>${esc(t)}/${s}</h2><pre>`+esc(JSON.stringify(d,null,1))+"</pre>"}
async function trig(t,s,job){
  const r=await j(`/dbg/${t}/${s}/${job}`,{method:"POST",body:"{}"});
  document.getElementById("trigout").textContent=JSON.stringify(r,null,1)}
function shardOf(id){const[t,s]=document.getElementById(id).value.split("/");
  return[t,s]}
async function inspectBatch(){
  const[t,s]=shardOf("bshard");
  const b=document.getElementById("bid").value||"-1";
  const r=await j(`/dbg/${t}/${s}/batches/${b}`);
  document.getElementById("bout").textContent=JSON.stringify(r,null,1)}
async function sampleVP(){
  const[t,s]=shardOf("bshard");
  const b=document.getElementById("bid").value||"-1";
  const c=document.getElementById("bcol").value;
  const off=document.getElementById("boff").value,n=document.getElementById("bn").value;
  const r=await j(`/dbg/${t}/${s}/batches/${b}/vector-parties/${c}?offset=${off}&rows=${n}`);
  document.getElementById("bout").textContent=JSON.stringify(r,null,1)}
async function evictVP(){
  const[t,s]=shardOf("bshard");
  const b=document.getElementById("bid").value||"-1";
  const c=document.getElementById("bcol").value;
  const r=await j(`/dbg/${t}/${s}/batches/${b}/vector-parties/${c}`,{method:"DELETE"});
  document.getElementById("bout").textContent=JSON.stringify(r,null,1)}
async function pkLookup(){
  const[t,s]=shardOf("pkshard");
  const k=encodeURIComponent(document.getElementById("pkkey").value);
  const r=await j(`/dbg/${t}/${s}/primary-keys?key=${k}`);
  document.getElementById("pkout").textContent=JSON.stringify(r,null,1)}
async function peekBackfill(){
  const[t,s]=shardOf("bfshard");
  const off=document.getElementById("bfoff").value;
  const r=await j(`/dbg/${t}/${s}/backfill-queue/${off}`);
  document.getElementById("bfout").textContent=JSON.stringify(r,null,1)}
async function healthSwitch(x){
  const r=await fetch(`/health/${x}`,{method:"POST"});
  document.getElementById("hout").textContent=await r.text();go("Node")}
async function bootstrapRetry(){
  const r=await j("/dbg/bootstrap/retry",{method:"POST",body:"{}"});
  document.getElementById("bsout").textContent=JSON.stringify(r,null,1)}
async function prof(a){
  const dir=document.getElementById("pdir").value;
  const r=await j(`/dbg/profiler/${a}`,{method:"POST",
    body:JSON.stringify(dir?{dir}:{})});
  document.getElementById("pout").textContent=JSON.stringify(r,null,1)}
function flat(node,prefix,out){
  for(const[k,v]of Object.entries(node)){
    if(v!==null&&typeof v==="object"&&!Array.isArray(v))flat(v,prefix.concat(k),out);
    else out.push(prefix.concat([k,v]))}return out}
async function runq(){
  const mode=document.getElementById("qmode").value;
  const verbose=document.getElementById("qverbose").checked;
  const text=document.getElementById("qtext").value;
  let body;
  if(mode==="SQL")body={queries:[text]};
  else{let q;try{q=JSON.parse(text)}catch(e){
    document.getElementById("qout").innerHTML=`<pre class=err>bad AQL json: ${esc(e)}</pre>`;return}
    body={queries:[q],verbose}}
  const t0=performance.now();
  const resp=await j(mode==="SQL"?"/query/sql":"/query/aql",
    {method:"POST",body:JSON.stringify(body)});
  const ms=(performance.now()-t0).toFixed(1);
  let h=`<p class=ok>${ms} ms</p>`;
  if(resp.errors&&resp.errors[0])h+=`<pre class=err>${esc(resp.errors[0])}</pre>`;
  const r=(resp.results||[])[0];
  if(r&&r.matrixData)h+=tbl(r.headers,r.matrixData.map(row=>row.map(esc)));
  else if(r&&typeof r==="object"){
    const rows=flat(r,[],[]);
    const depth=rows.length?rows[0].length-1:0;
    h+=tbl([...Array(depth).keys()].map(i=>"dim"+i).concat(["value"]),
      rows.map(row=>row.map(esc)))}
  if(resp.context)h+="<h2>stats</h2><pre>"+esc(JSON.stringify(resp.context,null,1))+"</pre>";
  document.getElementById("qout").innerHTML=h}
nav();render();
</script></body></html>"""


def _openapi_spec() -> dict:
    """Minimal OpenAPI 3 description of the public surface (reference ships
    a swagger spec under api/ui/swagger; this is the generated equivalent)."""
    def op(summary, **kw):
        d = {"summary": summary,
             "responses": {"200": {"description": "OK"}}}
        d.update(kw)
        return d

    return {
        "openapi": "3.0.0",
        "info": {"title": "aresdb_tpu", "version": "1.0",
                 "description": "TPU-native real-time analytics engine"},
        "paths": {
            "/health": {"get": op("liveness probe")},
            "/query/aql": {"post": op(
                "run AQL queries",
                requestBody={"content": {"application/json": {"schema": {
                    "type": "object", "properties": {
                        "queries": {"type": "array"},
                        "verbose": {"type": "boolean"}}}}}})},
            "/query/sql": {"post": op("run SQL queries")},
            "/data/{table}/{shard}": {"post": op(
                "ingest a binary UpsertBatch")},
            "/schema/tables": {"get": op("list tables"),
                               "post": op("create table")},
            "/schema/tables/{table}": {"get": op("get table schema"),
                                       "put": op("update table"),
                                       "delete": op("delete table")},
            "/schema/tables/{table}/columns/{column}": {
                "delete": op("delete (tombstone) a column")},
            "/schema/tables/{table}/columns/{column}/enum-cases": {
                "get": op("list enum cases"),
                "post": op("extend enum cases")},
            "/metrics": {"get": op("metrics snapshot")},
            "/dbg": {"get": op("debug web UI")},
            "/dbg/shards": {"get": op("table shard overview")},
            "/dbg/jobs": {"get": op("job statuses")},
            "/dbg/jobs/{jobType}": {"get": op(
                "job statuses for one job type")},
            "/dbg/devices": {"get": op("torch devices")},
            "/dbg/host-memory": {"get": op("host memory usage")},
            "/dbg/device-cache": {"get": op("HBM column cache stats")},
            "/dbg/{table}/{shard}": {"get": op("shard detail")},
            "/dbg/{table}/{shard}/{job}": {"post": op(
                "trigger archiving|backfill|snapshot|purge")},
            "/dbg/{table}/{shard}/redologs": {"get": op("list redo logs")},
            "/dbg/{table}/{shard}/primary-keys": {"get": op(
                "look up a primary key (?key=v1,v2)")},
            "/dbg/profiler/{action}": {"post": op(
                "start|stop a torch profiler trace")},
            "/dbg/trace/{action}": {"post": op(
                "start|stop recording the daemon's spans")},
            "/health/{onOrOff}": {"post": op(
                "drain switch for the liveness probe")},
            "/dbg/{table}/{shard}/batches/{batch}": {"get": op(
                "inspect a live or archive batch")},
            "/dbg/{table}/{shard}/batches/{batch}/vector-parties/{column}":
                {"get": op("sample a column's values"),
                 "delete": op("evict an archive column from host memory")},
            "/dbg/{table}/{shard}/backfill-queue/{offset}": {"get": op(
                "peek a queued backfill upsert batch")},
            "/peer/{table}/{shard}/metadata": {"get": op(
                "peer bootstrap: shard metadata")},
        },
    }


class SwaggerHandler(_Base):
    def get(self):
        self.write_json(_openapi_spec())


class DebugUIHandler(_Base):
    def get(self):
        self.set_header("Content-Type", "text/html")
        self.finish(_DEBUG_HTML)


# -- peer data copy (reference: datanode/bootstrap/bootstrap_server.go
# FetchTableShardMetaData + FetchVectorPartyRawData gRPC streaming; here the
# same roles over HTTP chunked transfer) --

class PeerSessionHandler(_Base):
    """Peer-copy session: holds the shard's bootstrap token for the whole
    copy (reference: bootstrap_server.go:76 StartSession + keep-alive).

    POST   /peer/<table>/<shard>/session            -> {sessionId, ttl}
    PUT    /peer/session/<sid>/keepalive            -> 200 | 410
    DELETE /peer/session/<sid>                      -> 200
    """

    def post(self, table: str, shard: str):
        from aresdb_tpu_torch.memstore.common import GLOBAL_BOOTSTRAP_SESSIONS

        sid = int(shard)
        try:
            self.ctx.memstore.get_table_shard(table, sid)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        # open() blocks up to 20s waiting for an archiving/backfill job to
        # release the token; it takes a query worker, as in the JAX package
        try:
            session_id = self.run_query(
                GLOBAL_BOOTSTRAP_SESSIONS.open, table, sid)
        except TimeoutError as e:
            return self.write_error_json(503, str(e))
        self.write_json({"sessionId": session_id,
                         "ttl": GLOBAL_BOOTSTRAP_SESSIONS.ttl})


class PeerSessionKeepaliveHandler(_Base):
    def put(self, session_id: str):
        from aresdb_tpu_torch.memstore.common import GLOBAL_BOOTSTRAP_SESSIONS

        if not GLOBAL_BOOTSTRAP_SESSIONS.keepalive(session_id):
            return self.write_error_json(410, "session expired")
        self.write_json({"message": "ok"})

    def delete(self, session_id: str):
        from aresdb_tpu_torch.memstore.common import GLOBAL_BOOTSTRAP_SESSIONS

        GLOBAL_BOOTSTRAP_SESSIONS.close(session_id)
        self.write_json({"message": "closed"})


class PeerMetadataHandler(_Base):
    def get(self, table: str, shard: str):
        from aresdb_tpu_torch.memstore.common import (
            GLOBAL_BOOTSTRAP_SESSIONS, GLOBAL_BOOTSTRAP_TOKEN)

        ms = self.ctx.memstore
        sid = int(shard)
        try:
            ms.get_table_shard(table, sid)
        except KeyError as e:
            return self.write_error_json(404, str(e))
        session = self.get_query_argument("session", None)
        if session is not None:
            # session already holds the token for the whole copy
            if not GLOBAL_BOOTSTRAP_SESSIONS.validate(session, table, sid):
                return self.write_error_json(410, "session expired")
        else:
            # legacy single-shot: hold off data jobs only while snapshotting
            # this shard's metadata
            GLOBAL_BOOTSTRAP_TOKEN.acquire(table, sid)
            GLOBAL_BOOTSTRAP_TOKEN.release(table, sid)
        meta = ms.metastore
        ds = ms.diskstore
        cutoff = meta.get_archiving_cutoff(table, sid)
        batches = meta.get_archive_batches(table, sid, cutoff)
        rf, off = meta.get_backfill_progress(table, sid)
        srf, soff, sbid, sidx = meta.get_snapshot_progress(table, sid)
        self.write_json({
            "archivingCutoff": cutoff,
            "batches": {str(b): list(v) for b, v in batches.items()},
            "backfillProgress": [rf, off],
            "snapshotProgress": [srf, soff, sbid, sidx],
            "redologs": ds.list_logs(table, sid),
            "archiveColumns": {
                f"{b}_{v[0]}_{v[1]}": ds.list_archive_batch_columns(
                    table, sid, b, v[0], v[1])
                for b, v in batches.items()
            },
            "snapshotBatches": {
                str(b): ds.list_snapshot_batch_columns(
                    table, sid, srf, soff, b)
                for b in ds.list_snapshot_batches(table, sid, srf, soff)
            },
        })


class PeerArchiveFileHandler(_Base):
    def get(self, table, shard, batch, version, seq, col):
        data = self.ctx.memstore.diskstore.read_archive_column(
            table, int(shard), int(batch), int(version), int(seq), int(col))
        if data is None:
            return self.write_error_json(404, "no such archive column")
        self.set_header("Content-Type", "application/octet-stream")
        self.finish(data)


class PeerSnapshotFileHandler(_Base):
    def get(self, table, shard, rf, off, batch, col):
        data = self.ctx.memstore.diskstore.read_snapshot_column(
            table, int(shard), int(rf), int(off), int(batch), int(col))
        if data is None:
            return self.write_error_json(404, "no such snapshot column")
        self.set_header("Content-Type", "application/octet-stream")
        self.finish(data)


class PeerRedologHandler(_Base):
    def get(self, table, shard, creation_time):
        p = self.ctx.memstore.diskstore.redolog_path(
            table, int(shard), int(creation_time))
        if not os.path.exists(p):
            return self.write_error_json(404, "no such redolog")
        # ?offset=N serves only bytes past N — the client's post-copy delta
        # catch-up re-fetches the tail that grew from concurrent ingest
        # (reference: memstore/bootstrap.go:487 redolog replay after copy)
        offset = int(self.get_query_argument("offset", "0"))
        self.set_header("Content-Type", "application/octet-stream")
        with open(p, "rb") as f:
            f.seek(offset)
            self.finish(f.read())


ROUTES = (
    (r"/health", HealthHandler),
    (r"/health/(on|off)", HealthSwitchHandler),
    (r"/query/aql", AQLHandler),
    (r"/query/sql", SQLHandler),
    (r"/data/([^/]+)/(\d+)", DataHandler),
    (r"/schema/tables", TablesHandler),
    (r"/schema/tables/([^/]+)", TableHandler),
    (r"/schema/tables/([^/]+)/columns/([^/]+)/enum-cases", EnumHandler),
    (r"/schema/tables/([^/]+)/columns", ColumnsHandler),
    (r"/schema/tables/([^/]+)/columns/([^/]+)", ColumnHandler),
    (r"/dbg/shards", ShardsDebugHandler),
    (r"/dbg/jobs", JobsDebugHandler),
    (r"/dbg/jobs/([^/]+)", JobsDebugHandler),
    (r"/dbg/devices", DevicesDebugHandler),
    (r"/dbg/host-memory", HostMemoryDebugHandler),
    (r"/dbg/([^/]+)/(\d+)/(archiving|backfill|snapshot|purge)",
     JobTriggerHandler),
    (r"/dbg/([^/]+)/(\d+)/redologs/?(.*)", RedologBrowserHandler),
    (r"/dbg/([^/]+)/(\d+)/primary-keys", PrimaryKeyLookupHandler),
    (r"/dbg/([^/]+)/(\d+)/batches/(-?\d+)", BatchInspectHandler),
    (r"/dbg/([^/]+)/(\d+)/batches/(-?\d+)/vector-parties/([^/]+)",
     BatchInspectHandler),
    # reference path shape (api/debug_handler.go:96) + short alias
    (r"/dbg/([^/]+)/(\d+)/backfill-manager/upsertbatches/(\d+)",
     BackfillQueueHandler),
    (r"/dbg/([^/]+)/(\d+)/backfill-queue/(\d+)", BackfillQueueHandler),
    (r"/dbg/device-cache", DeviceCacheDebugHandler),
    (r"/dbg/bootstrap/retry", BootstrapRetryHandler),
    (r"/dbg/profiler/(start|stop)", ProfilerHandler),
    (r"/dbg/trace/(start|stop)", TraceHandler),
    (r"/dbg/?", DebugUIHandler),
    (r"/swagger.json", SwaggerHandler),
    (r"/dbg/([^/]+)/(\d+)", ShardDebugHandler),
    (r"/metrics", MetricsHandler),
    (r"/dbg/device", DeviceStatsHandler),
    (r"/peer/([^/]+)/(\d+)/session", PeerSessionHandler),
    (r"/peer/session/([0-9a-f]+)/keepalive", PeerSessionKeepaliveHandler),
    (r"/peer/session/([0-9a-f]+)", PeerSessionKeepaliveHandler),
    (r"/peer/([^/]+)/(\d+)/metadata", PeerMetadataHandler),
    (r"/peer/([^/]+)/(\d+)/archive/(-?\d+)/(\d+)/(\d+)/(\d+)",
     PeerArchiveFileHandler),
    (r"/peer/([^/]+)/(\d+)/snapshot/(\d+)/(\d+)/(-?\d+)/(\d+)",
     PeerSnapshotFileHandler),
    (r"/peer/([^/]+)/(\d+)/redolog/(\d+)", PeerRedologHandler),
)
_COMPILED = compile_routes(ROUTES)


class ApiServer(Service):
    """Embeddable server: used by cmd/aresd and by in-process tests.
    device: where queries run; `cuda` unless the caller asks for another."""

    def __init__(self, memstore, scheduler=None, port: int = 0,
                 timezone_table: str = "", query_config=None, device=None):
        super().__init__(ServerContext(memstore, scheduler, timezone_table,
                                       query_config=query_config,
                                       device=device), _COMPILED, port)

    def stop(self):
        self.shutdown()
        self.ctx.close()
