"""Query service: AQL request → compile → execute → postprocess.

Port of `aresdb_tpu/query/service.py`: group-by queries (dense and keyed)
over live and archive batches, HLL distinct counts (also as the binary
`application/hll` frame), non-aggregate listings, joins to dimension
tables, the timezone table included, geo intersection joins, array
columns, SQL statements (`handle_sql`) and multi-measure composite
queries (`_run_composite`). The store is anything that offers
`get_schemas()` and `get_table_shard(name, shard_id)`, as `ShardExecutor`
uses it: a `MemStore` recovered from its redo log
(`memstore/memstore.py`), or a plain table-shard holder. A query may
pass an admission gate on device memory (`admission.DeviceMemoryManager`)
and carry a deadline that the executor checks before each batch.

With a device pool (`admission.DevicePool`) each admitted query instead
takes a lease on one of the pool's devices and runs there, on an
executor of that device's own, so that N queries run on N devices at
once; the executors share the kernel cache, the column cache and the
capacity hints. Under ARES_MESH=1 one query's batches instead spread
over the executor's mesh devices (`mesh_devices`;
`ShardExecutor._run_mesh_batch`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

from aresdb_tpu_torch.query import composite as C
from aresdb_tpu_torch.query import hll_wire as W
from aresdb_tpu_torch.query.admission import (AdmissionError,
                                              estimate_query_memory)
from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import Compiler, QueryError
from aresdb_tpu_torch.query.executor import ShardExecutor
from aresdb_tpu_torch.query.postprocess import (build_agg_result,
                                                build_non_agg_result)
from aresdb_tpu_torch.query.sql import SQLParseError, parse_sql
from aresdb_tpu_torch.utils import tracing
from aresdb_tpu_torch.utils.torch_env import resolve_device


class QueryService:
    def __init__(self, memstore, device=None, timezone_table: str = "",
                 device_manager=None, admission_timeout: float = -1,
                 query_timeout: float = 0, device_pool=None,
                 mesh_devices=None):
        """device: where the query kernels run; `cuda` unless the caller
        passes another (`"cpu"` runs every kernel's plain version).
        timezone_table: the table that `timezone(join_key)` queries join
        for each row's timezone (reference query.timezone_table).
        device_manager: optional DeviceMemoryManager admission gate
        (query/device_manager.go FindDeviceForQuery). admission_timeout:
        seconds to wait for device memory (device_choosing_timeout).
        query_timeout: per-query execution deadline in seconds (0 = off).
        device_pool: optional admission.DevicePool — each admitted query
        pins to one of its devices (the reference DeviceManager's
        placement model); takes precedence over device_manager.
        mesh_devices: the devices of a mesh batch under ARES_MESH=1
        (ShardExecutor's; by default every device of `device`'s type)."""
        self.memstore = memstore
        self.timezone_table = timezone_table
        self.device = resolve_device(device)
        self.executor = ShardExecutor(memstore, self.device,
                                      mesh_devices=mesh_devices)
        self.device_manager = device_manager
        self.device_pool = device_pool
        # one executor a pool entry, sharing the capacity hints
        self.pool_executors = [] if device_pool is None else [
            ShardExecutor(memstore, resolve_device(d),
                          k_hints=self.executor._k_hints,
                          mesh_devices=mesh_devices)
            for d in device_pool.devices]
        self.admission_timeout = admission_timeout
        self.query_timeout = query_timeout

    def handle_aql(self, request: Dict[str, Any], data_only: bool = False,
                   device: int = -1,
                   admission_timeout: Optional[float] = None
                   ) -> Dict[str, Any]:
        """Process an AQLRequest JSON dict; returns an AQLResponse-shaped
        dict. data_only, or a true `dataonly` in the request, keeps enum
        dimensions as untranslated ranks (reference `?dataonly=1`).
        device: preferred device index (`?device=`, -1 = auto) — honored
        when that device's budget in the pool fits, else most-free-first
        (device_manager.go:193); without a pool it is ignored.
        admission_timeout: per-request seconds to wait for device memory
        (`?timeout=`)."""
        results: List[Dict[str, Any]] = []
        errors: List[Any] = []
        contexts: List[Any] = []
        had_error = False
        verbose = bool(request.get("verbose") or request.get("debug"))
        data_only = data_only or bool(request.get("dataonly"))
        for qd in request.get("queries", []):
            try:
                q = AQLQuery.from_json(qd)
                if len(q.measures) > 1 or q.supporting_measures:
                    results.append(self._run_composite(q))
                    errors.append(None)
                    contexts.append(None)
                    continue
                result, plan = self._run(q, data_only=data_only,
                                         device=device,
                                         admission_timeout=admission_timeout)
                results.append(result)
                errors.append(None)
                contexts.append(plan.stats)
            except (QueryError, AdmissionError, KeyError, ValueError) as e:
                results.append({})
                errors.append(str(e))
                contexts.append(None)
                had_error = True
        resp: Dict[str, Any] = {"results": results}
        if had_error:
            resp["errors"] = errors
        if verbose:
            resp["context"] = contexts
        return resp

    def handle_aql_hll(self, request: Dict[str, Any]) -> bytes:
        """Process an AQLRequest with `Accept: application/hll`: the binary
        HLLQueryResults frame (api/query_handler.go:382
        HLLQueryResponseWriter); every query must be an HLL query
        (broker/query_compiler.go:305)."""
        out = W.HLLQueryResults()
        for qd in request.get("queries", []):
            try:
                q = AQLQuery.from_json(qd)
                plan = Compiler(self.memstore.get_schemas(),
                                timezone_table=self.timezone_table).compile(q)
                if plan.is_non_agg or plan.measure.agg != "hll":
                    raise QueryError(
                        "expect hll aggregate function when Accept is "
                        "application/hll")
                # binary responses need the register rows; JSON queries
                # fetch only per-group estimator sums
                plan.hll_registers = True
                table, _ = self._execute(plan)
                out.write_result(W.serialize_result_table(plan, table))
            except (QueryError, AdmissionError, KeyError, ValueError) as e:
                out.write_error(str(e))
        return out.get_bytes()

    def handle_sql(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Process {"queries": ["SELECT ..."]} (reference /query/sql);
        verbose/debug return per-stage stats as the AQL form does."""
        results: List[Dict[str, Any]] = []
        errors: List[Any] = []
        contexts: List[Any] = []
        had_error = False
        verbose = bool(request.get("verbose") or request.get("debug"))
        for stmt in request.get("queries", []):
            try:
                q = parse_sql(stmt)
                if len(q.measures) > 1 or q.supporting_measures:
                    results.append(self._run_composite(q))
                    contexts.append(None)
                else:
                    result, plan = self._run(q)
                    results.append(result)
                    contexts.append(plan.stats)
                errors.append(None)
            except (QueryError, AdmissionError, SQLParseError, KeyError,
                    ValueError) as e:
                results.append({})
                errors.append(str(e))
                contexts.append(None)
                had_error = True
        resp: Dict[str, Any] = {"results": results}
        if had_error:
            resp["errors"] = errors
        if verbose:
            resp["context"] = contexts
        return resp

    def handle_query(self, q: AQLQuery) -> Dict[str, Any]:
        if len(q.measures) > 1 or q.supporting_measures:
            return self._run_composite(q)
        return self._run(q)[0]

    def _run_composite(self, q: AQLQuery) -> Dict[str, Any]:
        """A multi-measure query: one engine run per aggregate measure,
        the results joined by group and the derived expressions evaluated
        on the host (composite.py). The reference parses these from SQL
        but refuses to run them (query/sql/sql_parser.go:2018)."""
        try:
            return C.execute_composite(
                q.to_json(),
                lambda b: self._run(AQLQuery.from_json(b))[0])
        except C.CompositeError as e:
            raise QueryError(str(e)) from e

    def _admit(self, plan, device: int = -1,
               timeout: Optional[float] = None):
        """Stamp the query deadline, and reserve device memory for the
        plan's estimated footprint for the duration of execution
        (FindDeviceForQuery + deferred release): a DeviceLease from the
        pool (entered, it yields itself), else the device manager's
        reservation (yields None); a no-op without either."""
        if self.query_timeout > 0:
            plan.deadline = time.time() + self.query_timeout
        if self.device_pool is None and self.device_manager is None:
            return contextlib.nullcontext()
        with tracing.span("admission"):
            reserved = estimate_query_memory(plan, self.memstore)
            plan.memory_required = reserved
            if timeout is None or timeout <= 0:
                timeout = self.admission_timeout
            if self.device_pool is not None:
                return self.device_pool.acquire(
                    reserved, timeout=timeout,
                    preferred=device if device >= 0 else None)
            self.device_manager.reserve(reserved, timeout=timeout)

        @contextlib.contextmanager
        def _held():
            try:
                yield
            finally:
                self.device_manager.release(reserved)
        return _held()

    def _execute(self, plan, device: int = -1,
                 timeout: Optional[float] = None):
        """Admit the plan and run it on the executor of its lease's device
        (the service's own without a pool); a leased query's verbose
        context names its pool index under "device"."""
        with self._admit(plan, device=device, timeout=timeout) as lease:
            executor = self.executor if lease is None \
                else self.pool_executors[lease.index]
            out = executor.execute(plan)
        if lease is not None:
            plan.stats["device"] = lease.index
        return out

    def _run(self, q: AQLQuery, data_only: bool = False, device: int = -1,
             admission_timeout: Optional[float] = None):
        compiler = Compiler(self.memstore.get_schemas(),
                            timezone_table=self.timezone_table)
        compiled = {}   # the executor starts plan.stats afresh
        with tracing.stage(compiled, "compile"):
            plan = compiler.compile(q)
            plan.data_only = data_only
        table, rows = self._execute(plan, device=device,
                                    timeout=admission_timeout)
        plan.stats["compile"] = compiled["compile"]
        if getattr(plan, "memory_required", None) is not None:
            plan.stats["memoryRequired"] = plan.memory_required
        with tracing.stage(plan.stats, "postprocess"):
            if plan.is_non_agg:
                result = build_non_agg_result(plan, rows)
            else:
                result = build_agg_result(plan, table)
        return result, plan
