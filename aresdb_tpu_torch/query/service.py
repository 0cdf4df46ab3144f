"""Query service: AQL request → compile → execute → postprocess.

Port of `aresdb_tpu/query/service.py`: group-by queries (dense and keyed)
over live and archive batches, HLL distinct counts (also as the binary
`application/hll` frame), non-aggregate listings, joins to dimension
tables, the timezone table included, geo intersection joins, array
columns, SQL statements (`handle_sql`) and multi-measure composite
queries (`_run_composite`). The store is anything that offers
`get_schemas()` and `get_table_shard(name, shard_id)`, as `ShardExecutor`
uses it: a `MemStore` recovered from its redo log
(`memstore/memstore.py`), or a plain table-shard holder.

Not ported yet: the JAX package's mesh batches (the port runs every
batch on its one device), admission and the query deadline.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from aresdb_tpu_torch.query import composite as C
from aresdb_tpu_torch.query import hll_wire as W
from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import Compiler, QueryError
from aresdb_tpu_torch.query.executor import ShardExecutor
from aresdb_tpu_torch.query.postprocess import (build_agg_result,
                                                build_non_agg_result)
from aresdb_tpu_torch.query.sql import SQLParseError, parse_sql
from aresdb_tpu_torch.utils.torch_env import resolve_device


class QueryService:
    def __init__(self, memstore, device=None, timezone_table: str = ""):
        """device: where the query kernels run; `cuda` unless the caller
        passes another (`"cpu"` runs every kernel's plain version).
        timezone_table: the table that `timezone(join_key)` queries join
        for each row's timezone (reference query.timezone_table)."""
        self.memstore = memstore
        self.timezone_table = timezone_table
        self.device = resolve_device(device)
        self.executor = ShardExecutor(memstore, self.device)

    def handle_aql(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Process an AQLRequest JSON dict; returns an AQLResponse-shaped
        dict. A true `dataonly` keeps enum dimensions as untranslated ranks
        (reference `?dataonly=1`)."""
        results: List[Dict[str, Any]] = []
        errors: List[Any] = []
        contexts: List[Any] = []
        had_error = False
        verbose = bool(request.get("verbose") or request.get("debug"))
        data_only = bool(request.get("dataonly"))
        for qd in request.get("queries", []):
            try:
                q = AQLQuery.from_json(qd)
                if len(q.measures) > 1 or q.supporting_measures:
                    results.append(self._run_composite(q))
                    errors.append(None)
                    contexts.append(None)
                    continue
                result, plan = self._run(q, data_only=data_only)
                results.append(result)
                errors.append(None)
                contexts.append(plan.stats)
            except (QueryError, KeyError, ValueError) as e:
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
                table, _ = self.executor.execute(plan)
                out.write_result(W.serialize_result_table(plan, table))
            except (QueryError, KeyError, ValueError) as e:
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
            except (QueryError, SQLParseError, KeyError, ValueError) as e:
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

    def _run(self, q: AQLQuery, data_only: bool = False):
        compiler = Compiler(self.memstore.get_schemas(),
                            timezone_table=self.timezone_table)
        t0 = time.perf_counter()
        plan = compiler.compile(q)
        plan.data_only = data_only
        compile_s = time.perf_counter() - t0
        table, rows = self.executor.execute(plan)
        plan.stats["compile"] = compile_s
        t0 = time.perf_counter()
        if plan.is_non_agg:
            result = build_non_agg_result(plan, rows)
        else:
            result = build_agg_result(plan, table)
        plan.stats["postprocess"] = time.perf_counter() - t0
        return result, plan
