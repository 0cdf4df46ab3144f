"""Query service: AQL request → compile → execute → postprocess.

Port of `aresdb_tpu/query/service.py` for the group-by paths, dense and
keyed (sort). The store is anything that offers `get_schemas()` and
`get_table_shard(name, shard_id)`, as `ShardExecutor` uses it.

What the port does not run yet is answered with a "not ported yet" error
in the response, never with a wrong result: multi-measure composite
queries, SQL, non-aggregate queries, HLL, joins, geo, array columns,
archive batches and admission (executor.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from aresdb_tpu_torch.query.aql import AQLQuery
from aresdb_tpu_torch.query.compiler import Compiler, QueryError
from aresdb_tpu_torch.query.executor import ShardExecutor, not_ported
from aresdb_tpu_torch.query.postprocess import build_agg_result
from aresdb_tpu_torch.utils.torch_env import resolve_device


class QueryService:
    def __init__(self, memstore, device=None):
        """device: where the query kernels run; `cuda` unless the caller
        passes another (`"cpu"` runs every kernel's plain version)."""
        self.memstore = memstore
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
                    raise not_ported("multi-measure composite queries are")
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

    def handle_sql(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """SQL is not ported yet: every statement answers with that error."""
        n = len(request.get("queries", []))
        err = str(not_ported("SQL queries are"))
        return {"results": [{}] * n, "errors": [err] * n}

    def _run(self, q: AQLQuery, data_only: bool = False):
        compiler = Compiler(self.memstore.get_schemas())
        t0 = time.perf_counter()
        plan = compiler.compile(q)
        plan.data_only = data_only
        compile_s = time.perf_counter() - t0
        table, _ = self.executor.execute(plan)
        plan.stats["compile"] = compile_s
        t0 = time.perf_counter()
        result = build_agg_result(plan, table)
        plan.stats["postprocess"] = time.perf_counter() - t0
        return result, plan
