"""Broker query executor: scatter per-host sub-queries, merge partials.

Reference: broker/executor.go:48 QueryExecutor.Execute,
broker/query_plan_agg.go (MergeNode over BlockingScanNodes, retries ×3 with
health marking :149-167, AVG→SUM+COUNT split :241),
broker/query_plan_non_agg.go (streaming limit push), result merge lattice
(broker/result_merge.go:42), shard assignment
(broker/util/assignment.go:24).
"""

from __future__ import annotations

import copy
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from aresdb_tpu_torch.utils import http_client

from aresdb_tpu_torch.cluster.topology import (HealthTrackingTopology,
                                               TopologyView)
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import hll_wire as W

RETRIES = 3


class BrokerError(Exception):
    pass


def _first_block(framed: bytes) -> bytes:
    """First result payload of an HLLQueryResults response (skips the
    magic+padding and the per-result 8-byte header)."""
    import struct

    if len(framed) < 16:
        return b""
    size = struct.unpack_from("<I", framed, 8)[0]
    return framed[16:16 + size]


def calculate_shard_assignment(view: TopologyView) -> Dict[str, Tuple]:
    """shard→host choice, balancing shard counts across hosts.

    Reference: broker/util/assignment.go:24 CalculateShardAssignment — one
    Available replica per shard, least-loaded host first. A shard with no
    Available replica goes to a Leaving one: a replacement's source holds
    the shard whole and keeps serving it until the joiner has copied it
    and turned Available (DataNode.desired_shards), where the JAX
    package's broker answers "no available host" for the whole copy
    (ROADMAP section 3).
    """
    load: Dict[str, int] = {}
    hosts: Dict[str, Any] = {}
    assignment: Dict[str, List[int]] = {}
    for sid in view.shard_ids():
        candidates = view.available_hosts(sid) or \
            view.bootstrap_sources(sid)
        if not candidates:
            raise BrokerError(f"no available host for shard {sid}")
        best = min(candidates, key=lambda h: (load.get(h.name, 0), h.name))
        load[best.name] = load.get(best.name, 0) + 1
        hosts[best.name] = best
        assignment.setdefault(best.name, []).append(sid)
    return {name: (hosts[name], shards) for name, shards in assignment.items()}


def _agg_of(query: Dict[str, Any]) -> Optional[str]:
    measures = query.get("measures") or []
    if not measures:
        return None
    expr = measures[0].get("sqlExpression", "")
    try:
        ast = E.parse(expr)
    except E.ExprParseError:
        return None
    if isinstance(ast, E.NumberLiteral):
        return None  # non-agg
    if isinstance(ast, E.Call):
        name = ast.name
        if name == E.COUNT_DISTINCT_HLL:
            return "hll"
        if name in E.AGGREGATE_CALLS:
            return name
    return None


def _merge_leaf(agg: str, a, b):
    if a is None:
        return b
    if b is None:
        return a
    if agg in ("count", "sum"):
        return a + b
    if agg == "min":
        return min(a, b)
    if agg == "max":
        return max(a, b)
    raise BrokerError(f"cannot merge leaves for {agg}")


def merge_results(agg: str, results: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge nested dim→measure trees (reference result_merge.go lattice)."""
    out: Dict[str, Any] = {}

    def rec(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                rec(dst.setdefault(k, {}), v)
            else:
                dst[k] = _merge_leaf(agg, dst.get(k), v)

    for r in results:
        rec(out, r)
    return out


def merge_hll_results(scans: List[Tuple[Dict[str, Any],
                                        List[W.HLLDimensionSpec]]]
                      ) -> Tuple[Dict[str, Any], List[W.HLLDimensionSpec]]:
    """Merge parsed binary HLLData trees by register max (reference
    result_merge.go hllMergeFunc over HLL structs)."""
    merged: Dict[str, Any] = {}
    specs: List[W.HLLDimensionSpec] = []
    for tree, meta in scans:
        if meta:
            specs = meta
        W.merge_hll_trees(merged, tree)
    return merged, specs


class BrokerExecutor:
    """Scatter-gather executor over a health-tracked topology."""

    def __init__(self, topology, session=None, max_workers: int = 16):
        self.topology = (topology if isinstance(topology, HealthTrackingTopology)
                         else HealthTrackingTopology(topology))
        self.session = session or http_client.Session()
        self.pool = ThreadPoolExecutor(max_workers=max_workers)

    # -- datanode RPC --

    def _scan(self, host, shards: List[int], query: Dict[str, Any],
              ctx_out: Optional[list] = None,
              hll_binary: bool = False) -> Any:
        """One sub-query with retries + health marking (BlockingScanNode).

        hll_binary: request `application/hll` and return the parsed
        (tree, dim_specs) pair (reference dataNodeQueryClient.QueryRaw +
        ParseHLLQueryResults)."""
        from aresdb_tpu_torch.utils import metrics as M

        sub = copy.deepcopy(query)
        sub["shards"] = shards
        last_err = None
        headers = {"Accept": W.CONTENT_TYPE} if hll_binary else None
        for attempt in range(RETRIES):
            try:
                t0 = time.perf_counter()
                r = self.session.post(
                    f"http://{host.address}/query/aql",
                    json={"queries": [sub], "verbose": ctx_out is not None},
                    headers=headers, timeout=120)
                r.raise_for_status()
                M.root().record_timer(M.TIME_WAITED_FOR_DATA_NODE,
                                      time.perf_counter() - t0)
                if hll_binary:
                    results, errors = W.parse_hll_query_results(r.content)
                    if errors and errors[0]:
                        raise BrokerError(errors[0])
                    if not results:
                        raise BrokerError("empty hll response")
                    block_meta = W.parse_hll_block_meta(
                        _first_block(r.content))
                    self.topology.mark_healthy(host.name)
                    if ctx_out is not None:
                        ctx_out.append({"host": host.name, "shards": shards,
                                        "stats": None})
                    return results[0], block_meta
                body = r.json()
                errs = body.get("errors")
                if errs and errs[0]:
                    raise BrokerError(errs[0])
                self.topology.mark_healthy(host.name)
                if ctx_out is not None:
                    ctx_out.append({
                        "host": host.name, "shards": shards,
                        "stats": (body.get("context") or [None])[0]})
                return body["results"][0]
            except (http_client.RequestException, BrokerError,
                    ValueError) as e:
                last_err = e
                M.root().count(M.DATA_NODE_QUERY_FAILURES, 1)
                self.topology.mark_unhealthy(host.name)
        raise BrokerError(
            f"datanode {host.address} failed after {RETRIES} tries: {last_err}")

    def _scatter(self, query: Dict[str, Any],
                 ctx_out: Optional[list] = None,
                 hll_binary: bool = False) -> List[Any]:
        view = self.topology.get()
        try:
            if not view.shards:
                raise BrokerError("empty topology")
            assignment = calculate_shard_assignment(view)
        except BrokerError:
            # stale snapshot (nodes may have turned Available since the last
            # poll): force a refresh once before giving up
            inner = getattr(self.topology, "inner", self.topology)
            if hasattr(inner, "refresh"):
                inner.refresh()
            view = self.topology.get()
            if not view.shards:
                raise BrokerError("empty topology")
            assignment = calculate_shard_assignment(view)
        futures = [
            self.pool.submit(self._scan, host, shards, query, ctx_out,
                             hll_binary)
            for host, shards in assignment.values()
        ]
        return [f.result() for f in futures]

    # -- public --

    def execute(self, query: Dict[str, Any],
                ctx_out: Optional[list] = None) -> Dict[str, Any]:
        """Scatter-gather one query; ctx_out (when given) collects each
        datanode's verbose stage stats for broker-level verbose responses."""
        agg = _agg_of(query)

        if agg is None:
            return self._execute_non_agg(query, ctx_out)
        if agg == "avg":
            return self._execute_avg(query, ctx_out)
        if agg == "hll":
            merged, _ = merge_hll_results(
                self._scatter(query, ctx_out, hll_binary=True))
            return W.compute_hll_result(merged)
        return merge_results(agg, self._scatter(query, ctx_out))

    def execute_hll_binary(self, query: Dict[str, Any]) -> bytes:
        """Broker-level `application/hll`: merge datanode registers and
        re-serialize one HLLData block (reference broker result path via
        BuildVectorsFromHLLResult, query/common/hll.go:1007)."""
        agg = _agg_of(query)
        if agg != "hll":
            raise BrokerError("expect hll aggregate function when Accept "
                              "is application/hll")
        merged, specs = merge_hll_results(
            self._scatter(query, None, hll_binary=True))
        return W.serialize_from_tree(merged, specs)

    def _execute_avg(self, query: Dict[str, Any],
                     ctx_out: Optional[list] = None) -> Dict[str, Any]:
        """AVG = merged SUM / merged COUNT (query_plan_agg.go:241)."""
        m = query["measures"][0]
        ast = E.parse(m["sqlExpression"])
        arg = str(ast.args[0])
        sum_q = copy.deepcopy(query)
        sum_q["measures"][0]["sqlExpression"] = f"sum({arg})"
        cnt_q = copy.deepcopy(query)
        cnt_q["measures"][0]["sqlExpression"] = "count(*)"
        # the count must only include rows where the arg is non-null to
        # match single-node avg semantics
        cnt_q["measures"][0].setdefault("rowFilters", []).append(
            f"{arg} IS NOT NULL")
        sums = merge_results("sum", self._scatter(sum_q, ctx_out))
        cnts = merge_results("count", self._scatter(cnt_q, ctx_out))

        def divide(s_node, c_node):
            out = {}
            for k, v in s_node.items():
                c = c_node.get(k)
                if isinstance(v, dict):
                    out[k] = divide(v, c or {})
                else:
                    out[k] = (float(np.float32(v / c))
                              if c else None)
            return out

        return divide(sums, cnts)

    def _execute_non_agg(self, query: Dict[str, Any],
                         ctx_out: Optional[list] = None) -> Dict[str, Any]:
        limit = query.get("limit", 0) or 1000
        results = self._scatter(query, ctx_out)
        headers = None
        matrix: List[List[Any]] = []
        for r in results:
            if headers is None:
                headers = r.get("headers", [])
            matrix.extend(r.get("matrixData", []))
            if len(matrix) >= limit:
                matrix = matrix[:limit]
                break
        return {"headers": headers or [], "matrixData": matrix}
