"""Broker HTTP service: /query/aql and /query/sql fan-out endpoints.

Reference: broker/handler.go:36 + cmd/broker/cmd/cmd.go:43.

Port of `aresdb_tpu/broker/server.py` on `http.server`
(api/httpbase.py), with its status codes and JSON bodies. Each request is
served on a thread of its own and runs its queries on a pool of
FRONT_WORKERS threads, as the JAX package's handlers await that pool on
their IOLoop; the executor scatters each query over its own pool.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from aresdb_tpu_torch.api.httpbase import (HTTPError, Handler, Service,
                                           compile_routes)
from aresdb_tpu_torch.broker.executor import BrokerError, BrokerExecutor
from aresdb_tpu_torch.broker.validator import (BrokerValidationError,
                                               validate_query)
from aresdb_tpu_torch.query import composite as C
from aresdb_tpu_torch.query import hll_wire as W
from aresdb_tpu_torch.query.composite import CompositeError
from aresdb_tpu_torch.query.sql import SQLParseError, parse_sql
from aresdb_tpu_torch.utils import metrics as M

FRONT_WORKERS = 16


class BrokerContext:
    def __init__(self, executor: BrokerExecutor, pool, schema_view=None):
        self.executor = executor
        self.pool = pool
        self.schema_view = schema_view
        self.lock = threading.Lock()
        self.metrics = None


class _Base(Handler):
    def validate(self, q, hll_binary: bool = False) -> None:
        """Fail-fast compile gate (reference broker/query_compiler.go:117
        Compile) — rejects locally instead of scattering."""
        view = self.ctx.schema_view
        tables = view.tables() if view else None
        validate_query(q, tables, hll_binary=hll_binary)

    def on_pool(self, fn, *args):
        """fn(*args) on the front pool, waited for."""
        return self.ctx.pool.submit(fn, *args).result()

    def execute_one(self, q, ctx=None):
        """Validate + execute one query dict; composite (multi-measure)
        queries scatter once per aggregate measure and recombine
        (query/composite.py)."""
        execute = self.ctx.executor.execute
        if C.is_composite(q):
            bases, aliases, derived, visible = C.split_query(q)
            for b in bases:
                self.validate(b)
            results = [self.on_pool(execute, b, ctx) for b in bases]
            return C.combine(q, aliases, derived, results, visible)
        self.validate(q)
        return self.on_pool(execute, q, ctx)

    def body(self):
        try:
            return json.loads(self.request.body or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, str(e))

    def run_queries(self, queries, verbose: bool = False):
        results, errors, had_error = [], [], False
        contexts = []
        for q in queries:
            M.root().count(M.AQL_QUERY_RECEIVED_BROKER, 1)
            ctx = [] if verbose else None
            t0 = time.perf_counter()
            try:
                results.append(self.execute_one(q, ctx))
                errors.append(None)
                M.root().count(M.QUERY_SUCCEEDED_BROKER, 1)
            except (BrokerError, BrokerValidationError, CompositeError,
                    ValueError, KeyError) as e:
                results.append({})
                errors.append(str(e))
                had_error = True
                M.root().count(M.QUERY_FAILED_BROKER, 1)
            M.root().record_timer(M.QUERY_LATENCY_BROKER,
                                  time.perf_counter() - t0)
            contexts.append(ctx)
        resp = {"results": results}
        if had_error:
            resp["errors"] = errors
        if verbose:
            resp["context"] = contexts
        return resp


class BrokerAQLHandler(_Base):
    def post(self):
        body = self.body()
        if "application/hll" in self.request.headers.get("Accept", ""):
            # binary register pass-through (reference broker handles
            # application/hll end-to-end; broker/query_compiler.go:305)
            out = W.HLLQueryResults()
            for q in body.get("queries", []):
                try:
                    self.validate(q, hll_binary=True)
                    out.write_result(self.on_pool(
                        self.ctx.executor.execute_hll_binary, q))
                except (BrokerError, BrokerValidationError,
                        ValueError, KeyError) as e:
                    out.write_error(str(e))
            self.set_header("Content-Type", W.CONTENT_TYPE)
            return self.finish(out.get_bytes())
        self.write_json(self.run_queries(
            body.get("queries", []),
            verbose=bool(body.get("verbose") or body.get("debug"))))


class BrokerSQLHandler(_Base):
    def post(self):
        queries = []
        errors = []
        for stmt in self.body().get("queries", []):
            try:
                M.root().count(M.SQL_QUERY_RECEIVED_BROKER, 1)
                t0 = time.perf_counter()
                q = parse_sql(stmt)
                M.root().record_timer(M.SQL_PARSING_LATENCY_BROKER,
                                      time.perf_counter() - t0)
                # round-trip via the json form the executor consumes
                queries.append(q.to_json())
                errors.append(None)
            except SQLParseError as e:
                queries.append(None)
                errors.append(str(e))
        results = []
        final_errors = []
        had_error = False
        for q, err in zip(queries, errors):
            if err is not None:
                results.append({})
                final_errors.append(err)
                had_error = True
                continue
            try:
                results.append(self.execute_one(q))
                final_errors.append(None)
            except (BrokerError, BrokerValidationError, CompositeError,
                    ValueError, KeyError) as e:
                results.append({})
                final_errors.append(str(e))
                had_error = True
        resp = {"results": results}
        if had_error:
            resp["errors"] = final_errors
        self.write_json(resp)


class HealthHandler(Handler):
    def get(self):
        self.finish("OK")


ROUTES = (
    (r"/query/aql", BrokerAQLHandler),
    (r"/query/sql", BrokerSQLHandler),
    (r"/health", HealthHandler),
)
_COMPILED = compile_routes(ROUTES)


class BrokerServer(Service):
    """The broker over `topology` (polled by its owner, who starts and
    stops it, as it does `schema_view`)."""

    def __init__(self, topology, port: int = 0, schema_view=None):
        self.executor = BrokerExecutor(topology)
        self.pool = ThreadPoolExecutor(max_workers=FRONT_WORKERS,
                                       thread_name_prefix="ares-broker")
        self.schema_view = schema_view
        super().__init__(BrokerContext(self.executor, self.pool, schema_view),
                         _COMPILED, port, name="ares-broker")

    def stop(self):
        self.shutdown()
        self.pool.shutdown(wait=True)
        self.executor.pool.shutdown(wait=True)
