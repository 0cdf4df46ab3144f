"""Broker-side fail-fast query validation + schema view.

Reference: the broker compiles each query against its controller-synced
schema view BEFORE scattering (broker/query_compiler.go:117 Compile —
table lookup, single-measure rule, measure parse + aggregate checks,
application/hll function check), so malformed queries are rejected with
one local error instead of fanning out to every datanode. This module is
the equivalent gate for our scatter-gather broker; datanodes still run
the full Compiler, so this is strictly a fast-fail front.

Deliberate capability deltas (documented, not bugs):
- `x IN (...)` ships as-is — our kernel emitter evaluates IN natively
  (kernels.py _emit_binary) instead of the reference's OR-chain rewrite
  (expandINOp, broker/common/context/query_context_helper.go), with the
  same semantics (compiler-matrix covered).
- int64 binary transforms are ALLOWED: the reference rejects them because
  its CUDA transform lanes are 32-bit ("binary transformation not allowed
  for int64 fields"); our TPU kernels carry int64 lanes natively.

Schema view: BrokerSchemaView polls the controller's /schema/{ns}/tables
with the same hash short-circuit the datanode schema-fetch job uses
(reference: broker gets schema via the SchemaFetchJob's musterer,
cmd/broker/cmd/cmd.go).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from aresdb_tpu_torch.query import expr as E


class BrokerValidationError(Exception):
    pass


# measure calls taking exactly one argument (reference processMeasures
# arity check, broker/query_compiler.go:246 test "expect 1 argument")
_ONE_ARG_CALLS = {E.SUM, E.AVG, E.MIN, E.MAX, E.COUNT_DISTINCT_HLL, E.HLL}


def validate_query(q: Dict[str, Any],
                   tables: Optional[Dict[str, Any]] = None,
                   hll_binary: bool = False) -> None:
    """Raise BrokerValidationError for queries the reference broker
    rejects at compile time. `tables` is name->schema (None = skip
    table-existence checks when no schema view is configured)."""
    table = q.get("table")
    if not table:
        raise BrokerValidationError("no table specified")
    if tables is not None:
        if table not in tables:
            raise BrokerValidationError(f"unknown table {table!r}")
        for join in q.get("joins") or []:
            jt = join.get("table")
            if jt not in tables:
                raise BrokerValidationError(f"unknown table {jt!r}")

    measures = q.get("measures") or []
    if len(measures) != 1:
        raise BrokerValidationError("exactly 1 measure is required")
    expr_s = measures[0].get("sqlExpression", "")
    try:
        ast = E.parse(expr_s)
    except E.ExprParseError as e:
        raise BrokerValidationError(
            f"Failed to parse measure: {expr_s!r}: {e}") from e

    is_non_agg = isinstance(ast, E.NumberLiteral)
    if not is_non_agg:
        if not (isinstance(ast, E.Call) and ast.name in E.AGGREGATE_CALLS):
            raise BrokerValidationError(
                f"expect aggregate function, got {expr_s!r}")
        if ast.name in _ONE_ARG_CALLS and len(ast.args) != 1:
            raise BrokerValidationError(
                f"expect 1 argument for {ast.name}, got {expr_s!r}")
    if hll_binary:
        if is_non_agg or ast.name not in (E.COUNT_DISTINCT_HLL, E.HLL):
            raise BrokerValidationError(
                f"expect hll aggregate function, got {expr_s!r}")


class BrokerSchemaView:
    """Controller-synced name->schema map with hash short-circuit."""

    def __init__(self, controller_addr: str, namespace: str,
                 session=None, poll_seconds: float = 5.0):
        from aresdb_tpu_torch.utils import http_client

        self.addr = controller_addr
        self.namespace = namespace
        self.session = session or http_client.Session()
        self.poll_seconds = poll_seconds
        self._tables: Dict[str, Any] = {}
        self._hash = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tables(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._tables)

    def refresh(self) -> bool:
        try:
            h = self.session.get(
                f"http://{self.addr}/schema/{self.namespace}/hash",
                timeout=5).text.strip()
            if h and h == self._hash:
                return True
            r = self.session.get(
                f"http://{self.addr}/schema/{self.namespace}/tables",
                timeout=10)
            r.raise_for_status()
            tables = {t["name"]: t for t in r.json()}
            with self._lock:
                self._tables = tables
                self._hash = h
            return True
        except Exception:
            return False

    def start(self):
        self.refresh()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="broker-schema")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.poll_seconds):
            self.refresh()
