"""Composite (multi-measure) query decomposition and recombination.

The reference's SQL grammar parses composite measures — `WITH m1
(Requested) AS (...), m2 (Completed) AS (...) SELECT Completed,
Requested, Completed/Requested FROM m1 NATURAL LEFT JOIN m2` — into a
multi-measure AQLQuery (sql_parser_test.go "parse composite measures"),
but its engine then refuses to run them ("sub query not supported yet",
query/sql/sql_parser.go:2018, and the single-measure rule in
aql_compiler.go). Here they EXECUTE: the query splits into one
single-measure query per aggregate (each carrying its own measure-level
rowFilters), the results join on the shared dimension tree, and derived
expressions over the measure aliases evaluate host-side per group.

Result shape: the usual nested dim tree, with each leaf a dict keyed by
measure alias (base aggregates and derived expressions).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from aresdb_tpu_torch.query import expr as E


class CompositeError(Exception):
    pass


def is_composite(qd: Dict[str, Any]) -> bool:
    return (len(qd.get("measures") or []) > 1
            or bool(qd.get("supportingMeasures")))


def _alias_of(m: Dict[str, Any], idx: int) -> str:
    return m.get("alias") or m.get("sqlExpression") or f"m{idx}"


def split_query(qd: Dict[str, Any]):
    """Multi-measure query dict → (base_queries, base_aliases, derived).

    base_queries: one copy of qd per aggregate measure (single-measure).
    derived: [(alias, expr_ast)] evaluated over the base aliases.
    """
    measures = qd.get("measures") or []
    # supporting measures (reference AQLQuery.SupportingMeasures): bases
    # that are referenced by derived expressions but are NOT output
    # columns themselves — e.g. `SELECT Completed/Requested FROM ...`
    supporting = qd.get("supportingMeasures") or []
    bases: List[Dict[str, Any]] = []
    base_aliases: List[str] = []
    visible: List[bool] = []
    derived: List[Tuple[str, E.Expr]] = []
    for i, (m, vis) in enumerate([(m, True) for m in measures]
                                 + [(m, False) for m in supporting]):
        expr_s = m.get("sqlExpression", "")
        try:
            ast = E.parse(expr_s)
        except E.ExprParseError as e:
            raise CompositeError(f"cannot parse measure {expr_s!r}: {e}")
        if isinstance(ast, E.Call) and ast.name in E.AGGREGATE_CALLS:
            base = dict(qd)
            base["measures"] = [m]
            base.pop("supportingMeasures", None)
            bases.append(base)
            base_aliases.append(_alias_of(m, i))
            visible.append(vis)
        elif vis:
            _check_derived(ast, expr_s)
            derived.append((_alias_of(m, i), ast))
        else:
            raise CompositeError(
                f"supporting measure must be an aggregate, got {expr_s!r}")
    if not bases:
        raise CompositeError("composite query needs at least one "
                             "aggregate measure")
    names = set(base_aliases)
    for alias, ast in derived:
        for ref in _var_refs(ast):
            if ref not in names:
                raise CompositeError(
                    f"derived measure {alias!r} references {ref!r}, which "
                    f"is not an aggregate measure alias")
    return bases, base_aliases, derived, visible


def _check_derived(ast: E.Expr, expr_s: str) -> None:
    if isinstance(ast, (E.VarRef, E.NumberLiteral)):
        return
    if isinstance(ast, E.UnaryExpr):
        return _check_derived(ast.expr, expr_s)
    if isinstance(ast, E.BinaryExpr) and ast.op in ("+", "-", "*", "/"):
        _check_derived(ast.lhs, expr_s)
        _check_derived(ast.rhs, expr_s)
        return
    raise CompositeError(
        f"expect aggregate function or arithmetic over measure aliases, "
        f"got {expr_s!r}")


def _var_refs(ast: E.Expr) -> List[str]:
    if isinstance(ast, E.VarRef):
        return [ast.val]
    if isinstance(ast, E.UnaryExpr):
        return _var_refs(ast.expr)
    if isinstance(ast, E.BinaryExpr):
        return _var_refs(ast.lhs) + _var_refs(ast.rhs)
    return []


def _eval(ast: E.Expr, env: Dict[str, Any]):
    """NULL-propagating scalar arithmetic (measure lattice semantics)."""
    if isinstance(ast, E.NumberLiteral):
        return ast.val
    if isinstance(ast, E.VarRef):
        return env.get(ast.val)
    if isinstance(ast, E.UnaryExpr) and ast.op == "-":
        v = _eval(ast.expr, env)
        return None if v is None else -v
    if isinstance(ast, E.BinaryExpr):
        a = _eval(ast.lhs, env)
        b = _eval(ast.rhs, env)
        if a is None or b is None:
            return None
        if ast.op == "+":
            return a + b
        if ast.op == "-":
            return a - b
        if ast.op == "*":
            return a * b
        if ast.op == "/":
            return None if b == 0 else a / b
    raise CompositeError(f"cannot evaluate derived expression node {ast!r}")


def combine(qd: Dict[str, Any], base_aliases: List[str],
            derived: List[Tuple[str, E.Expr]],
            results: List[Dict[str, Any]],
            visible: List[bool] = None) -> Dict[str, Any]:
    """Join per-measure dim trees on dim values + evaluate derived."""
    depth = len(qd.get("dimensions") or [])
    if visible is None:
        visible = [True] * len(base_aliases)

    def rec(nodes: List[Any], level: int):
        if level == depth:
            env = {a: nodes[i] for i, a in enumerate(base_aliases)}
            leaf = {a: env[a] for a, vis in zip(base_aliases, visible)
                    if vis}
            for alias, ast in derived:
                leaf[alias] = _eval(ast, env)
            if len(leaf) == 1:
                # single output column → plain scalar leaf (the usual
                # agg result shape)
                return next(iter(leaf.values()))
            return leaf
        out: Dict[str, Any] = {}
        keys: List[str] = []
        seen = set()
        for n in nodes:
            for k in (n or {}):
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        for k in keys:
            out[k] = rec([(n or {}).get(k) for n in nodes], level + 1)
        return out

    return rec(list(results), 0)


def execute_composite(qd: Dict[str, Any],
                      run_one: Callable[[Dict[str, Any]], Dict[str, Any]]
                      ) -> Dict[str, Any]:
    bases, base_aliases, derived, visible = split_query(qd)
    results = [run_one(b) for b in bases]
    return combine(qd, base_aliases, derived, results, visible)
