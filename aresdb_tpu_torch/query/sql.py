"""SQL frontend: SQL text → AQLQuery.

Reference: query/sql/ (ANTLR-generated parser + ASTBuilder visitor,
sql_parser.go) and query/sql/util/udfRegister.go (the aql_* udf registry:
aql_time_filter, aql_now, aql_time_bucket_*, aql_numeric_bucket_*).

This is a hand-rolled clause parser rather than a generated one: the SQL
subset AresDB accepts maps 1:1 onto AQLQuery, and expression text passes
through verbatim (the AQL compiler re-parses it), so only the clause
structure and the aql_* udfs need handling here.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from aresdb_tpu_torch.query.aql import AQLQuery

# aql_time_bucket_X → bucketizer string (reference udfRegister.go:62-79)
TIME_BUCKET_UDFS = {
    "aql_time_bucket_minute": "minute",
    "aql_time_bucket_minutes": "minutes",
    "aql_time_bucket_hour": "hour",
    "aql_time_bucket_hours": "hours",
    "aql_time_bucket_day": "day",
    "aql_time_bucket_week": "week",
    "aql_time_bucket_month": "month",
    "aql_time_bucket_quarter": "quarter",
    "aql_time_bucket_year": "year",
    "aql_time_bucket_time_of_day": "time of day",
    "aql_time_bucket_minutes_of_day": "minutes of day",
    "aql_time_bucket_hour_of_day": "hour of day",
    "aql_time_bucket_hour_of_week": "hour of week",
    "aql_time_bucket_day_of_week": "day of week",
    "aql_time_bucket_day_of_month": "day of month",
    "aql_time_bucket_day_of_year": "day of year",
    "aql_time_bucket_month_of_year": "month of year",
    "aql_time_bucket_quarter_of_year": "quarter of year",
}

NUMERIC_BUCKET_UDFS = {
    "aql_numeric_bucket_bucket_width": "bucketWidth",
    "aql_numeric_bucket_logbase": "logBase",
    "aql_numeric_bucket_mannual_partitions": "manualPartitions",
}

AGG_FUNCS = ("count", "sum", "avg", "min", "max", "hll", "countdistincthll")

_CLAUSES = ("select", "from", "where", "group by", "order by", "limit",
            "having")


def _pos(full: str, off: int) -> Tuple[int, int]:
    """Absolute char offset -> (1-based line, 0-based col), the reference's
    ANTLR position convention (sql/errorHandler go formats)."""
    off = max(0, min(off, len(full)))
    line = full.count("\n", 0, off) + 1
    col = off - (full.rfind("\n", 0, off) + 1)
    return line, col


class SQLParseError(ValueError):
    """Parse error carrying the reference's (line, col) anchor when the
    offending construct's offset is known: formatted as
    `<msg> at (line:L, col:C)` — or `<msg> (line:L, col:C)` for messages
    ending in '.', matching sql_parser.go's identifier-in-expression
    error verbatim (sql_parser_test.go:511)."""

    def __init__(self, msg: str, full: Optional[str] = None,
                 off: Optional[int] = None):
        self.line: Optional[int] = None
        self.col: Optional[int] = None
        if full is not None and off is not None:
            self.line, self.col = _pos(full, off)
            sep = "" if msg.rstrip().endswith(".") else " at"
            msg = f"{msg}{sep} (line:{self.line}, col:{self.col})"
        super().__init__(msg)


def _strip_quote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'`":
        return s[1:-1]
    return s


def _split_top_level_pos(s: str, sep_pattern: str) -> List[Tuple[str, int]]:
    """Split on a regex at paren/quote depth 0 (case-insensitive),
    returning (part, offset-of-part-within-s) pairs."""
    parts: List[Tuple[str, int]] = []
    depth = 0
    quote = None
    last = 0
    i = 0
    rx = re.compile(sep_pattern, re.IGNORECASE)
    while i < len(s):
        c = s[i]
        if quote:
            if c == quote:
                quote = None
            i += 1
            continue
        if c in "\"'`":
            quote = c
            i += 1
            continue
        if c == "(":
            depth += 1
            i += 1
            continue
        if c == ")":
            depth -= 1
            i += 1
            continue
        if depth == 0:
            m = rx.match(s, i)
            if m:
                parts.append((s[last:i], last))
                i = m.end()
                last = i
                continue
        i += 1
    parts.append((s[last:], last))
    return parts


def _split_top_level(s: str, sep_pattern: str) -> List[str]:
    """Split on a regex at paren/quote depth 0 (case-insensitive)."""
    return [p for p, _ in _split_top_level_pos(s, sep_pattern)]


def _word_char(c: str) -> bool:
    """Identifier chars for keyword boundaries — includes '_', so
    `having_fun` / `fromage` never read as clause keywords (regex \\b
    semantics; the round-4 splitter fuzz caught isalnum() missing '_')."""
    return c.isalnum() or c == "_"


def _skip_ws(s: str, off: int) -> int:
    """Offset of the first non-whitespace char at or after off."""
    while off < len(s) and s[off].isspace():
        off += 1
    return off


def _find_clauses(sql: str, full: Optional[str] = None,
                  base: int = 0) -> Tuple[Dict[str, str],
                                          Dict[str, Tuple[int, int]]]:
    """Locate top-level clause bodies.

    Returns (clauses, offsets) where offsets[kw] = (keyword offset,
    stripped-body offset), both absolute within `full` (the original
    statement text that `sql` is a slice of, starting at `base`) — the
    position anchors SQLParseError carries."""
    if full is None:
        full, base = sql, 0
    lead = len(sql) - len(sql.lstrip())
    s = sql.strip().rstrip(";")
    abs0 = base + lead
    # find clause keyword positions at depth 0
    positions: List[Tuple[int, int, str]] = []
    depth = 0
    quote = None
    i = 0
    low = s.lower()
    while i < len(s):
        c = s[i]
        if quote:
            if c == quote:
                quote = None
            i += 1
            continue
        if c in "\"'`":
            quote = c
            i += 1
            continue
        if c == "(":
            depth += 1
            i += 1
            continue
        if c == ")":
            depth -= 1
            i += 1
            continue
        if depth == 0 and (i == 0 or not _word_char(s[i - 1])):
            for kw in _CLAUSES:
                if low.startswith(kw, i) and (
                        i + len(kw) == len(s)
                        or not _word_char(s[i + len(kw)])):
                    positions.append((i, i + len(kw), kw))
                    i += len(kw)
                    break
            else:
                i += 1
            continue
        i += 1
    clauses: Dict[str, str] = {}
    offsets: Dict[str, Tuple[int, int]] = {}
    for n, (start, body_start, kw) in enumerate(positions):
        end = positions[n + 1][0] if n + 1 < len(positions) else len(s)
        if kw in clauses:
            raise SQLParseError(f"duplicate {kw.upper()} clause",
                                full, abs0 + start)
        raw = s[body_start:end]
        clauses[kw] = raw.strip()
        offsets[kw] = (abs0 + start,
                       abs0 + body_start + len(raw) - len(raw.lstrip()))
    if "select" not in clauses or "from" not in clauses:
        raise SQLParseError("query must have SELECT ... FROM ...",
                            full, abs0)
    return clauses, offsets


def _parse_call(text: str) -> Optional[Tuple[str, List[str]]]:
    """'fn(a, b, c)' → ('fn', ['a','b','c']) textually, else None."""
    m = re.match(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*\((.*)\)\s*$", text, re.S)
    if not m:
        return None
    name = m.group(1).lower()
    inner = m.group(2).strip()
    args = [a.strip() for a in _split_top_level(inner, r",")] if inner else []
    return name, args


def _split_as_alias(item: str) -> Tuple[str, str]:
    parts = _split_top_level(item, r"\bas\b")
    if len(parts) == 2:
        return parts[0].strip(), _strip_quote(parts[1])
    return item.strip(), ""


def parse_sql(sql: str) -> AQLQuery:
    """Parse one SQL statement into an AQLQuery JSON-equivalent object.

    Supports the reference's one-level WITH / FROM-subquery flattening
    (sql_parser.go mergeWithOrSubQueries): inner SELECTs share one FROM /
    GROUP BY / ORDER BY and flatten into a single AQL where inner WHERE
    clauses become measure-level rowFilters.
    """
    stripped = sql.lstrip()
    if not stripped.rstrip().rstrip(";").strip():
        # reference sql_parser.go:229, positioned at statement start
        # (sql_parser_test.go:523: "... at (line:1, col:0)")
        raise SQLParseError("missing queryNoWith body", sql, 0)
    if stripped.lower().startswith("with"):
        return AQLQuery.from_json(_parse_with(sql))
    clauses, offs = _find_clauses(sql)
    from_items = _split_top_level(clauses["from"], r",")
    if any(it.strip().startswith("(") for it in from_items):
        return AQLQuery.from_json(_parse_from_subquery(sql, clauses, offs))
    return AQLQuery.from_json(_parse_plain(sql))


def _parse_plain(sql: str, depth: int = 0, full: Optional[str] = None,
                 base: int = 0) -> Dict:
    """Parse a plain (no WITH/subquery) statement into the AQL JSON dict.

    full/base: the original statement text and sql's offset within it,
    for (line, col) error anchors."""
    if full is None:
        full, base = sql, 0
    # constructs AQL cannot express are rejected up front (reference:
    # sql_parser.go "having not yet supported"; DISTINCT has no AQL
    # mapping either) — silently misparsing them would return wrong results
    if sql.lstrip().lower().startswith("with"):
        at = _skip_ws(full, base)
        if depth:
            # reference sql_parser.go:264, anchored at the inner WITH token
            # (sql_parser_test.go:416: "... at (line:2, col:5)")
            raise SQLParseError("only support 1 level with query", full, at)
        raise SQLParseError("WITH / subqueries are not supported", full, at)
    clauses, offs = _find_clauses(sql, full, base)
    if depth:
        for it, it_off in _split_top_level_pos(clauses["from"], r","):
            if it.strip().startswith("("):
                # reference sql_parser.go:216
                raise SQLParseError(
                    "only support 1 level subquery", full,
                    _skip_ws(full, offs["from"][1] + it_off))
    if "having" in clauses:
        # reference sql_parser.go:496
        raise SQLParseError("having not yet supported", full,
                            offs["having"][0])
    if clauses["select"].lower().lstrip().startswith("distinct"):
        raise SQLParseError("DISTINCT is not supported", full,
                            offs["select"][1])
    q: Dict = {"measures": [], "dimensions": [], "rowFilters": [], "joins": []}

    # FROM: main table + joins
    from_body = clauses["from"]
    from_off = offs["from"][1]
    join_parts_pos = _split_top_level_pos(
        from_body, r"(?:left\s+|inner\s+|cross\s+)?join\b")
    join_parts = [p for p, _ in join_parts_pos]
    main = join_parts[0].strip()
    mparts = _split_top_level(main, r"\bas\b")
    main_name = _strip_quote(mparts[0])
    if len(mparts) == 2:
        pass  # alias of the main table equals the table name in AQL
    elif not (len(main) >= 2 and main[0] == main[-1] and main[0] in "\"'`"):
        # a fully-quoted name ('FROM "weird table"') is never name+alias
        toks = main.split()
        if len(toks) == 2:
            main_name = _strip_quote(toks[0])
    q["table"] = main_name

    for jp, jp_off in join_parts_pos[1:]:
        on_split = _split_top_level(jp, r"\bon\b")
        if len(on_split) != 2:
            raise SQLParseError(f"JOIN missing ON condition: {jp!r}",
                                full, _skip_ws(full, from_off + jp_off))
        tbl_part, cond = on_split[0].strip(), on_split[1].strip()
        tp = _split_top_level(tbl_part, r"\bas\b")
        if len(tp) == 2:
            tname, talias = _strip_quote(tp[0]), _strip_quote(tp[1])
        else:
            toks = tbl_part.split()
            tname = _strip_quote(toks[0])
            talias = _strip_quote(toks[1]) if len(toks) == 2 else ""
        conditions = [c.strip()
                      for c in _split_top_level(cond, r"\band\b") if c.strip()]
        q["joins"].append({"table": tname, "alias": talias,
                           "conditions": conditions})

    # WHERE: split conjuncts; extract aql_time_filter / aql_now.
    # A TOP-LEVEL OR means the clause is one single filter — splitting on
    # AND would regroup `a AND b OR c` as a AND (b OR c) (SQL gives AND
    # the tighter binding; the reference keeps the whole WHERE as one
    # filter string, sql_parser_test.go:38).
    timezone = ""
    where_clause = clauses.get("where", "")
    where_off = offs["where"][1] if "where" in offs else 0
    if len(_split_top_level(where_clause, r"\bor\b")) > 1:
        conjuncts = [(where_clause, 0)]
    else:
        conjuncts = _split_top_level_pos(where_clause, r"\band\b")
    for conj, c_off in conjuncts:
        conj = conj.strip()
        if not conj:
            continue
        at = _skip_ws(full, where_off + c_off)
        call = _parse_call(conj)
        if call and call[0] == "aql_time_filter":
            if len(call[1]) != 4:
                raise SQLParseError("aql_time_filter requires 4 arguments",
                                    full, at)
            col, frm, to, tz = call[1]
            q["timeFilter"] = {"column": _strip_quote(col),
                               "from": _strip_quote(frm),
                               "to": _strip_quote(to)}
            tz = _strip_quote(tz)
            if tz and tz.lower() != "null":
                timezone = tz
            continue
        if call and call[0] == "aql_now":
            if len(call[1]) != 2:
                raise SQLParseError("aql_now requires 2 arguments",
                                    full, at)
            q["now"] = int(_strip_quote(call[1][1]))
            continue
        q["rowFilters"].append(conj)

    # GROUP BY: dimensions
    gb_off = offs["group by"][1] if "group by" in offs else 0
    for item, it_off in _split_top_level_pos(clauses.get("group by", ""),
                                             r","):
        item = item.strip()
        if not item:
            continue
        at = _skip_ws(full, gb_off + it_off)
        call = _parse_call(item)
        if call and call[0] in TIME_BUCKET_UDFS:
            if len(call[1]) != 3:
                raise SQLParseError(f"{call[0]} requires 3 arguments",
                                    full, at)
            col, unit, tz = (_strip_quote(a) for a in call[1])
            q["dimensions"].append({
                "sqlExpression": col,
                "timeBucketizer": TIME_BUCKET_UDFS[call[0]],
                "timeUnit": unit,
            })
            if tz and tz.lower() != "null":
                if timezone and timezone != tz:
                    raise SQLParseError(
                        f"conflicting timezones {timezone!r} vs {tz!r}",
                        full, at)
                timezone = tz
            continue
        if call and call[0] in NUMERIC_BUCKET_UDFS:
            if len(call[1]) != 2:
                raise SQLParseError(f"{call[0]} requires 2 arguments",
                                    full, at)
            col, expr_arg = call[1]
            kind = NUMERIC_BUCKET_UDFS[call[0]]
            nb: Dict = {}
            if kind == "manualPartitions":
                nb[kind] = [float(x) for x in
                            _strip_quote(expr_arg).strip("[]{}()").split(",")]
            else:
                nb[kind] = float(_strip_quote(expr_arg))
            q["dimensions"].append({"sqlExpression": _strip_quote(col),
                                    "numericBucketizer": nb})
            continue
        q["dimensions"].append({"sqlExpression": item})

    # SELECT: aggregate call → measure; non-agg items → dims (non-agg query)
    group_dim_exprs = {d["sqlExpression"] for d in q["dimensions"]}
    select_dims: List[Dict] = []
    for item in _split_top_level(clauses["select"], r","):
        item = item.strip()
        if not item:
            continue
        if item == "*":
            # wildcard select: a `*` dimension, expanded by the compiler
            # to all usable columns (reference sql_parser_test.go:87 keeps
            # the `*` dim; aql_compiler.go:412 expands it)
            select_dims.append({"sqlExpression": "*"})
            continue
        expr_text, alias = _split_as_alias(item)
        call = _parse_call(expr_text)
        if call and call[0] in AGG_FUNCS:
            q["measures"].append({"sqlExpression": expr_text, "alias": alias})
            continue
        # select of a grouped dim (or its alias): attach alias
        matched = False
        for d in q["dimensions"]:
            if d["sqlExpression"] == expr_text and alias and \
                    not d.get("alias"):
                d["alias"] = alias
                matched = True
                break
            if alias and d["sqlExpression"] == alias:
                # GROUP BY referenced the select alias ('SELECT population
                # AS pop ... GROUP BY aql_numeric_bucket_logbase(pop, 2)');
                # resolve the dim to the real expression, like the
                # reference's late alias resolution (sql_parser_test.go
                # "parse numeric bucketizer should work")
                d["sqlExpression"] = expr_text
                d["alias"] = alias
                matched = True
                break
        if expr_text in group_dim_exprs:
            matched = True
        if not matched:
            select_dims.append({"sqlExpression": expr_text, "alias": alias})

    if not q["measures"]:
        # non-aggregate: selected columns become dims, measure literal 1
        q["measures"] = [{"sqlExpression": "1"}]
        q["dimensions"] = q["dimensions"] + select_dims
    elif select_dims:
        # selected non-grouped expressions are additional dimensions
        q["dimensions"] = q["dimensions"] + select_dims
    # multiple aggregates parse fine (the reference's Parse accepts them,
    # sql_parser_test.go "parse row filters should work"); non-composite
    # execution rejects later with the compiler's "exactly 1 measure is
    # required" (compiler.py:192), matching reference staging. Inner
    # (depth>0) queries legitimately carry several — the outer selection
    # narrows to one and the rest become supporting measures.

    # ORDER BY / LIMIT
    sorts = []
    for item in _split_top_level(clauses.get("order by", ""), r","):
        item = item.strip()
        if not item:
            continue
        toks = item.split()
        order = "asc"
        if toks[-1].lower() in ("asc", "desc"):
            order = toks[-1].lower()
            item = " ".join(toks[:-1])
        sorts.append({"name": _strip_quote(item), "order": order})
    if sorts:
        q["sorts"] = sorts
    if "limit" in clauses:
        try:
            q["limit"] = int(clauses["limit"].strip())
        except ValueError:
            raise SQLParseError(f"invalid LIMIT {clauses['limit']!r}",
                                full, offs["limit"][1])
    if timezone:
        q["timezone"] = timezone
    q["sql"] = sql
    return q


# ---------------------------------------------------------------------------
# one-level WITH / FROM-subquery flattening
# (reference: sql_parser.go VisitWith, isValidWithOrSubQuery,
#  mergeWithOrSubQueries — maxLevelQuery/maxlevelWith are both 1)
# ---------------------------------------------------------------------------

def _parse_with(sql: str) -> Dict:
    """'WITH a AS (q) [, b AS (q)] SELECT ...' → flattened AQL dict."""
    base = len(sql) - len(sql.lstrip())
    s = sql.strip().rstrip(";")
    m = re.match(r"\s*with\b(\s+recursive\b)?", s, re.IGNORECASE)
    if m.group(1):
        # anchored at the WITH statement start, like the reference's ANTLR
        # production anchor (sql_parser_test.go:400 "(line:1, col:0)")
        raise SQLParseError("RECURSIVE not yet supported", sql, base)
    i = m.end()
    named: Dict[str, Dict] = {}
    while True:
        # 'name AS (q)' or 'name (col [, col]) AS (q)' — the optional
        # column-alias list renames the subquery's output columns
        # (reference grammar: namedQuery columnAliases,
        # sql_parser_test.go "parse composite measures")
        nm = re.compile(r"\s*([A-Za-z_][A-Za-z0-9_]*)\s*"
                        r"(?:\(([^)]*)\)\s*)?as\s*\(",
                        re.IGNORECASE).match(s, i)
        if not nm:
            # reference sql_parser.go namedQuery miss, anchored at the
            # token where the named query was expected
            # (sql_parser_test.go:449 "(line:2, col:3)")
            raise SQLParseError("missing with query body", sql,
                                _skip_ws(sql, base + i))
        name = nm.group(1)
        if name in named:
            raise SQLParseError(
                f"subquery/withQuery identifier: {name} already exist",
                sql, base + nm.start(1))
        start = nm.end()
        depth = 1
        j = start
        while j < len(s) and depth:
            if s[j] == "(":
                depth += 1
            elif s[j] == ")":
                depth -= 1
            j += 1
        if depth:
            raise SQLParseError("unbalanced parentheses in WITH query",
                                sql, base + start - 1)
        inner = _parse_inner(s[start:j - 1], full=sql, base=base + start)
        if nm.group(2):
            _apply_column_aliases(
                inner, [a.strip() for a in nm.group(2).split(",")], name)
        named[name] = inner
        i = j
        comma = re.compile(r"\s*,").match(s, i)
        if not comma:
            break
        i = comma.end()
    outer_sql = s[i:]
    if not outer_sql.strip():
        raise SQLParseError("missing query body after WITH", sql,
                            base + i)
    clauses, coffs = _find_clauses(outer_sql, sql, base + i)
    for section in ("where", "select", "group by"):
        body = clauses.get(section, "")
        for name in named:
            hit = re.search(rf"\b{re.escape(name)}\s*\.", body)
            if hit:
                # reference sql_parser.go:1052, anchored at the identifier
                # (sql_parser_test.go:511 "(line:4, col:16)")
                raise SQLParseError(
                    "subquery/withQuery identifier in expression not "
                    "supported yet.", sql, coffs[section][1] + hit.start())
    inners = []
    for item, it_off in _split_top_level_pos(clauses["from"], _FROM_SEP):
        ident = _strip_quote(item.strip())
        if ident not in named:
            raise SQLParseError(
                f"cannot find withQuery identifier: {ident}", sql,
                _skip_ws(sql, coffs["from"][1] + it_off))
        inners.append(named[ident])
    return _merge_subqueries(outer_sql, clauses, inners, sql,
                             offs=coffs)


# FROM-clause separators between subquery relations: commas and NATURAL
# joins (the only join form allowed between With/subquery identifiers —
# reference sql_parser_test.go:421)
_FROM_SEP = r",|\bnatural\s+(?:left\s+|right\s+|full\s+)?(?:outer\s+)?join\b"


def _is_derived_over(expr_text: str, by_alias: Dict) -> bool:
    """True if expr_text parses to arithmetic whose variable references
    all name output MEASURE columns of the merged subqueries."""
    from aresdb_tpu_torch.query import expr as E

    try:
        ast = E.parse(expr_text)
    except E.ExprParseError:
        return False

    def ok(node) -> bool:
        if isinstance(node, E.NumberLiteral):
            return True
        if isinstance(node, E.VarRef):
            hit = by_alias.get(node.val)
            return hit is not None and hit[0] == "measure"
        if isinstance(node, E.UnaryExpr) and node.op == "-":
            return ok(node.expr)
        if isinstance(node, E.BinaryExpr) and node.op in "+-*/":
            return ok(node.lhs) and ok(node.rhs)
        return False

    return isinstance(ast, (E.BinaryExpr, E.UnaryExpr)) and ok(ast)


def _apply_column_aliases(inner: Dict, aliases: List[str],
                          name: str) -> None:
    """Positionally rename the subquery's output columns: aggregate
    measures first, then remaining slots onto dimensions."""
    measures = [m for m in inner.get("measures", [])
                if m.get("sqlExpression") != "1"]
    dims = inner.get("dimensions", [])
    outputs = measures + dims
    if len(aliases) > len(outputs):
        raise SQLParseError(
            f"withQuery {name}: {len(aliases)} column aliases for "
            f"{len(outputs)} output columns")
    for alias, obj in zip(aliases, outputs):
        obj["alias"] = _strip_quote(alias)


def _parse_from_subquery(sql: str, clauses: Dict[str, str],
                         offs: Dict[str, Tuple[int, int]]) -> Dict:
    """'SELECT ... FROM (SELECT ...) [AS alias] [NATURAL JOIN ...]' →
    flattened AQL dict."""
    inners = []
    for item, it_off in _split_top_level_pos(clauses["from"], _FROM_SEP):
        lead = len(item) - len(item.lstrip())
        item = item.strip()
        at = offs["from"][1] + it_off + lead
        if not item.startswith("("):
            # reference sql_parser_test.go:437 — both sides of a join
            # relation must be subqueries (or both table names)
            raise SQLParseError(
                "from clause cannot mix tables with subqueries", sql, at)
        depth = 0
        for j, c in enumerate(item):
            depth += (c == "(") - (c == ")")
            if depth == 0:
                break
        inners.append(_parse_inner(item[1:j], full=sql, base=at + 1))
    return _merge_subqueries(sql, clauses, inners, sql, offs=offs)


def _parse_inner(sql: str, full: Optional[str] = None,
                 base: int = 0) -> Dict:
    if full is None:
        full, base = sql, 0
    hit = re.search(r"\bnatural\s+(?:left\s+|right\s+|full\s+)?"
                    r"(?:outer\s+)?join\b", sql, re.IGNORECASE)
    if hit:
        # reference sql_parser.go:773
        raise SQLParseError(
            "natural join not supported at subquery/withQuery",
            full, base + hit.start())
    q = _parse_plain(sql, depth=1, full=full, base=base)
    if "limit" in q:
        # reference sql_parser.go:390
        raise SQLParseError("limit on query level > 0 not supported",
                            full, _skip_ws(full, base))
    return q


def _merge_subqueries(outer_sql: str, clauses: Dict[str, str],
                      inners: List[Dict], full_sql: str,
                      offs: Optional[Dict[str, Tuple[int, int]]] = None
                      ) -> Dict:
    """Flatten one-level subqueries per the reference's AQL merge rules."""
    if not inners:
        raise SQLParseError("missing subquery in from clause")
    first = inners[0]
    # all inner from/group-by/order-by clauses must agree
    # (reference isSameFromTables/isSameGroupBy/isSameOrderBy)
    import json as _json

    def sig(q, key):
        return _json.dumps(q.get(key, []), sort_keys=True)

    for q in inners[1:]:
        if (q.get("table"), sig(q, "joins")) != (first.get("table"),
                                                 sig(first, "joins")):
            raise SQLParseError(
                "all subquery/withQuery from clauses must be the same")
        if sig(q, "dimensions") != sig(first, "dimensions"):
            raise SQLParseError(
                "all subquery/withQuery group by clauses must be the same")
        if sig(q, "sorts") != sig(first, "sorts"):
            raise SQLParseError(
                "all subquery/withQuery order by clauses must be the same")
        if q.get("timeFilter") != first.get("timeFilter"):
            raise SQLParseError(
                "all subquery/withQuery time filters must be the same")

    if "having" in clauses:
        raise SQLParseError("having not yet supported")
    inner_dims = list(first.get("dimensions", []))
    # outer GROUP BY conflicts with an aggregated inner (reference
    # sql_parser.go:483)
    outer_groupby = clauses.get("group by", "").strip()
    inner_is_agg = any(m.get("sqlExpression") != "1"
                       for m in first.get("measures", []))
    if outer_groupby and inner_is_agg and inner_dims:
        raise SQLParseError(
            "group by is not allowed since with/subQuery already has "
            "group by")

    # index inner output columns by alias and expression; measures come
    # from EVERY inner, each carrying its own inner WHERE as measure-level
    # filters (reference mergeWithOrSubQueries: same FROM/GROUP BY inners
    # merge into one query with per-measure filters)
    by_alias: Dict[str, Tuple[str, Dict, List[str]]] = {}
    all_measures: List[Tuple[Dict, List[str]]] = []
    for inner in inners:
        filters_i = list(inner.get("rowFilters", []))
        for m in inner.get("measures", []):
            if m.get("sqlExpression") == "1":
                continue
            all_measures.append((m, filters_i))
            if m.get("alias"):
                if m["alias"] in by_alias:
                    raise SQLParseError(
                        f"duplicate output column {m['alias']!r} across "
                        "subquery/withQuery relations")
                by_alias[m["alias"]] = ("measure", m, filters_i)
            by_alias.setdefault(m["sqlExpression"],
                                ("measure", m, filters_i))
    for d in inner_dims:
        if d.get("alias"):
            by_alias[d["alias"]] = ("dim", d, [])
        by_alias.setdefault(d["sqlExpression"], ("dim", d, []))

    q: Dict = {"table": first.get("table", ""),
               "joins": list(first.get("joins", [])),
               "measures": [], "dimensions": [], "rowFilters": []}
    inner_filters = list(first.get("rowFilters", []))
    used_measures = []

    select_body = clauses["select"].strip()
    if select_body.lower().startswith("distinct"):
        raise SQLParseError("DISTINCT is not supported")
    if select_body == "*":
        # adopt the inner queries wholesale
        q["dimensions"] = inner_dims
        for m, filters_i in all_measures:
            q["measures"].append(dict(m, rowFilters=filters_i))
            used_measures.append(m["sqlExpression"])
    else:
        for item in _split_top_level(select_body, r","):
            item = item.strip()
            if not item:
                continue
            expr_text, alias = _split_as_alias(item)
            hit = by_alias.get(expr_text) or by_alias.get(
                _strip_quote(expr_text))
            if hit is None:
                # expression over output-measure aliases → a derived
                # composite measure, e.g. 'Completed/Requested'
                # (reference sql_parser_test.go "parse composite measures";
                # validated + executed by query/composite.py)
                if _is_derived_over(expr_text, by_alias):
                    q["measures"].append({
                        "sqlExpression": expr_text,
                        "alias": alias,
                    })
                    continue
                raise SQLParseError(
                    f"{expr_text!r} does not name an output column of the "
                    "subquery/withQuery")
            kind, obj, filters_i = hit
            if kind == "measure":
                # inner WHERE becomes a measure-level filter
                q["measures"].append({
                    "sqlExpression": obj["sqlExpression"],
                    "alias": alias or obj.get("alias", ""),
                    "rowFilters": filters_i,
                })
                used_measures.append(obj["sqlExpression"])
            else:
                d = dict(obj)
                if alias:
                    d["alias"] = alias
                q["dimensions"].append(d)

    # outer GROUP BY over a non-aggregated inner re-groups its columns
    for item in _split_top_level(outer_groupby, r","):
        item = item.strip()
        if not item:
            continue
        hit = by_alias.get(item)
        if hit is None or hit[0] != "dim":
            raise SQLParseError(
                f"group by {item!r} does not name a dimension of the "
                "subquery/withQuery")
        # dedup ignoring only the alias — the select loop may have appended
        # an alias-mutated copy of this dimension (plain dict equality
        # missed it), but dims sharing an expression can still differ by
        # bucketizer and must NOT be conflated
        def _no_alias(d):
            return {k: v for k, v in d.items() if k != "alias"}

        if _no_alias(hit[1]) not in [_no_alias(d) for d in q["dimensions"]]:
            q["dimensions"].append(dict(hit[1]))

    # unselected inner measures ride along as supporting measures
    # (reference mergeWithOrSubQuery case2)
    supporting = [dict(m, rowFilters=filters_i)
                  for m, filters_i in all_measures
                  if m["sqlExpression"] not in used_measures]
    if supporting:
        q["supportingMeasures"] = supporting

    # outer with no selected/grouped dims inherits the inner group by
    # (reference mergeWithOrSubQuery: MapDimensions[0] <- MapDimensions[key])
    if not q["dimensions"] and not outer_groupby:
        q["dimensions"] = inner_dims
    if not q["measures"]:
        q["measures"] = [{"sqlExpression": "1"}]
    # multi-measure (composite) queries are legal here: the reference
    # grammar parses them the same way (sql_parser_test.go "parse
    # composite measures") and our engine EXECUTES them by decomposition
    # (query/composite.py) where the reference rejects with "sub query
    # not supported yet" (sql_parser.go:2018)

    # outer WHERE stays query-level; time filter prefers the outer one
    timezone = first.get("timezone", "")
    for conj in _split_top_level(clauses.get("where", ""), r"\band\b"):
        conj = conj.strip()
        if not conj:
            continue
        call = _parse_call(conj)
        if call and call[0] == "aql_time_filter":
            if len(call[1]) != 4:
                raise SQLParseError("aql_time_filter requires 4 arguments")
            col, frm, to, tz = call[1]
            q["timeFilter"] = {"column": _strip_quote(col),
                               "from": _strip_quote(frm),
                               "to": _strip_quote(to)}
            tz = _strip_quote(tz)
            if tz and tz.lower() != "null":
                timezone = tz
            continue
        if call and call[0] == "aql_now":
            if len(call[1]) != 2:
                raise SQLParseError("aql_now requires 2 arguments")
            q["now"] = int(_strip_quote(call[1][1]))
            continue
        q["rowFilters"].append(conj)
    if "timeFilter" not in q and first.get("timeFilter"):
        q["timeFilter"] = first["timeFilter"]
    if "now" not in q and first.get("now") is not None and "now" in first:
        q["now"] = first["now"]

    # ORDER BY / LIMIT from the outer level, else the inner one
    sorts = []
    for item in _split_top_level(clauses.get("order by", ""), r","):
        item = item.strip()
        if not item:
            continue
        toks = item.split()
        order = "asc"
        if toks[-1].lower() in ("asc", "desc"):
            order = toks[-1].lower()
            item = " ".join(toks[:-1])
        sorts.append({"name": _strip_quote(item), "order": order})
    if sorts:
        q["sorts"] = sorts
    elif first.get("sorts"):
        q["sorts"] = first["sorts"]
    if "limit" in clauses:
        try:
            q["limit"] = int(clauses["limit"].strip())
        except ValueError:
            raise SQLParseError(f"invalid LIMIT {clauses['limit']!r}")
    if timezone:
        q["timezone"] = timezone
    q["sql"] = full_sql
    return q
