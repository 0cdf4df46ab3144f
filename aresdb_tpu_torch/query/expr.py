"""AQL expression AST + scanner + recursive-descent parser.

Capability parity with the reference expression language
(reference: query/expr/{token.go,scanner.go,parser.go,ast.go} — an
InfluxQL-derived grammar). The AST is deliberately small: literals, variable
references, unary/binary operators, and function calls; type resolution and
rewrites live in the compiler (reference: query/aql_compiler.go Rewrite).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Expression value types (reference: query/expr/ast.go Type)
# ---------------------------------------------------------------------------

UNKNOWN_TYPE = 0
BOOLEAN = 1
UNSIGNED = 2
SIGNED = 3
FLOAT = 4
GEOPOINT = 5
GEOSHAPE = 6

TYPE_NAMES = {
    UNKNOWN_TYPE: "Unknown",
    BOOLEAN: "Boolean",
    UNSIGNED: "Unsigned",
    SIGNED: "Signed",
    FLOAT: "Float",
    GEOPOINT: "GeoPoint",
    GEOSHAPE: "GeoShape",
}

# Aggregate/function call names (reference: query/expr/ast.go:62-81)
CONVERT_TZ = "convert_tz"
COUNT = "count"
DAY_OF_WEEK = "dayofweek"
FROM_UNIXTIME = "from_unixtime"
GEOGRAPHY_INTERSECTS = "geography_intersects"
HEX = "hex"
HLL = "hll"
COUNT_DISTINCT_HLL = "countdistincthll"
HOUR = "hour"
MAX = "max"
MIN = "min"
SUM = "sum"
AVG = "avg"
LENGTH = "length"
CONTAINS = "contains"
ELEMENT_AT = "element_at"

AGGREGATE_CALLS = {COUNT, SUM, AVG, MIN, MAX, HLL, COUNT_DISTINCT_HLL}


class Expr:
    """Base expression node; every node carries a resolved value type."""

    type: int = UNKNOWN_TYPE


@dataclass
class NumberLiteral(Expr):
    val: float
    int_val: int
    expr: str  # original literal text
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return self.expr or (
            str(self.int_val) if self.type != FLOAT else repr(self.val))


@dataclass
class StringLiteral(Expr):
    val: str
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return f"'{self.val}'"


@dataclass
class BooleanLiteral(Expr):
    val: bool
    type: int = BOOLEAN

    def __str__(self) -> str:
        return "true" if self.val else "false"


@dataclass
class NullLiteral(Expr):
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return "NULL"


@dataclass
class VarRef(Expr):
    """Column reference, possibly qualified as table_alias.column."""

    val: str
    type: int = UNKNOWN_TYPE
    table_id: int = 0       # index into query scanner tables (0 = main)
    column_id: int = -1     # schema column id within that table
    data_type: int = 0      # memstore data type code
    enum_dict: Optional[dict] = None       # str -> rank (for enum columns)
    enum_reverse_dict: Optional[list] = None
    enum_ci: bool = False                  # case-insensitive enum column

    def __str__(self) -> str:
        return self.val


@dataclass
class ParenExpr(Expr):
    expr: Expr = None
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return f"({self.expr})"


@dataclass
class UnaryExpr(Expr):
    op: str  # '-', 'NOT', '~', 'IS_NULL', 'IS_NOT_NULL', 'IS_TRUE', 'IS_FALSE'
    expr: Expr = None
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        if self.op in ("IS_NULL", "IS_NOT_NULL", "IS_TRUE", "IS_FALSE"):
            return f"{self.expr} {self.op.replace('_', ' ')}"
        return f"{self.op}{self.expr}"


@dataclass
class BinaryExpr(Expr):
    op: str  # '+','-','*','/','%','=','!=','<','<=','>','>=','AND','OR','&','|','^','<<','>>','IN','NOT IN'
    lhs: Expr = None
    rhs: Expr = None
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return f"{self.lhs} {self.op} {self.rhs}"


@dataclass
class Call(Expr):
    name: str
    args: List[Expr] = field(default_factory=list)
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        return f"{self.name}({', '.join(str(a) for a in self.args)})"


@dataclass
class Case(Expr):
    """CASE WHEN cond THEN val [...] ELSE val END."""

    when_thens: List[Tuple[Expr, Expr]] = field(default_factory=list)
    else_expr: Optional[Expr] = None
    type: int = UNKNOWN_TYPE

    def __str__(self) -> str:
        parts = ["CASE"]
        for w, t in self.when_thens:
            parts.append(f"WHEN {w} THEN {t}")
        if self.else_expr is not None:
            parts.append(f"ELSE {self.else_expr}")
        parts.append("END")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Scanner
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<string>'(''|[^'])*'|"(""|[^"])*")
  | (?P<op><<|>>|<=|>=|!=|<>|\|\||&&|[-+*/%(),=<>!&|^~\[\]])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "and", "or", "not", "in", "is", "null", "true", "false", "case", "when",
    "then", "else", "end",
}


@dataclass
class _Token:
    kind: str  # 'number' | 'ident' | 'string' | 'op' | 'keyword' | 'eof'
    text: str


def tokenize(s: str) -> List[_Token]:
    tokens: List[_Token] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ExprParseError(f"unexpected character {s[pos]!r} at {pos} in {s!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "ident" and text.lower() in _KEYWORDS:
            tokens.append(_Token("keyword", text.lower()))
        elif kind == "string":
            q = text[0]
            tokens.append(_Token("string", text[1:-1].replace(q * 2, q)))
        else:
            tokens.append(_Token(kind, text))
    tokens.append(_Token("eof", ""))
    return tokens


class ExprParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser (precedence climbing; precedence mirrors reference token.go)
# ---------------------------------------------------------------------------

_PRECEDENCE = {
    "OR": 1,
    "AND": 2,
    "=": 3, "!=": 3, "<>": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
    "IN": 3, "NOT IN": 3,
    "|": 4, "^": 4,
    "&": 5,
    "<<": 5, ">>": 5,
    "+": 6, "-": 6,
    "*": 7, "/": 7, "%": 7,
}


class _Parser:
    def __init__(self, tokens: List[_Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> _Token:
        return self.tokens[self.i]

    def next(self) -> _Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind != "op" or t.text != op:
            raise ExprParseError(f"expected {op!r}, got {t.text!r}")

    # -- grammar --

    def parse_expr(self, min_prec: int = 1) -> Expr:
        lhs = self.parse_unary()
        while True:
            op = self._peek_binary_op()
            if op is None or _PRECEDENCE[op] < min_prec:
                return lhs
            self._consume_binary_op(op)
            if op in ("IN", "NOT IN"):
                rhs = self.parse_in_list()
                lhs = BinaryExpr(op=op, lhs=lhs, rhs=rhs)
                continue
            rhs = self.parse_expr(_PRECEDENCE[op] + 1)
            lhs = BinaryExpr(op=op, lhs=lhs, rhs=rhs)

    def _peek_binary_op(self) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.text in _PRECEDENCE:
            return t.text
        if t.kind == "keyword":
            if t.text == "and":
                return "AND"
            if t.text == "or":
                return "OR"
            if t.text == "in":
                return "IN"
            if t.text == "not" and self.tokens[self.i + 1].kind == "keyword" \
                    and self.tokens[self.i + 1].text == "in":
                return "NOT IN"
            if t.text == "is":
                return None  # handled as postfix in parse_unary
        return None

    def _consume_binary_op(self, op: str) -> None:
        if op == "NOT IN":
            self.next()
            self.next()
        else:
            self.next()

    def parse_in_list(self) -> Call:
        """IN (a, b, c) — list packaged as a Call with empty name."""
        self.expect_op("(")
        args = []
        if not (self.peek().kind == "op" and self.peek().text == ")"):
            args.append(self.parse_expr())
            while self.peek().kind == "op" and self.peek().text == ",":
                self.next()
                args.append(self.parse_expr())
        self.expect_op(")")
        return Call(name="", args=args)

    def parse_unary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.text == "-":
            self.next()
            return UnaryExpr(op="-", expr=self.parse_unary())
        if t.kind == "op" and t.text == "~":
            self.next()
            return UnaryExpr(op="~", expr=self.parse_unary())
        if t.kind == "op" and t.text == "!":
            # C-style prefix negation (reference expr/parser.go parses
            # "!is_first" as NOT, aql_compiler_test.go:330)
            self.next()
            return UnaryExpr(op="NOT", expr=self.parse_unary())
        if t.kind == "keyword" and t.text == "not":
            self.next()
            return UnaryExpr(op="NOT", expr=self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "keyword" and t.text == "is":
                self.next()
                neg = False
                if self.peek().kind == "keyword" and self.peek().text == "not":
                    self.next()
                    neg = True
                v = self.next()
                if v.kind == "keyword" and v.text == "null":
                    e = UnaryExpr(op="IS_NOT_NULL" if neg else "IS_NULL", expr=e)
                elif v.kind == "keyword" and v.text == "true":
                    e = UnaryExpr(op="IS_FALSE" if neg else "IS_TRUE", expr=e)
                elif v.kind == "keyword" and v.text == "false":
                    e = UnaryExpr(op="IS_TRUE" if neg else "IS_FALSE", expr=e)
                else:
                    raise ExprParseError(f"IS must be followed by NULL/TRUE/FALSE, got {v.text!r}")
                continue
            if t.kind == "op" and t.text == "[":
                # array subscript sugar: a[i] == element_at(a, i)
                self.next()
                idx = self.parse_expr()
                self.expect_op("]")
                e = Call(name=ELEMENT_AT, args=[e, idx])
                continue
            return e

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "number":
            if "." in t.text or "e" in t.text.lower():
                return NumberLiteral(val=float(t.text), int_val=int(float(t.text)),
                                     expr=t.text, type=FLOAT)
            return NumberLiteral(val=float(int(t.text)), int_val=int(t.text),
                                 expr=t.text)
        if t.kind == "string":
            return StringLiteral(val=t.text)
        if t.kind == "keyword":
            if t.text == "true":
                return BooleanLiteral(val=True)
            if t.text == "false":
                return BooleanLiteral(val=False)
            if t.text == "null":
                return NullLiteral()
            if t.text == "case":
                return self.parse_case()
            raise ExprParseError(f"unexpected keyword {t.text!r}")
        if t.kind == "op" and t.text == "(":
            e = self.parse_expr()
            self.expect_op(")")
            return ParenExpr(expr=e)
        if t.kind == "op" and t.text == "*":
            # bare '*' (count(*))
            return VarRef(val="*")
        if t.kind == "ident":
            nxt = self.peek()
            if nxt.kind == "op" and nxt.text == "(":
                self.next()
                args = []
                if not (self.peek().kind == "op" and self.peek().text == ")"):
                    args.append(self.parse_expr())
                    while self.peek().kind == "op" and self.peek().text == ",":
                        self.next()
                        args.append(self.parse_expr())
                self.expect_op(")")
                return Call(name=t.text.lower(), args=args)
            return VarRef(val=t.text)
        raise ExprParseError(f"unexpected token {t.text!r}")

    def parse_case(self) -> Case:
        when_thens = []
        else_expr = None
        while True:
            t = self.next()
            if t.kind == "keyword" and t.text == "when":
                cond = self.parse_expr()
                t2 = self.next()
                if not (t2.kind == "keyword" and t2.text == "then"):
                    raise ExprParseError("expected THEN after WHEN condition")
                val = self.parse_expr()
                when_thens.append((cond, val))
            elif t.kind == "keyword" and t.text == "else":
                else_expr = self.parse_expr()
            elif t.kind == "keyword" and t.text == "end":
                return Case(when_thens=when_thens, else_expr=else_expr)
            else:
                raise ExprParseError(f"unexpected token {t.text!r} in CASE")


def parse(s: str) -> Expr:
    """Parse one AQL expression string into an AST."""
    p = _Parser(tokenize(s))
    e = p.parse_expr()
    t = p.peek()
    if t.kind != "eof":
        raise ExprParseError(f"trailing tokens starting at {t.text!r} in {s!r}")
    return e


def walk(e: Expr, fn) -> None:
    """Pre-order visit of every node."""
    fn(e)
    if isinstance(e, ParenExpr):
        walk(e.expr, fn)
    elif isinstance(e, UnaryExpr):
        walk(e.expr, fn)
    elif isinstance(e, BinaryExpr):
        walk(e.lhs, fn)
        walk(e.rhs, fn)
    elif isinstance(e, Call):
        for a in e.args:
            walk(a, fn)
    elif isinstance(e, Case):
        for w, t in e.when_thens:
            walk(w, fn)
            walk(t, fn)
        if e.else_expr is not None:
            walk(e.else_expr, fn)


def transform(e: Expr, fn) -> Expr:
    """Post-order rewrite: children first, then fn(node)."""
    if isinstance(e, ParenExpr):
        e.expr = transform(e.expr, fn)
    elif isinstance(e, UnaryExpr):
        e.expr = transform(e.expr, fn)
    elif isinstance(e, BinaryExpr):
        e.lhs = transform(e.lhs, fn)
        e.rhs = transform(e.rhs, fn)
    elif isinstance(e, Call):
        e.args = [transform(a, fn) for a in e.args]
    elif isinstance(e, Case):
        e.when_thens = [(transform(w, fn), transform(t, fn))
                        for w, t in e.when_thens]
        if e.else_expr is not None:
            e.else_expr = transform(e.else_expr, fn)
    return fn(e)
