"""SQL statements and composite (multi-measure) queries of the port
against the JAX package.

The port's `query/sql.py` and `query/composite.py` are copies of the JAX
package's: every statement that tests/test_sql.py and
tests/test_composite.py parse must give the same AQL query in both, and
every statement they refuse the same error. The services run them end to
end over the 12 trips of tests/test_query_e2e.py, filled into both
packages from the same upsert bytes (the JAX package with
ARES_FUSED=interp, the port on the CPU); the responses must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from aresdb_tpu.query import composite as JC
from aresdb_tpu.query import sql as JS
from aresdb_tpu.query.aql import AQLQuery as JAQLQuery
from aresdb_tpu_torch.query import composite as TC
from aresdb_tpu_torch.query import sql as TS
from aresdb_tpu_torch.query.aql import AQLQuery as TAQLQuery
from tests.test_composite import COMPOSITE_SUBQUERY, COMPOSITE_WITH
from tests.test_torch_service import (CITIES, NOW, TRIPS, _services,
                                      _small_batches)

PARSED = {
    "reference example": (
        "SELECT count(*) AS value FROM trips WHERE status='completed' AND "
        'aql_time_filter(request_at, "24 hours ago", "this quarter-hour", '
        'America/New_York) GROUP BY aql_time_bucket_hour(request_at, "", '
        "America/New_York)"),
    "join": ("SELECT sum(fare) FROM trips JOIN cities AS c ON c.id = city_id "
             "GROUP BY c.name"),
    "non-agg": "SELECT city_id, fare FROM trips WHERE fare > 10 LIMIT 5",
    "order by and aliases": (
        "SELECT status AS s, count(*) AS cnt FROM trips GROUP BY status "
        "ORDER BY cnt DESC LIMIT 10"),
    "numeric bucket": ("SELECT count(*) FROM trips "
                       "GROUP BY aql_numeric_bucket_bucket_width(fare, 5.0)"),
    "aql_now": ("SELECT count(*) FROM trips WHERE "
                "aql_now(request_at, 1600000000)"),
    "words inside literals": ("SELECT count(*) FROM t WHERE "
                              "name = 'with distinct'"),
    "with flattens": ("WITH t1 AS (SELECT count(*) AS c, city_id FROM trips "
                      "WHERE status='completed' GROUP BY city_id) "
                      "SELECT city_id, c FROM t1"),
    "from subquery flattens": (
        "SELECT s FROM (SELECT sum(fare) AS s, status FROM trips "
        "WHERE fare > 2 GROUP BY status) LIMIT 10"),
    "subquery star": ("SELECT * FROM (SELECT avg(fare) AS a, city_id "
                      "FROM trips GROUP BY city_id)"),
    "outer where and order by": (
        "SELECT c FROM (SELECT count(*) AS c, status FROM trips "
        "GROUP BY status ORDER BY status) WHERE aql_now(request_at, '99') "
        "ORDER BY c DESC"),
    "with time filter and sorts": (
        "WITH t1 AS (SELECT count(*) AS c, status FROM trips WHERE "
        'aql_time_filter(request_at, "-1d", "now", null) '
        "GROUP BY status ORDER BY status) SELECT c FROM t1"),
    "unselected measure supports": (
        "WITH t1 AS (SELECT count(*) AS c, sum(fare) AS s, status "
        "FROM trips GROUP BY status) SELECT status, c FROM t1"),
    "group by of an aliased select": (
        "SELECT city_id AS c, fare FROM (SELECT city_id, fare FROM trips) "
        "GROUP BY city_id"),
    "top-level or": (
        "SELECT count(*) AS completed_trips FROM trips "
        "WHERE status='completed' AND NOT status = 'cancelled' "
        "OR marketplace='agora' GROUP BY status"),
    "wildcard": "SELECT field1, * FROM trips LIMIT 10",
    "composite with": COMPOSITE_WITH,
    "composite subquery": COMPOSITE_SUBQUERY,
}

REFUSED = {
    "delete": "DELETE FROM trips",
    "two group bys": ("SELECT count(*), sum(fare) FROM t GROUP BY x "
                      "GROUP BY y"),
    "having": "SELECT count(*) FROM t GROUP BY c HAVING count(*) > 5",
    "recursive": ("WITH RECURSIVE x AS (SELECT count(*) FROM t) "
                  "SELECT c FROM x"),
    "distinct": "SELECT DISTINCT c FROM t",
    "from differs": (
        "WITH a AS (SELECT count(*) AS c, x FROM t GROUP BY x), "
        "b AS (SELECT count(*) AS d, x FROM u GROUP BY x) "
        "SELECT c, d FROM a, b"),
    "group by differs": (
        "WITH a AS (SELECT count(*) AS c, x FROM t GROUP BY x), "
        "b AS (SELECT count(*) AS d, y FROM t GROUP BY y) "
        "SELECT c, d FROM a, b"),
    "outer group by": ("WITH a AS (SELECT count(*) AS c, x FROM t GROUP BY "
                       "x) SELECT c FROM a GROUP BY x"),
    "unknown identifier": ("WITH a AS (SELECT count(*) AS c FROM t) "
                           "SELECT c FROM zz"),
    "duplicate identifier": (
        "WITH a AS (SELECT count(*) AS c FROM t), a AS "
        "(SELECT count(*) AS c FROM t) SELECT c FROM a"),
    "nested subquery": ("SELECT c FROM (SELECT c FROM (SELECT count(*) AS c "
                        "FROM t))"),
    "inner limit": "SELECT c FROM (SELECT count(*) AS c FROM t LIMIT 5)",
    "unresolved column": "SELECT zz FROM (SELECT count(*) AS c FROM t)",
    "nested with": (
        "WITH m1 (Requested) AS (With m (Requested) AS (SELECT count(*) AS "
        "Requested FROM trips) SELECT Requested FROM m) "
        "SELECT Requested FROM m1;"),
    "natural join in a with body": (
        "WITH m1 (Requested) AS (SELECT count(*) AS Requested FROM trips), "
        "m2 (Completed) AS (SELECT count(*) AS Completed FROM trips "
        "NATURAL LEFT JOIN m1) "
        "SELECT Completed, Requested FROM m1 NATURAL LEFT JOIN m2;"),
    "identifier in an expression": (
        "WITH m1 (avg_fare) AS (SELECT avg(fare) AS avg_fare FROM trips) "
        "SELECT fare FROM trips WHERE fare > m1.avg_fare;"),
    "empty": "",
    "only a semicolon": "   ;  ",
    "column alias count": ("WITH m1 (A, B, C) AS (SELECT count(*) FROM t "
                           "GROUP BY s) SELECT A FROM m1"),
    "composite group bys differ": (
        "WITH m1 (A) AS (SELECT count(*) FROM t GROUP BY s), "
        "m2 (B) AS (SELECT count(*) FROM t GROUP BY c) "
        "SELECT A, B FROM m1 NATURAL LEFT JOIN m2"),
    "tables mixed with subqueries": (
        "SELECT A FROM (SELECT count(*) AS A FROM t GROUP BY s) "
        "AS m1 NATURAL LEFT JOIN t2"),
    "unknown output column": ("WITH m1 (A) AS (SELECT count(*) FROM t "
                              "GROUP BY s) SELECT bogus FROM m1"),
}


@pytest.mark.parametrize("stmt", PARSED.values(), ids=PARSED.keys())
def test_sql_parses_as_in_the_jax_package(stmt):
    assert TS.parse_sql(stmt).to_json() == JS.parse_sql(stmt).to_json()


@pytest.mark.parametrize("stmt", REFUSED.values(), ids=REFUSED.keys())
def test_sql_is_refused_as_in_the_jax_package(stmt):
    with pytest.raises(JS.SQLParseError) as want:
        JS.parse_sql(stmt)
    with pytest.raises(TS.SQLParseError) as got:
        TS.parse_sql(stmt)
    assert str(got.value) == str(want.value)


def _qd():
    return {"table": "trips",
            "dimensions": [{"sqlExpression": "city_id"}],
            "measures": [
                {"sqlExpression": "count(*)", "alias": "Total"},
                {"sqlExpression": "count(*)", "alias": "Completed",
                 "rowFilters": ["status='completed'"]},
                {"sqlExpression": "Completed/Total", "alias": "rate"}]}


def _supporting():
    return {"table": "trips",
            "dimensions": [{"sqlExpression": "city_id"}],
            "measures": [{"sqlExpression": "Completed/Total", "alias": ""}],
            "supportingMeasures": [
                {"sqlExpression": "count(*)", "alias": "Total"},
                {"sqlExpression": "count(*)", "alias": "Completed",
                 "rowFilters": ["status='completed'"]}]}


@pytest.mark.parametrize("qd,trees", [
    (_qd(), [{"1": 6.0, "2": 3.0, "NULL": 1.0}, {"1": 4.0, "2": 1.0}]),
    (_qd(), [{"1": 0.0}, {"1": 2.0}]),
    (_supporting(), [{"1": 6.0}, {"1": 4.0}]),
], ids=["joins and derives", "zero division", "supporting measures"])
def test_composite_split_and_combine_as_in_the_jax_package(qd, trees):
    got = TC.split_query(qd)
    want = JC.split_query(qd)
    assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
    # derived expressions are each package's own AST classes
    assert [(a, str(e)) for a, e in got[2]] == \
        [(a, str(e)) for a, e in want[2]]
    _, aliases, derived, visible = got
    assert TC.combine(qd, aliases, derived, trees, visible) == \
        JC.combine(qd, want[1], want[2], trees, want[3])


@pytest.mark.parametrize("qd,match", [
    (dict(_qd(), measures=_qd()["measures"][:2] + [
        {"sqlExpression": "Completed/Nope", "alias": "rate"}]),
     "not an aggregate measure"),
    ({"table": "t", "dimensions": [],
      "measures": [{"sqlExpression": "a/b"}, {"sqlExpression": "a*2"}]},
     "at least one"),
], ids=["unknown alias", "no aggregate"])
def test_composite_is_refused_as_in_the_jax_package(qd, match):
    with pytest.raises(JC.CompositeError, match=match) as want:
        JC.split_query(qd)
    with pytest.raises(TC.CompositeError) as got:
        TC.split_query(qd)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def small():
    return _services([TRIPS, CITIES], _small_batches())


WITH_TOTAL_DONE = f"""
WITH m1 (Total) AS (SELECT count(*) AS Total FROM trips
    WHERE aql_time_filter(request_at, "72 hours ago", "now", NULL)
      AND aql_now(request_at, {NOW})
    GROUP BY city_id),
m2 (Done) AS (SELECT count(*) AS Done FROM trips
    WHERE aql_time_filter(request_at, "72 hours ago", "now", NULL)
      AND aql_now(request_at, {NOW}) AND status='completed'
    GROUP BY city_id)
"""

STATEMENTS = {
    "count with filter": ("SELECT count(*) FROM trips WHERE "
                          f"status='completed' AND aql_now(request_at, {NOW})"),
    "sum joined by name": ("SELECT sum(fare) FROM trips JOIN cities AS c ON "
                           f"c.id = city_id WHERE aql_now(request_at, {NOW}) "
                           "GROUP BY c.name"),
    "no-dims sum": f"SELECT sum(fare) FROM trips WHERE aql_now(request_at, {NOW})",
    "order by limit": ("SELECT status AS s, count(*) AS cnt FROM trips "
                       f"WHERE aql_now(request_at, {NOW}) GROUP BY status "
                       "ORDER BY cnt DESC LIMIT 2"),
    "listing": (f"SELECT city_id, fare FROM trips WHERE fare > 5 AND "
                f"aql_now(request_at, {NOW}) LIMIT 4"),
    "numeric bucket": ("SELECT count(*) FROM trips WHERE "
                       f"aql_now(request_at, {NOW}) GROUP BY "
                       "aql_numeric_bucket_bucket_width(fare, 5.0)"),
    "with flattens": ("WITH t1 AS (SELECT count(*) AS c, status FROM trips "
                      f"WHERE aql_now(request_at, {NOW}) GROUP BY status) "
                      "SELECT status, c FROM t1"),
    "composite": (WITH_TOTAL_DONE + "SELECT Done, Total, Done/Total AS rate "
                  "FROM m1 NATURAL LEFT JOIN m2"),
    "supporting measures": (WITH_TOTAL_DONE + "SELECT Done/Total "
                            "FROM m1 NATURAL LEFT JOIN m2"),
    "unknown column": f"SELECT sum(nope) FROM trips WHERE aql_now(request_at, {NOW})",
    "parse error": "SELECT count(*) FROM t GROUP BY c HAVING count(*) > 5",
}


@pytest.mark.parametrize("stmt", STATEMENTS.values(), ids=STATEMENTS.keys())
def test_handle_sql_answers_as_the_jax_package(small, stmt):
    jr, tr = (svc.handle_sql({"queries": [stmt], "verbose": True})
              for svc in small)
    assert tr["results"] == jr["results"]
    assert tr.get("errors") == jr.get("errors")
    # verbose returns the per-stage stats of a single-measure statement
    assert [c is None for c in tr["context"]] == \
        [c is None for c in jr["context"]]


def test_composite_aql_and_handle_query(small):
    """A composite AQL query through handle_aql and handle_query: one
    engine run per measure, joined by city, the derived rate on the
    host."""
    qd = dict(_qd(), now=NOW, timeFilter={
        "column": "request_at", "from": "72 hours ago", "to": "now"})
    jr, tr = (svc.handle_aql({"queries": [qd]}) for svc in small)
    assert "errors" not in tr, tr.get("errors")
    assert tr == jr
    assert tr["results"][0]["1"] == {"Total": 6.0, "Completed": 4.0,
                                     "rate": 4.0 / 6.0}
    assert small[1].handle_query(TAQLQuery.from_json(qd)) == \
        small[0].handle_query(JAQLQuery.from_json(qd)) == tr["results"][0]
    one = dict(qd, measures=qd["measures"][:1])
    assert small[1].handle_query(TAQLQuery.from_json(one)) == \
        small[0].handle_query(JAQLQuery.from_json(one))


def test_alias_shadowing_as_in_the_jax_package(small):
    """WITH statements whose output aliases shadow column names, other
    aliases and the named-query identifiers (tests/test_composite.py's
    fuzz): both packages bind and answer alike."""
    rng = np.random.RandomState(11)
    alias_pool = ["fare", "city_id", "Total", "m1", "m2", "X", "status"]
    for _ in range(6):
        a1, a2 = rng.choice(alias_pool, 2, replace=False)
        w = (f"WITH m1 ({a1}) AS (SELECT count(*) AS {a1} FROM trips "
             f"WHERE aql_now(request_at, {NOW}) GROUP BY status), "
             f"m2 ({a2}) AS (SELECT count(*) AS {a2} FROM trips "
             f"WHERE aql_now(request_at, {NOW}) AND status='completed' "
             f"GROUP BY status) SELECT {a1}, {a2}, {a2}/{a1} AS rate "
             f"FROM m1 NATURAL LEFT JOIN m2")
        jr, tr = (svc.handle_sql({"queries": [w]}) for svc in small)
        assert "errors" not in tr, (w, tr.get("errors"))
        assert tr == jr, w
