"""The port's client (`client/connector.py`, `client/query.py`) against the
JAX package's.

`Connector.build_batch` and `insert_columns` must build the same wire
bytes from the same rows in both packages (the upsert's arrival time
frozen), over a schema with every scalar type, enums (case-insensitive,
auto-expanded and not), arrays given as lists and as JSON strings, HLL
columns and update modes, with rows made from a seed with numpy; rows
with a null primary key, time or scalar enum are abandoned alike, and
every `ConnectorError` of tests/test_connector.py is raised alike. Then
each package's Connector loads the same rows into its own daemon (the
port's on the CPU) over HTTP, and `QueryClient` must get equal AQL, SQL
and HLL answers from both.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch_daemons as D
from aresdb_tpu.client.connector import Connector as JaxConnector
from aresdb_tpu.client.connector import ConnectorError as JaxConnectorError
from aresdb_tpu.client.query import QueryClient as JaxQueryClient
from aresdb_tpu.common.schema import Table as JaxTable
from aresdb_tpu_torch.client import Connector as PortConnector
from aresdb_tpu_torch.client import connector as port_connector
from aresdb_tpu_torch.client.connector import ConnectorError
from aresdb_tpu_torch.client.query import QueryClient
from aresdb_tpu_torch.common import upsert_batch as UB
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.common.upsert_batch import (UPDATE_FORCE_OVERWRITE,
                                                  UPDATE_OVERWRITE_NOT_NULL,
                                                  UPDATE_WITH_ADDITION,
                                                  UPDATE_WITH_MAX,
                                                  UpsertBatch)

NOW = 1_600_000_000
N_ROWS = 300
STATUSES = ["completed", "canceled", "rejected"]
SCHEMA = {
    "name": "conn_t",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "id", "type": "Uint32"},
        {"name": "flag", "type": "Bool"},
        {"name": "i8", "type": "Int8"},
        {"name": "u8", "type": "Uint8"},
        {"name": "i16", "type": "Int16"},
        {"name": "u16", "type": "Uint16"},
        {"name": "i32", "type": "Int32"},
        {"name": "i64", "type": "Int64"},
        {"name": "fare", "type": "Float32"},
        {"name": "status", "type": "SmallEnum"},
        {"name": "city", "type": "BigEnum", "caseInsensitive": True},
        {"name": "fixed", "type": "SmallEnum", "disableAutoExpand": True},
        {"name": "rider", "type": "UUID"},
        {"name": "pickup", "type": "GeoPoint"},
        {"name": "tags", "type": "ArrayInt32"},
        {"name": "labels", "type": "ArraySmallEnum"},
        {"name": "rider_hll", "type": "UUID",
         "hllConfig": {"isHLLColumn": True}},
        {"name": "i32_hll", "type": "Int32",
         "hllConfig": {"isHLLColumn": True}},
        {"name": "i64_hll", "type": "Int64",
         "hllConfig": {"isHLLColumn": True}},
    ],
    "primaryKeyColumns": [1], "archivingSortColumns": [4],
    "isFactTable": True,
    "config": {"batchSize": 128, "recordRetentionInDays": 0},
}
COLUMNS = [c["name"] for c in SCHEMA["columns"]]
# the daemons' table: the HLL columns left out, since both daemons refuse
# the Uint32 values a connector sends for them (test_an_hll_column_...)
SERVED = dict(SCHEMA, columns=[c for c in SCHEMA["columns"]
                               if "hllConfig" not in c])
SERVED_COLUMNS = [c["name"] for c in SERVED["columns"]]
DIM = {"name": "conn_dim", "columns": [{"name": "id", "type": "Uint16"},
                                       {"name": "kind", "type": "SmallEnum"}],
       "primaryKeyColumns": [0], "isFactTable": False,
       "config": {"batchSize": 64}}


def _rows(seed: int, n: int = N_ROWS, nulls: bool = True) -> list:
    """n rows over every column, from `seed`: a tenth of the optional
    values null, arrays alternately lists and JSON strings, enum cases in
    mixed case for the case-insensitive column, `fixed` partly unseen."""
    rng = np.random.RandomState(seed)

    def maybe(v):
        return None if nulls and rng.rand() < 0.1 else v

    rows = []
    for i in range(n):
        tags = [int(x) for x in rng.randint(-50, 50, rng.randint(0, 4))]
        if rng.rand() < 0.2:
            tags.append(None)
        labels = [str(rng.choice(STATUSES)) for _ in range(rng.randint(0, 3))]
        lat, lng = rng.uniform(-80, 80), rng.uniform(-170, 170)
        rows.append([
            int(NOW - 1 - rng.randint(0, 20 * 3600)),
            i + 1,
            maybe(bool(rng.rand() < 0.5)),
            maybe(int(rng.randint(-128, 128))),
            maybe(str(rng.randint(0, 256))),
            maybe(int(rng.randint(-32768, 32768))),
            maybe(int(rng.randint(0, 65536))),
            maybe(int(rng.randint(-2**31, 2**31 - 1))),
            maybe(int(rng.randint(-2**62, 2**62))),
            maybe(float(np.float32(rng.rand() * 50))),
            maybe(str(rng.choice(STATUSES))),
            maybe(str(rng.choice(["SF", "sf", "NYC", "nyc", "LA"]))),
            maybe(str(rng.choice(["a", "b", "unseen"]))),
            maybe("%08x-%04x-%04x-%04x-%012x" % tuple(
                int(x) for x in rng.randint(0, 2**16, 5) * [1, 1, 1, 1, 7])),
            maybe(f"Point({lng:.6f} {lat:.6f})"),
            maybe(tags if i % 2 else json.dumps(tags)),
            maybe(labels if i % 2 else json.dumps(labels)),
            maybe("%032x" % int(rng.randint(0, 2**62))),
            maybe(int(rng.randint(-2**31, 2**31 - 1))),
            maybe(int(rng.randint(-2**62, 2**62))),
        ])
    return rows


class _Schema:
    """A connector's schema cache without a server (tests/test_connector.py
    _FakeSchemaCache): `fixed` knows "a" and "b"; other enums start empty
    and extend as the server would."""

    def __init__(self, table_cls, table_json):
        self._table = table_cls.from_json(table_json)
        self._enums = {"fixed": {"a": 0, "b": 1}}

    def table(self, name):
        return self._table

    def enum_dict(self, table_name, column):
        return dict(self._enums.get(column, {}))

    def extend_enum(self, table_name, column, cases):
        d = self._enums.setdefault(column, {})
        return [d.setdefault(c, len(d)) for c in cases]


class _Session:
    """Records the bodies a connector posts; answers like the daemon."""

    def __init__(self):
        self.posted = []

    def post(self, url, data=None, headers=None, **kw):
        self.posted.append((url, data, headers))
        return _Answer()


class _Answer:
    status_code = 200
    text = ""

    def json(self):
        return {"inserted": 1, "updated": 0}


def _offline(cls, table_cls, table_json=SCHEMA):
    c = cls.__new__(cls)
    c.host, c.port, c.session = "x", 0, _Session()
    c.schema = _Schema(table_cls, table_json)
    return c


def _pair(table_json=SCHEMA):
    return (_offline(JaxConnector, JaxTable, table_json),
            _offline(PortConnector, Table, table_json))


@pytest.fixture
def frozen(monkeypatch):
    """The upsert's arrival time (upsert_batch's time.time) at NOW."""
    monkeypatch.setattr(UB.time, "time", lambda: NOW)


def _build_both(columns, rows, modes=None, table_json=SCHEMA):
    jax, port = _pair(table_json)
    want = jax.build_batch(table_json["name"], columns, rows, modes)
    got = port.build_batch(table_json["name"], columns, rows, modes)
    return want, got, port


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_build_batch_bytes_are_identical_over_every_type(frozen, seed):
    want, got, port = _build_both(COLUMNS, _rows(seed))
    assert got == want
    batch = UpsertBatch(got)
    assert batch.num_rows == N_ROWS
    # the case-insensitive column extended with lower-case cases only,
    # `fixed`'s unseen case not at all
    assert sorted(port.schema._enums["city"]) == ["la", "nyc", "sf"]
    assert port.schema._enums["fixed"] == {"a": 0, "b": 1}


@pytest.mark.parametrize("columns", [
    ["request_at", "id", "fare"],
    ["id", "request_at", "status", "labels"],
    ["request_at", "id", "rider_hll", "i32_hll", "i64_hll"],
    ["request_at", "id", "tags", "pickup", "rider"],
], ids=["numeric", "enums_reordered", "hll", "arrays_and_pairs"])
def test_build_batch_bytes_are_identical_over_a_subset(frozen, columns):
    pos = [COLUMNS.index(c) for c in columns]
    rows = [[r[i] for i in pos] for r in _rows(7)]
    want, got, _ = _build_both(columns, rows)
    assert got == want


@pytest.mark.parametrize("modes", [
    [UPDATE_OVERWRITE_NOT_NULL] * 4,
    [UPDATE_OVERWRITE_NOT_NULL, UPDATE_FORCE_OVERWRITE,
     UPDATE_WITH_ADDITION, UPDATE_WITH_MAX],
], ids=["overwrite", "addition_and_max"])
def test_update_modes_travel_alike(frozen, modes):
    columns = ["request_at", "id", "fare", "i32"]
    pos = [COLUMNS.index(c) for c in columns]
    rows = [[r[i] for i in pos] for r in _rows(3)]
    want, got, _ = _build_both(columns, rows, modes)
    assert got == want


@pytest.mark.parametrize("bad", ["pk", "time", "enum"])
def test_rows_with_a_null_key_time_or_enum_are_abandoned_alike(frozen, bad):
    columns = ["request_at", "id", "status", "fare"]
    rows = [[NOW - 10, 1, "completed", 1.5], [NOW - 20, 2, "canceled", 2.5]]
    if bad == "pk":
        rows.insert(1, [NOW - 30, None, "completed", 3.5])
    elif bad == "time":
        rows.insert(1, [None, 3, "completed", 3.5])
    else:
        rows.insert(1, [NOW - 30, 3, 7, 3.5])   # a scalar enum not a string
    want, got, _ = _build_both(columns, rows)
    assert got == want
    assert UpsertBatch(got).num_rows == 2


def test_an_unseen_case_of_a_fixed_enum_is_rank_0_alike(frozen):
    columns = ["request_at", "id", "fixed"]
    rows = [[NOW - 1, 1, "b"], [NOW - 2, 2, "unseen"]]
    want, got, port = _build_both(columns, rows)
    assert got == want
    batch = UpsertBatch(got)
    col = batch.columns[2]
    assert [col.get_value(r) for r in range(2)] == [1, 0]


# every ConnectorError case of tests/test_connector.py, and the other
# refusals of build_batch and insert_columns
ERRORS = {
    "update mode on the primary key": (
        ["request_at", "id"], [[NOW, 1]], [0, UPDATE_WITH_ADDITION],
        "only supports overwrite"),
    "update mode on an enum": (
        ["request_at", "id", "status"], [[NOW, 1, "completed"]],
        [0, 0, UPDATE_WITH_ADDITION], "only supports overwrite"),
    "missing primary key column": (["request_at"], [[NOW]], None,
                                   "primary key"),
    "missing time column": (["id"], [[1]], None, "time column"),
    "no columns": ([], [], None, "no columns"),
    "unknown column": (["request_at", "id", "nope"], [[NOW, 1, 2]], None,
                       "unknown column"),
    "row of another length": (["request_at", "id"], [[NOW, 1, 2]], None,
                              "has 3 values"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_connector_errors_are_raised_alike(case):
    columns, rows, modes, match = ERRORS[case]
    jax, port = _pair()
    with pytest.raises(JaxConnectorError, match=match) as want:
        jax.build_batch("conn_t", columns, rows, modes)
    with pytest.raises(ConnectorError, match=match) as got:
        port.build_batch("conn_t", columns, rows, modes)
    assert str(got.value) == str(want.value)


def test_an_hll_value_of_another_type_is_refused_alike():
    table = dict(SCHEMA, columns=SCHEMA["columns"][:2] + [
        {"name": "f_hll", "type": "Float32",
         "hllConfig": {"isHLLColumn": True}}])
    jax, port = _pair(table)
    with pytest.raises(JaxConnectorError, match="fast hll") as want:
        jax.build_batch("conn_t", ["request_at", "id", "f_hll"],
                        [[NOW, 1, 2.5]])
    with pytest.raises(ConnectorError, match="fast hll") as got:
        port.build_batch("conn_t", ["request_at", "id", "f_hll"],
                         [[NOW, 1, 2.5]])
    assert str(got.value) == str(want.value)


def test_hll_values_equal_the_jax_packages():
    from aresdb_tpu.client import connector as jax_connector
    from aresdb_tpu_torch.common import data_types as mdt

    rng = np.random.RandomState(5)
    for dtype, values in (
            (mdt.Int32, rng.randint(-2**31, 2**31 - 1, 200).tolist()),
            (mdt.Uint32, rng.randint(0, 2**32 - 1, 200).tolist()),
            (mdt.Int64, rng.randint(-2**62, 2**62, 200).tolist()),
            (mdt.UUID, ["%032x" % v
                        for v in rng.randint(0, 2**62, 200).tolist()])):
        want = [jax_connector._compute_hll_value(dtype, v) for v in values]
        got = [port_connector._compute_hll_value(dtype, v) for v in values]
        assert got == want, dtype


def _columns(seed: int, n: int):
    rng = np.random.RandomState(seed)
    cols = {"request_at": (NOW - 1 - rng.randint(0, 3600, n))
            .astype(np.uint32),
            "id": np.arange(1, n + 1, dtype=np.uint32),
            "status": rng.randint(0, 3, n).astype(np.uint8),
            "fare": (rng.rand(n) * 50).astype(np.float32)}
    return cols, {"fare": rng.rand(n) > 0.1}


def test_insert_columns_bytes_are_identical(frozen):
    cols, validity = _columns(0, 1000)
    jax, port = _pair()
    want = jax.insert_columns("conn_t", cols, validity, shard_id=3)
    got = port.insert_columns("conn_t", cols, validity, shard_id=3)
    assert got == want == {"inserted": 1, "updated": 0}
    (jurl, jbody, jheaders), = jax.session.posted
    (url, body, headers), = port.session.posted
    assert (url, headers) == (jurl, jheaders)
    assert url.endswith("/data/conn_t/3")
    assert body == jbody


@pytest.mark.parametrize("case", ["unknown column", "length mismatch",
                                  "no columns"])
def test_insert_columns_errors_are_raised_alike(case):
    cols, _ = _columns(1, 10)
    if case == "unknown column":
        cols["nope"] = cols["fare"]
    elif case == "length mismatch":
        cols["fare"] = cols["fare"][:5]
    else:
        cols = {}
    jax, port = _pair()
    with pytest.raises(JaxConnectorError) as want:
        jax.insert_columns("conn_t", cols)
    with pytest.raises(ConnectorError) as got:
        port.insert_columns("conn_t", cols)
    assert str(got.value) == str(want.value)
    assert not port.session.posted


# -- both daemons, each fed by its own package's Connector over HTTP --

def _q(measure, dims=(), filters=(), table="conn_t"):
    return {"table": table, "now": NOW,
            "measures": [{"sqlExpression": measure,
                          "rowFilters": list(filters)}],
            "dimensions": [{"sqlExpression": d} for d in dims]}


AQL = {
    "count": _q("count(*)"),
    "sum by status": _q("sum(fare)", ["status"]),
    "count by city": _q("count(*)", ["city"]),
    "max i16 by fixed": _q("max(i16)", ["fixed"]),
    "sum i32 by flag": _q("sum(i8)", ["flag"]),
    "tags length": _q("count(*)", ["length(tags)"]),
    "tags contains": _q("count(*)", filters=["contains(tags, 7)"]),
    "labels by first": _q("count(*)", ["element_at(labels, 0)"]),
    "hll of id": _q("countdistincthll(id)", ["status"]),
    "hll of a uuid": _q("countdistincthll(rider)"),
    "join": {**_q("count(*)", ["d.kind"]),
             "joins": [{"table": "conn_dim", "alias": "d",
                        "conditions": ["d.id = u16 % 8"]}]},
    "unknown column": _q("sum(nope)"),
    "columnar count": _q("count(*)", ["status"], table="conn_cols"),
    # a live batch in which no row has a value of the array column: both
    # packages answer "not staged" (ROADMAP section 3)
    "columnar tags length": _q("count(*)", ["length(tags)"],
                               table="conn_cols"),
}
SQL = {
    "count": f"SELECT count(*) FROM conn_t WHERE aql_now(request_at, {NOW})",
    "by status": "SELECT status, sum(fare) FROM conn_t WHERE "
                 f"aql_now(request_at, {NOW}) GROUP BY status",
}
HLL = ("hll of id", "hll of a uuid")


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(answers by side, insert stats by side): each daemon fed by its
    own package's Connector, then asked through its QueryClient."""
    rows = _rows(11, 600)
    answers, stats = {}, {}
    with D.daemons(tmp_path_factory, NOW) as ports:
        for side, port in ports.items():
            Conn, Client = ((JaxConnector, JaxQueryClient) if side == "jax"
                            else (PortConnector, QueryClient))
            conn = Conn("localhost", port)
            conn.create_table(SERVED)
            conn.create_table(DIM)
            conn.create_table(dict(SCHEMA, name="conn_hll"))
            got = [conn.insert("conn_t", SERVED_COLUMNS,
                               [r[:len(SERVED_COLUMNS)]
                                for r in rows[lo:lo + 200]])
                   for lo in range(0, len(rows), 200)]
            # updates of the first rows: fare added, status overwritten
            got.append(conn.insert(
                "conn_t", ["request_at", "id", "status", "fare"],
                [[r[0], r[1], "rejected", 1.0] for r in rows[:50]],
                update_modes=[0, 0, 0, UPDATE_WITH_ADDITION]))
            got.append(conn.insert("conn_dim", ["id", "kind"],
                                   [[i, STATUSES[i % 3]] for i in range(8)]))
            conn.create_table(dict(SERVED, name="conn_cols"))
            cols, validity = _columns(2, 500)
            got.append(conn.insert_columns("conn_cols", cols, validity))
            stats[side] = got
            client = Client(f"localhost:{port}")
            out = {("aql", k): client.query_aql([q]) for k, q in AQL.items()}
            out[("aql", "several")] = client.query_aql(
                [AQL["count"], AQL["sum by status"]])
            out.update({("sql", k): client.query_sql([s])
                        for k, s in SQL.items()})
            for k in HLL:
                out[("hll", k)] = client.query_hll([AQL[k]])
                out[("hll raw", k)] = client.query_hll([AQL[k]],
                                                       compute=False)
            try:
                conn.insert("conn_hll", COLUMNS, rows[:3])
            except (JaxConnectorError, ConnectorError) as e:
                out[("hll insert", "refused")] = str(e)
            out[("connector aql", "count")] = conn.query_aql(AQL["count"])
            out[("connector sql", "count")] = conn.query_sql(SQL["count"])
            answers[side] = out
    return answers, stats


def test_both_daemons_ingest_alike(loaded):
    _, stats = loaded
    assert stats["port"] == stats["jax"]
    assert sum(s["inserted"] for s in stats["port"]) == 600 + 8 + 500
    assert stats["port"][3]["updated"] == 50


ANSWERS = ([("aql", k) for k in AQL] + [("aql", "several")]
           + [("sql", k) for k in SQL] + [("hll", k) for k in HLL]
           + [("connector aql", "count"), ("connector sql", "count")])


@pytest.mark.parametrize("key", ANSWERS, ids=" ".join)
def test_query_client_answers_alike(loaded, key):
    answers, _ = loaded
    want, got = answers["jax"][key], answers["port"][key]
    D.close(got, want, key)
    if key[1] == "unknown column":
        assert got["errors"] and got["errors"][0]
    elif key[1] == "columnar tags length":
        assert got["errors"] == ["array column 'tags' not staged"]
    elif key[0] != "hll":
        assert "errors" not in got, got
        assert got["results"][0]


def test_an_hll_column_insert_is_refused_alike_by_both_daemons(loaded):
    """The connector sends an HLL column's values as Uint32 (the
    reference's DataTypeForColumn), and both daemons check the batch's
    type against the schema's and refuse it."""
    answers, _ = loaded
    want = answers["jax"][("hll insert", "refused")]
    assert answers["port"][("hll insert", "refused")] == want
    assert "type mismatch" in want


@pytest.mark.parametrize("name", HLL)
def test_raw_hll_registers_are_equal(loaded, name):
    answers, _ = loaded
    (want,), werr = answers["jax"][("hll raw", name)]
    (got,), err = answers["port"][("hll raw", name)]
    assert err == werr == [None]
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(want, sort_keys=True, default=repr)


def test_query_hll_refuses_a_json_answer():
    from aresdb_tpu_torch.client.query import QueryClientError

    class JsonSession:
        def post(self, url, **kw):
            return type("R", (), {
                "headers": {"Content-Type": "application/json"},
                "content": b"{}", "raise_for_status": lambda self: None})()

    client = QueryClient("localhost:1", session=JsonSession())
    with pytest.raises(QueryClientError, match="expected application/hll"):
        client.query_hll([AQL["count"]])
