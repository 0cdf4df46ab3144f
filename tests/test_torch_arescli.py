"""The port's `cmd/arescli.py` against the JAX package's.

Each package's `Shell` talks to its own daemon (the port's on the CPU),
both loaded with the same rows through their own Connector; one list of
statements and commands (the battery's shapes as AQL and SQL, `show`,
`desc`, `connect`, `format`, `timing`, `verbose`, `source`, errors) must
print the same output, with the host:port, the timings and the verbose
stage statistics left out. `render_table` and `flatten_result` must give
what the JAX package's give.
"""

from __future__ import annotations

import io
import json
import re

import numpy as np
import pytest

import chip_smoke as CS
import torch_daemons as D
from aresdb_tpu.client.connector import Connector as JaxConnector
from aresdb_tpu.cmd import arescli as jax_cli
from aresdb_tpu_torch.client import Connector
from aresdb_tpu_torch.cmd import arescli as port_cli

NOW = CS.SERVER_NOW
N_ROWS = 500
TRIPS = dict(CS.SERVER_TRIPS_JSON, name="cli_trips",
             config={"batchSize": 128, "recordRetentionInDays": 0})


def _renamed(q):
    if isinstance(q, str):
        return q.replace("FROM trips", "FROM cli_trips")
    return json.dumps(dict(q, table="cli_trips"))


SHAPES = {name: _renamed(q) for name, (_, q) in CS.server_queries().items()
          if name != "B5"}


def _statements(source_file: str) -> list:
    sql_now = f"aql_now(request_at, {NOW})"
    return (
        ["show tables", "desc cli_trips", "describe nope", "show configs"]
        + list(SHAPES.values())
        + ["format json", "desc cli_trips"] + list(SHAPES.values())
        + ["format table", "verbose on",
           SHAPES["B1"], f"SELECT count(*) FROM cli_trips WHERE {sql_now};",
           "verbose off", "timing on", SHAPES["B10"], "timing off",
           f"SELECT status, sum(fare) FROM cli_trips WHERE {sql_now} "
           "GROUP BY status",
           "SELECT count(*) FROM nope", "SELEC nothing",
           '{"table": "cli_trips", "measures": []}', "{not json",
           "connect localhost {port}", "show configs",
           f"source {source_file}", "format bogus", "timing maybe", ""])


_HOST_PORT = re.compile(r"(localhost|127\.0\.0\.1)(:|\s+|\"port\": )\d+")
_TIMING = re.compile(r"\(\d+ ms\)")


def _normalized(text: str) -> str:
    text = _HOST_PORT.sub(r"\1\2PORT", text)
    text = re.sub(r'"port": \d+', '"port": PORT', text)
    return _TIMING.sub("(T ms)", text)


def _split_stats(text: str):
    """The output without the verbose statistics' JSON, and the key sets
    of each statistics block."""
    out, keys = [], []
    lines = iter(text.splitlines())
    for line in lines:
        if line.startswith("stats: "):
            block = [line[len("stats: "):]]
            while block[-1] != "}":
                block.append(next(lines))
            keys.append(sorted(json.loads("\n".join(block))))
            out.append("stats: ...")
        else:
            out.append(line)
    return "\n".join(out), keys


@pytest.fixture(scope="module")
def shells(tmp_path_factory):
    """{side: (stdout text, stderr text, answers)}: every statement through
    each package's Shell against its own daemon, one at a time."""
    data = CS.server_rows(N_ROWS, 3)
    src = tmp_path_factory.mktemp("src") / "stmts.sql"
    src.write_text(f"SELECT count(*) FROM cli_trips WHERE aql_now(request_at,"
                   f" {NOW});\nshow tables;\n\nformat json;\n"
                   + SHAPES["B2"] + ";\nexit;\nshow tables;\n")
    out = {}
    with D.daemons(tmp_path_factory, NOW) as ports:
        for side, port in ports.items():
            Conn, cli = ((JaxConnector, jax_cli) if side == "jax"
                         else (Connector, port_cli))
            conn = Conn("localhost", port)
            conn.create_table(TRIPS)
            conn.schema.extend_enum("cli_trips", "status", CS.STATUSES)
            conn.insert_columns(
                "cli_trips",
                {k: data[k] for k in ("request_at", "id", "city_id",
                                      "status", "fare")},
                validity={"fare": data["fare_valid"]})
            so, se = io.StringIO(), io.StringIO()
            shell = cli.Shell("localhost", port, out=so, err=se)
            per = []
            for stmt in _statements(str(src)):
                o0, e0 = len(so.getvalue()), len(se.getvalue())
                keep = shell.dispatch(stmt.replace("{port}", str(port)))
                per.append((keep, so.getvalue()[o0:], se.getvalue()[e0:]))
            out[side] = (so.getvalue(), se.getvalue(), per)
    return out


STMT_IDS = [f"{i}:{s[:40]}" for i, s in enumerate(_statements("F"))]


@pytest.mark.parametrize("i", range(len(STMT_IDS)), ids=STMT_IDS)
def test_each_statement_prints_alike(shells, i):
    want = shells["jax"][2][i]
    got = shells["port"][2][i]
    assert got[0] == want[0]
    w_out, w_keys = _split_stats(_normalized(want[1]))
    g_out, g_keys = _split_stats(_normalized(got[1]))
    assert _numbers_close(g_out, w_out), (g_out[:400], w_out[:400])
    assert _normalized(got[2]) == _normalized(want[2])
    assert len(g_keys) == len(w_keys)


_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


def _numbers_close(a: str, b: str) -> bool:
    """The texts equal but for float sums within the tests' 2^-17
    relative (the packages sum in another order), and so for the width of
    a table's columns."""
    def shape(text):
        return re.sub(r"-+", "-", re.sub(r" +", " ", _NUMBER.sub("#", text)))

    if shape(a) != shape(b):
        return False
    for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b)):
        x, y = float(x), float(y)
        if x != y and abs(x - y) > D.RTOL * max(abs(x), abs(y)):
            return False
    return True


def test_the_whole_session_prints_alike(shells):
    want, got = shells["jax"], shells["port"]
    assert _numbers_close(_split_stats(_normalized(got[0]))[0],
                          _split_stats(_normalized(want[0]))[0])
    assert _normalized(got[1]) == _normalized(want[1])
    assert "error:" in got[1]
    assert "stats: " in got[0]


def test_json_output_equals_the_daemons_answer(shells):
    """Under `format json` a shape prints its result as the daemon
    answers it: B10's counts exactly."""
    stmts = _statements("F")
    start = stmts.index("format json")
    i = start + 2 + list(SHAPES).index("B10")
    printed = json.loads(shells["port"][2][i][1])
    data = CS.server_rows(N_ROWS, 3)
    counts = np.bincount(data["city_id"], minlength=CS.N_CITIES)
    assert printed == {str(c): float(n) for c, n in enumerate(counts) if n}


def test_exit_stops_the_shell_and_source_stops_at_it(shells):
    stmts = _statements("F")
    i = next(k for k, s in enumerate(stmts) if s.startswith("source "))
    keep, out, _ = shells["port"][2][i]
    assert keep is True
    assert out.count("cli_trips") == 1   # `show tables` after exit not run
    assert port_cli.Shell("localhost", 1).dispatch("quit") is False


@pytest.mark.parametrize("seed", range(4))
def test_render_table_and_flatten_result_equal_the_jax_packages(seed):
    rng = np.random.RandomState(seed)

    def tree(depth):
        if depth == 0:
            return float(np.round(rng.rand() * 100, 3))
        return {f"k{int(k)}": tree(depth - 1)
                for k in rng.randint(0, 50, rng.randint(1, 5))}

    result = tree(int(rng.randint(1, 4)))
    rows = port_cli.flatten_result(result)
    assert rows == jax_cli.flatten_result(result)
    headers = [f"col{i}" for i in range(len(rows[0]))]
    assert port_cli.render_table(headers, rows) == \
        jax_cli.render_table(headers, rows)
    assert port_cli.render_table(["a", "bb"], []) == \
        jax_cli.render_table(["a", "bb"], [])
