"""The port's example tools (`cmd/examples.py`, `cmd/example_data.py`)
against the JAX package's.

`gen_arraytest_batches` must give the JAX package's rows. Then each
package's `examples` runs `tables`, `data` and `query` over one dataset
in the tool's documented layout (`chip_smoke.write_examples`: the
battery's trips as ex_trips with time placeholders, B2 and B8 as .aql
and B7 as .sql; the reference integration suite's arraytest table, whose
rows `data` generates, and its array length, contains and element_at
queries) against its own daemon (the port's on the CPU): every answer
must be alike, the battery shapes equal to a numpy oracle, and the array
queries equal to the aligned oracles of
tests/test_integration_goldens.py:84-150.
"""

from __future__ import annotations

import contextlib
import io
import random
import time
import types

import pytest

import chip_smoke as CS
import torch_daemons as D
from aresdb_tpu.cmd import example_data as jax_data
from aresdb_tpu.cmd import examples as jax_examples
from aresdb_tpu_torch.cmd import example_data as port_data
from aresdb_tpu_torch.cmd import examples as port_examples


@pytest.mark.parametrize("now", (1560049867, CS.SERVER_NOW, 1792137016))
def test_gen_arraytest_batches_equals_the_jax_packages(now):
    want = jax_data.gen_arraytest_batches(now)
    got = port_data.gen_arraytest_batches(now)
    assert got == want
    assert [len(b) for b in got] == [1000] * 4
    assert port_data.ARRAYTEST_COLUMNS == jax_data.ARRAYTEST_COLUMNS
    assert [c["name"] for c in CS.ARRAYTEST_SCHEMA_JSON["columns"]] == \
        port_data.ARRAYTEST_COLUMNS


@pytest.mark.parametrize("mark", ("{1d}", "{2h}", "{30m}", " {7d} "))
def test_time_placeholders_draw_alike(mark):
    random.seed(3)
    want = [jax_examples.parse_time_placeholder(mark, CS.SERVER_NOW)
            for _ in range(50)]
    random.seed(3)
    got = [port_examples.parse_time_placeholder(mark, CS.SERVER_NOW)
           for _ in range(50)]
    assert got == want


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """{side: (each subcommand's output, the query answers, the arraytest
    rows' now)}: the examples tool of each package against its daemon."""
    root = tmp_path_factory.mktemp("dataset")
    rows = CS.write_examples(str(root / "ds"), CS.server_queries(), 0)
    out = {}
    # each package's `data` reads the wall clock for its rows' `now`, and
    # the array answers move with it (the window's hour, the UTC days):
    # one `now` for both, at or before the wall, so never a future row
    now_of_data = int(time.time())
    with D.daemons(tmp_path_factory, None) as ports, \
            pytest.MonkeyPatch.context() as mp:
        for tool in (jax_examples, port_examples):
            mp.setattr(tool, "time",
                       types.SimpleNamespace(time=lambda: now_of_data))
        for side, port in ports.items():
            tool = jax_examples if side == "jax" else port_examples
            texts, now = {}, None
            D.set_clocks(None)   # `data` times its rows by the wall clock
            for cmd in ("tables", "data", "query"):
                if cmd == "query":
                    now = CS.arraytest_now(port)
                    D.set_clocks(now)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    tool.main([cmd, "--dataset", str(root / "ds"),
                               "--host", "localhost", "--port", str(port)])
                texts[cmd] = buf.getvalue()
            out[side] = (texts, CS.examples_answers(texts["query"]), now)
    return out, rows


def test_tables_and_data_print_alike(ran):
    out, _ = ran
    for cmd in ("tables", "data"):
        assert out["port"][0][cmd] == out["jax"][0][cmd], cmd
    assert "arraytest: 4000 rows" in out["port"][0]["data"]
    assert "'inserted': 3000" in out["port"][0]["data"]


QUERY_FILES = [n.rsplit(".", 1)[0] for n in
               sorted(list(CS.EX_QUERIES) + list(CS.ARRAY_QUERIES))]


@pytest.mark.parametrize("name", QUERY_FILES)
def test_every_query_document_answers_alike(ran, name):
    out, rows = ran
    want, got = out["jax"][1][name], out["port"][1][name]
    D.close(got, want, name)
    assert "errors" not in got, got
    if name.startswith("array_"):
        assert got == {"results": [CS.arraytest_oracles(out["port"][2])[
            name]]}
    else:
        shape = CS.EX_QUERIES[next(f for f in CS.EX_QUERIES
                                   if f.startswith(name))]
        CS.check_server(shape, got["results"][0], rows)


def test_the_array_oracles_see_both_days(ran):
    out, _ = ran
    oracles = CS.arraytest_oracles(out["port"][2])
    assert len(oracles["array_length"]) in (2, 3)   # the window's days
    assert sum(sum(d.values()) for d in oracles["array_length"].values()) \
        > 1000
