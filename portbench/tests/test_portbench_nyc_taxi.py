"""The nyc_taxi configuration: its generator's sizes and determinism,
the columns the frozen encoder lacks (Int8, Int16, BigEnum, GeoPoint)
read back exactly by the port's decoder, a CPU rehearsal of its cell
that comes out correct, and one with an answer altered that does not;
its generator, reference and readers load nothing of JAX, and the
generator nothing of the port."""

import numpy as np
import pytest

from conftest import TINY_LOAD
from portbench import bench
from portbench.reference import engine as E
from portbench.reference import nyc_taxi as N
from test_portbench_isolation import JAX, loaded
from test_portbench_rehearsal import SEED, alter_answers

CELL = "nyc_taxi.four_queries"
TINY = {"rows_per_day": 3000, "day_stride": 400, "days_held": 6,
        "upsert_rows": 4096, "batchSize": 4096}
CLOCK = 1_760_000_000


def tiny():
    return bench.Cell(CELL, scale=TINY)


def test_the_configuration_holds_the_51_published_columns():
    cfg = bench.Cell(CELL).config
    cols = cfg["table"]["columns"]
    assert len(cols) == 51 and cols[0]["name"] == "pickup_datetime"
    assert [cols[i]["name"] for i in cfg["table"]["primaryKeyColumns"]] == \
        ["trip_id"]
    assert [cols[i]["name"] for i in cfg["table"]["archivingSortColumns"]] \
        == ["cab_type", "passenger_count"]
    types = {c["type"] for c in cols}
    assert {"Int8", "Int16", "BigEnum", "GeoPoint"} <= types
    assert "Float64" not in types
    for c in cols:
        if c["type"].endswith("Enum"):
            n = len(cfg["enums"][c["name"]])
            assert (n > 256) == (c["type"] == "BigEnum"), c
    assert len(N.held_days(cfg)) == cfg["days_held"]
    assert list(cfg["reduced"]) == ["days_held"]


def _body(upsert: bytes) -> bytes:
    """An upsert without its header's arrival time, the second in which
    it was encoded."""
    return upsert[:24] + upsert[28:]


def test_a_seed_gives_the_same_rows_and_sizes():
    cell = tiny()
    a = cell.gen.generate(cell.config, SEED, CLOCK)
    b = cell.gen.generate(cell.config, SEED, CLOCK + 86400)
    c = cell.gen.generate(cell.config, SEED + 1, CLOCK)
    n = TINY["rows_per_day"] * TINY["days_held"]
    assert len(a.rows) == len(c.rows) == n == a.n_archived == c.n_archived
    assert a.cutoff == c.cutoff == E.day_seconds("2014-06-25")
    for k in a.rows.columns:
        assert np.array_equal(a.rows.columns[k], b.rows.columns[k]), k
    assert [_body(u) for u in a.upserts()] == [_body(u) for u in b.upserts()]
    assert any(not np.array_equal(a.rows.columns[k], c.rows.columns[k])
               for k in a.rows.columns)
    t = a.rows.columns["pickup_datetime"]
    assert np.all(np.diff(t.astype(np.int64)) >= 0)
    years = {int(y) for y in t.astype("datetime64[s]").astype(
        "datetime64[Y]").astype(int) + 1970}
    assert years == set(range(2009, 2015))
    ids = a.rows.columns["trip_id"]
    assert len(np.unique(ids)) == n


def test_the_columns_wire_lacks_decode_exactly():
    from aresdb_tpu_torch.common import data_types as dt
    from aresdb_tpu_torch.common.upsert_batch import UpsertBatch

    cell = tiny()
    dep = cell.gen.generate(cell.config, SEED, CLOCK)
    idx = np.arange(len(dep.rows))[::5]
    batch = UpsertBatch(N.encode(cell.config, dep.rows, idx))
    assert batch.num_rows == len(idx)
    seen = set()
    for cid, col in enumerate(batch.columns):
        spec = cell.config["table"]["columns"][cid]
        if spec["type"] not in N.LANES:
            continue
        seen.add(spec["type"])
        assert col.data_type == dt.data_type_from_string(spec["type"])
        want = dep.rows.columns[spec["name"]][idx]
        valid = dep.rows.valid.get(spec["name"])
        if valid is not None:
            assert np.array_equal(col.validity, valid[idx])
            keep = valid[idx].reshape((-1,) + (1,) * (want.ndim - 1))
            want = np.where(keep, want, 0).astype(want.dtype)
        assert col.values.dtype == want.dtype
        assert np.array_equal(col.values, want), spec["name"]
    assert seen == set(N.LANES)


def rehearse(trace=False):
    cell = bench.Cell(CELL, scale=TINY, traffic=TINY_LOAD)
    return bench.run_cell(cell, SEED, 1.5, trace, device="cpu",
                          log=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_rehearses_correct_on_the_cpu(trace):
    out = rehearse(trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert {"sort_exec_ms", "sort_merge_ms", "sort_batch_pct"} <= \
            set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"query_p95_ms", "queries_per_s",
                                       "setup_s"}


def test_an_altered_answer_is_not_correct(monkeypatch):
    alter_answers(monkeypatch)
    out = rehearse()
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limit():
    from portbench import control

    cell = tiny()
    got = control.control(cell, SEED, CLOCK)
    assert got["sum_rel_err"] > cell.traffic["limits"]["sum_rel_err"]


def test_its_modules_load_no_jax_and_the_generator_none_of_the_port():
    readers = ["portbench.metrics.sort_exec_ms",
               "portbench.metrics.sort_merge_ms",
               "portbench.metrics.sort_batch_pct"]
    assert loaded(readers + ["portbench.reference.nyc_taxi"], JAX) == []
    assert loaded(["portbench.reference.nyc_taxi"],
                  JAX + ("aresdb_tpu_torch", "torch")) == []
