"""The generators and the numpy reference: a seed gives the same rows,
and the reference equals a loop over them; the frozen encoder gives the
port's bytes; the bfloat16 control fails the sums' limit."""

import calendar
import time

import numpy as np
import pytest

from conftest import TINY
from portbench import bench, wire
from portbench.reference import engine as E

CELLS = ["uber_trips.dash"]
CLOCK = 1_760_000_000


def tiny(cell_name):
    return bench.Cell(cell_name, scale=TINY[cell_name.split(".")[0]])


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_seed_gives_the_same_rows_and_sizes(cell_name):
    cell = tiny(cell_name)
    a = cell.gen.generate(cell.config, 2 ** 31 + 5, CLOCK)
    b = cell.gen.generate(cell.config, 2 ** 31 + 5, CLOCK)
    c = cell.gen.generate(cell.config, 2 ** 31 + 6, CLOCK)
    assert a.now == b.now == c.now and a.cutoff == c.cutoff
    assert len(a.rows) == len(c.rows) and a.n_archived == c.n_archived
    for k in a.rows.columns:
        assert np.array_equal(a.rows.columns[k], b.rows.columns[k])
    assert list(a.upserts()) == list(b.upserts())
    assert any(not np.array_equal(a.rows.columns[k], c.rows.columns[k])
               for k in a.rows.columns)


def test_seeds_past_64_bits_and_negative_give_streams_of_their_own():
    draws = [E.rng_of(s).integers(0, 2 ** 62) for s in
             (0, 1, -1, 2 ** 31 + 1, 2 ** 64 + 1, 2 ** 80)]
    assert len(set(draws)) == len(draws)


def brute(spec, rows, now):
    """The reference's answer by a loop over the rows."""
    lo, hi = E.time_range(spec, now)
    c, out, n = rows.columns, {}, {}
    for i in range(len(rows)):
        t = int(c[rows.time_column][i])
        if not lo <= t < hi:
            continue
        if any(rows.enums.get(f["column"], [None] * 256)[
                int(c[f["column"]][i])] != f["equals"]
               if f["column"] in rows.enums
               else c[f["column"]][i] != f["equals"]
               for f in spec.get("filters", ())):
            continue
        key = []
        for d in spec["dims"]:
            v = c[d["column"]][i]
            if d.get("time") == "hour":
                key.append(time.strftime("%Y-%m-%d %H:00", time.gmtime(
                    t - t % 3600)))
            elif d.get("time") == "day":
                key.append(time.strftime("%Y-%m-%d", time.gmtime(t)))
            elif d.get("time") == "year":
                key.append(str(calendar.timegm(
                    (time.gmtime(t).tm_year, 1, 1, 0, 0, 0))))
            elif "width" in d:
                key.append(str(int(float(v) // d["width"])))
            elif d["column"] in rows.enums:
                key.append(rows.enums[d["column"]][int(v)])
            else:
                key.append(str(int(v)))
        key = tuple(key)
        out.setdefault(key, 0.0)
        n.setdefault(key, [0, 0])
        n[key][0] += 1
        if spec["measure"] == "count":
            out[key] += 1
        else:
            valid = rows.valid.get(spec["column"])
            if valid is None or valid[i]:
                out[key] += float(c[spec["column"]][i])
                n[key][1] += 1
    if spec["measure"] == "avg":
        out = {k: v / n[k][1] for k, v in out.items()}
    return out


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_reference_equals_a_loop_over_the_rows(cell_name):
    cell = bench.Cell(cell_name, scale=dict(
        TINY[cell_name.split(".")[0]], rows_per_day=300))
    dep = cell.gen.generate(cell.config, 7, CLOCK)
    for name, q in cell.queries.items():
        want = brute(q["spec"], dep.rows, dep.now)
        got = E.answer(q["spec"], dep.rows, dep.now)
        assert set(got) == set(want), name
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (name, k)


def test_compare_counts_what_differs():
    spec = {"measure": "sum"}
    want = {("a", "x"): 1.0, ("b", "x"): 2.0}
    assert E.compare(spec, {"a": {"x": 1.0}, "b": {"x": 2.0}}, want) == {
        "group_mismatch": 0, "count_mismatch": 0, "sum_rel_err": 0.0}
    c = E.compare(spec, {"a": {"x": 1.5}, "c": {"x": 2.0}}, want)
    assert c["group_mismatch"] == 2 and c["sum_rel_err"] == 0.5
    c = E.compare({"measure": "count"}, {"a": {"x": 2.0}}, {("a", "x"): 1.0})
    assert c["count_mismatch"] == 1


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 3.1415927, -2.5],
                 np.float32)
    assert E.bf16(x).tolist() == [1.0, 1.0, 1.015625, 3.140625, -2.5]


def test_the_frozen_encoder_gives_the_ports_bytes():
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      build_columnar_upsert)

    cell = tiny("uber_trips.dash")
    dep = cell.gen.generate(cell.config, 3, CLOCK)
    c, v = dep.rows.columns, dep.rows.valid
    n = 777
    mine = wire.encode([(0, wire.Uint32, c["request_at"][:n], None, 0),
                        (1, wire.UUID, c["uuid"][:n], None, 0),
                        (2, wire.Uint16, c["city_id"][:n], None, 0),
                        (3, wire.SmallEnum, c["status"][:n], None, 0),
                        (4, wire.Float32, c["fare"][:n], v["fare"][:n], 0)],
                       n, arrival_time=123)
    theirs = build_columnar_upsert(
        [(0, mdt.Uint32, c["request_at"][:n], None, 0),
         (1, mdt.UUID, c["uuid"][:n], None, 0),
         (2, mdt.Uint16, c["city_id"][:n], None, 0),
         (3, mdt.SmallEnum, c["status"][:n], None, 0),
         (4, mdt.Float32, c["fare"][:n], v["fare"][:n], 0)], n,
        arrival_time=123)
    assert mine == theirs
    batch = UpsertBatch(mine)
    assert batch.num_rows == n


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_bfloat16_control_fails_the_sums_limit(cell_name):
    """The reference on bfloat16 values, put in the port's place, is judged
    as the port's answers are: its sums miss the cell's limit."""
    cell = bench.Cell(cell_name, scale=dict(
        TINY[cell_name.split(".")[0]], rows_per_day=5000))
    dep = cell.gen.generate(cell.config, 21, CLOCK)
    worst = 0.0
    for q in cell.queries.values():
        if q["spec"]["measure"] == "count":
            continue
        want = E.answer(q["spec"], dep.rows, dep.now)
        low = E.answer(q["spec"], dep.rows, dep.now, values_bf16=True)
        nested = {}
        for k, val in low.items():
            d = nested
            for part in k[:-1]:
                d = d.setdefault(part, {})
            d[k[-1]] = val
        worst = max(worst, E.compare(q["spec"], nested, want)["sum_rel_err"])
    assert worst > cell.traffic["limits"]["sum_rel_err"]
