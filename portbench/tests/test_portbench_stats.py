"""The benchmark's arithmetic: percentiles, spreads, the roofline's least
time, the union of device intervals and a query's byte count."""

import statistics

import numpy as np
import pytest

from portbench import bench
from portbench import stats as S
from portbench.reference import engine as E


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(3).lognormal(size=137).tolist()
    assert S.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert S.spread(xs) == (q3 - q1) / med


def test_bound_ms_takes_the_larger_bound():
    assert S.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert S.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")


def test_union_gaps_and_cover():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert S.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert S.covered(iv) == 3.0
    assert S.gaps(iv, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]
    assert S.clip(iv, 1.5, 3.2) == [(1.5, 2.0), (3.0, 3.2)]
    assert S.clip_events([("k", 0.0, 2.0), ("m", 5.0, 6.0)], 1.0, 5.5) == \
        [("k", 1.0, 2.0), ("m", 5.0, 5.5)]


def brute_bytes(cell, dep, name):
    """A query's least bytes by a loop over the rows."""
    spec = cell.queries[name]["spec"]
    rows, t = dep.rows, dep.rows.columns[dep.rows.time_column]
    lo, hi = E.time_range(spec, dep.now)
    passing = E.selection(spec, rows, dep.now)
    width = {"request_at": 4, "uuid": 16, "city_id": 2, "status": 1,
             "fare": 4 + 0.125}
    filt = [f["column"] for f in spec.get("filters", ())]
    used = {d["column"] for d in spec["dims"]
            if d["column"] != "request_at" or "time" in d}
    if spec["measure"] != "count":
        used.add(spec["column"])
    total = 0.0
    for i in range(len(rows)):
        if not lo <= t[i] < hi:
            continue
        if passing[i]:
            total += sum(width[c] for c in used | set(filt))
        elif t[i] >= dep.cutoff:       # live: read the filter to reject
            total += sum(int(width[c]) for c in filt)
    groups = len(E.answer(spec, rows, dep.now))
    return total + groups * (4 * len(spec["dims"]) + 8)


@pytest.mark.parametrize("name", ["D1", "D2", "D3", "D4"])
def test_query_bytes_match_a_loop_over_the_rows(name):
    from conftest import TINY

    cell = bench.Cell("uber_trips.dash",
                      scale=dict(TINY["uber_trips"], rows_per_day=400))
    dep = cell.gen.generate(cell.config, 11, 1_760_000_000)
    qb = bench.query_bytes(cell, dep)[name]
    groups = len(E.answer(cell.queries[name]["spec"], dep.rows, dep.now))
    assert bench.bytes_of(qb, groups) == pytest.approx(
        brute_bytes(cell, dep, name))


def test_a_seed_orders_the_dashboards_and_never_moves_a_due_time():
    from portbench import client

    spec = {"dashboards": 5, "refresh_s": 2.0, "queries": ["D1", "D2", "D3"]}
    a = client.schedule(dict(spec, seed=[1, 2]), 10.0, 20.0)
    b = client.schedule(dict(spec, seed=[1, 2]), 10.0, 20.0)
    c = client.schedule(dict(spec, seed=[3, 4]), 10.0, 20.0)
    assert a == b and a != c
    assert sorted(d for d, _ in a) == sorted(d for d, _ in c)
    assert len(a) == 5 * 5 * 3 and all(10.0 <= d < 20.0 for d, _ in a)
    # every 2 s / 5 dashboards a refresh of every panel
    assert sorted({round(d, 9) for d, _ in a})[:3] == [10.0, 10.4, 10.8]


def test_the_roofline_counts_a_query_by_its_share_in_the_window():
    from portbench.metrics import scan_roofline as R

    assert R.in_window(["D1", 0.0, 1.0, 3.0, True, "0-1"], 2.0, 9.0) == 0.5
    assert R.in_window(["D1", 0.0, 3.0, 4.0, True, "0-1"], 2.0, 9.0) == 1.0
    assert R.in_window(["D1", 0.0, 8.0, 12.0, True, "0-1"], 2.0, 9.0) == \
        0.25
    assert R.in_window(["D1", 0.0, 10.0, 12.0, True, "0-1"], 2.0, 9.0) == 0
