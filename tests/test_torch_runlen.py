"""The run-length archive path of the port against the JAX package.

Under ARES_RUNLEN=1 both packages aggregate a sorted archive day by its
runs (runlen.py, kernels.make_runlen_agg_kernel): the same archived rows,
the same AQL requests, the JAX package with ARES_FUSED=interp and the port
on the CPU. The cases are those of tests/test_runlen.py. Each must take
the run-length path in both packages (`runlenBatches` > 0) and agree:
keys and counts exactly, float sums within the 2^-17 relative measure
error; the port's run-length answer must also equal its own expanded one
within rel 1e-5, the tolerance of tests/test_runlen.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu_torch.query import executor as TX
from aresdb_tpu_torch.query import kernels as TK
from tests.test_torch_archive import (BASE, DAY, NOW, REL, assert_same, ask,
                                      make_rows, services, upserts)

CASES = [
    ("sum by sort col",
     {"measures": [{"sqlExpression": "sum(fare)"}],
      "dimensions": [{"sqlExpression": "city_id"}]}),
    ("count by two sort cols",
     {"measures": [{"sqlExpression": "count(*)"}],
      "dimensions": [{"sqlExpression": "city_id"},
                     {"sqlExpression": "status"}]}),
    ("run filter + row filter",
     {"measures": [{"sqlExpression": "sum(fare)",
                    "rowFilters": ["status='completed'", "fare > 10"]}],
      "dimensions": [{"sqlExpression": "city_id"}]}),
    ("avg with row-level measure",
     {"measures": [{"sqlExpression": "avg(fare)"}],
      "dimensions": [{"sqlExpression": "status"}]}),
    ("int64 sum (scatter lane)",
     {"measures": [{"sqlExpression": "sum(tip)"}],
      "dimensions": [{"sqlExpression": "city_id"}]}),
    ("run-level count measure",
     {"measures": [{"sqlExpression": "count(city_id)"}],
      "dimensions": [{"sqlExpression": "status"}]}),
    ("expr dim on sort col",
     {"measures": [{"sqlExpression": "sum(fare)"}],
      "dimensions": [{"sqlExpression": "city_id % 5"}]}),
    ("time filter (row level) + sort dim",
     {"measures": [{"sqlExpression": "sum(fare)"}],
      "dimensions": [{"sqlExpression": "city_id"}],
      "timeFilter": {"column": "request_at",
                     "from": f"{BASE + 3000}", "to": f"{BASE + DAY}"}}),
]

NULLS = {
    "name": "t", "columns": [
        {"name": "ts", "type": "Uint32"},
        {"name": "k", "type": "Uint32"},
        {"name": "g", "type": "Uint16"},
        {"name": "v", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 4096, "recordRetentionInDays": 0}}


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def day(tmp_path_factory):
    """6,000 trips over one day, archived whole into one sorted mode-3
    day batch (the rows of tests/test_runlen.py's store)."""
    rows = make_rows(6000, seed=0, n_cities=12, days=1)
    return services(str(tmp_path_factory.mktemp("day")), upserts(rows, 6000),
                    cutoff=BASE + DAY) + (rows,)


def _runlen(monkeypatch, on: bool):
    if on:
        monkeypatch.setenv("ARES_RUNLEN", "1")
    else:
        monkeypatch.delenv("ARES_RUNLEN", raising=False)


@pytest.mark.parametrize("name,query", CASES, ids=[c[0] for c in CASES])
def test_runlen_matches_the_jax_package(day, monkeypatch, name, query):
    _runlen(monkeypatch, True)
    exact = query["measures"][0]["sqlExpression"].startswith(
        ("count", "sum(tip)"))
    jres, jctx = ask(day[0], query)
    tres, tctx = ask(day[1], query)
    assert tctx.get("runlenBatches", 0) > 0 and \
        jctx.get("runlenBatches", 0) > 0, (tctx, jctx)
    assert tctx["runlenRuns"] == jctx["runlenRuns"]
    assert_same(tres, jres, exact)
    _runlen(monkeypatch, False)
    expanded, ectx = ask(day[1], query)
    assert not ectx.get("runlenBatches")
    assert_same(tres, expanded, exact, rel=1e-5)


def test_runlen_sum_against_the_oracle_with_a_prefilter(day, monkeypatch):
    """A prefilter on the first sort column narrows the run-length slice
    by its entries; the weighted sums equal the ingested rows' sums."""
    _runlen(monkeypatch, True)
    rows = day[4]
    query = {"measures": [{"sqlExpression": "sum(fare)",
                           "rowFilters": ["city_id = 7"]}],
             "dimensions": [{"sqlExpression": "status"}]}
    jres, jctx = ask(day[0], query)
    tres, tctx = ask(day[1], query)
    assert tctx["runlenBatches"] > 0
    assert tctx["prefilterRowsSkipped"] == jctx["prefilterRowsSkipped"] > 0
    assert_same(tres, jres)
    sel = rows["fare_valid"] & (rows["city"] == 7)
    for s, status in enumerate(["completed", "canceled", "rejected"]):
        want = float(rows["fare"][sel & (rows["status"] == s)]
                     .astype(np.float64).sum())
        assert abs(tres[status] - want) < max(1e-3, want * 1e-5)


def test_runlen_null_measure_group_still_exists(tmp_path, monkeypatch):
    """A group whose measures are all null still appears, with the sum's
    identity, as on the expand path."""
    from aresdb_tpu.common import data_types as dt
    from aresdb_tpu.common.upsert_batch import build_columnar_upsert

    n = 512
    g = np.repeat(np.arange(8, dtype=np.uint16), n // 8)
    cols = [(0, dt.Uint32, np.full(n, BASE + 100, np.uint32), None, 0),
            (1, dt.Uint32, np.arange(n, dtype=np.uint32), None, 0),
            (2, dt.Uint16, g, None, 0),
            (3, dt.Float32, np.random.RandomState(1).rand(n)
             .astype(np.float32), g != 3, 0)]
    jsvc, tsvc, _, _ = services(str(tmp_path), [build_columnar_upsert(cols, n)],
                                schema=NULLS, cutoff=BASE + DAY)
    _runlen(monkeypatch, True)
    query = {"table": "t", "now": NOW,
             "measures": [{"sqlExpression": "sum(v)"}],
             "dimensions": [{"sqlExpression": "g"}]}
    out = [svc.handle_aql({"queries": [query], "verbose": True})
           for svc in (jsvc, tsvc)]
    for resp in out:
        assert "errors" not in resp and resp["context"][0]["runlenBatches"]
    tres = out[1]["results"][0]
    assert tres["3"] == 0.0 and len(tres) == 8
    assert_same(tres, out[0]["results"][0])


def test_runlen_batch_outgrowing_its_capacity_reruns_on_runlen(day,
                                                               monkeypatch):
    """A run-length chunk whose groups outgrow the capacity K reruns on
    the run-length kernel at the next rung, not on the sort kernel, and
    answers as the JAX package does at its default capacity."""
    _runlen(monkeypatch, True)
    monkeypatch.setattr(TX, "DEFAULT_GROUP_CAPACITY", 4)
    calls = []
    real = TX.ShardExecutor._run_runlen_batch
    sort_calls = []
    real_sort = TX.ShardExecutor._run_sort_batch

    def spy(self, *args, k=0):
        calls.append(k)
        return real(self, *args, k=k)

    def sort_spy(self, *args, **kw):
        sort_calls.append(kw)
        return real_sort(self, *args, **kw)

    monkeypatch.setattr(TX.ShardExecutor, "_run_runlen_batch", spy)
    monkeypatch.setattr(TX.ShardExecutor, "_run_sort_batch", sort_spy)
    query = {"measures": [{"sqlExpression": "count(*)"}],
             "dimensions": [{"sqlExpression": "city_id"},
                            {"sqlExpression": "status"}]}
    svc = day[1]
    svc.executor._k_hints.clear()
    tres, tctx = ask(svc, query)
    assert tctx["runlenBatches"] == 1 and tctx["ladderReruns"] == 1
    assert calls[0] == 0 and calls[1] > 4 and not sort_calls
    jres, _ = ask(day[0], query)
    assert_same(tres, jres, exact=True)
    assert len(tres) == 12 and sum(len(v) for v in tres.values()) == 36
    svc.executor._k_hints.clear()


def test_run_sums_keep_nonfinite_values_to_their_runs():
    """The per-run prefix differences: exact integer counts, finite float
    sums as float64 direct sums rounded to float32, a NaN in its own run
    only, an infinity propagated, +inf and -inf together NaN."""
    rng = np.random.RandomState(3)
    n = 4096
    v = (rng.rand(n) * 100 - 30).astype(np.float32)
    bounds = np.unique(np.concatenate([[0, n], rng.randint(1, n, 60)]))
    starts, ends = bounds[:-1], bounds[1:]
    v[starts[3] + 1] = np.nan
    v[starts[7]] = np.inf
    v[starts[9]] = np.inf
    v[starts[9] + 1] = -np.inf
    flag = rng.rand(n) > 0.5
    s, c = TK._run_sums([torch.from_numpy(v), torch.from_numpy(flag)],
                        torch.from_numpy(starts), torch.from_numpy(ends))
    with np.errstate(invalid="ignore"):   # inf + -inf
        want = np.array([v[a:b].astype(np.float64).sum()
                         for a, b in zip(starts, ends)]).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(s.numpy()), np.isnan(want))
    fin = np.isfinite(want)
    assert set(np.flatnonzero(~fin)) == {3, 7, 9}
    assert s.numpy()[7] == np.inf and np.isnan(s.numpy()[9])
    np.testing.assert_allclose(s.numpy()[fin], want[fin], rtol=1e-6)
    np.testing.assert_array_equal(
        c.numpy(), [flag[a:b].sum() for a, b in zip(starts, ends)])


def test_runlen_kernel_cache_keys_on_the_spec(day, monkeypatch):
    """The run-length kernel is cached per (plan signature, rows, runs,
    K, spec): the same query reuses it, and an equal-shaped query with
    another filter level does not."""
    _runlen(monkeypatch, True)
    cache = day[1].executor.kernel_cache
    before = {k for k in cache._cache if k[0] == "runlen"}
    q = {"measures": [{"sqlExpression": "sum(fare)"}],
         "dimensions": [{"sqlExpression": "status"}]}
    ask(day[1], q)
    first = {k for k in cache._cache if k[0] == "runlen"} - before
    ask(day[1], q)
    assert {k for k in cache._cache if k[0] == "runlen"} - before == first
    assert len(first) == 1
    ask(day[1], dict(q, rowFilters=["fare > 1"]))
    keys = {k for k in cache._cache if k[0] == "runlen"} - before - first
    assert len(keys) == 1 and next(iter(keys))[5] != next(iter(first))[5]
