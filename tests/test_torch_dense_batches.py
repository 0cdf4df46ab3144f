"""A query's K1 batches go out in one launcher call a group, on the CPU.

The executor records each batch whose dense kernel is K1 and, after the
last batch, hands the query's batches of one structure, literal block
and dense plan to `fused_dense.reduce_batches` at once; their tables fold
into the query's float64 accumulator together (`kernels.
dense_fold_batches`). On the CPU each recorded batch runs K1's plain
version into its slice, so these tests run the grouped loop.

The archived store: 135,000 trips in time order over three days, in live
batches of FD_MIN_ROWS rows, two days archived. The live batch wholly
below the cutoff is purged; the one that straddles it and each archived
day's chunk pad to FD_MIN_ROWS rows or more and take K1; the last live
batch (3,928 rows) takes the unfused kernel. Trips of the live day have
cities 0-19, the archived ones 0-11, so a group-by on city_id plans a
16-city domain on the archive chunks and a 32-city one on the live
batches.

Each answer is held against the JAX package's (ARES_FUSED=interp) and
against a run with the grouping patched off (each K1 batch launched and
folded on its own): keys and counts exact, sums within the JAX package's
2^-17 relative measure error.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

from aresdb_tpu import demo as JD
from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.utils import metrics as M
from tests import test_torch_archive as TA
from tests import test_torch_service as TS

TX = TA.TX
N_ROWS = 135_000
FACT = dict(TA.FACT, config={"batchSize": FD.FD_MIN_ROWS,
                             "recordRetentionInDays": 0})
# K1 batches over the whole range: the straddling live batch and the two
# archived days' chunks
K1_BATCHES = 3

BY_STATUS = {"dimensions": [{"sqlExpression": "status"}]}
BY_CITY = {"measures": [{"sqlExpression": "sum(fare)"}],
           "dimensions": [{"sqlExpression": "city_id"}]}


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def rows():
    d = TA.make_rows(N_ROWS, seed=5)
    live = d["ts"] >= TA.CUTOFF
    d["city"][live] = np.random.RandomState(6).randint(
        0, 20, int(live.sum())).astype(np.uint16)
    return d


@pytest.fixture(scope="module")
def archived(rows, tmp_path_factory):
    return TA.services(str(tmp_path_factory.mktemp("dense_batches")),
                       TA.upserts(rows, FD.FD_MIN_ROWS), schema=FACT)


@pytest.fixture
def launches(monkeypatch):
    """Counts K1's launches (its plain version's runs here) and the
    launcher calls (reduce_batches)."""
    seen = {"launches": 0, "calls": []}
    reduce, reduce_batches = FD.FusedDenseKernel.reduce, FD.reduce_batches

    def counted(self, *args, **kw):
        seen["launches"] += 1
        return reduce(self, *args, **kw)

    def calls(batches):
        seen["calls"].append(len(batches))
        return reduce_batches(batches)

    monkeypatch.setattr(FD.FusedDenseKernel, "reduce", counted)
    monkeypatch.setattr(FD, "reduce_batches", calls)
    return seen


def per_batch(monkeypatch):
    """Patch the grouping off: each K1 batch launches and folds alone."""
    monkeypatch.setattr(TX.ShardExecutor, "_collects",
                        staticmethod(lambda kernel: False))


def grouped_and_per_batch(archived, query, monkeypatch, exact):
    """The query through the JAX package, the grouped port and the
    per-batch port, held alike: (grouped context, per-batch context)."""
    res, ctx, _ = TA.both(archived, query, exact)
    with monkeypatch.context() as mp:
        per_batch(mp)
        one, one_ctx = TA.ask(archived[1], query)
    TA.assert_same(res, one, exact)
    return ctx, one_ctx


@pytest.mark.parametrize("measure", ["sum(fare)", "count(*)", "avg(fare)"])
def test_batches_across_the_cutoff_answer_alike(archived, measure,
                                                monkeypatch, launches):
    """(a) Live batches and archive chunks across the cutoff: one launcher
    call for the three K1 batches (the small live batch takes the
    unfused kernel into the same accumulator), the same answer as the
    JAX package and as one launch and fold a batch."""
    query = dict(BY_STATUS, measures=[{"sqlExpression": measure}])
    ctx, one_ctx = grouped_and_per_batch(archived, query, monkeypatch,
                                         exact=measure == "count(*)")
    assert launches["calls"] == [K1_BATCHES]
    assert launches["launches"] == 2 * K1_BATCHES
    assert (ctx["denseLaunchCalls"], ctx["denseBatchesLaunched"]) == (
        1, K1_BATCHES)
    assert "denseLaunchCalls" not in one_ctx
    assert ctx["batches"] == one_ctx["batches"] == K1_BATCHES + 1


def test_an_understated_batch_folds_as_identity_and_reruns(
        archived, monkeypatch, launches):
    """(b) Stats that understate the live day's cities: every batch plans
    the archive's 16 cities, so the three K1 batches form one group; the
    straddling live batch overflows inside it, folds as identity and
    reruns on the sort path (as does the small unfused one), and the
    answer is the JAX package's."""
    real = TX.plan_dense

    def understated(plan, stats):
        stats = dict(stats or {})
        key = (0, plan.main_schema.column_id("city_id"))
        if key in stats:
            stats[key] = (0, min(stats[key][1], 11))
        return real(plan, stats)

    monkeypatch.setattr(TX, "plan_dense", understated)
    ctx, one_ctx = grouped_and_per_batch(archived, BY_CITY, monkeypatch,
                                         exact=False)
    assert launches["calls"] == [K1_BATCHES]
    assert ctx["overflowReruns"] == one_ctx["overflowReruns"] == 2
    assert ctx["denseLaunchCalls"] == 1


def test_two_dense_plans_form_two_groups_whose_piles_merge(
        archived, monkeypatch, launches):
    """(c) The archive chunks plan 16 cities, the live batches 32: two
    groups, two launcher calls, and their two piles merge into one
    answer."""
    merges = []
    real = TX.GroupTable._merge_piles

    def spy(self, piles):
        merges.append(len(piles))
        return real(self, piles)

    monkeypatch.setattr(TX.GroupTable, "_merge_piles", spy)
    ctx, _ = grouped_and_per_batch(archived, BY_CITY, monkeypatch,
                                   exact=False)
    assert sorted(launches["calls"]) == [1, 2]
    assert (ctx["denseLaunchCalls"], ctx["denseBatchesLaunched"]) == (2, 3)
    assert ctx["overflowReruns"] == 0
    assert merges == [2, 2]   # the grouped run's, then the per-batch one's


def _counter(name) -> float:
    return sum(M.root().find(name).values())


@pytest.mark.parametrize("since,n_k1", [("12 hours ago", 1),
                                        (None, K1_BATCHES)])
def test_counters_of_one_and_of_n_batches(archived, since, n_k1, launches):
    """(d) One launcher call for 1 K1 batch (the straddling live batch,
    the last 12 hours) and for 3; `query.dense_launch_calls` counts the
    call, `query.dense_batches_launched` and the launches the batches."""
    query = dict(BY_STATUS, measures=[{"sqlExpression": "count(*)"}])
    if since:
        query["timeFilter"] = {"column": "request_at", "from": since,
                               "to": "now"}
    calls0 = _counter(M.QUERY_DENSE_LAUNCH_CALLS)
    batches0 = _counter(M.QUERY_DENSE_BATCHES_LAUNCHED)
    _, ctx, _ = TA.both(archived, query, exact=True)
    assert _counter(M.QUERY_DENSE_LAUNCH_CALLS) - calls0 == 1
    assert _counter(M.QUERY_DENSE_BATCHES_LAUNCHED) - batches0 == n_k1
    assert launches["calls"] == [n_k1] and launches["launches"] == n_k1
    assert (ctx["denseLaunchCalls"], ctx["denseBatchesLaunched"]) == (
        1, n_k1)


def test_a_deadline_passing_mid_loop_raises_before_any_launch(
        archived, monkeypatch, launches):
    """(e) The deadline passes after the first batch is staged: the next
    batch's check raises, and no K1 batch was launched."""
    real = TX.ShardExecutor._iter_batches

    def expiring(self, plan, *args, **kw):
        for i, staged in enumerate(real(self, plan, *args, **kw)):
            yield staged
            if i == 0:
                plan.deadline = 1.0   # long past
    monkeypatch.setattr(TX.ShardExecutor, "_iter_batches", expiring)
    query = dict(BY_STATUS, table="trips", now=TA.NOW,
                 measures=[{"sqlExpression": "count(*)"}])
    resp = archived[1].handle_aql({"queries": [query]})
    assert "timed out" in str(resp.get("errors")), resp
    assert launches == {"launches": 0, "calls": []}


CITIES = {"name": "cities",
          "columns": [{"name": "id", "type": "Uint16"},
                      {"name": "name", "type": "BigEnum"},
                      {"name": "population", "type": "Uint32"}],
          "primaryKeyColumns": [0], "isFactTable": False,
          "config": {"batchSize": 512}}
POPULATION = np.random.RandomState(9).randint(1000, 400_000, 300).astype(
    np.uint32)


@pytest.fixture(scope="module")
def joined():
    """Three live batches of FD_MIN_ROWS trips and 300 cities with a
    population: (JAX service, port service)."""
    n = 3 * FD.FD_MIN_ROWS
    trips = dict(TS.TRIPS, config={"batchSize": FD.FD_MIN_ROWS,
                                   "recordRetentionInDays": 0})
    ids = np.arange(1, 301, dtype=np.uint16)
    cities = build_columnar_upsert(
        [(0, dt.Uint16, ids, None, 0),
         (1, dt.BigEnum, np.zeros(300, np.uint16), None, 0),
         (2, dt.Uint32, POPULATION, None, 0)], 300)
    return TS._services([trips, CITIES], TS._random_batches(n, 8, n)
                        + [("cities", cities)])


def test_a_joined_lane_is_gathered_at_its_launch(joined, monkeypatch,
                                                launches):
    """(f) J1's shape, Q1 with the measure filter c.population > 200000:
    a recorded batch holds its staged columns and no gathered lane; the
    lanes its launch takes (fused_dense.launch_lanes, what the launcher
    call's pointers are made from) are its main columns as staged, then
    the population gathered by city; the three batches go out in calls
    of PIPELINE_FACTOR, so that no more of them hold a gathered lane at
    once; the answer is the JAX package's and the per-batch run's."""
    query = dict(JD.DEMO_QUERY, joins=[{"table": "cities", "alias": "c",
                                        "conditions": ["c.id = city_id"]}])
    query["measures"] = [{"sqlExpression": "sum(fare)",
                          "rowFilters": ["c.population > 200000"]}]
    calls = []
    reduce_batches = FD.reduce_batches

    def spy(batches):
        calls.append(list(batches))
        return reduce_batches(batches)

    monkeypatch.setattr(FD, "reduce_batches", spy)
    calls0 = _counter(M.QUERY_DENSE_LAUNCH_CALLS)
    grouped = TS._assert_same(query, *joined)
    assert FD.PIPELINE_FACTOR == 2
    assert [len(c) for c in calls] == [2, 1]
    assert _counter(M.QUERY_DENSE_LAUNCH_CALLS) - calls0 == 2
    for rec in (r for c in calls for r in c):
        kern = rec.kernel
        assert len(kern.spec.fkeys) == 1
        assert not any(isinstance(v, torch.Tensor) or isinstance(v, list)
                       for v in vars(rec).values())
        lanes = FD.launch_lanes(rec)
        assert len(lanes) == len(kern.spec.col_ids) + 1
        for (v, b), cid in zip(lanes, kern.spec.col_ids):
            staged = rec.columns[(0, cid)]
            assert v is staged[0] and b is staged[1]
        city, city_valid = rec.columns[
            (0, kern.plan.main_schema.column_id("city_id"))]
        pop, pop_valid = lanes[-1]
        assert pop.shape == pop_valid.shape == (kern.n_rows,)
        n = rec.n_valid
        valid = city_valid[:n].numpy()
        np.testing.assert_array_equal(pop_valid[:n].numpy(), valid)
        np.testing.assert_array_equal(
            pop[:n].numpy()[valid].view(np.uint32),
            POPULATION[city[:n].numpy()[valid].astype(np.int64) - 1])
    per_batch(monkeypatch)
    assert TS._assert_same(query, *joined) == grouped


@pytest.mark.parametrize("expires", [False, True],
                         ids=["answered", "timed_out"])
def test_the_plan_keeps_no_batch_after_the_query(archived, monkeypatch,
                                                 expires):
    """A cached K1 kernel keeps the plan that built it: after the query,
    answered or timed out mid-loop, the plan's per-query lists are empty
    and no recorded K1 batch (its staged columns and joined probes) is
    left alive."""
    records, plans = [], []
    record = FD.FusedDenseKernel.record

    def spy(self, *args):
        rec = record(self, *args)
        records.append(weakref.ref(rec))
        plans.append(self.plan)
        return rec

    monkeypatch.setattr(FD.FusedDenseKernel, "record", spy)
    if expires:
        real = TX.ShardExecutor._iter_batches

        def expiring(self, plan, *args, **kw):
            for i, staged in enumerate(real(self, plan, *args, **kw)):
                yield staged
                if i == 1:
                    plan.deadline = 1.0   # long past
        monkeypatch.setattr(TX.ShardExecutor, "_iter_batches", expiring)
    query = dict(BY_STATUS, table="trips", now=TA.NOW,
                 measures=[{"sqlExpression": "count(*)"}])
    resp = archived[1].handle_aql({"queries": [query]})
    assert ("timed out" in str(resp.get("errors"))) == expires, resp
    gc.collect()
    assert records and plans
    assert [r() for r in records] == [None] * len(records)
    for plan in plans:
        assert plan._exec_k1 == {} and plan._exec_dense_routes == {}
        assert plan._exec_pending == [] and plan._exec_dense_dev == {}


def test_the_fold_of_a_group_is_the_fold_of_its_batches():
    """dense_fold_batches against dense_fold_epilogue batch by batch: an
    overflowed batch (with a NaN and an inf in its table) folds as
    identity, the rest add in float64; counts exact."""
    rng = np.random.RandomState(3)
    tables = torch.from_numpy((rng.rand(5, 3, 40) * 1e4).astype(np.float32))
    tables[:, 1:] = torch.floor(tables[:, 1:])
    tables[2, 0, 7], tables[2, 0, 8] = float("nan"), float("inf")
    overflow = torch.tensor([0, 0, 3, 0, 0], dtype=torch.int32)
    init = [torch.full((40,), 0.5, dtype=torch.float64) for _ in range(3)]
    one = [t.clone() for t in init]
    for b in range(5):
        K.dense_fold_epilogue("sum", one, tables[b, 0], tables[b, 1],
                              tables[b, 2], overflow[b])
    got = K.dense_fold_batches([t.clone() for t in init], tables.clone(),
                               overflow)
    # with no accumulator yet, the group's sums start it
    fresh = K.dense_fold_batches(None, tables.clone(), overflow)
    for g, f, w in zip(got, fresh, one):
        assert g.dtype == f.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-15)
        np.testing.assert_allclose(f.numpy() + 0.5, w.numpy(), rtol=1e-15)
    np.testing.assert_array_equal(got[1].numpy(), one[1].numpy())
    np.testing.assert_array_equal(got[2].numpy(), one[2].numpy())
