"""K1, the fused dense group-by kernel, against the JAX package.

`FusedDenseKernel.reduce` on CPU tensors takes the plain PyTorch version
(torch expression emitter, dense slot lane, K2's plain version). It is
held against the Pallas kernel `make_fused_dense_kernel` run in interpret
mode, over the query matrix of tests/test_fused_dense.py, on the same
numpy columns.

The CUDA kernel's per-plan row function (`fused_dense.emit_cuda`) also
compiles with the host C++ compiler; a small ctypes harness runs it over
the staged lanes, and its per-row keep mask, out-of-domain flag, slot and
measure must equal the torch emitter's. That is the check of K1's logic
that runs without a GPU.

A plan joined to a dimension table takes the joined column as one more
input lane, gathered through the join's probe before the kernel runs; it
is held against the JAX package's fused kernel, and its row function
against the torch emitter, the same way.

The emitted source holds a plan's structure only: a moved window (the
query's `now`) or a moved column range gives the same source, and so one
cubin, with another literal block. The g++-built row function is run
with each window's block against the torch emitter at that window, and
both packages' services answer at two windows alike.

That source is device code only, built as a cubin: it holds no host
launcher, and every plan structure is launched by one fixed launcher
library, whose text no plan changes (its build and load are stood in for
here: no nvcc and no card). Under ARES_FUSED=0 both packages take the
unfused dense kernel, and the port builds no FusedDenseKernel.

Tolerances are the JAX package's: counts, row totals and overflow exact,
float sums within rtol=2e-4, atol=1e-3.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from aresdb_tpu import demo as JD
from aresdb_tpu.common import data_types as dt
from aresdb_tpu.query import fused_dense as JFD
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.dense import plan_dense as j_plan_dense
from aresdb_tpu_torch import demo as TD
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.dense import plan_dense
from aresdb_tpu_torch.query.executor import columns_from_numpy
from aresdb_tpu_torch.utils import cuda_build

N_ROWS = 4096
RTOL, ATOL = 2e-4, 1e-3
CPU = torch.device("cpu")


def _q(**changes):
    q = json.loads(json.dumps(JD.DEMO_QUERY))
    q.update(changes)
    return q


def _dims(first_bucket):
    return [{"sqlExpression": "request_at", "timeBucketizer": first_bucket},
            {"sqlExpression": "city_id"}]


# name -> (query, seed, n_valid, cutoff, n_cities, city stat override)
CASES = {
    "headline": (JD.DEMO_QUERY, 3, None, 0, 40, None),
    "avg_null_measures": (_q(measures=[{"sqlExpression": "avg(fare)"}]),
                          11, None, 0, 40, None),
    "count_no_filters": (_q(measures=[{"sqlExpression": "count(*)"}]),
                         3, None, 0, 40, None),
    "partial_n_valid_and_cutoff": (JD.DEMO_QUERY, 3, N_ROWS - 777,
                                   JD.DEMO_NOW - 5 * 3600, 40, None),
    "case_and_in_filter": (_q(measures=[{
        "sqlExpression":
            "sum(case when status='completed' then fare else 0 end)",
        "rowFilters": ["status in ('completed', 'canceled')"]}]),
        3, None, 0, 40, None),
    "single_dim_city": (_q(dimensions=[{"sqlExpression": "city_id"}]),
                        3, None, 0, 40, None),
    "numeric_bucket_dim": (_q(dimensions=[{
        "sqlExpression": "fare", "numericBucketizer": {"bucketWidth": 5.0}}]),
        3, None, 0, 40, None),
    "avg_day_of_week": (_q(measures=[{"sqlExpression": "avg(fare)"}],
                           dimensions=_dims("day of week")),
                        5, None, 0, 300, None),
    "arithmetic_and_modulo": (_q(measures=[{
        "sqlExpression": "sum(fare * 2 - 7)",
        "rowFilters": ["city_id % 7 != 3", "NOT (status = 'rejected')"]}]),
        9, None, 0, 40, None),
    "overflow_rows_counted": (JD.DEMO_QUERY, 3, None, 0, 60, (0, 20)),
}


# a second window for each case: 5 h 15 min later, so the time filter
# drops the oldest rows and the hour domain's base moves
SHIFT = 5 * 3600 + 900


def _setup(name, shift=0):
    query, seed, n_valid, cutoff, n_cities, city_stat = CASES[name]
    query = dict(query, now=query["now"] + shift)
    jplan = JD.demo_plan(query)
    tplan = TD.demo_plan(query)
    cols_np, _ = JD.demo_columns(jplan, N_ROWS, seed=seed, n_cities=n_cities)
    stats = {}
    city_key = (0, jplan.main_schema.column_id("city_id"))
    if city_key in cols_np:
        stats[city_key] = city_stat or (0, int(cols_np[city_key][0].max()))
    fare_key = (0, jplan.main_schema.column_id("fare"))
    if fare_key in cols_np:
        fv = cols_np[fare_key][0]
        stats[fare_key] = (float(fv.min()), float(fv.max()))
    jdp, tdp = j_plan_dense(jplan, stats), plan_dense(tplan, stats)
    assert jdp is not None and tdp is not None
    assert jdp.n_slots == tdp.n_slots
    jspec, tspec = JFD.plan_fused(jplan, jdp), FD.plan_fused(tplan, tdp)
    assert jspec is not None and tspec is not None
    assert tspec.col_ids == jspec.col_ids
    nv = N_ROWS if n_valid is None else n_valid
    return (jplan, jdp, jspec, tplan, tdp, tspec, cols_np, nv, cutoff)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k1_matches_pallas_kernel(name, monkeypatch):
    monkeypatch.setenv("ARES_FUSED", "interp")
    import jax.numpy as jnp

    (jplan, jdp, jspec, tplan, tdp, tspec, cols_np, nv,
     cutoff) = _setup(name)
    jcols = {k: (jnp.asarray(v), jnp.asarray(b))
             for k, (v, b) in cols_np.items()}
    jfn = JFD.make_fused_dense_kernel(jplan, N_ROWS, jdp, jspec,
                                      interpret=True)
    ja, jc, jr, jo = [np.asarray(x) for x in JK.run_dense_kernel(
        jfn, jplan, jdp.n_slots, jcols, (), np.int32(nv), np.int64(cutoff))]

    kern = FD.FusedDenseKernel(tplan, N_ROWS, tdp, tspec, CPU)
    tcols = columns_from_numpy(cols_np, N_ROWS, CPU)
    ta, tc, tr, to = [x.numpy() for x in K.run_dense_kernel(
        kern, tplan, tdp.n_slots, tcols, nv, cutoff, CPU)]

    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert int(to) == int(jo)
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
    if name == "overflow_rows_counted":
        assert int(to) > 0
    else:
        assert tr.sum() > 0


@pytest.fixture(scope="module")
def gxx_build_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("the host C++ compiler g++ is required for this test")
    return tmp_path_factory.mktemp("fused_rows")


def _host_rows(spec, lanes, build_dir) -> dict:
    """The g++-built row function of spec's source over the lanes, with
    spec's literal block: its per-row lanes by name."""
    lib = cuda_build.load_library("fused_rows", spec.source, "g++",
                                  build_dir)
    fn = lib.ares_rows_host
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, p, p, p, p, p]
    fn.restype = None
    vals = (p * len(lanes))(*[v.data_ptr() for v, _ in lanes])
    valids = (p * len(lanes))(*[b.data_ptr() for _, b in lanes])
    lits_i = np.array(spec.lits_i or [0], np.int32)
    lits_f = np.array(spec.lits_f or [0], np.float32)
    out = {"keep": np.zeros(N_ROWS, np.uint8),
           "bad": np.zeros(N_ROWS, np.uint8),
           "slot": np.zeros(N_ROWS, np.int32),
           "mval": np.zeros(N_ROWS, np.float32),
           "mvalid": np.zeros(N_ROWS, np.uint8)}
    fn(vals, valids, lits_i.ctypes.data, lits_f.ctypes.data, N_ROWS,
       *[a.ctypes.data for a in out.values()])
    return out


def _assert_rows_match_torch_emitter(got, tplan, tdp, cols, foreign=()):
    ctx = K._EvalCtx(cols, N_ROWS, CPU, foreign)
    mask, dim_vals = K._eval_common(tplan, ctx, N_ROWS, None)
    want_slot, want_bad = K.dense_slot_lane(dim_vals, tdp, N_ROWS, CPU)
    mlane = K._measure_lane(tplan, ctx)
    np.testing.assert_array_equal(got["keep"].astype(bool), mask.numpy())
    np.testing.assert_array_equal(got["bad"].astype(bool), want_bad.numpy())
    np.testing.assert_array_equal(got["slot"], want_slot.numpy())
    np.testing.assert_array_equal(got["mvalid"].astype(bool),
                                  mlane.valid.numpy())
    np.testing.assert_array_equal(got["mval"], mlane.value.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_emitted_row_function_matches_torch_emitter(name, gxx_build_dir):
    """At the case's window and at one SHIFT later: one source, so one
    library, read with each window's literal block."""
    rows = []
    for shift in (0, SHIFT):
        _, _, _, tplan, tdp, tspec, cols_np, _, _ = _setup(name, shift)
        cols = columns_from_numpy(cols_np, N_ROWS, CPU)
        lanes = [cols[(0, cid)] for cid in tspec.col_ids]
        got = _host_rows(tspec, lanes, gxx_build_dir)
        _assert_rows_match_torch_emitter(got, tplan, tdp, cols)
        keep = got["keep"]
        assert keep.any() and not keep.all() or name == "count_no_filters"
        rows.append((tspec, got))
    (spec0, got0), (spec1, got1) = rows
    assert spec1.source == spec0.source
    assert spec1.lits_i != spec0.lits_i
    # the later window drops the oldest rows and moves the hour slots
    assert not np.array_equal(got1["keep"], got0["keep"]) or \
        not np.array_equal(got1["slot"], got0["slot"])


def test_plan_fused_keeps_the_jax_eligibility_rules():
    # calendar ops need int64 lanes and stay off K1 in both packages
    q = _q(dimensions=_dims("day of month"))
    tplan = TD.demo_plan(q)
    jplan = JD.demo_plan(q)
    stats = {(0, tplan.main_schema.column_id("city_id")): (0, 40)}
    assert FD.plan_fused(tplan, plan_dense(tplan, stats)) is None
    assert JFD.plan_fused(jplan, j_plan_dense(jplan, stats)) is None


def test_batches_below_fd_min_rows_stay_on_the_unfused_kernel():
    plan = TD.demo_plan(JD.DEMO_QUERY)
    dp = plan_dense(plan, {(0, plan.main_schema.column_id("city_id")):
                           (0, 40)})
    assert FD.FD_MIN_ROWS == JFD.FD_MIN_ROWS
    small = K.make_dense_agg_kernel(plan, FD.FD_MIN_ROWS // 2, dp, CPU)
    big = K.make_dense_agg_kernel(plan, FD.FD_MIN_ROWS, dp, CPU)
    assert not isinstance(small, FD.FusedDenseKernel)
    assert isinstance(big, FD.FusedDenseKernel)


CITIES = {"name": "cities",
          "columns": [{"name": "id", "type": "Uint16"},
                      {"name": "population", "type": "Uint32"}],
          "primaryKeyColumns": [0], "isFactTable": False}


def _joined_case():
    """Q1 joined to 300 cities by id, with the measure filter
    c.population > 200000: (JAX plan, dense plan and spec, port plan,
    dense plan and spec, main columns, joined columns, lookup table)."""
    from aresdb_tpu.common.schema import Table as JTable
    from aresdb_tpu.common.schema import TableSchema as JTableSchema
    from aresdb_tpu.query.aql import AQLQuery as JQ
    from aresdb_tpu.query.compiler import Compiler as JC
    from aresdb_tpu_torch.common.schema import Table, TableSchema
    from aresdb_tpu_torch.query.aql import AQLQuery
    from aresdb_tpu_torch.query.compiler import Compiler

    q = _q(joins=[{"table": "cities", "alias": "c",
                   "conditions": ["c.id = city_id"]}])
    q["measures"][0]["rowFilters"].append("c.population > 200000")
    jplan = JC({"trips": JD.demo_schema(),
                "cities": JTableSchema(JTable.from_json(CITIES))}).compile(
        JQ.from_json(q))
    tplan = Compiler({"trips": TD.demo_schema(),
                      "cities": TableSchema(Table.from_json(CITIES))}
                     ).compile(AQLQuery.from_json(q))
    cols_np, _ = JD.demo_columns(jplan, N_ROWS, seed=13, n_cities=320)
    rng = np.random.RandomState(14)
    ids = np.arange(1, 301, dtype=np.uint16)
    pop = rng.randint(1000, 400_000, 300).astype(np.uint32)
    fcols = {(1, 0): (ids, np.ones(300, bool)),
             (1, 1): (pop, rng.rand(300) > 0.1)}
    lut = np.full(302, -1, np.int32)
    lut[ids] = np.arange(300, dtype=np.int32)
    stats = {(0, jplan.main_schema.column_id("city_id")): (0, 320)}
    jdp, tdp = j_plan_dense(jplan, stats), plan_dense(tplan, stats)
    jspec, tspec = JFD.plan_fused(jplan, jdp), FD.plan_fused(tplan, tdp)
    assert jspec is not None and tspec is not None
    assert tspec.fkeys == jspec.fkeys == [(1, 1, dt.Uint32)]
    return jplan, jdp, jspec, tplan, tdp, tspec, cols_np, fcols, lut


def _port_joined_columns(cols_np, fcols, lut):
    cols = columns_from_numpy(cols_np, N_ROWS, CPU)
    for key, (v, b) in fcols.items():
        signed = v.view(np.int16) if v.dtype == np.uint16 else v.view(
            np.int32)
        cols[key] = (torch.from_numpy(signed), torch.from_numpy(b))
    return cols, ((torch.from_numpy(lut),),)


def test_k1_with_a_joined_lane_matches_pallas_kernel(monkeypatch):
    monkeypatch.setenv("ARES_FUSED", "interp")
    import jax.numpy as jnp

    (jplan, jdp, jspec, tplan, tdp, tspec, cols_np, fcols,
     lut) = _joined_case()
    jcols = {k: (jnp.asarray(v), jnp.asarray(b))
             for k, (v, b) in list(cols_np.items()) + list(fcols.items())}
    jfn = JFD.make_fused_dense_kernel(jplan, N_ROWS, jdp, jspec,
                                      interpret=True)
    cutoff = JD.DEMO_NOW - 5 * 3600
    ja, jc, jr, jo = [np.asarray(x) for x in JK.run_dense_kernel(
        jfn, jplan, jdp.n_slots, jcols, ((jnp.asarray(lut),),),
        np.int32(N_ROWS - 100), np.int64(cutoff))]
    tcols, foreign = _port_joined_columns(cols_np, fcols, lut)
    kern = FD.FusedDenseKernel(tplan, N_ROWS, tdp, tspec, CPU)
    ta, tc, tr, to = [x.numpy() for x in K.run_dense_kernel(
        kern, tplan, tdp.n_slots, tcols, N_ROWS - 100, cutoff, CPU,
        foreign)]
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tr, jr)
    assert int(to) == int(jo) == 0
    np.testing.assert_allclose(ta, ja, rtol=RTOL, atol=ATOL)
    assert 0 < tc.sum() < N_ROWS / 3


def test_emitted_row_function_reads_the_joined_lane(gxx_build_dir):
    """The g++-built row function, fed the main columns and the gathered
    joined lane (FusedDenseKernel._lanes), against the torch emitter,
    which probes the joined table itself."""
    _, _, _, tplan, tdp, tspec, cols_np, fcols, lut = _joined_case()
    cols, foreign = _port_joined_columns(cols_np, fcols, lut)
    kern = FD.FusedDenseKernel(tplan, N_ROWS, tdp, tspec, CPU)
    lanes = kern._lanes(cols, foreign)
    assert len(lanes) == len(tspec.col_ids) + 1
    assert "V[4]" in tspec.source and "V[5]" not in tspec.source
    got = _host_rows(tspec, lanes, gxx_build_dir)
    _assert_rows_match_torch_emitter(got, tplan, tdp, cols, foreign)
    assert got["keep"].any() and not got["keep"].all()


# ---------------------------------------------------------------------------
# the source holds the plan's structure; its literal block holds the values
# ---------------------------------------------------------------------------

# chip_smoke's A6 over the demo trips: sum(fare) by hour x city_id over
# the 36 hours up to `now`, whose upper bound moves every second
A6_QUERY = _q(measures=[{"sqlExpression": "sum(fare)"}],
              timeFilter={"column": "request_at", "from": "36 hours ago",
                          "to": "now"})


def _port_spec(query, city_max=300, now=None):
    if now is not None:
        query = dict(query, now=now)
    plan = TD.demo_plan(query)
    stats = {(0, plan.main_schema.column_id("city_id")): (1, city_max),
             (0, plan.main_schema.column_id("fare")): (0.0, 50.0)}
    dp = plan_dense(plan, stats)
    spec = FD.plan_fused(plan, dp)
    assert spec is not None
    return spec


# name -> (spec, spec): one plan structure, another window or range
SAME_STRUCTURE = {
    "A6 at now and now + 1": (A6_QUERY, {"now": JD.DEMO_NOW},
                              {"now": JD.DEMO_NOW + 1}),
    "headline across a quarter-hour": (JD.DEMO_QUERY, {"now": JD.DEMO_NOW},
                                       {"now": JD.DEMO_NOW + 900}),
    "headline as its city range grows": (JD.DEMO_QUERY, {"city_max": 300},
                                         {"city_max": 600}),
}


@pytest.mark.parametrize("name", sorted(SAME_STRUCTURE))
def test_a_moved_window_or_range_emits_the_same_source(name):
    query, before, after = SAME_STRUCTURE[name]
    a, b = _port_spec(query, **before), _port_spec(query, **after)
    assert b.source == a.source
    assert (b.lits_i, b.lits_f) != (a.lits_i, a.lits_f)
    assert "#define ARES_NI" in a.source
    # no window bound, domain base, size or stride is a C constant
    for v in set(a.lits_i + b.lits_i) - {0, 1}:
        assert f"({v})" not in a.source and f" {v})" not in a.source


# name -> the query whose structure differs from the headline's
OTHER_STRUCTURE = {
    "count measure": _q(measures=[{"sqlExpression": "count(*)"}]),
    "day-of-week dimension": _q(dimensions=_dims("day of week")),
    "one more filter": _q(measures=[{
        "sqlExpression": "sum(fare)",
        "rowFilters": ["status='completed'", "city_id != 7"]}]),
    "the 36-hour window": A6_QUERY,
    "a numeric bucket": _q(dimensions=[{
        "sqlExpression": "fare", "numericBucketizer": {"bucketWidth": 5.0}}]),
}


@pytest.mark.parametrize("name", sorted(OTHER_STRUCTURE))
def test_another_plan_structure_emits_another_source(name):
    assert _port_spec(OTHER_STRUCTURE[name]).source != \
        _port_spec(JD.DEMO_QUERY).source


def test_two_windows_build_one_library(tmp_path):
    """The second window's source is the first's: load_library finds the
    library in the process, and build_all finds it on disk."""
    a = _port_spec(JD.DEMO_QUERY, now=JD.DEMO_NOW)
    b = _port_spec(JD.DEMO_QUERY, now=JD.DEMO_NOW + 900)
    built = cuda_build.built
    lib_a = cuda_build.load_library("fused_rows", a.source, "g++", tmp_path)
    assert cuda_build.built == built + 1
    assert cuda_build.build_seconds > 0
    lib_b = cuda_build.load_library("fused_rows", b.source, "g++", tmp_path)
    assert lib_b is lib_a
    cuda_build.build_all([("fused_rows", b.source, "g++")], tmp_path)
    assert cuda_build.built == built + 1
    assert len(list(tmp_path.glob("*.so"))) == 1


def test_a_plan_over_the_literal_capacity_bakes_them_and_matches(
        gxx_build_dir):
    ids = ", ".join(str(c) for c in range(1, FD.MAX_LITS + 2))
    q = _q(measures=[{"sqlExpression": "sum(fare)",
                      "rowFilters": [f"city_id in ({ids})",
                                     "status='completed'"]}])
    tplan = TD.demo_plan(q)
    cols_np, _ = JD.demo_columns(JD.demo_plan(q), N_ROWS, seed=3,
                                 n_cities=2 * FD.MAX_LITS)
    stats = {(0, tplan.main_schema.column_id("city_id")):
             (1, 2 * FD.MAX_LITS)}
    tdp = plan_dense(tplan, stats)
    tspec = FD.plan_fused(tplan, tdp)
    assert tspec is not None
    assert tspec.lits_i == [] and tspec.lits_f == []
    assert "#define ARES_NI 0\n#define ARES_NF 0\n" in tspec.source
    assert "P.i[" not in tspec.source and f"({FD.MAX_LITS + 1})" in \
        tspec.source
    cols = columns_from_numpy(cols_np, N_ROWS, CPU)
    got = _host_rows(tspec, [cols[(0, cid)] for cid in tspec.col_ids],
                     gxx_build_dir)
    _assert_rows_match_torch_emitter(got, tplan, tdp, cols)
    # about half the cities pass the IN-list
    assert 0.3 < got["keep"].mean() / 0.98 ** 2 / (1 / 3) < 0.7


@pytest.fixture(scope="module")
def windowed_services():
    """Both packages' services over two live batches of FD_MIN_ROWS demo
    trips, so that the port routes dense plans through K1 (its plain
    version on the CPU) and the JAX package through its interpreted
    Pallas K1."""
    from tests.test_torch_service import TRIPS, _random_batches, _services

    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    n = 2 * FD.FD_MIN_ROWS
    trips = dict(TRIPS, config={"batchSize": FD.FD_MIN_ROWS,
                                "recordRetentionInDays": 0})
    yield _services([trips], _random_batches(n, 4, n))
    mp.undo()


# (query, its later `now`): each later window drops some of the oldest
# rows (the rows lie in the 20 hours before DEMO_NOW)
WINDOWS = {"headline": (JD.DEMO_QUERY, JD.DEMO_NOW + SHIFT),
           "A6": (A6_QUERY, JD.DEMO_NOW + 17 * 3600)}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_both_packages_answer_alike_at_two_windows(name, windowed_services,
                                                   monkeypatch):
    from tests.test_torch_service import _assert_same

    query, later = WINDOWS[name]
    sources = []
    real = FD.FusedDenseKernel.reduce

    def spy(self, *args):
        sources.append(self.spec.source)
        return real(self, *args)

    monkeypatch.setattr(FD.FusedDenseKernel, "reduce", spy)
    answers = [_assert_same(dict(query, now=now), *windowed_services)
               for now in (JD.DEMO_NOW, later)]
    assert answers[0] != answers[1]
    # both windows ran K1 on each batch, from one structural source
    assert len(sources) == 4 and len(set(sources)) == 1


def test_the_per_plan_source_holds_device_code_only():
    template = (cuda_build.CSRC / "fused_dense_template.cuh").read_text()
    for name, text in (("source", _port_spec(JD.DEMO_QUERY).source),
                       ("template", template)):
        # no host launcher: no C entry point that returns a status
        assert not re.search(r'extern\s+"C"\s+int', text), name
    # the launcher finds the kernel in the image by its C name
    assert re.search(r'extern "C" __global__ void __launch_bounds__\(1024\)'
                     r'\s+fused_dense_kernel\(', template)
    # a device-only compile parses none of block_hist.cuh's host helpers
    assert "#define ARES_DEVICE_ONLY" in template
    hist = (cuda_build.CSRC / "block_hist.cuh").read_text()
    host = hist[hist.index("#ifdef ARES_HIST_HOST"):]
    for helper in ("<mutex>", "hist_plan", "hist_launch_args"):
        assert helper in host and helper not in hist[:hist.index(
            "#ifdef ARES_HIST_HOST")], helper


# plans whose device code NVRTC compiles: the headline, the widest (a
# joined lane) and a float dimension (the numeric bucket's floorf)
RTC_PLANS = {
    "Q1": lambda: _port_spec(JD.DEMO_QUERY),
    "J1": lambda: _joined_case()[5],
    "numeric bucket": lambda: _port_spec(OTHER_STRUCTURE["a numeric bucket"]),
}


@pytest.mark.parametrize("name", sorted(RTC_PLANS))
def test_k1_device_code_reaches_no_system_header_under_nvrtc(name, tmp_path):
    """The emitted source preprocessed as NVRTC preprocesses it (the
    device side, __CUDACC_RTC__, NVRTC_OPTIONS' defines) with no system
    include directory at all: every header it reaches is a csrc one."""
    if shutil.which("g++") is None:
        pytest.fail("the host C++ compiler g++ is required for this test")
    src = tmp_path / "k1.cu"
    src.write_text(RTC_PLANS[name]().source)
    defines = [o for o in cuda_build.NVRTC_OPTIONS if o.startswith("-D")]
    proc = subprocess.run(
        ["g++", "-E", "-nostdinc", "-Werror", "-x", "c++", "-D__CUDACC__",
         "-D__CUDACC_RTC__", "-D__CUDA_ARCH__=900", *defines, "-I",
         str(cuda_build.CSRC), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    # the device side was reached, through the cluster helpers, and none
    # of the host helpers
    assert "fused_dense_kernel" in out and "ares_cluster_sync" in out
    assert "hist_launch_args" not in out and "ares_rows_host" not in out
    reached = set(re.findall(r'^# \d+ "([^"<]+)"', out, re.M))
    assert {Path(f).name for f in reached if f != str(src)} == {
        "fused_dense_template.cuh", "ares_common.cuh", "block_hist.cuh",
        "ares_cluster.cuh"}
    assert all(Path(f).parent == cuda_build.CSRC for f in reached
               if f != str(src))


def test_no_csrc_file_includes_cooperative_groups():
    for path in cuda_build.CSRC.glob("*.cu*"):
        text = path.read_text()
        assert not re.search(r"#\s*include\s*<cooperative_groups", text), \
            path.name
        assert "cg::" not in text, path.name


def test_every_plan_takes_one_fixed_launcher(monkeypatch):
    """structure_kernel builds the launcher's fixed text beside each new
    structure's cubin, and loads each structure once; another window of
    a structure finds its kernel loaded."""
    builds, loads = [], []
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_all",
                        lambda items, build_dir=None: builds.append(
                            list(items)) or 0.0)
    monkeypatch.setattr(cuda_build, "load_cubin",
                        lambda name, text, build_dir=None: text.encode())

    class Launcher:
        def ares_fused_dense_load(self, image, ni, nf, device, handle):
            loads.append((image, ni, nf, device))
            handle._obj.value = 4096 * len(loads)
            return 0

    monkeypatch.setattr(FD, "_launcher", lambda: Launcher())
    specs = [_port_spec(JD.DEMO_QUERY),
             _port_spec(OTHER_STRUCTURE["count measure"]),
             _port_spec(JD.DEMO_QUERY, now=JD.DEMO_NOW + 900)]
    handles = [FD.structure_kernel(spec, CPU) for spec in specs]
    assert handles == [4096, 8192, 4096]
    assert [b[0] for b in builds] == [FD.launcher_item()] * 2
    assert [b[1] for b in builds] == [FD.build_item(s.source)
                                      for s in specs[:2]]
    assert builds[0][1] != builds[1][1]
    assert [(ni, nf) for _, ni, nf, _ in loads] == [
        (len(s.lits_i), len(s.lits_f)) for s in specs[:2]]
    name, text, kind = FD.launcher_item()
    assert kind == "host" and text == cuda_build.csrc_text(FD.LAUNCH_SOURCE)
    # no plan's text in it: the ABI block alone of the template
    assert "#define ARES_K1_ABI_ONLY" in text
    assert "#define ARES_NI" not in text and "ares_row" not in text


UNFUSED = {
    "Q1": JD.DEMO_QUERY,
    "count by city": _q(measures=[{"sqlExpression": "count(*)"}],
                        dimensions=[{"sqlExpression": "city_id"}]),
}


@pytest.mark.parametrize("name", sorted(UNFUSED))
def test_ares_fused_0_takes_the_unfused_kernel_in_both_packages(
        name, monkeypatch):
    """Both packages over two live batches of FD_MIN_ROWS trips, each with
    a kernel cache of its own: under ARES_FUSED=0 the answers agree and
    the port makes no FusedDenseKernel; without it, the same plan on the
    same batches makes one a batch size."""
    from tests.test_torch_service import (TRIPS, _assert_same,
                                          _random_batches, _services)

    made = []
    real = FD.FusedDenseKernel.__init__

    def init(self, *args, **kw):
        made.append(self)
        real(self, *args, **kw)

    monkeypatch.setattr(FD.FusedDenseKernel, "__init__", init)
    n = 2 * FD.FD_MIN_ROWS
    trips = dict(TRIPS, config={"batchSize": FD.FD_MIN_ROWS,
                                "recordRetentionInDays": 0})
    jsvc, tsvc = _services([trips], _random_batches(n, 4, n))
    tsvc.executor.kernel_cache = K.KernelCache()
    monkeypatch.setenv("ARES_FUSED", "0")
    _assert_same(UNFUSED[name], jsvc, tsvc)
    assert made == []
    monkeypatch.delenv("ARES_FUSED")
    tsvc.executor.kernel_cache = K.KernelCache()
    tsvc.handle_aql({"queries": [UNFUSED[name]]})
    assert len(made) == 1
