"""The inputs and checks of `chip_smoke.py`, on the CPU.

The K3 phase holds the kernel against its plain version on the card; what
it feeds the kernel and how it compares the results is plain numpy and
torch, checked here: the Q5 batch is one real batch of the end-to-end
phase's data, the NaN and inf case puts each in a slot of its own, and
`check_close` holds non-finite values to the indices it is given. The
end-to-end phase runs here for the joined, listing and HLL queries at a
small size, with the kernel wrappers counting their plain versions as
launches: its launch, rerun and oracle checks run as on the card. So do
the geo queries (G1-G3, G2 under ARES_GEO2=0) and the events phase with
its MemStore recovery, at a small size; the geo oracle is held against
the JAX package's matched_shape, and the zones128 table, the events rows
and the new launch counts against what the smoke's docstring states.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import chip_smoke as S
from aresdb_tpu_torch import demo
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import pallas_ops as P


def test_q5_batch_is_one_real_batch_on_8_of_128_slots():
    slots, vals = S.q5_batch(0)
    assert slots.shape == (S.BATCH_ROWS,) and slots.dtype == np.int32
    assert vals.shape == (S.BATCH_ROWS, 3) and vals.dtype == np.float32
    # every row falls in the 20-hour window and in the dense domain: one
    # or two days of month x three statuses and null
    live, counts = np.unique(slots, return_counts=True)
    assert live.min() >= 0 and live.max() < 128 and len(live) == 8
    assert counts.sum() == S.BATCH_ROWS
    # the dense layout: measure, 0/1 valid count, 1 presence
    assert set(np.unique(vals[:, 1]).tolist()) == {0.0, 1.0}
    assert np.all(vals[:, 2] == 1.0)
    # the phase's cases name the functions the profiler reports
    pat = re.compile(S.KERNEL_FUNCS["K3"])
    assert all(pat.fullmatch(case[4]) for case in S.K3_CASES)
    assert S.K3_CASES[0][:4] == ("uniform 128", 128, 3, "dense")
    assert [c[0] for c in S.K3_CASES].count(S.K3_Q5_CASE) == 1


def test_nan_and_inf_fall_in_slots_of_their_own():
    rng = np.random.RandomState(5)
    q5 = (rng.choice([49, 50, 53, 54], 4096).astype(np.int32),
          rng.rand(4096, 3).astype(np.float32))
    slots, vals, nonfinite = S.k3_inputs(128, 3, "Q5 nan inf", rng, q5)
    assert np.array_equal(slots, q5[0])
    assert np.isnan(vals).sum() == 1 and np.isinf(vals).sum() == 1
    assert len({s for _, s in nonfinite}) == 2
    out = P.dense_segment_sum_plain(torch.from_numpy(slots),
                                    torch.from_numpy(vals), 128).t()
    err = S.check_close("plain", out, out, exact_rows=(1, 2),
                        nonfinite=nonfinite)
    assert err == 0.0
    got = out.numpy()
    assert np.isnan(got[nonfinite[0]]) and np.isposinf(got[nonfinite[1]])
    assert np.isfinite(got).sum() == got.size - 2
    # the input it was given is left as it was
    assert np.isfinite(q5[1]).all()


@pytest.mark.parametrize("got_value,listed,ok", [
    (np.nan, True, True),        # the listed NaN, in both
    (np.inf, True, False),       # inf where the reference holds NaN
    (1.0, True, False),          # finite where NaN is expected
    (np.nan, False, False),      # a NaN that is not listed
])
def test_check_close_holds_nonfinite_values_to_their_indices(got_value,
                                                             listed, ok):
    want = torch.ones((3, 8))
    want[0, 5] = float("nan") if listed else 1.0
    got = want.clone()
    got[0, 5] = float(got_value)
    nonfinite = [(0, 5)] if listed else []
    if ok:
        assert S.check_close("case", got, want, nonfinite=nonfinite) == 0.0
    else:
        with pytest.raises(AssertionError):
            S.check_close("case", got, want, nonfinite=nonfinite)


PTXAS_LOG = """ptxas info    : Compiling entry function 'fused_dense_kernel' for 'sm_90a'
ptxas info    : Function properties for fused_dense_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 51 registers, used 1 barriers, 128 bytes smem
ptxas info    : Function properties for _Z19segment_sum_clusterILi3EEvPKiPKfx10HistLayoutPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_logs_are_read_function_by_function():
    usage = S.ptxas_functions(PTXAS_LOG)
    assert usage == {
        "fused_dense_kernel": {"registers": 51, "stack_bytes": 0,
                               "spill_bytes": 0},
        "_Z19segment_sum_clusterILi3EEvPKiPKfx10HistLayoutPf": {
            "registers": 40, "stack_bytes": 8, "spill_bytes": 8}}
    # NVRTC's log, where its ptxas ran, words the frame line its own way
    nvrtc_log = PTXAS_LOG.replace("\n    0 bytes stack",
                                  "\nptxas         .     0 bytes stack")
    assert nvrtc_log != PTXAS_LOG
    assert S.ptxas_functions(nvrtc_log) == usage


@pytest.fixture
def cpu_rehearsal(monkeypatch):
    """The smoke's end-to-end phase on the CPU, as on the card: K2 and K3
    take their CUDA routes (ARES_FACTORED=1, ARES_PALLAS=1), and every
    kernel wrapper adds one to its count when it runs its plain version,
    where on the card it launches the kernel."""
    monkeypatch.setenv("ARES_FACTORED", "1")
    monkeypatch.setenv("ARES_PALLAS", "1")

    def counted(fn):
        def wrapper(*args, **kw):
            wrapper.launches += 1
            return fn(*args, **kw)
        wrapper.launches = 0
        return wrapper

    for name in ("segment_sum", "dense_segment_sum"):
        monkeypatch.setattr(P, name, counted(getattr(P, name)))
    real = FD.FusedDenseKernel.reduce

    def reduce(self, *args, **kw):
        FD.FusedDenseKernel.launches += 1
        return real(self, *args, **kw)

    monkeypatch.setattr(FD.FusedDenseKernel, "reduce", reduce)


def test_phase_e2e_runs_the_new_queries_with_their_launches(cpu_rehearsal,
                                                            capsys):
    """J1, J2, N1, N2, H1 and H2 over three batches of FD_MIN_ROWS rows:
    the launch and rerun counts assert inside the phase, every answer
    against the CPU service, N1's rows and H1's and H2's estimates against
    the numpy oracles over the ingested rows."""
    names = ("J1", "J2", "N1", "N2", "H1", "H2")
    batch = FD.FD_MIN_ROWS
    launches, in_situ = S.phase_e2e(3 * batch, 0, warm=1, device="cpu",
                                    batch_rows=batch, names=names)
    # J1: K1 on every batch of both runs; J2: K2 on every batch
    assert launches == {"K1": 6, "K2": 6, "K3": 0}
    out = capsys.readouterr().out
    for name in names:
        assert f"{name}: cuda result matches the cpu run" in out
    assert "H2: application/hll frame of" in out
    assert "batches scanned 1" in out   # N1 stops after the first batch


def test_phase_mesh_and_phase_pool_follow_the_trips_queries(cpu_rehearsal,
                                                             capsys):
    """phase_e2e with its mesh and pool steps over three batches of
    FD_MIN_ROWS rows: Q1, Q2, J1, H1 and H2 as mesh batches over 4 `cpu`
    entries, each equal to its single-device answer, its K2 calls
    MESH_RUNS times the rehearsal's and its mesh counters checked inside
    the phase; then 8 threads x 4 requests through a pool of two `cpu`
    entries, both serving, with the launches of the requests made."""
    names = ("Q1", "Q2", "J1", "H1", "H2")
    batch = FD.FD_MIN_ROWS
    launches, in_situ = S.phase_e2e(3 * batch, 0, warm=1, device="cpu",
                                    batch_rows=batch, names=names,
                                    mesh=names, pool=True)
    out = capsys.readouterr().out
    assert "trips mesh: ARES_MESH=1 over 4 entries of cpu" in out
    for name in names:
        assert f"{name} mesh: warm " in out
        assert f"{name} mesh: cuda result matches the cpu run" in out
    # every run of a mesh query through K2: Q1, Q2 and J1's four shards a
    # batch fit the runtime-dense table; the HLL queries launch nothing
    k2 = {}
    for name in names:
        m = re.search(rf"{name} mesh: .*K2 (\d+) launches = 3 x the CPU "
                      rf"rehearsal's (\d+)", out)
        k2[name] = (int(m.group(1)), int(m.group(2)))
    for name in ("Q1", "Q2", "J1"):   # a launch a shard, and reruns
        assert k2[name][0] == 3 * k2[name][1] >= 3 * 3 * 4, name
    assert k2["H1"] == k2["H2"] == (0, 0)
    pool = re.search(r"pool: DevicePool\(\[cpu, cpu\]\), 8 threads x 4 "
                     r"requests of Q1, Q2, J1, H1: served \[(\d+), (\d+)\]",
                     out)
    assert pool and int(pool.group(1)) + int(pool.group(2)) == 32
    assert min(int(pool.group(1)), int(pool.group(2))) > 0
    # e2e: 2 runs of Q1, J1 (K1) and Q2 (K2) over 3 batches; Q1 once
    # under ARES_FUSED=0 (K2); the mesh's K2; pool: 8 requests of each of
    # Q1, J1 (K1) and Q2 (K2)
    assert launches == {"K1": 2 * 3 + 2 * 3 + 16 * 3,
                        "K2": 2 * 3 + 3 + sum(g for g, _ in k2.values())
                        + 8 * 3, "K3": 0}
    assert re.search(r"Q1 ARES_FUSED=0: [0-9.]+ ms, launches K1=0 K2=3 K3=0, "
                     r"equal to the cpu run's Q1", out)
    # phase_window: Q1 at now and a quarter-hour on, K1 on its 3 batches
    assert "window Q1: now + 0 s" in out
    assert [(r["move_s"], r["builds"], r["k1_launches"])
            for r in S.WINDOW["Q1"]["runs"]] == [(0, 0, 3), (900, 0, 3)]


def test_phase_mesh_reruns_the_batches_that_outgrow_its_capacity(
        cpu_rehearsal, capsys):
    """Q3 (by minute x city, sorted) and Q4 (runtime-dense) as mesh
    batches over three batches of FD_MIN_ROWS rows, against the CPU
    service's single-device answers: the merged or a shard's group count
    past the mesh's capacity of 4,096 reruns the batch on the
    single-device ladder, and the answers stay equal."""
    from aresdb_tpu_torch.query.service import QueryService

    batch = FD.FD_MIN_ROWS
    store, _, _ = S.ingest_trips(3 * batch, 0, batch)
    queries = {n: S.e2e_queries(demo)[n][:2] for n in ("Q3", "Q4")}
    svc = QueryService(store, device="cpu")
    single = {n: (S.ask(svc, n, q)[0], 0.0) for n, (q, _) in queries.items()}
    S.phase_mesh("trips", store, queries, single, "cpu", 3 * batch)
    out = capsys.readouterr().out
    reruns = re.search(r"Q3 mesh: cold .*\(ladder, overflow\) reruns by run "
                       r"\[\((\d+), 0\)", out)
    assert reruns and int(reruns.group(1)) >= 3
    for name in queries:
        assert f"{name} mesh: cuda result matches the cpu run" in out


def test_phase_mesh_runs_g1_and_e1_in_their_phases(cpu_rehearsal,
                                                    monkeypatch, capsys):
    """G1 over atrips (live batches and archive chunks, the geo shapes
    whole on every entry) and E1 over the events MemStore (array
    stagings split by rows) as mesh batches, each equal to its phase's
    single-device answer."""
    from aresdb_tpu_torch.query import executor as X

    monkeypatch.setattr(X.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 8192)
    S.phase_atrips(4 * 4096, 0, warm=1, device="cpu", batch_rows=4096,
                   names=("G1",), mesh=("G1",))
    S.phase_events(20_000, 0, warm=1, device="cpu", batch_rows=4096,
                   mesh=("E1",))
    out = capsys.readouterr().out
    assert "atrips mesh: ARES_MESH=1" in out and "events mesh:" in out
    for name in ("G1", "E1"):
        m = re.search(rf"{name} mesh: .*?(\d+) mesh batches in 3 runs; K2 "
                      rf"(\d+) launches", out)
        # every batch and chunk on the mesh, K2 in each of its 4 shards
        assert m and int(m.group(2)) == 4 * int(m.group(1)) > 0


@pytest.mark.parametrize("join", [False, True], ids=["by_city", "j1"])
def test_k1_batches_holds_one_launcher_call_against_one_call_a_batch(
        cpu_rehearsal, capsys, join):
    """The card check of the K1 phase at a small size: A1's live and
    archive shapes (live batches of FD_MIN_ROWS rows, chunks of twice
    that), one group, the grouped tables against one `reduce` a batch,
    a launch a batch either way; with J1's joined lane, two batches a
    launcher call."""
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.query.executor import columns_from_numpy

    shapes = S.k1_batch_shapes(demo, FD.FD_MIN_ROWS, 2 * FD.FD_MIN_ROWS)
    assert [s[0] for s in shapes] == [FD.FD_MIN_ROWS, 2 * FD.FD_MIN_ROWS,
                                      2 * FD.FD_MIN_ROWS, FD.FD_MIN_ROWS]
    assert [s[2] > 0 for s in shapes] == [True, False, False, True]
    out = S.k1_batches(demo, FD, columns_from_numpy, plan_dense,
                       torch.device("cpu"), shapes, join=join)
    assert out["batches"] == 4 and out["max_abs_err"] == 0.0
    assert out["calls"] == (2 if join else 1)
    text = capsys.readouterr().out
    assert ("in 2 launcher calls match" if join else
            "in 1 launcher call match one call a batch") in text
    assert ("(J1, a joined lane)" in text) == join


def test_cities_table_and_join_filter():
    store, _, data = S.ingest_trips(5000, 3, batch_rows=2048)
    assert [len(b["fare"]) for b in data] == [2048, 2048, 904]
    cities = store.get_table_shard("cities")
    assert cities.schema.table.columns[1].name == "population"
    pops = S.city_populations(3)
    assert pops.shape == (S.N_CITIES,) and len(np.unique(pops)) > 290
    q = S.joined(S.q2_query(demo), 3)
    median = int(np.median(pops))
    assert q["joins"] == S.CITY_JOIN
    assert q["measures"][0]["rowFilters"][-1] == f"c.population > {median}"
    rows = S.listing_oracle(data, 50)
    assert len(rows) == 50 and all(len(r) == 2 for r in rows)


def test_phase_atrips_runs_the_archive_queries_with_their_launches(
        cpu_rehearsal, monkeypatch, capsys):
    """A1-C1 and G1-G3 over eight batches of FD_MIN_ROWS rows, two days of
    them archived, with the archive chunk cut to two batches' rows so
    that each day stages as two chunks: the launch counts assert inside
    the phase (K1 on every dense batch and chunk, K2 on every run-length
    chunk and on every batch and chunk of G1 and G2, none for the plans
    with no dimensions), as do runlenBatches, prefilterRowsSkipped, every
    answer against the CPU service and the numpy oracles. (G2 dense, a
    dense sweep of 4,096 edges a point, rehearses at a smaller size
    below.)"""
    from aresdb_tpu_torch.query import executor as X

    batch = FD.FD_MIN_ROWS
    monkeypatch.setattr(X.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 2 * batch)
    names = list(S.atrips_queries()) + ["G1", "G2", "G3"]
    launches, in_situ = S.phase_atrips(8 * batch, 0, warm=1, device="cpu",
                                       batch_rows=batch, names=names)
    out = capsys.readouterr().out
    # 3 live batches and 4 chunks; two runs of each query
    assert "live batches 3, archive chunks 4" in out
    assert launches == {"K1": 2 * (7 + 3 + 7 + 3 + 5 + 14),
                        "K2": 2 * (4 + 4) + 2 * 2 * 7, "K3": 0}
    for name in names:
        assert f"{name}: cuda result matches the cpu run" in out
    # phase_window: A6 at now, now + 1 and now + 2, K1 on its 5 batches
    # and chunks each time, against the cpu run and the oracle
    assert "window A6: now + 0 s" in out
    assert [(r["move_s"], r["builds"], r["k1_launches"])
            for r in S.WINDOW["A6"]["runs"]] == [(0, 0, 5), (1, 0, 5),
                                                 (2, 0, 5)]


def test_phase_atrips_runs_the_geo_queries_and_the_dense_sweep(
        cpu_rehearsal, monkeypatch, capsys):
    """G1, G2, G3 and G2 under ARES_GEO2=0 over four small batches, two
    archived chunks: K2 on every batch and chunk of the three group-bys,
    none for G3, each answer against the oracle; G2 dense against G2."""
    from aresdb_tpu_torch.query import executor as X

    monkeypatch.setattr(X.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 8192)
    launches, _ = S.phase_atrips(4 * 4096, 0, warm=1, device="cpu",
                                 batch_rows=4096, names=S.GEO_QUERIES)
    out = capsys.readouterr().out
    assert "live batches 2, archive chunks 2" in out
    assert launches == {"K1": 0, "K2": 3 * 2 * 4, "K3": 0}
    for name in S.GEO_QUERIES:
        assert f"{name}: cuda result matches the cpu run" in out


def test_geo_oracle_matches_the_jax_packages_sweep():
    """The smoke's numpy oracle against the JAX package's matched_shape on
    a few thousand points and both geo tables of the smoke (the tables'
    shapes are far from the float32 ulps where XLA:CPU's fused
    multiply-add could flip a verdict)."""
    import jax.numpy as jnp

    from aresdb_tpu.common import data_types as jdt
    from aresdb_tpu.query import geo as JG

    rng = np.random.RandomState(4)
    lat = (rng.rand(5000) * 50).astype(np.float32)
    lng = (rng.rand(5000) * 50).astype(np.float32)
    pad = (-len(lat)) % JG.ROW_TILE
    for zones in (S.BATTERY_ZONES, S.zones128_wkt()):
        shapes = [jdt.parse_geoshape(w) for _, w in zones]
        jb = JG.build_shape_batch(shapes, [k for k, _ in zones])
        want = np.asarray(JG.matched_shape(
            jnp.asarray(np.concatenate([lat, np.zeros(pad, np.float32)])),
            jnp.asarray(np.concatenate([lng, np.zeros(pad, np.float32)])),
            jnp.asarray(np.arange(len(lat) + pad) < len(lat)),
            jnp.asarray(jb.slope), jnp.asarray(jb.lat1),
            jnp.asarray(jb.lng1), jnp.asarray(jb.lng2),
            jnp.asarray(jb.onehot), jnp.int32(jb.n_shapes)))[:len(lat)]
        got = S.geo_oracle(shapes, lat, lng)
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).sum() > 100


def test_zones128_are_128_overlapping_16_gons():
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.query import geo as G

    zones = S.zones128_wkt()
    assert [k for k, _ in zones] == list(range(1, 129))
    shapes = [mdt.parse_geoshape(w) for _, w in zones]
    for (k, _), (ring,) in zip(zones, shapes):
        assert len(ring) == 17 and ring[0] == ring[-1]
        i, j = divmod(k - 1, 16)
        lats = np.array([p[0] for p in ring])
        lngs = np.array([p[1] for p in ring])
        assert abs(lats.mean() - (3.125 + 6.25 * i)) < 0.2
        assert abs(lngs[:-1].mean() - (1.5625 + 3.125 * j)) < 1e-9
        assert np.allclose(np.hypot(lats - (3.125 + 6.25 * i),
                                    lngs - (1.5625 + 3.125 * j)), 2.0)
    batch = G.build_shape_batch(shapes, [k for k, _ in zones])
    assert batch.prune_ok and batch.slab.shape == (4, 32, G.PRUNE_S)
    assert len(batch.slope) == 4096
    # lng neighbours overlap: some points have two candidates
    lo, hi = batch.bbox[0, :128], batch.bbox[1, :128]
    assert (hi[:-1] > lo[1:]).sum() >= 100


def test_phase_geo_sweep_checks_both_routes_point_by_point():
    rng = np.random.RandomState(8)
    data = {"pickup": (rng.rand(6000, 2) * 50).astype(np.float32)}
    oracle = S.geo_matches(data)
    assert set(oracle) == {"zones", "zones128", "zones128[:64]"}
    assert S.phase_geo_sweep(data["pickup"], torch.device("cpu"), oracle,
                             batch_rows=2048) == {}
    bad = dict(oracle, zones128=oracle["zones128"].copy())
    bad["zones128"][np.flatnonzero(bad["zones128"] >= 0)[0]] = -1
    with pytest.raises(AssertionError, match="zones128"):
        S.phase_geo_sweep(data["pickup"], torch.device("cpu"), bad,
                          batch_rows=2048)


def test_events_rows_are_the_batterys():
    bufs, data = S.build_events(3000, 0, 1024)
    assert len(bufs) == 3 and len(data["tags"]) == 3000
    assert np.all(np.diff(data["ts"]) >= 0)
    assert data["ts"].min() >= S.EVENTS_NOW - 2 * S.DAY
    assert data["ts"].max() < S.EVENTS_NOW
    lengths = [len(t) for t in data["tags"]]
    assert min(lengths) == 0 and max(lengths) == 4
    assert all(0 <= x < 20 for t in data["tags"] for x in t)
    assert np.all(data["score"] * 8 == np.round(data["score"] * 8))
    assert data["score"].min() >= 0 and data["score"].max() < 10
    cols = [c["type"] for c in S.EVENTS_SCHEMA_JSON["columns"]]
    assert cols == ["Uint32", "Uint32", "ArrayInt32", "Float32"]
    assert S.EVENTS_ROWS == 16 * S.EVENTS_SCHEMA_JSON["config"]["batchSize"]


def test_phase_events_recovers_and_answers_alike(cpu_rehearsal, monkeypatch,
                                                capsys):
    """E1 and E2 through a MemStore, then again after recovery: K2 on
    every live batch and archive chunk (the archived day cut into two
    chunks), the answers exactly equal to the CPU run, the oracle and,
    after recovery, the first answers."""
    from aresdb_tpu_torch.query import executor as X

    monkeypatch.setattr(X.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 8192)
    launches, _ = S.phase_events(20_000, 0, warm=1, device="cpu",
                                 batch_rows=4096)
    out = capsys.readouterr().out
    assert "live batches 3, archive chunks 2" in out
    assert "a new MemStore recovered in" in out
    # two stages x two queries x two runs x five batches
    assert launches == {"K1": 0, "K2": 2 * 2 * 2 * 5, "K3": 0}
    for name in ("E1", "E2", "E1 recovered", "E2 recovered"):
        assert f"{name}: cuda result matches the cpu run" in out


def test_runlen_k2_inputs_are_one_weighted_run_a_slot():
    """K2's run-length cases: the live runs on distinct slots of the
    16,384-slot runtime-dense table in key order, counts in the thousands,
    padded runs dropped; each slot's sum is its run's row, exactly."""
    from aresdb_tpu_torch.query import kernels as K

    assert S.RT_DENSE_SLOTS == K.RT_DENSE_CAP
    rng = np.random.RandomState(2)
    for name, n, live in S.K2_RUNLEN_CASES:
        slots, vals = S.runlen_k2_inputs(n, live, rng)
        assert slots.shape == (n,) and vals.shape == (n, 3)
        kept = slots[slots >= 0]
        assert len(kept) == live and np.all(np.diff(kept) > 0)
        assert kept.max() < S.RT_DENSE_SLOTS
        assert (vals[live:] == 0).all() and vals[:live, 2].max() > 1000
        assert (vals[:live, 2] >= vals[:live, 1]).all()
        out = P.segment_sum_plain(torch.from_numpy(slots),
                                  torch.from_numpy(vals), S.RT_DENSE_SLOTS)
        assert S.check_close(name, out.t(), out.t(), exact_rows=(1, 2)) == 0
        np.testing.assert_array_equal(out[kept].numpy(), vals[:live])


def test_phase_server_runs_the_battery_over_http(cpu_rehearsal, capsys):
    """The daemon over three batches of FD_MIN_ROWS battery trips: the 14
    shapes over HTTP against the numpy oracle and the CPU service, the
    HLL frames, 8 concurrent clients, the admission gate and the
    deadline, archiving through /dbg (two archive chunks, one below
    FD_MIN_ROWS), the shapes again and a restart. The launch counts
    assert inside the phase; over both batteries: K1 on the five dense
    shapes' batches and large chunk, K2 on the small chunk of four of
    them (B2's four slots take masked sums) and on every batch and chunk
    of the calendar shape."""
    batch = FD.FD_MIN_ROWS
    launches, _, single = S.phase_server(3 * batch, 0, warm=1, device="cpu",
                                         batch_rows=batch)
    assert sorted(single["answers"]) == sorted(single["warm_ms"]) == \
        sorted(S.server_queries())
    out = capsys.readouterr().out
    assert "live batches 3, archive chunks 0" in out
    assert "live batches 3, archive chunks 2" in out
    assert out.count("every shape equals the numpy oracle") == 2
    assert out.count(", HTTP layer ") == 2 * 14
    assert "B4: application/hll frame of" in out
    assert "every answer equals its serial one" in out
    assert "answers 'query timed out'" in out
    assert "B1 and B14 equal their first answers" in out
    # phase_window's range kind: B1 after rows in cities 300-599, against
    # the cpu run and the oracle over every row
    # (a batch of their own; K1 on it, on the recovered live batch and on
    # the large archive chunk)
    run, = S.WINDOW["B1 raised range"]["runs"]
    assert (run["builds"], run["k1_launches"]) == (0, 3)
    assert run["city_max"] >= 512
    assert "window B1: 65536 rows in cities up to" in out
    assert launches == {"K1": 2 * 5 * 3 + 2 * 5 * 4,
                        "K2": 2 * 3 + 2 * 4 * 1 + 2 * 5, "K3": 0}
    assert list(S.server_queries()) == [f"B{i}" for i in range(1, 15)]


def test_phase_cluster_runs_the_battery_through_the_broker(cpu_rehearsal,
                                                           capsys):
    """The cluster over four batches of FD_MIN_ROWS battery trips, one a
    shard, held against phase_server's answers over the same rows: the 14
    shapes through the broker against the numpy oracle and the single
    daemon (B5 the reference cluster's error), the HLL frames, archiving
    on each owner, dn2 started as a process of its own on the CPU in dn1's
    place, its peer bootstrap, each of dn1's shards counted on dn2 below
    and above the cutoff as on dn1, and the shapes again. The launch counts
    assert inside the phase: before the migration K1 on the dense shapes'
    four batches (twice for B2, the broker's sum and count) and K2 on the
    calendar shape's; after it, dn0's two live batches and four archive
    chunks (each shard's archived rows span two days; below FD_MIN_ROWS,
    so K2 on the dense shapes but B2)."""
    batch = FD.FD_MIN_ROWS
    _, _, single = S.phase_server(4 * batch, 0, warm=1, device="cpu",
                                  batch_rows=batch)
    capsys.readouterr()
    launches, _ = S.phase_cluster(4 * batch, 0, single, warm=1,
                                  device="cpu", batch_rows=batch)
    out = capsys.readouterr().out
    assert out.count("every shape equals the numpy oracle and the single "
                     "daemon") == 2
    assert out.count("the reference cluster's answer: datanode") == 2
    assert out.count("its estimates equal the single daemon's") == 4
    assert "its peer bootstrap copied" in out
    assert "cluster: dn2 holds dn1's shards whole" in out
    assert "every shape but the listing equals its first answer" in out
    assert "live batches 4, archive chunks 0 on this process's" in out
    assert "live batches 2, archive chunks 4 on this process's" in out
    # runs x batches x (B1, B10, B11, B12, and B2 twice); K2: B13 on every
    # batch and chunk, the four dense shapes on the small chunks
    assert launches == {"K1": 2 * 4 * (4 + 2) + 2 * 2 * (4 + 2),
                        "K2": 2 * 4 + 2 * 4 * 4 + 2 * (2 + 4), "K3": 0}


class _Posted:
    """A Connector's session that records what it posts."""

    def __init__(self):
        self.bodies = []

    def post(self, url, data=None, headers=None, **kw):
        self.bodies.append((url, data))
        return type("R", (), {"status_code": 200,
                              "json": lambda self: {"inserted": 0}})()


def _offline_connector():
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.common.schema import Table

    conn = Connector.__new__(Connector)
    conn.host, conn.port, conn.session = "localhost", 1, _Posted()
    tables = {t["name"]: Table.from_json(t)
              for t in (S.SERVER_TRIPS_JSON, S.CITIES_SCHEMA_JSON)}
    conn.schema = type("Schema", (), {
        "table": lambda self, name: tables[name],
        "enum_dict": lambda self, t, c: {}})()
    return conn


def test_the_connector_sends_the_bytes_of_server_upsert(monkeypatch):
    """phase_server and phase_cluster load the trips through
    Connector.insert_columns(*trips_columns(...)): the same bytes as the
    hand-built upsert they sent before; the cities through
    Connector.insert: the same rows as the columnar cities upsert."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common import upsert_batch as UB

    monkeypatch.setattr(UB.time, "time", lambda: S.SERVER_NOW)
    data = S.server_rows(5000, 0)
    conn = _offline_connector()
    for lo, hi, sid in ((0, 5000, 0), (1000, 3000, 2)):
        conn.insert_columns("trips", *S.trips_columns(data, lo, hi),
                            shard_id=sid)
        url, body = conn.session.bodies[-1]
        assert url == f"http://localhost:1/data/trips/{sid}"
        assert body == S.server_upsert(data, lo, hi)
    conn.insert("cities", ["id", "population"], S.city_rows())
    _, body = conn.session.bodies[-1]
    batch = UB.UpsertBatch(body)
    want = UB.UpsertBatch(UB.build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(S.N_CITIES, dtype=np.uint16), None, 0),
         (1, mdt.Uint32, (np.arange(S.N_CITIES, dtype=np.uint32) + 1)
          * 1000, None, 0)], S.N_CITIES))
    assert batch.num_rows == want.num_rows == S.N_CITIES
    for c in range(2):
        assert [batch.columns[c].get_value(r) for r in range(S.N_CITIES)] \
            == [want.columns[c].get_value(r) for r in range(S.N_CITIES)]


def test_stream_events_parse_to_the_oracles_rows():
    """The stream's lines through the port's subscriber rules (the job's
    columns and timestamp transformation), applied last-write-wins over
    the loaded rows, give stream_events' oracle; its mix is the
    documented one."""
    from aresdb_tpu_torch.subscriber import subscriber as SUB

    n_old, new, upd = 20_000, 3000, 1000
    data = S.server_rows(n_old, 0)
    lines, final = S.stream_events(data, new, upd, 0)
    assert len(lines) == new + upd + S.STREAM_MALFORMED
    job = S.stream_job("/dev/null", 1)["config"]
    rules = SUB.JobRules(job=S.STREAM_JOB, table="trips",
                         columns=job["columns"], sources={
                             c: SUB.Transformation(**t) for c, t
                             in job["transformations"].items()})
    rows = [SUB.parse_message(rules, line.encode()) for line in lines]
    assert sum(r is None for r in rows) == S.STREAM_MALFORMED
    rows = [r for r in rows if r is not None]
    assert rows[-1][1] >= n_old   # a new trip last
    assert sum('"request_at": "' in line for line in lines) == (new + upd) // 2
    assert {r[3] for r in rows} == set(S.STATUSES)
    got = {k: (data[k].copy() if k != "id" else None)
           for k in ("request_at", "city_id", "status", "fare",
                     "fare_valid")}
    got = {k: np.concatenate([v, np.zeros(new, v.dtype)])
           for k, v in got.items() if v is not None}
    updated = [r[1] for r in rows if r[1] < n_old]
    assert len(set(updated)) == upd
    for t, i, city, status, fare in rows:
        got["request_at"][i] = t
        got["city_id"][i] = city
        got["status"][i] = S.STATUSES.index(status)
        got["fare_valid"][i] = fare is not None
        got["fare"][i] = fare if fare is not None else \
            (got["fare"][i] if i < n_old else 0.0)
    for k, v in got.items():
        want = final[k]
        if k == "fare":
            v, want = v[final["fare_valid"]], want[final["fare_valid"]]
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert np.array_equal(final["id"], np.arange(n_old + new))


def test_phase_stream_feeds_and_queries_like_a_deployment(cpu_rehearsal,
                                                          capsys):
    """The stream phase over three batches of FD_MIN_ROWS bulk-loaded
    trips, 16,384 new trips and 8,192 updates streamed by the subscriber
    process: the count polls, the 14 shapes through QueryClient against
    the oracle of the final rows and the CPU service, the query_hll
    frames, arescli and the example tools. The launch counts assert
    inside the phase: K1 on the dense shapes' three full batches, K2 on
    the new trips' batch (below FD_MIN_ROWS) for four of them (B2 takes
    masked sums) and on every batch of the calendar shape."""
    batch = FD.FD_MIN_ROWS
    launches, _ = S.phase_stream(3 * batch, 0, warm=1, device="cpu",
                                 batch_rows=batch, new_rows=1 << 14,
                                 update_rows=1 << 13, deadline=300)
    out = capsys.readouterr().out
    assert f"{3 * batch} rows bulk-loaded through Connector" in out
    assert "24576 events landed" in out
    assert "every shape equals the numpy oracle of the final rows" in out
    assert out.count("query_hll's estimates equal the JSON answer") == 2
    assert "every statement's output equals QueryClient's answers" in out
    assert "the array length, contains and element_at queries" in out
    assert launches == {"K1": 2 * 5 * 3, "K2": 2 * 4 * 1 + 2 * 4, "K3": 0}


def test_phase_prefix_runs_the_sort_path_through_k2(cpu_rehearsal, capsys):
    """phase_e2e's Q1, Q1 overflow, H1 and H2 over three batches of
    FD_MIN_ROWS rows, then phase_prefix: the last three and M1 under
    ARES_PREFIX=0
    through a service of its own, each equal to the default route's
    answer and its numpy oracle; every sorted reduce and HLL batch within
    K2's cap launches K2 once (asserted inside the phase)."""
    names = ("Q1 overflow", "H1", "H2")
    batch = FD.FD_MIN_ROWS
    S.phase_e2e(3 * batch, 0, warm=1, device="cpu", batch_rows=batch,
                names=("Q1",) + names)
    out = capsys.readouterr().out
    for name in names + ("M1",):
        m = re.search(rf"{name} ARES_PREFIX=0: .* sorted reduces (\d+) .*"
                      rf"(\d+) through K2\), launches K1=(\d+) K2=(\d+) "
                      r"K3=0; equal to the default route's answer and the "
                      "oracle", out)
        assert m, name
        # two runs of three batches, the cold one climbing the ladder
        assert int(m.group(1)) == int(m.group(2)) >= 2 * 3, name
    assert "phase_prefix took" in out
