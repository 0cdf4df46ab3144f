"""Mesh batches of the port (ARES_MESH=1) against the JAX package's.

The queries of tests/test_mesh_executor.py (a status sum, a random
group-by against a numpy oracle, HLL, geo and arrays), and a join, a min
and an hourly avg, go to the JAX package's QueryService under ARES_MESH=1
on its 8 host devices (ARES_FUSED=interp) and to the port's
`QueryService(device="cpu", mesh_devices=[cpu] * 8)`. Each answer equals
the other package's and the port's single-device one: keys and counts
exactly, float sums within 2^-17 relative. Every mesh query moves
`query.mesh_batches` in both packages and moves neither the port's
ineligible nor its fallback counter.

A shard whose own groups outgrow the capacity while the merged count
does not is the one place the packages differ: the JAX package loses the
groups past the capacity, the port reruns the batch (ROADMAP section 3).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu.utils import metrics as JM
from aresdb_tpu_torch.parallel import sharded as S
from aresdb_tpu_torch.query import kernels as TK
from aresdb_tpu_torch.query.executor import DEFAULT_GROUP_CAPACITY
from aresdb_tpu_torch.query.service import QueryService as TQueryService
from aresdb_tpu_torch.utils import metrics as TM
from tests import test_torch_array as TA
from tests import test_torch_geo as TG
from tests.test_torch_service import (CITIES, NOW, TRIPS, _services,
                                      _small_batches)

REL = 2.0 ** -17
MESH = [torch.device("cpu")] * 8
COUNTERS = ("mesh_batches", "mesh_ineligible_batches",
            "mesh_fallback_batches")


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


def counts(metrics) -> dict:
    snap = metrics.root().snapshot().get("counters", {})
    return {k: snap.get("query." + k, 0) for k in COUNTERS}


def same(got: dict, want: dict, where: str) -> None:
    """Keys and integral values exactly, floats within REL."""
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            same(g, w, f"{where}.{k}")
        else:
            assert g == pytest.approx(w, rel=REL, abs=1e-6), (where, k)


def on_the_mesh(jsvc, tstore, q, monkeypatch, exact=False) -> dict:
    """q through the port's single-device service, then under ARES_MESH=1
    through the port's 8-entry mesh and the JAX package's 8 devices:
    every answer alike, the mesh run on both sides, and the port's
    ineligible and fallback counters still. Returns the port's mesh
    answer."""
    request = {"queries": [q]}
    monkeypatch.delenv("ARES_MESH", raising=False)
    single = TQueryService(tstore, device="cpu").handle_aql(request)
    assert "errors" not in single, single
    monkeypatch.setenv("ARES_MESH", "1")
    mesh_svc = TQueryService(tstore, device="cpu", mesh_devices=MESH)
    t0, j0 = counts(TM), counts(JM)
    port = mesh_svc.handle_aql(request)
    jax = jsvc.handle_aql(request)
    t1, j1 = counts(TM), counts(JM)
    assert "errors" not in port and "errors" not in jax, (port, jax)
    assert t1["mesh_batches"] > t0["mesh_batches"]
    assert j1["mesh_batches"] > j0["mesh_batches"]
    assert t1["mesh_ineligible_batches"] == t0["mesh_ineligible_batches"]
    assert t1["mesh_fallback_batches"] == t0["mesh_fallback_batches"]
    (p,), (j,), (s,) = port["results"], jax["results"], single["results"]
    if exact:
        assert p == s == j
    else:
        same(p, s, "single")
        same(p, j, "jax")
    return p


@pytest.fixture(scope="module")
def small():
    """The 12 trips and 3 cities of tests/test_query_e2e.py, both
    packages: (JAX service, port store)."""
    jsvc, tsvc = _services([TRIPS, CITIES], _small_batches())
    return jsvc, tsvc.memstore


def _q(measure, dims, **extra):
    return {"table": "trips", "now": NOW,
            "measures": [{"sqlExpression": measure}],
            "dimensions": [d if isinstance(d, dict) else {"sqlExpression": d}
                           for d in dims], **extra}


SMALL = {
    "status sum": _q("sum(fare)", ["status"]),
    "join by city name": _q("count(*)", ["c.name"], joins=[
        {"table": "cities", "alias": "c", "conditions": ["c.id = city_id"]}]),
    "min by city": _q("min(fare)", ["city_id"]),
    "hourly avg": _q("avg(fare)", [{"sqlExpression": "request_at",
                                    "timeBucketizer": "hour"}]),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_mesh_query_matches_single_device_and_the_jax_mesh(small, name,
                                                           monkeypatch):
    jsvc, tstore = small
    got = on_the_mesh(jsvc, tstore, SMALL[name], monkeypatch)
    if name == "status sum":
        assert got == {"NULL": 6.0, "completed": 69.0, "canceled": 5.0,
                       "rejected": 0.0}


def test_mesh_random_oracle_equality(monkeypatch):
    """A randomized count by city over 4 batches on the mesh against a
    numpy oracle, exact groups."""
    rng = np.random.RandomState(33)
    n = 4096
    city = rng.randint(1, 40, n).astype(np.uint16)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    cols = [(0, dt.Uint32, (NOW - rng.randint(0, 3600, n)).astype(np.uint32),
             None, 0),
            (1, dt.UUID, np.stack([keys, np.zeros_like(keys)], 1), None, 0),
            (2, dt.Uint16, city, None, 0),
            (4, dt.Float32, (rng.rand(n) * 100).astype(np.float32), None, 0)]
    trips = dict(TRIPS, config={"batchSize": 1024,
                                "recordRetentionInDays": 0})
    jsvc, tsvc = _services([trips], [("trips",
                                      build_columnar_upsert(cols, n))])
    got = on_the_mesh(jsvc, tsvc.memstore, _q("count(*)", ["city_id"]),
                      monkeypatch, exact=True)
    u, c = np.unique(city, return_counts=True)
    assert got == {str(a): int(b) for a, b in zip(u, c)}


def test_mesh_hll_matches_single_device(small, monkeypatch):
    """HLL register planes merge by max on the first device: the
    estimates equal the single-device path's and the JAX mesh's
    exactly."""
    jsvc, tstore = small
    got = on_the_mesh(jsvc, tstore,
                      _q("countdistincthll(uuid)", ["status"]), monkeypatch,
                      exact=True)
    assert got == {"NULL": 1.0, "completed": 8.0, "canceled": 2.0,
                   "rejected": 1.0}


def test_mesh_geo_matches_single_device(monkeypatch):
    """Geo shapes go whole to every device (their key is (-1, 0), as the
    JAX package's (-1, i) keys), the points split by rows."""
    assert TK.GEO_SHAPES[0] < 0
    jsvc, tsvc = TG.geo_services.__wrapped__()
    q = {"table": "trips", "joins": TG.GEO_JOIN,
         "measures": [{"sqlExpression": "sum(fare)"}],
         "dimensions": [{"sqlExpression": "g.geo_uuid"}],
         "rowFilters": [f"g.geo_uuid IN ('{TG.zone(1)}', '{TG.zone(2)}')"],
         "now": TG.NOW}
    got = on_the_mesh(jsvc, tsvc.memstore, q, monkeypatch)
    assert got == {TG.zone(1).replace("-", ""): 6.0,
                   TG.zone(2).replace("-", ""): 9.0}


def test_mesh_array_matches_single_device(monkeypatch):
    """Array stagings ([n, L] items and their lanes) split by rows."""
    jsvc, tsvc = TA.live.__wrapped__()
    q = {"table": "events", "now": TA.NOW,
         "measures": [{"sqlExpression": "sum(score)",
                       "rowFilters": ["contains(tags, 2)"]}],
         "dimensions": [{"sqlExpression": "length(tags)"}]}
    got = on_the_mesh(jsvc, tsvc.memstore, q, monkeypatch)
    assert got == {"3": 1.0, "2": 2.0}


def test_a_shard_past_capacity_reruns_where_the_jax_package_loses_a_group(
        monkeypatch):
    """8 shards of 8,192 rows at the mesh's capacity K = 4,096: shard 0
    holds K + 1 cities, every other shard K of them, all among shard 0's
    first K. The merged count is K, so the JAX package reruns nothing and
    loses city K + 1; the port sees shard 0's K + 1 groups, reruns the
    batch on the single-device ladder and answers every group."""
    k = DEFAULT_GROUP_CAPACITY
    rows = 2 * k
    n = 8 * rows
    i = np.arange(n)
    city = (np.where(i < rows, i % (k + 1), i % k) + 1).astype(np.uint16)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    cols = [(0, dt.Uint32, np.full(n, NOW - 60, np.uint32), None, 0),
            (1, dt.UUID, np.stack([keys, keys], 1), None, 0),
            (2, dt.Uint16, city, None, 0)]
    trips = dict(TRIPS, config={"batchSize": n, "recordRetentionInDays": 0})
    jsvc, tsvc = _services([trips], [("trips",
                                      build_columnar_upsert(cols, n))])
    request = {"queries": [_q("count(*)", ["city_id"])], "verbose": True}
    u, c = np.unique(city, return_counts=True)
    oracle = {str(a): int(b) for a, b in zip(u, c)}
    assert len(oracle) == k + 1
    monkeypatch.setenv("ARES_MESH", "1")
    port = TQueryService(tsvc.memstore, device="cpu",
                         mesh_devices=MESH).handle_aql(request)
    jax = jsvc.handle_aql(request)
    assert port["results"] == [oracle]
    assert port["context"][0]["ladderReruns"] == 1
    assert jax["results"] == [{g: v for g, v in oracle.items()
                               if g != str(k + 1)}]


def test_a_failing_mesh_batch_runs_on_the_single_device_path(
        small, monkeypatch, caplog):
    """A mesh batch that raises never fails the query: the batch runs on
    the single-device path, with the JAX package's log line and
    counter."""
    _, tstore = small

    def broken(*args, **kw):
        raise RuntimeError("mesh broken")

    monkeypatch.setattr(S, "make_sharded_agg_kernel", broken)
    monkeypatch.setenv("ARES_MESH", "1")
    q = _q("sum(fare)", ["city_id", "status"])
    svc = TQueryService(tstore, device="cpu", mesh_devices=MESH)
    before = counts(TM)
    with caplog.at_level(logging.ERROR, logger="aresdb.executor"):
        got = svc.handle_aql({"queries": [q]})
    after = counts(TM)
    assert after["mesh_fallback_batches"] == \
        before["mesh_fallback_batches"] + 1
    assert after["mesh_batches"] == before["mesh_batches"]
    assert "falling back to single-chip path" in caplog.text
    monkeypatch.delenv("ARES_MESH")
    assert got == TQueryService(tstore, device="cpu").handle_aql(
        {"queries": [q]})


@pytest.mark.parametrize("devices", [[torch.device("cpu")], None],
                         ids=["one entry", "the default"])
def test_one_device_is_ineligible(small, monkeypatch, devices):
    """Fewer than 2 devices (a `cpu` executor's default mesh is itself):
    the batch is counted ineligible and runs on the single-device path."""
    _, tstore = small
    monkeypatch.setenv("ARES_MESH", "1")
    svc = TQueryService(tstore, device="cpu", mesh_devices=devices)
    assert len(svc.executor.mesh_devices) == 1
    before = counts(TM)
    got = svc.handle_aql({"queries": [SMALL["status sum"]]})
    after = counts(TM)
    assert after["mesh_ineligible_batches"] > \
        before["mesh_ineligible_batches"]
    assert after["mesh_batches"] == before["mesh_batches"]
    assert got["results"] == [{"NULL": 6.0, "completed": 69.0,
                               "canceled": 5.0, "rejected": 0.0}]
