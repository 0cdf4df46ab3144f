"""Geo intersection of the port against the JAX package.

`matched` (each point's first matching shape) must be bit-equal between
the packages, on the dense sweep and the bbox walk (ARES_GEO2 on and off)
of each, for random shapes with holes, points on bbox edges and
vertices, points a few ulps from steep edge lines, candidate overflow,
open rings, shapes of over PRUNE_MAX_EDGES edges, NaN, invalid and
padded points; the port's host half equals the JAX `GeoShapeBatch`. Then
the service cases of tests/test_geo.py, geo over archived points, HLL by
a geo dimension and a listing with a geo filter go to both packages'
`QueryService` (the JAX package's with ARES_FUSED=interp) over the same
upsert bytes: keys and counts exactly, float sums within the JAX
package's 2^-17 relative error.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.schema import TableSchema as JTableSchema
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.common.upsert_batch import (UpsertBatchBuilder,
                                            build_columnar_upsert)
from aresdb_tpu.diskstore.local_diskstore import LocalDiskStore as JDisk
from aresdb_tpu.memstore.archiving import Archiver as JArchiver
from aresdb_tpu.memstore.table_shard import TableShard as JTableShard
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JMeta
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import geo as JG
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common.schema import Table as TTable
from aresdb_tpu_torch.common.schema import TableSchema as TTableSchema
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch as TUpsertBatch
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore as TDisk
from aresdb_tpu_torch.memstore.archiving import Archiver as TArchiver
from aresdb_tpu_torch.memstore.table_shard import TableShard as TTableShard
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore as TMeta
from aresdb_tpu_torch.query import geo as TG
from aresdb_tpu_torch.query.service import QueryService as TQueryService

REL = 2.0 ** -17   # the JAX package's relative measure error
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


# ---------------------------------------------------------------------------
# matched: the JAX package's two routes and the port's two
# ---------------------------------------------------------------------------

def jax_dense(batch, lats, lngs, valid):
    n = len(lats)
    pad = (-n) % JG.ROW_TILE   # the JAX sweep takes whole row tiles

    def padded(a, fill):
        return jnp.asarray(np.concatenate([a, np.full(pad, fill, a.dtype)]))

    return np.asarray(JG.matched_shape(
        padded(lats, 0), padded(lngs, 0), padded(valid, False),
        jnp.asarray(batch.slope), jnp.asarray(batch.lat1),
        jnp.asarray(batch.lng1), jnp.asarray(batch.lng2),
        jnp.asarray(batch.onehot), jnp.int32(batch.n_shapes)))[:n]


def jax_pruned(batch, lats, lngs, valid):
    m, ovf = JG.matched_shape_pruned(
        jnp.asarray(lats), jnp.asarray(lngs), jnp.asarray(valid),
        jnp.asarray(batch.tab3), jnp.asarray(batch.bbox),
        jnp.int32(batch.n_shapes))
    return np.asarray(m), bool(ovf)


def port_args(lats, lngs, valid):
    return (torch.from_numpy(lats), torch.from_numpy(lngs),
            torch.from_numpy(valid))


def assert_host_half_equal(jb, tb):
    for name in ("slope", "lat1", "lng1", "lng2"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      err_msg=name)
        assert getattr(tb, name).dtype == np.float32
    assert tb.n_shapes == jb.n_shapes
    assert tb.shape_values == jb.shape_values
    # each block's shape is the JAX one-hot's column (-1 for no shape)
    owner = np.where(jb.onehot.any(1), jb.onehot.argmax(1), -1)
    np.testing.assert_array_equal(tb.block_shape, owner)
    assert tb.prune_ok == jb.prune_ok
    if jb.prune_ok:
        np.testing.assert_array_equal(tb.bbox, jb.bbox)
        # the float32 slab is what the bfloat16 thirds add up to
        parts = jb.tab3.astype(np.float32).reshape(3, 4, -1, JG.PRUNE_S)
        np.testing.assert_array_equal(tb.slab, parts[0] + parts[1] + parts[2])


def check_matched(shapes, lats, lngs, valid, overflow=False):
    """Both packages' host halves equal, and every route's matched equal
    to the JAX dense sweep's. Returns that matched."""
    values = list(range(len(shapes)))
    jb = JG.build_shape_batch(shapes, values)
    tb = TG.build_shape_batch(shapes, values)
    assert_host_half_equal(jb, tb)
    want = jax_dense(jb, lats, lngs, valid)
    args = port_args(lats, lngs, valid)
    dense = TG.stage_shapes(tb, CPU, pruned=False)
    assert dense.slab is None
    np.testing.assert_array_equal(TG.matched_shape(*args, dense).numpy(),
                                  want)
    np.testing.assert_array_equal(TG.matched(*args, dense).numpy(), want)
    if jb.prune_ok:
        got_j, ovf_j = jax_pruned(jb, lats, lngs, valid)
        pruned = TG.stage_shapes(tb, CPU, pruned=True)
        got_t, ovf_t = TG.matched_shape_pruned(*args, pruned)
        assert ovf_j == ovf_t == overflow
        if not overflow:
            np.testing.assert_array_equal(got_j, want)
            np.testing.assert_array_equal(got_t.numpy(), want)
        np.testing.assert_array_equal(TG.matched(*args, pruned).numpy(), want)
        assert TG.matched(*args, pruned).dtype == torch.int32
    return want


def rand_polygon(rng, cx, cy, r, n_pts):
    ang = np.sort(rng.rand(n_pts) * 2 * np.pi)
    radii = r * (0.4 + 0.6 * rng.rand(n_pts))
    ring = [(float(cy + radii[i] * np.sin(ang[i])),
             float(cx + radii[i] * np.cos(ang[i]))) for i in range(n_pts)]
    ring.append(ring[0])
    return ring


def rand_points(rng, n, lo=0.0, hi=10.0):
    lats = (lo + rng.rand(n) * (hi - lo)).astype(np.float32)
    lngs = (lo + rng.rand(n) * (hi - lo)).astype(np.float32)
    return lats, lngs, rng.rand(n) > 0.05


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_random_shapes_with_holes(seed):
    """tests/test_geo_pruned.py's fuzz: up to 40 random polygons, 30% of
    them with a hole, and 4,096 points."""
    rng = np.random.RandomState(seed)
    shapes = []
    for _ in range(rng.randint(1, 40)):
        cx, cy = rng.rand(2) * 10
        polys = [rand_polygon(rng, cx, cy, 0.3 + rng.rand(),
                              rng.randint(3, 20))]
        if rng.rand() < 0.3:
            polys.append(rand_polygon(rng, cx, cy, 0.2, rng.randint(3, 8)))
        shapes.append(polys)
    lats, lngs, valid = rand_points(rng, 4096)
    want = check_matched(shapes, lats, lngs, valid)
    assert (want >= 0).any()


def test_row_chunks_give_the_same_answer(monkeypatch):
    """Chunks of a few rows (CHUNK_ELEMENTS patched) through both port
    routes, against the JAX sweep."""
    monkeypatch.setattr(TG, "CHUNK_ELEMENTS", 4096)
    rng = np.random.RandomState(11)
    shapes = [[rand_polygon(rng, cx, cy, 1.0, 12)]
              for cx, cy in rng.rand(20, 2) * 10]
    lats, lngs, valid = rand_points(rng, 3000)
    want = check_matched(shapes, lats, lngs, valid)
    assert (want >= 0).sum() > 100


def test_points_on_bbox_and_vertex_boundaries():
    shapes = [
        [[(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]],
        [[(2.0, 2.0), (3.0, 2.5), (2.5, 3.5), (2.0, 2.0)]],
    ]
    pts = [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.0), (0.5, 1.0),
           (0.0, 0.5), (1.0, 0.5), (0.5, 0.5), (2.0, 2.0), (2.5, 2.5),
           (3.0, 2.5), (2.5, 3.5), (-0.0, 0.5), (0.99999994, 0.99999994)]
    lats = np.array([p[0] for p in pts], np.float32)
    lngs = np.array([p[1] for p in pts], np.float32)
    check_matched(shapes, lats, lngs, np.ones(len(pts), bool))


def np_matched(batch, lats, lngs, valid):
    """The first shape with odd parity, by the crossing test in numpy
    float32 with every operation rounded on its own (no fused
    multiply-add) and denormals kept."""
    p, lat = lngs[:, None], lats[:, None]
    cond1 = (batch.lng1[None] > p) != (batch.lng2[None] > p)
    line = (batch.slope[None] * (p - batch.lng1[None])).astype(np.float32)
    line = (line + batch.lat1[None]).astype(np.float32)
    cross = (cond1 & (lat < line)).reshape(len(lats), -1, TG.BLOCK).sum(-1)
    out = np.full(len(lats), -1, np.int32)
    for s in range(batch.n_shapes - 1, -1, -1):
        odd = cross[:, batch.block_shape == s].sum(1) % 2 == 1
        out[odd] = s
    return np.where(valid, out, -1)


def test_near_edge_precision_of_test_geo_pruned():
    """tests/test_geo_pruned.py's near-edge case: 2,048 points 1e-7 lng
    steps from a steep edge's line."""
    rng = np.random.RandomState(7)
    shapes = [[[(0.0, 5.0), (1000.0, 5.0000048), (1000.0, 5.0001),
                (0.0, 5.00005), (0.0, 5.0)]]]
    lats = rng.rand(2048).astype(np.float32) * 1000
    lngs = np.float32(5.00003) + (rng.randint(-20, 20, 2048)
                                  ).astype(np.float32) * np.float32(1e-7)
    check_matched(shapes, lats, lngs, np.ones(2048, bool))


def test_points_ulps_from_steep_edge_lines_follow_the_float32_expression():
    """Points whose latitude is an edge's float32 line value, and one and
    two ulps either side, on steep near-vertical edges (and, where an
    edge starts at latitude 0, denormal latitudes). Both port routes
    answer as the crossing test computed with separately rounded float32
    operations (np_matched). The JAX package's two routes agree with each
    other but not with that expression here: XLA:CPU fuses the line into
    a fused multiply-add and flushes denormals (ROADMAP section 3)."""
    shapes = [[[(0.0, 5.0), (1000.0, 5.0000048), (1000.0, 5.0001),
                (0.0, 5.00005), (0.0, 5.0)]],
              [[(0.0, 100.0), (1.0, 100.0001), (0.0, 100.0002),
                (0.0, 100.0)]]]
    tb = TG.build_shape_batch(shapes, [0, 1])
    rng = np.random.RandomState(7)
    lats, lngs = [], []
    for e in np.flatnonzero(tb.lng1 != tb.lng2):
        lo, hi = sorted((tb.lng1[e], tb.lng2[e]))
        p = (lo + rng.rand(64) * (hi - lo)).astype(np.float32)
        line = tb.slope[e] * (p - tb.lng1[e])
        line = (line + tb.lat1[e]).astype(np.float32)
        for k in (-2, -1, 0, 1, 2):
            q = line.copy()
            for _ in range(abs(k)):
                q = np.nextafter(q, np.float32(np.inf if k > 0 else -np.inf))
            lats.append(q)
            lngs.append(p)
    lats, lngs = np.concatenate(lats), np.concatenate(lngs)
    valid = np.ones(len(lats), bool)
    want = np_matched(tb, lats, lngs, valid)
    assert 0 < (want >= 0).sum() < len(want)
    args = port_args(lats, lngs, valid)
    for pruned in (False, True):
        shapes_dev = TG.stage_shapes(tb, CPU, pruned)
        np.testing.assert_array_equal(
            TG.matched(*args, shapes_dev).numpy(), want)
    jb = JG.build_shape_batch(shapes, [0, 1])
    np.testing.assert_array_equal(jax_pruned(jb, lats, lngs, valid)[0],
                                  jax_dense(jb, lats, lngs, valid))


def test_steep_edge_precision():
    """tests/test_geo.py:209: a near-vertical edge at a large longitude."""
    shapes = [[[(0.0, 100.0), (1.0, 100.0001), (0.0, 100.0002),
                (0.0, 100.0)]]]
    lats = np.array([0.5, 0.99], np.float32)
    lngs = np.array([100.0001, 100.00005], np.float32)
    want = check_matched(shapes, lats, lngs, np.ones(2, bool))
    assert want.tolist() == [0, -1]


def test_shape_with_hole():
    shapes = [[
        [(0.0, 0.0), (0.0, 4.0), (4.0, 4.0), (4.0, 0.0), (0.0, 0.0)],
        [(1.0, 1.0), (1.0, 3.0), (3.0, 3.0), (3.0, 1.0), (1.0, 1.0)],
    ]]
    lats = np.array([0.5, 2.0, 5.0], np.float32)
    lngs = np.array([0.5, 2.0, 5.0], np.float32)
    want = check_matched(shapes, lats, lngs, np.ones(3, bool))
    assert want.tolist() == [0, -1, -1]


def test_overflow_past_the_round_cap_falls_back_to_the_sweep():
    shapes = []
    for i in range(TG.PRUNE_ROUNDS_CAP + 3):
        d = 1.0 + i * 1e-3
        shapes.append([[(-d, -d), (-d, d), (d, d), (d, -d), (-d, -d)]])
    lats = np.zeros(64, np.float32)
    lngs = np.zeros(64, np.float32)
    lats[1], lngs[1] = 5.0, 5.0
    want = check_matched(shapes, lats, lngs, np.ones(64, bool),
                         overflow=True)
    assert want[0] == 0 and want[1] == -1


def test_open_ring_keeps_the_sweep():
    shapes = [[[(0.0, 0.0), (0.0, 1.0), (1.0, 1.0)]]]   # not closed
    assert not TG.build_shape_batch(shapes, ["x"]).prune_ok
    lats = np.array([0.5, 0.2], np.float32)
    lngs = np.array([0.7, 0.9], np.float32)
    check_matched(shapes, lats, lngs, np.ones(2, bool))


def test_shapes_of_over_128_edges_keep_the_sweep():
    rng = np.random.RandomState(0)
    ring = rand_polygon(rng, 5, 5, 1.0, TG.PRUNE_MAX_EDGES + 10)
    assert not TG.build_shape_batch([[ring]], ["x"]).prune_ok
    lats, lngs, valid = rand_points(rng, 2048, 3.0, 7.0)
    want = check_matched([[ring]], lats, lngs, valid)
    assert (want == 0).any()


def test_nan_invalid_and_padded_points():
    shapes = [[[(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0),
                (0.0, 0.0)]]]
    rng = np.random.RandomState(3)
    lats, lngs, valid = rand_points(rng, 777)   # not a chunk multiple
    lats[5] = np.nan
    lngs[6] = np.nan
    lats[7] = lngs[7] = np.nan
    want = check_matched(shapes, lats, lngs, valid)
    assert (want[~valid] == -1).all() and (want[5:8] == -1).all()
    assert (want[valid & ~np.isnan(lats) & ~np.isnan(lngs)] == 0).all()


def test_empty_shape_batch_matches_nothing():
    jb, tb = JG.empty_shape_batch(), TG.empty_shape_batch()
    for name in ("slope", "lat1", "lng1", "lng2"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    assert TG.build_shape_batch([], []) is None
    lats = np.array([0.0, 1.0], np.float32)
    for pruned in (False, True):
        shapes = TG.stage_shapes(tb, CPU, pruned)
        got = TG.matched(*port_args(lats, lats, np.ones(2, bool)), shapes)
        assert got.tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# the service: tests/test_geo.py's cases, archived points, HLL, listings
# ---------------------------------------------------------------------------

NOW = 1_600_000_000
DAY = 86400

TRIPS = {
    "name": "trips",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "id", "type": "Uint32"},
        {"name": "request_point", "type": "GeoPoint"},
        {"name": "fare", "type": "Float32"},
    ],
    "primaryKeyColumns": [1],
    "isFactTable": True,
    "config": {"batchSize": 64, "recordRetentionInDays": 0},
}
ZONES = {
    "name": "zones",
    "columns": [{"name": "geo_uuid", "type": "UUID"},
                {"name": "shape", "type": "GeoShape"}],
    "primaryKeyColumns": [0],
    "isFactTable": False,
    "config": {"batchSize": 16},
}


class Store:
    """The store protocol the executors use: schemas and table shards."""

    def __init__(self, schemas, shards):
        self.schemas, self.shards = schemas, shards

    def get_schemas(self):
        return dict(self.schemas)

    def get_table_shard(self, name, shard_id=0):
        return self.shards[(name, shard_id)]


JAX_SIDE = (JTable, JTableSchema, JTableShard, JUpsertBatch, JMeta, JDisk,
            JArchiver)
PORT_SIDE = (TTable, TTableSchema, TTableShard, TUpsertBatch, TMeta, TDisk,
             TArchiver)


def build(side, tables, root=None, archive=None):
    """One package's store of `tables` ([(schema json, [upsert bytes])]);
    with `root`, the fact table gets a disk store there and is archived
    to `archive`."""
    table_cls, schema_cls, shard_cls, batch_cls, meta_cls, disk_cls, \
        archiver_cls = side
    schemas, shards = {}, {}
    for js, bufs in tables:
        ts = schema_cls(table_cls.from_json(js))
        if root is not None and js["isFactTable"]:
            meta, disk = meta_cls(root), disk_cls(root)
            shard = shard_cls(ts, diskstore=disk, metastore=meta)
        else:
            shard = shard_cls(ts)
        for buf in bufs:
            shard.save_upsert_batch(batch_cls(buf))
        if root is not None and js["isFactTable"]:
            archiver_cls(shard, meta, disk).archive(archive)
        schemas[js["name"]], shards[(js["name"], 0)] = ts, shard
    return Store(schemas, shards)


def services(tables, root=None, archive=None):
    jstore = build(JAX_SIDE, tables,
                   root and os.path.join(root, "jax"), archive)
    tstore = build(PORT_SIDE, tables,
                   root and os.path.join(root, "port"), archive)
    jsvc = JQueryService(jstore)
    # a kernel cache of its own, so interpret-mode kernels stay here
    jsvc.executor = JX.ShardExecutor(jstore, kernel_cache=JK.KernelCache())
    return jsvc, TQueryService(tstore, device="cpu")


def zones_bytes(zones, key_type=dt.UUID):
    zb = UpsertBatchBuilder()
    zb.add_column(0, key_type)
    zb.add_column(1, dt.GeoShape)
    for i, (key, wkt) in enumerate(zones):
        zb.add_row()
        zb.set_value(i, 0, key)
        zb.set_value(i, 1, dt.parse_geoshape(wkt))
    return zb.to_bytes()


@pytest.fixture(scope="module")
def geo_services():
    """tests/test_geo.py's six trips and two zones, plus a null point."""
    tb = UpsertBatchBuilder()
    for cid, t in enumerate((dt.Uint32, dt.Uint32, dt.GeoPoint, dt.Float32)):
        tb.add_column(cid, t)
    pts = [(0.5, 0.5), (0.2, 0.8), (0.9, 0.1), (10.5, 10.5), (10.1, 10.9),
           (50.0, 50.0), None]
    for i, p in enumerate(pts):
        tb.add_row()
        tb.set_value(i, 0, NOW - 100 - i)
        tb.set_value(i, 1, i)
        if p is not None:
            tb.set_value(i, 2, p)
        tb.set_value(i, 3, float(i + 1))
    zones = zones_bytes([((1, 0), "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"),
                         ((2, 0), "POLYGON ((10 10, 11 10, 11 11, 10 11, "
                                  "10 10))")])
    return services([(TRIPS, [tb.to_bytes()]), (ZONES, [zones])])


def zone(n):
    return dt.uuid_to_string(n, 0)


GEO_JOIN = [{"table": "zones", "alias": "g",
             "conditions": ["geography_intersects(g.shape, request_point)"]}]


def ask(svc, query, hll=False):
    request = {"queries": [dict(query, now=query.get("now", NOW))]}
    if hll:
        return svc.handle_aql_hll(request)
    return svc.handle_aql(request)


def assert_same(jr, tr, exact=False):
    assert "errors" not in tr, tr.get("errors")
    assert "errors" not in jr, jr.get("errors")
    if exact:
        assert tr == jr
        return
    (j,), (t,) = jr["results"], tr["results"]
    assert set(t) == set(j)
    for k, v in j.items():
        if isinstance(v, dict):
            assert_same({"results": [v]}, {"results": [t[k]]})
        else:
            assert t[k] == pytest.approx(v, rel=REL, abs=1e-3), k


@pytest.mark.parametrize("case", ["in", "not_in", "dimension", "empty"])
def test_service_cases_of_test_geo(geo_services, case):
    queries = {
        "in": {"measures": [{"sqlExpression": "count(*)",
                             "rowFilters": [f"g.geo_uuid IN ('{zone(1)}')"]}]},
        "not_in": {"measures": [{"sqlExpression": "count(*)", "rowFilters": [
            f"g.geo_uuid NOT IN ('{zone(1)}')"]}]},
        "dimension": {"measures": [{"sqlExpression": "sum(fare)"}],
                      "dimensions": [{"sqlExpression": "g.geo_uuid"}],
                      "rowFilters": [f"g.geo_uuid IN ('{zone(1)}', "
                                     f"'{zone(2)}')"]},
        "empty": {"measures": [{"sqlExpression": "count(*)", "rowFilters": [
            f"g.geo_uuid IN ('{zone(99)}')"]}]},
    }
    want = {"in": {"": 3.0}, "not_in": {"": 3.0},
            "dimension": {zone(1).replace("-", "").upper(): 6.0,
                          zone(2).replace("-", "").upper(): 9.0}}
    q = dict(queries[case], table="trips", joins=GEO_JOIN)
    jr, tr = (ask(svc, q) for svc in geo_services)
    assert_same(jr, tr, exact=True)
    if case in want:
        assert tr["results"][0] == want[case]
    else:
        assert tr["results"][0] in ({}, {"": 0.0})


def test_geo_join_requires_a_filter(geo_services):
    q = {"table": "trips", "joins": GEO_JOIN,
         "measures": [{"sqlExpression": "count(*)"}]}
    jr, tr = (ask(svc, q) for svc in geo_services)
    assert "geo filter" in tr["errors"][0]
    assert tr == jr


def test_listing_with_a_geo_filter(geo_services):
    q = {"table": "trips", "joins": GEO_JOIN,
         "measures": [{"sqlExpression": "1"}],
         "dimensions": [{"sqlExpression": "id"},
                        {"sqlExpression": "g.geo_uuid"}],
         "rowFilters": [f"g.geo_uuid NOT IN ('{zone(2)}')"], "limit": 10}
    jr, tr = (ask(svc, q) for svc in geo_services)
    assert_same(jr, tr, exact=True)
    rows = tr["results"][0]["matrixData"]
    assert [r[0] for r in rows] == ["0", "1", "2", "5"]


# archived points: atrips-like rows over three days, two archived, and
# the battery's two square zones beside 128 overlapping 16-gons

ATRIPS = {
    "name": "atrips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "fare", "type": "Float32"},
                {"name": "pickup", "type": "GeoPoint"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 2048, "recordRetentionInDays": 0}}
ZONES16 = {"name": "zones", "columns": [{"name": "id", "type": "Uint16"},
                                        {"name": "shape", "type": "GeoShape"}],
           "primaryKeyColumns": [0], "isFactTable": False,
           "config": {"batchSize": 256}}
BASE = NOW - NOW % DAY - 3 * DAY


def polygon_wkt(lat, lng, r, k=16):
    ang = 2 * np.pi * np.arange(k + 1) / k
    pts = [(float(lng + r * np.cos(a)), float(lat + r * np.sin(a)))
           for a in ang[:-1]]
    pts.append(pts[0])
    return "POLYGON ((" + ", ".join(f"{x!r} {y!r}" for x, y in pts) + "))"


def zones128():
    return [(1 + 16 * i + j,
             polygon_wkt(3.125 + 6.25 * i, 1.5625 + 3.125 * j, 2.0))
            for i in range(8) for j in range(16)]


@pytest.fixture(scope="module")
def archived(tmp_path_factory):
    n = 8000
    rng = np.random.RandomState(5)
    ts = np.sort(BASE + rng.randint(0, 3 * DAY, n)).astype(np.uint32)
    city = rng.randint(0, 6, n).astype(np.uint16)
    fare = (rng.rand(n) * 50).astype(np.float32)
    pts = (rng.rand(n, 2) * 50).astype(np.float32)
    pvalid = rng.rand(n) > 0.03
    bufs = [build_columnar_upsert(
        [(0, dt.Uint32, ts[lo:lo + 2048], None, 0),
         (1, dt.Uint32, np.arange(lo, min(lo + 2048, n), dtype=np.uint32),
          None, 0),
         (2, dt.Uint16, city[lo:lo + 2048], None, 0),
         (3, dt.Float32, fare[lo:lo + 2048], None, 0),
         (4, dt.GeoPoint, pts[lo:lo + 2048], pvalid[lo:lo + 2048], 0)],
        len(ts[lo:lo + 2048])) for lo in range(0, n, 2048)]
    squares = [(1, "POLYGON((0 0, 0 10, 10 10, 10 0, 0 0))"),
               (2, "POLYGON((20 20, 20 30, 30 30, 30 20, 20 20))")]
    zones = zones_bytes(squares + [(1000 + k, w) for k, w in zones128()],
                        dt.Uint16)
    svcs = services([(ATRIPS, bufs), (ZONES16, [zones])],
                    str(tmp_path_factory.mktemp("geo")), BASE + 2 * DAY)
    return svcs, dict(ts=ts, fare=fare, pts=pts, pvalid=pvalid)


ZJOIN = [{"table": "zones", "alias": "z",
          "conditions": ["geography_intersects(z.shape, pickup)"]}]
ALL128 = ", ".join(str(1000 + k) for k, _ in zones128())


@pytest.mark.parametrize("geo2", ["1", "0"])
@pytest.mark.parametrize("case", ["battery", "zones128_sum",
                                  "zones128_not_in"])
def test_geo_over_archived_points(archived, case, geo2, monkeypatch):
    """G1-G3 of chip_smoke.py at a small size, under ARES_GEO2 on and
    off, on both packages; G1 also against the squares' point counts."""
    monkeypatch.setenv("ARES_GEO2", geo2)
    walks = []
    real = TG.matched_shape_pruned

    def spy(*args):
        walks.append(len(args[0]))
        return real(*args)

    monkeypatch.setattr(TG, "matched_shape_pruned", spy)
    (jsvc, tsvc), data = archived
    queries = {
        "battery": {"measures": [{"sqlExpression": "count(*)"}],
                    "dimensions": [{"sqlExpression": "z.id"}],
                    "rowFilters": ["z.id IN (1, 2)"]},
        "zones128_sum": {"measures": [{"sqlExpression": "sum(fare)"}],
                         "dimensions": [{"sqlExpression": "z.id"}],
                         "rowFilters": [f"z.id IN ({ALL128})"]},
        "zones128_not_in": {"measures": [{"sqlExpression": "count(*)"}],
                            "rowFilters": [
                                "z.id NOT IN (" + ", ".join(
                                    str(1000 + k) for k, _ in
                                    zones128()[:64]) + ")"]},
    }
    q = dict(queries[case], table="atrips", joins=ZJOIN)
    jr, tr = (ask(svc, q) for svc in (jsvc, tsvc))
    assert_same(jr, tr, exact=case != "zones128_sum")
    # the port's batches take the bbox walk unless ARES_GEO2=0
    assert bool(walks) == (geo2 == "1")
    got = tr["results"][0]
    if case == "battery":
        lat, lng = data["pts"][:, 0], data["pts"][:, 1]
        ok = data["pvalid"]
        for key, lo, hi in (("1", 0, 10), ("2", 20, 30)):
            inside = ok & (lat > lo) & (lat < hi) & (lng > lo) & (lng < hi)
            assert got[key] == float(inside.sum())
    elif case == "zones128_sum":
        assert len(got) > 100


def test_hll_by_a_geo_dimension(archived):
    (jsvc, tsvc), _ = archived
    q = {"table": "atrips", "joins": ZJOIN,
         "measures": [{"sqlExpression": "countdistincthll(city_id)"}],
         "dimensions": [{"sqlExpression": "z.id"}],
         "rowFilters": ["z.id IN (1, 2)"]}
    jr, tr = (ask(svc, q) for svc in (jsvc, tsvc))
    assert_same(jr, tr, exact=True)
    assert set(tr["results"][0]) == {"1", "2"}
    assert ask(tsvc, q, hll=True) == ask(jsvc, q, hll=True)
