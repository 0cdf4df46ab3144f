"""HLL distinct counts of the port against the JAX package.

The 64-bit murmur hash and the HLL value of the port run on int64 torch
tensors (torch's uint64 lacks most ops) and must give the bits of
`hll.murmur3_64` and `hll.hll_value_from_hash` on numpy uint64 for 10,000
seeded values of each width. Then `QueryService.handle_aql` of both
packages, on stores filled from the same upsert bytes, answers
countdistincthll over a Uint32, a Uint16, a UUID and a float measure,
with no, one and two dimensions; the estimates must be equal, as must
the bytes of `handle_aql_hll`'s binary frame (the registers themselves).
The capacity ladder climbs from 256 groups, and more than 4,096 groups
is an error in both. Counts, registers, estimates and wire bytes are
exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu.query import hll as JH
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.aql import AQLQuery as JQ
from aresdb_tpu.query.compiler import Compiler as JC
from aresdb_tpu_torch.query import executor as TX
from aresdb_tpu_torch.query import hll as H
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.aql import AQLQuery as TQ
from aresdb_tpu_torch.query.compiler import Compiler as TC
from tests.test_torch_service import HOUR, NOW, TRIPS, _services


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


def _values(dtype, rng, n=10_000):
    """n seeded values of one lane type, edges included: numpy values and
    the torch lane the emitter would hold for them."""
    if dtype == "uint32_as_int32":
        v = rng.randint(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v[:3] = [0, 0x7FFFFFFF, 0xFFFFFFFF]
        return v, torch.from_numpy(v.view(np.int32))
    if dtype == "uint16":
        v = rng.randint(0, 1 << 16, n).astype(np.uint16)
        return v, torch.from_numpy(v.astype(np.int32))
    if dtype == "uint8":
        v = rng.randint(0, 256, n).astype(np.uint8)
        return v, torch.from_numpy(v.astype(np.int32))
    if dtype == "int64":
        v = rng.randint(-(1 << 62), 1 << 62, n).astype(np.int64) * 2
        v[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
        return v, torch.from_numpy(v)
    v = (rng.rand(n) * 1e6).astype(np.float32)
    return v, torch.from_numpy(v)


WIDTHS = {"uint32_as_int32": 4, "uint16": 2, "uint8": 1, "int64": 8,
          "float32": 4}


@pytest.mark.parametrize("dtype", sorted(WIDTHS))
def test_torch_murmur_matches_numpy_bit_for_bit(dtype):
    rng = np.random.RandomState(WIDTHS[dtype] * 7 + len(dtype))
    v, lane = _values(dtype, rng)
    width = WIDTHS[dtype]
    want = H.murmur3_64(v, width)
    got = K.murmur3_64(lane, width)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        K.hll_value_from_hash(got).numpy().astype(np.uint32),
        H.hll_value_from_hash(want))


def test_hll_value_caps_rho_where_the_hash_has_no_bit_past_14():
    hashed = np.array([0, 1 << 14, 1 << 63, (1 << 14) - 1], np.uint64)
    got = K.hll_value_from_hash(torch.from_numpy(hashed.view(np.int64)))
    want = H.hll_value_from_hash(hashed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(want[0]) >> 16 == 64 - H.HLL_BITS


def test_the_copied_host_module_is_the_reference_verbatim():
    regs = np.random.RandomState(3).randint(0, 20, H.HLL_M).astype(np.uint8)
    assert H.compute_estimate(regs) == JH.compute_estimate(regs)
    assert H.encode_sparse(regs) == JH.encode_sparse(regs)


def _store(n_rows, batch, seed, n_cities=300):
    """Demo trips with cities 1..n_cities and an integer-valued fare, in
    live batches of `batch` rows."""
    rng = np.random.RandomState(seed)
    keys = np.arange(1, n_rows + 1, dtype=np.uint64)
    cols = [
        (0, dt.Uint32, (NOW - rng.randint(0, 20 * HOUR, n_rows))
         .astype(np.uint32), None, 0),
        (1, dt.UUID, np.stack([keys, keys * np.uint64(2654435761)], 1),
         None, 0),
        (2, dt.Uint16, rng.randint(1, n_cities + 1, n_rows)
         .astype(np.uint16), rng.rand(n_rows) > 0.02, 0),
        (3, dt.SmallEnum, rng.randint(0, 3, n_rows).astype(np.uint8),
         rng.rand(n_rows) > 0.02, 0),
        (4, dt.Float32, rng.randint(0, 5000, n_rows).astype(np.float32)
         / 4, rng.rand(n_rows) > 0.02, 0),
    ]
    trips = dict(TRIPS, config={"batchSize": batch,
                                "recordRetentionInDays": 0})
    return _services([trips], [("trips", build_columnar_upsert(cols,
                                                               n_rows))])


@pytest.fixture(scope="module")
def trips():
    """3,000 trips in live batches of 1,024 rows, 40 cities."""
    return _store(3000, 1024, 11, n_cities=40)


def _query(measure, dims=(), filters=()):
    return {"table": "trips", "now": NOW,
            "measures": [{"sqlExpression": measure,
                          "rowFilters": list(filters)}],
            "dimensions": [{"sqlExpression": e, "timeBucketizer": b} if b
                           else {"sqlExpression": e} for e, b in dims]}


def _same(query, jsvc, tsvc):
    """The JSON answers equal exactly, and so do the binary frames."""
    jr = jsvc.handle_aql({"queries": [query]})
    tr = tsvc.handle_aql({"queries": [query], "verbose": True})
    assert "errors" not in jr, jr.get("errors")
    assert "errors" not in tr, tr.get("errors")
    assert tr["results"] == jr["results"]
    jb = jsvc.handle_aql_hll({"queries": [query]})
    tb = tsvc.handle_aql_hll({"queries": [query]})
    assert tb == jb
    return tr["results"][0], tr["context"][0]


HLL_QUERIES = {
    "uint32_no_dims": ("countdistincthll(request_at)", ()),
    "uint16_by_status": ("countdistincthll(city_id)", [("status", None)]),
    "uuid_no_dims": ("countdistincthll(uuid)", ()),
    "uuid_by_city": ("hll(uuid)", [("city_id", None)]),
    "float_by_status_and_hour": ("countdistincthll(fare)",
                                 [("status", None), ("request_at", "hour")]),
    "uint32_by_city_filtered": ("countdistincthll(request_at)",
                                [("city_id", None)], ["status='completed'"]),
}


@pytest.mark.parametrize("name", sorted(HLL_QUERIES))
def test_hll_queries_match_exactly(name, trips):
    measure, dims, *filters = HLL_QUERIES[name]
    result, ctx = _same(_query(measure, dims, *filters), *trips)
    assert result and ctx["batches"] == 3


def test_estimates_stay_near_the_exact_distinct_count(trips):
    """countdistincthll(uuid) by city: every key is distinct, so each
    estimate is near its city's row count (the TPU battery's 10%
    check)."""
    result, _ = _same(_query("countdistincthll(uuid)", [("city_id", None)]),
                      *trips)
    rows = trips[1].handle_aql({"queries": [_query("count(*)",
                                               [("city_id", None)])]})
    counts = rows["results"][0]
    assert set(result) == set(counts)
    for city, est in result.items():
        assert abs(est - counts[city]) <= 0.1 * counts[city] + 1


def test_ladder_climbs_past_256_groups_and_remembers_it():
    """One batch of 2,048 rows over 600 cities: more than 256 groups, so
    the cold run reruns it at 1,024; the warm run starts there."""
    jsvc, tsvc = _store(2048, 2048, 12, n_cities=600)
    query = _query("countdistincthll(request_at)", [("city_id", None)])
    result, ctx = _same(query, jsvc, tsvc)
    assert ctx["ladderReruns"] == 1 and len(result) > 256
    warm = tsvc.handle_aql({"queries": [query], "verbose": True})
    assert warm["context"][0]["ladderReruns"] == 0
    assert warm["results"][0] == result


def test_more_than_4096_groups_is_an_error_in_both():
    jsvc, tsvc = _store(5000, 8192, 13)
    query = _query("countdistincthll(uuid)", [("uuid", None)])
    jr = jsvc.handle_aql({"queries": [query]})
    tr = tsvc.handle_aql({"queries": [query]})
    assert "exceeds 4096" in tr["errors"][0]
    assert tr == jr


def test_binary_frame_refuses_a_query_that_is_not_hll(trips):
    query = _query("count(*)", [("status", None)])
    jb = trips[0].handle_aql_hll({"queries": [query]})
    tb = trips[1].handle_aql_hll({"queries": [query]})
    assert tb == jb and b"expect hll aggregate" in tb


def test_batch_registers_match_the_jax_kernel(trips):
    """One batch's register table, group keys and counts of
    kernels.hll_batch_body against the JAX package's _hll_body_impl."""
    jsvc, tsvc = trips
    query = _query("countdistincthll(fare)", [("status", None)])
    jplan = JC(jsvc.memstore.get_schemas()).compile(JQ.from_json(query))
    tplan = TC(tsvc.memstore.get_schemas()).compile(TQ.from_json(query))
    shard = tsvc.memstore.get_table_shard("trips", 0)
    cols, n, n_pad, _, cutoff, _ = next(
        tsvc.executor._iter_batches(tplan, shard))
    np_cols = {k: (v.numpy(), b.numpy()) for k, (v, b) in cols.items()}
    jcols = {}
    for (t, c), (v, b) in np_cols.items():
        want = {dt.Uint32: np.uint32, dt.Uint16: np.uint16}.get(
            tplan.main_schema.table.columns[c].data_type)
        jcols[(t, c)] = (jnp.asarray(v.view(want) if want else v),
                         jnp.asarray(b))
    want = JK._hll_body_impl(jplan, n_pad, 8, H.HLL_M, jcols, (),
                             np.int32(n), np.int64(cutoff))
    got = K.hll_batch_body(tplan, n_pad, 8, cols, n, cutoff,
                           torch.device("cpu"))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) == 4
    assert TX.DEFAULT_HLL_CAPACITY == 256
