"""The keyed (sort) group-by path of the port against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package (with
ARES_FUSED=interp, so the runtime-dense branch's K2 runs its Pallas kernel
in interpret mode) and through the port on the CPU, where K2's wrapper
takes its plain version:
- key packing: `pack_dim_keys` (exact and splitmix-hashed), bit for bit,
  and `unpack_dim_keys`, value for value: the JAX package sign-extends an
  unsigned type narrower than its lane, the port reads the type's value;
- `reduce_by_key` for sum, count, avg, min, max and integer sums, with the
  runtime-dense branch on and off (tests/test_sorted_reduce.py:158-244),
  and its group-table semantics: the first k_groups keys in ascending
  order with nulls first, the sentinel in unused slots, n_groups past
  k_groups, identities for empty min/max groups, int64 integer sums, NaN
  and +/-inf per group;
- the cross-batch merges `_keyed_merge_device` and `_merge_big_device`,
  with counts past 2^24 (tests/test_large_counts.py:36);
- `QueryService.handle_aql` on the sort path: per-minute-by-city queries
  (no dense plan), the runtime-dense branch, K3 under ARES_FACTORED=0, a
  capacity-ladder rerun, a UUID group-by and an inexact key pack mixed
  with a dense pile.

Keys, slot_used, n_groups, counts and min/max are exact; float sums agree
within rtol=2e-4, atol=1e-3 (the JAX package's float-sum tolerance).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu_torch.query import executor as TX
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query import pallas_ops as P
from aresdb_tpu_torch.utils.torch_env import fetch_to_host
from tests.test_torch_service import (HOUR, NOW, TRIPS, _assert_same,
                                      _random_batches, _services)

RTOL, ATOL = 2e-4, 1e-3
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


def _jnp():
    import jax.numpy as jnp

    return jnp


def _dim_lanes(types, n, rng):
    """(values, valids) per dim, in the emitter's lane dtypes: 32-bit ints
    for integer types (Uint16 zero-extended), float32, bool, and UUIDs as
    two int64 lanes."""
    out = []
    for t in types:
        if t == dt.Bool:
            v = rng.rand(n) > 0.5
        elif t == dt.Float32:
            v = (rng.randint(-40, 40, n) * 0.25).astype(np.float32)
        elif t == dt.UUID:
            v = rng.randint(-(1 << 62), 1 << 62, (n, 2)).astype(np.int64)
        elif t == dt.Uint32:
            v = (NOW - rng.randint(0, 30, n) * HOUR).astype(np.int32)
        elif t == dt.Uint16:
            v = rng.randint(0, 65536, n).astype(np.int32)
        else:
            v = rng.randint(0, 200, n).astype(np.int32)
        out.append((v, rng.rand(n) > 0.1))
    return out


def _jvals(lanes):
    jnp = _jnp()
    return [JK._Val(jnp.asarray(v.view(np.uint64) if v.ndim == 2 else v),
                    jnp.asarray(b)) for v, b in lanes]


def _tvals(lanes):
    return [K._Val(torch.from_numpy(v), torch.from_numpy(b))
            for v, b in lanes]


def _u64(keys) -> np.ndarray:
    """JAX keys (u32 narrow or u64) in the canonical u64 space."""
    k = np.asarray(keys)
    if k.dtype == np.uint32:
        return np.where(k == np.uint32(0xFFFFFFFF), K.SENTINEL64,
                        k.astype(np.uint64))
    return k


def _port_keys(lanes, types, mask):
    return K.pack_dim_keys(_tvals(lanes), types, torch.from_numpy(mask))


PACKS = {
    "enum_bool": [dt.SmallEnum, dt.Bool],
    "time_city": [dt.Uint32, dt.Uint16],
    "fare_status": [dt.Float32, dt.SmallEnum],
    "no_dims": [],
    "uuid": [dt.UUID],
    "three_wide": [dt.Uint32, dt.Uint32, dt.Uint16],
}


@pytest.mark.parametrize("name", sorted(PACKS))
def test_pack_dim_keys_is_bit_equal_to_jax(name):
    types = PACKS[name]
    rng = np.random.RandomState(len(name))
    n = 3000
    lanes = _dim_lanes(types, n, rng)
    mask = rng.rand(n) > 0.2
    want = _u64(JK.pack_dim_keys(_jvals(lanes), types,
                                 _jnp().asarray(mask)))
    got = _port_keys(lanes, types, mask)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert K.pack_modes(types)[0] == (name not in ("uuid", "three_wide"))


@pytest.mark.parametrize("name", ["enum_bool", "time_city", "fare_status"])
def test_unpack_dim_keys_matches_jax_and_repacks(name):
    types = PACKS[name]
    rng = np.random.RandomState(7)
    n = 2000
    lanes = _dim_lanes(types, n, rng)
    mask = np.ones(n, bool)
    keys = _port_keys(lanes, types, mask).numpy().view(np.uint64)
    gkeys = np.concatenate([np.unique(keys)[:100],
                            np.full(28, K.SENTINEL64)])
    used = gkeys != K.SENTINEL64
    jv, jb = JK.unpack_dim_keys(_jnp().asarray(gkeys), _jvals(lanes), types,
                                _jnp().asarray(used))
    tv, tb = K.unpack_dim_keys(torch.from_numpy(gkeys.view(np.int64)),
                               _tvals(lanes), types, torch.from_numpy(used))
    for a, b, c, d, t in zip(tv, jv, tb, jb, types):
        np.testing.assert_array_equal(a.numpy(), _typed(b, t))
        np.testing.assert_array_equal(c.numpy(), np.asarray(d))
    # the host packing of the unpacked dims gives the keys back
    repacked = K.np_pack_dim_keys([a.numpy() for a in tv],
                                  [c.numpy() for c in tb], types)
    np.testing.assert_array_equal(repacked[used], gkeys[used])


def _jax_reduce(keys, mval, mvalid, agg, out_float, kg, lanes=None,
                types=None, strides=None):
    jnp = _jnp()
    return JK.reduce_by_key(jnp.asarray(keys), jnp.asarray(mval),
                            jnp.asarray(mvalid), agg, out_float, kg,
                            _jvals(lanes) if lanes else None,
                            dim_types=types, sortpack=bool(types),
                            dim_strides=strides)


def _port_reduce(keys, mval, mvalid, agg, out_float, kg, lanes=None,
                 types=None, strides=None):
    return K.reduce_by_key(torch.from_numpy(keys.view(np.int64)),
                           torch.from_numpy(mval), torch.from_numpy(mvalid),
                           agg, out_float, kg,
                           _tvals(lanes) if lanes else None,
                           dim_types=types, dim_strides=strides)


def _typed(values, t):
    """Unpacked dim values read as their type's value. The JAX package's
    `unpack_dim_keys` sign-extends an unsigned type narrower than its
    32-bit lane (a SmallEnum of 200 reads -56, an unused slot's all-ones
    bits -1); the port's zero-extends it (200, 255)."""
    v = np.asarray(values)
    width = K._dim_bits(t)
    if dt.is_unsigned(t) and v.dtype.kind == "i" and \
            v.dtype.itemsize * 8 > width:
        return v & ((1 << width) - 1)
    return v


def _assert_tables(got, want, exact_agg=False, types=None):
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[4]) == int(want[4])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ga, wa = got[2].numpy(), np.asarray(want[2])
    assert ga.dtype == wa.dtype
    if exact_agg:
        np.testing.assert_array_equal(ga, wa)
    else:
        np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL)
    for a, b, t in zip(got[5], want[5], types or [None] * len(got[5])):
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(b) if t is None else _typed(b, t))
    for a, b in zip(got[6], want[6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


MEASURES = {   # agg, measure lane dtype, out_float
    "sum": ("sum", np.float32, True),
    "count": ("count", np.float32, True),
    "avg": ("avg", np.float32, True),
    "min": ("min", np.float32, True),
    "max": ("max", np.float32, True),
    "int_sum": ("sum", np.int64, False),
    "int_min": ("min", np.int32, False),
    "int_max": ("max", np.int32, False),
}


@pytest.mark.parametrize("name", sorted(MEASURES))
def test_reduce_by_key_matches_jax(name):
    agg, dtype, out_float = MEASURES[name]
    rng = np.random.RandomState(11)
    n, kg = 3000, 64
    keys = rng.randint(0, 40, n).astype(np.uint64)
    keys[rng.rand(n) < 0.1] = K.SENTINEL64   # filtered rows
    mval = ((rng.rand(n) - 0.4) * 1000).astype(dtype)
    mvalid = rng.rand(n) > 0.15
    got = _port_reduce(keys, mval, mvalid, agg, out_float, kg)
    want = _jax_reduce(keys, mval, mvalid, agg, out_float, kg)
    _assert_tables(got, want, exact_agg=agg in ("min", "max")
                   or not out_float)


def _time_city(n, seed, cities=50):
    """A Uint32 hour bucket (30 values near 1.6e9, static pack 33 bits,
    never null, as a time column is not) and a Uint16 city: a runtime
    range of a few thousand slots."""
    rng = np.random.RandomState(seed)
    lanes = [((NOW - NOW % HOUR - rng.randint(0, 30, n) * HOUR)
              .astype(np.int32), np.ones(n, bool)),
             (rng.randint(0, cities, n).astype(np.int32), rng.rand(n) > 0.05)]
    types = [dt.Uint32, dt.Uint16]
    keys = _port_keys(lanes, types, rng.rand(n) > 0.1).numpy() \
        .view(np.uint64)
    mval = (rng.rand(n) * 10).astype(np.float32)
    return lanes, types, keys, mval, rng.rand(n) > 0.15


def _count_calls(monkeypatch, module, attr):
    calls = []
    real = getattr(module, attr)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, attr, spy)
    return calls


@pytest.mark.parametrize("rt", ["1", "0"])
@pytest.mark.parametrize("agg", ["sum", "count", "avg"])
def test_runtime_dense_branch_matches_jax(agg, rt, monkeypatch):
    monkeypatch.setenv("ARES_RTDENSE", rt)
    lanes, types, keys, mval, mvalid = _time_city(20000, 5)
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    fetches = fetch_to_host.calls
    got = _port_reduce(keys, mval, mvalid, agg, True, 256, lanes, types,
                       [HOUR, 1])
    # the dense decision costs one copy to the host; only it
    assert fetch_to_host.calls - fetches == int(rt == "1")
    assert len(k2) == int(rt == "1")
    want = _jax_reduce(keys, mval, mvalid, agg, True, 256, lanes, types,
                       [HOUR, 1])
    _assert_tables(got, want)
    assert int(got[4]) > 256   # n_groups counts past k_groups


def test_runtime_dense_and_sort_branches_give_one_table(monkeypatch):
    lanes, types, keys, mval, mvalid = _time_city(20000, 6)
    outs = []
    for rt in ("1", "0"):
        monkeypatch.setenv("ARES_RTDENSE", rt)
        outs.append(_port_reduce(keys, mval, mvalid, "sum", True, 4096,
                                 lanes, types, [HOUR, 1]))
    (k1, u1, a1, c1, g1, v1, b1), (k0, u0, a0, c0, g0, v0, b0) = outs
    assert torch.equal(k1, k0) and torch.equal(u1, u0)
    assert int(g1) == int(g0) and torch.equal(c1, c0)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(v1 + b1, v0 + b0):
        assert torch.equal(a, b)


def test_runtime_dense_falls_back_on_wide_ranges(monkeypatch):
    """id-like keys (a 31-bit range) take the sort branch."""
    rng = np.random.RandomState(9)
    n = 8192
    lanes = [(rng.randint(0, 1 << 31, n).astype(np.int32), np.ones(n, bool))]
    keys = _port_keys(lanes, [dt.Uint32], np.ones(n, bool)).numpy() \
        .view(np.uint64)
    mval = rng.rand(n).astype(np.float32)
    mvalid = np.ones(n, bool)
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    got = _port_reduce(keys, mval, mvalid, "sum", True, 8192, lanes,
                       [dt.Uint32])
    assert not k2
    want = _jax_reduce(keys, mval, mvalid, "sum", True, 8192, lanes,
                       [dt.Uint32])
    _assert_tables(got, want)


def test_first_k_groups_in_key_order_nulls_first_sentinel_after():
    rng = np.random.RandomState(21)
    n = 5000
    types = [dt.SmallEnum, dt.Bool]
    lanes = _dim_lanes(types, n, rng)
    lanes[0][1][:5] = False     # rows 0-4: both dims null, the 0 key
    lanes[1][1][:5] = False
    mask = np.ones(n, bool)
    keys = _port_keys(lanes, types, mask).numpy().view(np.uint64)
    live = np.unique(keys)
    assert live[0] == 0 and len(live) > 300
    mval = rng.rand(n).astype(np.float32)
    mvalid = np.ones(n, bool)
    for kg in (64, 1024):
        got = _port_reduce(keys, mval, mvalid, "sum", True, kg)
        gkeys = got[0].numpy().view(np.uint64)
        used = got[1].numpy()
        m = min(kg, len(live))
        np.testing.assert_array_equal(gkeys[:m], live[:m])
        assert used[:m].all() and not used[m:].any()
        assert (gkeys[m:] == K.SENTINEL64).all()
        assert int(got[4]) == len(live)
        _assert_tables(got, _jax_reduce(keys, mval, mvalid, "sum", True, kg))


@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("out_float", [True, False])
def test_min_max_give_the_identity_for_empty_groups(agg, out_float):
    rng = np.random.RandomState(3)
    n = 600
    keys = rng.randint(0, 5, n).astype(np.uint64)
    dtype = np.float32 if out_float else np.int32
    mval = ((rng.rand(n) - 0.5) * 100).astype(dtype)
    mvalid = keys != 2          # group 2 has no valid measure
    got = _port_reduce(keys, mval, mvalid, agg, out_float, 16)
    if out_float:
        ident = F32_MAX if agg == "min" else -F32_MAX
    else:
        info = np.iinfo(np.int32)
        ident = info.max if agg == "min" else info.min
    aggv = got[2].numpy()
    assert aggv[2] == ident and (aggv[5:] == ident).all()
    assert got[3].numpy()[2] == 0
    _assert_tables(got, _jax_reduce(keys, mval, mvalid, agg, out_float, 16),
                   exact_agg=True)


def test_integer_sums_keep_their_int64_accumulator():
    n = 64
    keys = (np.arange(n) % 2).astype(np.uint64)
    mval = np.full(n, (1 << 40) + 3, np.int64)
    got = _port_reduce(keys, mval, np.ones(n, bool), "sum", False, 4)
    assert got[2].dtype == torch.int64
    assert got[2].tolist()[:2] == [32 * ((1 << 40) + 3)] * 2


@pytest.mark.parametrize("branch", ["sort", "runtime_dense"])
def test_nan_poisons_only_its_group_and_inf_propagates(branch, monkeypatch):
    """Group 3 holds a valid NaN (the bits the JAX package's packed sort
    reserves), group 4 a +inf, group 6 both infinities, group 5 invalid
    rows: tests/test_sorted_reduce.py::test_packed_sort_nan_measure_semantics
    and kernels.py:1174-1201.

    Both branches of the port are held against the JAX package's sort
    branch. Its runtime-dense branch reduces with one-hot matmuls, where
    one NaN row turns every group of its row chunk into NaN (ROADMAP
    section 3)."""
    monkeypatch.setenv("ARES_RTDENSE", "1" if branch == "runtime_dense"
                       else "0")
    n = 4096
    rng = np.random.RandomState(5)
    lanes = [(rng.randint(0, 7, n).astype(np.int32), np.ones(n, bool))]
    types = [dt.SmallEnum]
    keys = _port_keys(lanes, types, np.ones(n, bool)).numpy().view(np.uint64)
    group = lanes[0][0]
    mval = rng.rand(n).astype(np.float32)
    mval[np.nonzero(group == 3)[0][0]] = np.uint32(0xFFFFFFFF).view(
        np.float32)
    mval[np.nonzero(group == 4)[0][0]] = np.inf
    six = np.nonzero(group == 6)[0]
    mval[six[0]], mval[six[1]] = np.inf, -np.inf
    mvalid = np.ones(n, bool)
    mvalid[np.nonzero(group == 5)[0][:4]] = False
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    got = _port_reduce(keys, mval, mvalid, "sum", True, 16, lanes, types)
    assert len(k2) == int(branch == "runtime_dense")
    aggv, cnt = got[2].numpy(), got[3].numpy()
    assert int(got[4]) == 7
    assert np.isnan(aggv[3]) and np.isnan(aggv[6]) and aggv[4] == np.inf
    for g in (0, 1, 2, 5):
        ok = (group == g) & mvalid
        assert cnt[g] == ok.sum()
        assert abs(aggv[g] - mval[ok].astype(np.float64).sum()) < 1e-3
    assert cnt[3] == (group == 3).sum()
    monkeypatch.setenv("ARES_RTDENSE", "0")
    want = _jax_reduce(keys, mval, mvalid, "sum", True, 16, lanes, types)
    np.testing.assert_array_equal(np.isnan(aggv), np.isnan(np.asarray(
        want[2])))
    _assert_tables(got, want, types=types)


def _partials(seed, n_tables=3, k=64, n_keys=100):
    """Concatenated partial group tables: each slot a distinct key of its
    table or the sentinel, one int32 dim derived from the key."""
    rng = np.random.RandomState(seed)
    keys = []
    for _ in range(n_tables):
        used = rng.randint(k // 2, k)
        t = np.full(k, K.SENTINEL64)
        t[:used] = np.sort(rng.choice(n_keys, used, replace=False)) \
            .astype(np.uint64)
        keys.append(t)
    gkeys = np.concatenate(keys)
    live = gkeys != K.SENTINEL64
    agg = np.where(live, (rng.rand(len(gkeys)) - 0.3) * 50, 0) \
        .astype(np.float32)
    cnt = np.where(live, rng.randint(1, 9, len(gkeys)), 0).astype(np.float32)
    dim = np.where(live, gkeys % 1000, 0).astype(np.int32)
    return gkeys, agg, cnt, dim, live


def _both(fn_j, fn_t, gkeys, agg, cnt, dim, valid, *rest):
    jnp = _jnp()
    want = fn_j(jnp.asarray(gkeys), jnp.asarray(agg), jnp.asarray(cnt),
                (jnp.asarray(dim),), (jnp.asarray(valid),), *rest)
    got = fn_t(torch.from_numpy(gkeys.view(np.int64)), torch.from_numpy(agg),
               torch.from_numpy(cnt), (torch.from_numpy(dim),),
               (torch.from_numpy(valid),), *rest)
    return got, want


@pytest.mark.parametrize("kind", ["sum", "count", "avg", "min", "max"])
def test_keyed_merge_device_matches_jax(kind):
    gkeys, agg, cnt, dim, live = _partials(1)
    got, want = _both(JX._keyed_merge_device, TX._keyed_merge_device,
                      gkeys, agg, cnt, dim, live, kind, 128)
    used = got[1].numpy()
    np.testing.assert_array_equal(used, np.asarray(want[1]))
    assert int(got[6]) == int(want[6]) == len(np.unique(gkeys[live]))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].numpy()[used],
                               np.asarray(want[2])[used], rtol=1e-6)
    for a, b in zip(got[4] + got[5], tuple(want[4]) + tuple(want[5])):
        np.testing.assert_array_equal(a.numpy()[used], np.asarray(b)[used])


def test_merge_big_device_matches_jax():
    gkeys, agg, cnt, dim, live = _partials(2)
    got, want = _both(JX._merge_big_device, TX._merge_big_device,
                      gkeys, agg, cnt, dim, live, 128)
    assert got[2].dtype == got[3].dtype == torch.float64
    _assert_tables(got, want)


def test_count_unique_keys():
    gkeys, _, _, _, live = _partials(3)
    got = TX._count_unique_keys(torch.from_numpy(gkeys.view(np.int64)))
    assert int(got) == len(np.unique(gkeys[live])) == int(
        JX._count_unique_keys(_jnp().asarray(gkeys)))


def test_big_merge_counts_past_2_24():
    n = 256
    gkeys = np.where(np.arange(n) < 5, np.uint64(3) << np.uint64(1) | 1,
                     K.SENTINEL64).astype(np.uint64)
    per = np.float32(2**24 - 1)
    wsum = np.where(np.arange(n) < 5, per, 0).astype(np.float32)
    dims = np.full(n, 3, np.int32)
    got, want = _both(JX._merge_big_device, TX._merge_big_device,
                      gkeys, wsum, wsum, dims, np.ones(n, bool), 64)
    assert int(got[3][0]) == int(got[2][0]) == 5 * (2**24 - 1)
    _assert_tables(got, want)


# -- QueryService.handle_aql on the sort path --

def _query(measure, dims, filters=(), time_filter=None):
    q = {"table": "trips", "now": NOW,
         "measures": [{"sqlExpression": measure,
                       "rowFilters": list(filters)}],
         "dimensions": [{"sqlExpression": e, "timeBucketizer": b} if b
                        else {"sqlExpression": e} for e, b in dims]}
    if time_filter:
        q["timeFilter"] = {"column": "request_at", "from": time_filter,
                           "to": "now"}
    return q


MINUTE_CITY = [("request_at", "minute"), ("city_id", None)]
# Q3 of the smoke run: no dense plan (1,442 x 513 slots), the sort branch
Q3 = _query("sum(fare)", MINUTE_CITY, ["status='completed'"],
            "24 hours ago")
# Q4: no dense plan (182 x 513 slots); live range within RT_DENSE_CAP
Q4 = _query("count(*)", MINUTE_CITY, ["city_id <= 20"], "3 hours ago")
# Q5: 32 x 4 dense slots, unfused (calendar math)
Q5 = _query("sum(fare)", [("request_at", "day of month"), ("status", None)],
            time_filter="24 hours ago")


@pytest.fixture(scope="module")
def trips():
    """6,000 demo trips (cities 1-300 over 20 hours) in three live
    batches of 2,048."""
    t = dict(TRIPS, config={"batchSize": 2048, "recordRetentionInDays": 0})
    return _services([t], _random_batches(6000, 31, 6000))


def _spy_batches(monkeypatch):
    """Counts of the port's sort-batch runs and K2 and K3 wrapper calls."""
    calls = {"sort": _count_calls(monkeypatch, TX.ShardExecutor,
                                  "_run_sort_batch"),
             "K2": _count_calls(monkeypatch, P, "segment_sum"),
             "K3": _count_calls(monkeypatch, P, "dense_segment_sum")}
    return lambda: {k: len(v) for k, v in calls.items()}


@pytest.mark.parametrize("measure", ["sum(fare)", "count(*)", "avg(fare)",
                                     "min(fare)", "max(fare)"])
def test_q3_minute_by_city_runs_on_the_sort_branch(measure, trips,
                                                   monkeypatch):
    counts = _spy_batches(monkeypatch)
    q = json.loads(json.dumps(Q3))
    q["measures"][0]["sqlExpression"] = measure
    result = _assert_same(q, *trips)
    assert counts() == {"sort": 3, "K2": 0, "K3": 0}
    assert len(result) > 1000


def test_q4_reduces_every_batch_through_k2(trips, monkeypatch):
    counts = _spy_batches(monkeypatch)
    result = _assert_same(Q4, *trips)
    assert counts() == {"sort": 3, "K2": 3, "K3": 0}
    assert len(result) > 50


def test_q5_reduces_every_batch_through_k3(trips, monkeypatch):
    monkeypatch.setenv("ARES_FACTORED", "0")
    monkeypatch.setenv("ARES_PALLAS", "1")
    counts = _spy_batches(monkeypatch)
    result = _assert_same(Q5, *trips)
    assert counts() == {"sort": 0, "K2": 0, "K3": 3}
    assert len(result) == 2 * 4   # two days of month, three statuses + NULL


def test_uuid_group_by_merges_hashed_keys(trips):
    result = _assert_same(_query("count(*)", [("uuid", None)]), *trips)
    assert len(result) == 6000


def _stats(svc, query):
    resp = svc.handle_aql({"queries": [query], "verbose": True})
    assert "errors" not in resp, resp.get("errors")
    return resp["context"][0]


def test_capacity_ladder_reruns_a_batch_and_remembers_its_hint():
    """One batch of 6,000 rows holds more than 4,096 distinct fares: the
    cold run reruns it at K = 8,192; the warm run starts there."""
    t = dict(TRIPS, config={"batchSize": 8192, "recordRetentionInDays": 0})
    jsvc, tsvc = _services([t], _random_batches(6000, 32, 6000))
    query = _query("count(*)", [("fare", None)])
    assert _stats(tsvc, query)["ladderReruns"] == 1
    warm = _stats(tsvc, query)
    # copies: the runtime-dense decision, the group count, the table
    assert warm["ladderReruns"] == 0 and warm["hostFetches"] == 3
    assert len(_assert_same(query, jsvc, tsvc)) > 4096


def test_inexact_key_pack_mixed_with_a_dense_pile(monkeypatch):
    """hour x driver (a Uint32 column) packs 66 bits, so its keys are
    hashed. The first batch's drivers (< 64) plan densely, the second's
    (up to 100,000) do not: the dense and the keyed pile merge by dim
    values (GroupTable._finalize_dict) in both packages."""
    schema = dict(TRIPS, columns=TRIPS["columns"] + [
        {"name": "driver", "type": "Uint32"}],
        config={"batchSize": 256, "recordRetentionInDays": 0})
    rng = np.random.RandomState(8)
    n = 512
    driver = np.concatenate([rng.randint(0, 60, 256),
                             rng.randint(0, 100_000, 256)]).astype(np.uint32)
    driver[256:300] = driver[:44]   # some groups in both piles
    keys = np.arange(1, n + 1, dtype=np.uint64)
    cols = [(0, dt.Uint32, (NOW - rng.randint(0, 3 * HOUR, n))
             .astype(np.uint32), None, 0),
            (1, dt.UUID, np.stack([keys, keys], 1), None, 0),
            (2, dt.Uint16, rng.randint(1, 9, n).astype(np.uint16), None, 0),
            (3, dt.SmallEnum, rng.randint(0, 3, n).astype(np.uint8), None, 0),
            (4, dt.Float32, (rng.rand(n) * 50).astype(np.float32), None, 0),
            (5, dt.Uint32, driver, rng.rand(n) > 0.05, 0)]
    jsvc, tsvc = _services([schema], [("trips", build_columnar_upsert(
        cols, n))])
    calls = _count_calls(monkeypatch, TX.GroupTable, "_finalize_dict")
    query = _query("sum(fare)", [("request_at", "hour"), ("driver", None)],
                   time_filter="24 hours ago")
    assert not K.pack_modes([dt.Uint32, dt.Uint32])[0]
    result = _assert_same(query, jsvc, tsvc)
    assert len(calls) == 1 and len(result) > 300
