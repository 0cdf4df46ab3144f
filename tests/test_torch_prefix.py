"""ARES_PREFIX=0: the sort path's sums and counts through K2, against the
JAX package under ARES_PREFIX=0.

With the knob the sort path's float32 sums, counts and averages add
[measure, valid] through K2, min and max count through it, integer sums
keep their int64 scatter and its float64 count, and the HLL path's valid
counts go through it (aresdb_tpu/query/kernels.py:1563-1590, 2029-2040).
The JAX package runs here under ARES_FUSED=interp, so that its K2, the
Pallas kernel behind factored_segment_sum_indicator, runs in interpret
mode; past K2's 65,536 slots it sums through an XLA one-hot matmul. The
port runs on the CPU under ARES_FACTORED=1 (on a CUDA device K2 is on by
default), where K2's wrapper takes its plain version; past the cap it
keeps its index_add_ route. The same numpy inputs, made from a seed, go
through both.

Keys, slot_used, n_groups, counts and min/max are exact, float sums within
2^-17 relative (the JAX kernel's documented bound, pallas_ops.py:206-216).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query import pallas_ops as P
from tests.test_torch_hll import _same as _same_hll
from tests.test_torch_hll import _store as _hll_store
from tests.test_torch_service import (NOW, TRIPS, _flatten,
                                      _random_batches, _services)
from tests.test_torch_sort_path import (MEASURES, MINUTE_CITY, _count_calls,
                                        _jax_reduce, _port_reduce, _query)

RTOL = 2.0 ** -17


@pytest.fixture(scope="module", autouse=True)
def prefix_off():
    """Both packages under ARES_PREFIX=0, the JAX kernels interpreted and
    the port's K2 on for the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_PREFIX", "0")
    mp.setenv("ARES_FUSED", "interp")
    mp.setenv("ARES_FACTORED", "1")
    yield
    mp.undo()


def _assert_tables(got, want):
    """Keys, slot_used, n_groups and counts exactly; min and max exactly;
    float sums within RTOL relative; integer sums exactly."""
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[4]) == int(want[4])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ga, wa = got[2].numpy(), np.asarray(want[2])
    assert ga.dtype == wa.dtype
    np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kg", [64, 16])
@pytest.mark.parametrize("name", sorted(MEASURES))
def test_sorted_reduce_through_k2_matches_jax(name, kg, monkeypatch):
    """40 live keys and sentinel rows; at k_groups 16 the rows of the 24
    keys past the table go into K2 as -1 and are dropped."""
    monkeypatch.setenv("ARES_RTDENSE", "0")
    agg, dtype, out_float = MEASURES[name]
    rng = np.random.RandomState(12)
    n = 3000
    keys = rng.randint(0, 40, n).astype(np.uint64)
    keys[rng.rand(n) < 0.1] = K.SENTINEL64
    # positive float measures, so that a relative bound means something
    mval = (rng.rand(n) * 1000).astype(dtype) if dtype == np.float32 \
        else ((rng.rand(n) - 0.4) * 1000).astype(dtype)
    mvalid = rng.rand(n) > 0.15
    calls = []
    real = P.segment_sum

    def spy(slots, values, n_slots, ones_channels=()):
        calls.append((slots.clone(), values.shape[1], n_slots))
        return real(slots, values, n_slots, ones_channels)

    monkeypatch.setattr(P, "segment_sum", spy)
    got = _port_reduce(keys, mval, mvalid, agg, out_float, kg)
    want = _jax_reduce(keys, mval, mvalid, agg, out_float, kg)
    _assert_tables(got, want)
    if name == "int_sum":
        assert not calls
        return
    ((slots, c, n_slots),) = calls
    assert n_slots == kg and c == (2 if agg in ("sum", "count", "avg")
                                   else 1)
    # each kept row on its group's slot, every other row dropped as -1
    live = keys != K.SENTINEL64
    kept = live & (keys < min(kg, 40))
    assert int((slots >= 0).sum()) == int(kept.sum())
    assert int((slots == -1).sum()) == n - int(kept.sum())
    assert int(slots.max()) == min(kg, 40) - 1
    # the same table as the default route's, its sums in float64 there
    monkeypatch.setenv("ARES_PREFIX", "1")
    default = _port_reduce(keys, mval, mvalid, agg, out_float, kg)
    for a, b in zip(got[:2] + got[3:5], default[:2] + default[3:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_a_batch_past_k2s_cap_keeps_its_index_add(agg, monkeypatch):
    """131,072 slots: the JAX package's factored sum takes its XLA one-hot
    matmul, no Pallas kernel; the port keeps index_add_ and calls no K2."""
    monkeypatch.setenv("ARES_RTDENSE", "0")
    rng = np.random.RandomState(13)
    n, kg = 70_000, 1 << 17
    assert kg > P.K2_MAX_SLOTS
    keys = rng.randint(0, 1 << 20, n).astype(np.uint64)
    mval = (rng.rand(n) * 50).astype(np.float32)
    mvalid = rng.rand(n) > 0.1
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    got = _port_reduce(keys, mval, mvalid, agg, True, kg)
    assert not k2
    assert int(got[4]) > P.K2_MAX_SLOTS
    _assert_tables(got, _jax_reduce(keys, mval, mvalid, agg, True, kg))


def test_a_nan_stays_in_its_group_where_the_jax_kernel_spreads_it(
        monkeypatch):
    """One valid NaN in group 3 of 7. The port's K2 adds it to its own
    slot; the JAX package's Pallas kernel reduces through one-hot dots,
    where NaN x 0 is NaN, so that the NaN reaches every group of its
    tile (ROADMAP section 3)."""
    monkeypatch.setenv("ARES_RTDENSE", "0")
    rng = np.random.RandomState(5)
    n = 4096
    keys = rng.randint(0, 7, n).astype(np.uint64)
    mval = rng.rand(n).astype(np.float32)
    mval[np.nonzero(keys == 3)[0][0]] = np.nan
    mvalid = np.ones(n, bool)
    got = _port_reduce(keys, mval, mvalid, "sum", True, 16)
    want = _jax_reduce(keys, mval, mvalid, "sum", True, 16)
    aggv = got[2].numpy()
    assert np.isnan(aggv[3]) and np.isfinite(np.delete(aggv[:7], 3)).all()
    for g in (0, 1, 2, 4, 5, 6):
        assert abs(aggv[g] - mval[keys == g].astype(np.float64).sum()) \
            < 1e-3
    assert np.isnan(np.asarray(want[2])[:7]).all()
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.fixture(scope="module")
def trips():
    """6,000 demo trips (cities 1-300 over 20 hours) in three live
    batches of 2,048, in services built under ARES_PREFIX=0."""
    t = dict(TRIPS, config={"batchSize": 2048, "recordRetentionInDays": 0})
    return _services([t], _random_batches(6000, 33, 6000))


@pytest.mark.parametrize("measure", ["sum(fare)", "count(*)", "avg(fare)",
                                     "min(fare)", "max(fare)"])
def test_minute_by_city_answers_alike(measure, trips, monkeypatch):
    """Q3's shape (1,442 x 513 slots, no dense plan; sort path): one K2
    call a batch and attempt."""
    monkeypatch.setenv("ARES_RTDENSE", "0")
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    q = _query(measure, MINUTE_CITY, ["status='completed'"], "24 hours ago")
    j, t = (_flatten(svc.handle_aql({"queries": [q]})["results"][0])
            for svc in trips)
    assert sorted(t) == sorted(j) and len(t) > 1000
    keys = sorted(j)
    tv, jv = (np.array([np.nan if d[k] is None else d[k] for k in keys])
              for d in (t, j))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=0)
    assert len(k2) >= 3


@pytest.fixture(scope="module")
def hll_trips():
    """3,000 trips in live batches of 1,024 rows, 40 cities, in services
    built under ARES_PREFIX=0."""
    return _hll_store(3000, 1024, 11, n_cities=40)


@pytest.mark.parametrize("measure, dims", [
    ("countdistincthll(request_at)", [("city_id", None)]),
    ("countdistincthll(uuid)", []),
    ("countdistincthll(fare)", [("status", None), ("request_at", "hour")]),
])
def test_hll_counts_through_k2_answer_alike(measure, dims, hll_trips,
                                            monkeypatch):
    """The JSON answers and the binary frames equal exactly; each batch's
    valid count went through K2."""
    k2 = _count_calls(monkeypatch, P, "segment_sum")
    q = {"table": "trips", "now": NOW,
         "measures": [{"sqlExpression": measure}],
         "dimensions": [{"sqlExpression": e, "timeBucketizer": b} if b
                        else {"sqlExpression": e} for e, b in dims]}
    result, ctx = _same_hll(q, *hll_trips)
    assert result and ctx["batches"] == 3
    # the JSON answer and the binary frame: a batch each, at least
    assert len(k2) >= 2 * 3
