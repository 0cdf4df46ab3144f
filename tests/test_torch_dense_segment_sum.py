"""K3, the direct segment sum, against the JAX package.

The port's `pallas_ops.dense_segment_sum` (its plain version on the CPU)
is held against the Pallas kernel `dense_segment_sum` run in interpret
mode, on the same numpy inputs at tests/test_pallas.py's shapes, with
arbitrary floats in every channel. Then the unfused dense kernel is run
under each of its three routes (K2, K3, the plain scatter) in both
packages, as the JAX package routes it: ARES_FACTORED=1 takes K2,
ARES_FACTORED=0 ARES_PALLAS=1 takes K3 (tests/test_pallas.py:25-52),
ARES_FACTORED=0 ARES_PALLAS=0 the scatter.

Tolerances are the JAX package's: counts and row totals exact, float sums
within rtol=2e-4, atol=1e-3 (another summation order, and the MXU's).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu import demo as JD
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query import pallas_ops as JP
from aresdb_tpu.query.dense import plan_dense as j_plan_dense
from aresdb_tpu_torch import demo as TD
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query import pallas_ops as P
from aresdb_tpu_torch.query.dense import plan_dense
from aresdb_tpu_torch.query.executor import columns_from_numpy

RTOL, ATOL = 2e-4, 1e-3
CPU = torch.device("cpu")


def _inputs(n: int, n_slots: int, c: int, seed: int):
    rng = np.random.RandomState(seed)
    slots = rng.randint(-1, n_slots + 2, n).astype(np.int32)  # some dropped
    values = ((rng.rand(n, c) - 0.3) * 100).astype(np.float32)
    return slots, values


@pytest.mark.parametrize("n,n_slots,c", [(100, 10, 1), (5000, 700, 3),
                                         (2048, 513, 2), (0, 8, 3),
                                         (3000, 8192, 3)])
def test_matches_the_pallas_kernel(n, n_slots, c):
    slots, values = _inputs(n, n_slots, c, seed=n + n_slots + c)
    want = np.asarray(JP.dense_segment_sum(slots, values, n_slots,
                                           interpret=True))
    got = P.dense_segment_sum(torch.from_numpy(slots),
                              torch.from_numpy(values), n_slots)
    assert got.dtype == torch.float32 and got.shape == (n_slots, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_out_of_range_slots_are_dropped():
    slots = torch.tensor([-5, -1, 0, 3, 4, 99], dtype=torch.int32)
    values = torch.full((6, 2), 2.5)
    out = P.dense_segment_sum(slots, values, 4)
    np.testing.assert_array_equal(out.numpy(),
                                  [[2.5, 2.5], [0, 0], [0, 0], [2.5, 2.5]])


def test_cpu_tensors_take_the_plain_version():
    slots, values = _inputs(400, 50, 4, seed=3)
    s, v = torch.from_numpy(slots), torch.from_numpy(values)
    before = P.dense_segment_sum.launches
    np.testing.assert_array_equal(
        P.dense_segment_sum(s, v, 50).numpy(),
        P.dense_segment_sum_plain(s, v, 50).numpy())
    assert P.dense_segment_sum.launches == before


def test_a_tensor_that_is_neither_cpu_nor_cuda_is_refused():
    slots = torch.zeros(8, dtype=torch.int32, device="meta")
    values = torch.zeros((8, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        P.dense_segment_sum(slots, values, 16)


def test_routing_predicates_follow_the_jax_package(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for var in ("ARES_FACTORED", "ARES_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    # on the accelerator by default, off on the CPU
    assert P.use_factored(128, cuda) and not P.use_factored(128, cpu)
    assert P.use_pallas(128, cuda) and not P.use_pallas(128, cpu)
    assert P.use_pallas(P.PALLAS_MAX_SLOTS, cuda)
    assert not P.use_pallas(P.PALLAS_MAX_SLOTS + 1, cuda)
    monkeypatch.setenv("ARES_FACTORED", "0")
    monkeypatch.setenv("ARES_PALLAS", "0")
    assert not P.use_factored(128, cuda) and not P.use_pallas(128, cuda)
    monkeypatch.setenv("ARES_FACTORED", "1")
    monkeypatch.setenv("ARES_PALLAS", "1")
    assert P.use_factored(128, cpu) and P.use_pallas(128, cpu)
    assert not P.use_pallas(P.PALLAS_MAX_SLOTS + 1, cpu)


ROUTES = {
    "K2": {"ARES_FACTORED": "1"},
    "K3": {"ARES_FACTORED": "0", "ARES_PALLAS": "1"},
    "scatter": {"ARES_FACTORED": "0", "ARES_PALLAS": "0"},
}


def _dense_case():
    """The demo plan over 2,048 rows (below K1's floor, so unfused) of 40
    cities, and its dense plan in each package."""
    n_rows = 2048
    jplan, tplan = JD.demo_plan(), TD.demo_plan()
    cols_np, _ = JD.demo_columns(jplan, n_rows, seed=4, n_cities=40)
    city_key = (0, jplan.main_schema.column_id("city_id"))
    stats = {city_key: int(cols_np[city_key][0].max())}
    return (n_rows, jplan, tplan, cols_np, j_plan_dense(jplan, stats),
            plan_dense(tplan, stats))


def _port_table(tplan, tdp, cols_np, n_rows):
    fn = K.make_dense_agg_kernel(tplan, n_rows, tdp, CPU)
    cols = columns_from_numpy(cols_np, n_rows, CPU)
    return [x.numpy() for x in K.run_dense_kernel(
        fn, tplan, tdp.n_slots, cols, n_rows - 9, 0, CPU)[:3]]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dense_kernel_gives_the_same_table_under_each_route(route,
                                                            monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("ARES_FUSED", "interp")
    for var, value in ROUTES[route].items():
        monkeypatch.setenv(var, value)
    n_rows, jplan, tplan, cols_np, jdp, tdp = _dense_case()
    assert tdp.n_slots == jdp.n_slots <= P.PALLAS_MAX_SLOTS
    jcols = {k: (jnp.asarray(v), jnp.asarray(b))
             for k, (v, b) in cols_np.items()}
    want = [np.asarray(x) for x in JK.run_dense_kernel(
        JK.make_dense_agg_kernel(jplan, n_rows, jdp), jplan, jdp.n_slots,
        jcols, (), np.int32(n_rows - 9), np.int64(0))[:3]]

    calls = {"K2": 0, "K3": 0}
    for name, attr in (("K2", "segment_sum"), ("K3", "dense_segment_sum")):
        real = getattr(P, attr)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(P, attr, spy)
    got = _port_table(tplan, tdp, cols_np, n_rows)
    assert calls == {"K2": int(route == "K2"), "K3": int(route == "K3")}
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    # and the same table as the plain scatter route
    for var, value in ROUTES["scatter"].items():
        monkeypatch.setenv(var, value)
    base = _port_table(tplan, tdp, cols_np, n_rows)
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_allclose(got[0], base[0], rtol=RTOL, atol=ATOL)
