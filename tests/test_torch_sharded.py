"""The port's single-process mesh (`parallel/sharded.py`) against the JAX
package's, and against its own single-device batch bodies.

`shard_rows` and `per_shard_valid` are numpy, copied: they must give the
JAX package's arrays on random sizes. The sharded aggregation over 8
`cpu` entries equals the single-device `agg_batch_body` over the whole
batch and the JAX package's sharded kernel on its 8 host devices
(tests/test_sharded.py), and the sharded HLL kernel's registers equal
the single-device `hll_batch_body`'s.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu import demo as JD
from aresdb_tpu.parallel import sharded as JS
from aresdb_tpu_torch import demo as TD
from aresdb_tpu_torch.parallel import sharded as S
from aresdb_tpu_torch.query import kernels as TK
from aresdb_tpu_torch.query.executor import columns_from_numpy

CPU = torch.device("cpu")
REL = 2.0 ** -17


@pytest.mark.parametrize("seed", range(6))
def test_shard_rows_and_per_shard_valid_equal_the_jax_packages(seed):
    rng = np.random.RandomState(seed)
    n_dev = int(rng.choice([1, 2, 4, 8]))
    rows = int(rng.randint(1, 300))
    n = int(rng.randint(0, n_dev * rows + 1))
    lanes = (2,) if seed % 2 else ()
    values = rng.randint(0, 1 << 20, (n,) + lanes).astype(np.int32)
    validity = rng.rand(n) > 0.3
    got = S.shard_rows(values, validity, n_dev, rows)
    want = JS.shard_rows(values, validity, n_dev, rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape == (n_dev * rows,) + lanes
    got_valid = S.per_shard_valid(n, n_dev, rows)
    assert np.array_equal(got_valid, JS.per_shard_valid(n, n_dev, rows))
    assert got_valid.sum() == n and got_valid.dtype == np.int32


def test_make_mesh_takes_the_devices_it_is_given():
    assert S.make_mesh(devices=["cpu"] * 8) == [CPU] * 8
    assert S.make_mesh(2, devices=[CPU] * 8) == [CPU] * 2


def _table(out, kind="agg"):
    """{group key: (agg, cnt)} of a keyed table's used slots."""
    keys, used = out[0].numpy(), out[1].numpy()
    if kind == "agg":
        agg, cnt = out[2].numpy(), out[3].numpy()
        return {int(k): (float(a), float(c))
                for k, u, a, c in zip(keys, used, agg, cnt) if u}
    regs, cnt = out[2].numpy(), out[3].numpy()
    return {int(k): (regs[i].tobytes(), float(cnt[i]))
            for i, (k, u) in enumerate(zip(keys, used)) if u}


def test_sharded_agg_matches_single_device_and_the_jax_mesh():
    rows_per_device = 512
    k_groups = 1024
    total = 8 * rows_per_device
    plan = TD.demo_plan()
    cols_np, _ = TD.demo_columns(plan, total, seed=3, n_cities=40)
    columns = columns_from_numpy(cols_np, total, CPU)
    single = _table(TK.agg_batch_body(plan, total, 4096, columns, total,
                                      None, CPU))
    fn = S.make_sharded_agg_kernel(plan, rows_per_device, k_groups,
                                   [CPU] * 8)
    out = fn(columns, (), S.per_shard_valid(total, 8, rows_per_device), 0)
    got = _table(out)
    assert int(out[4]) == len(got)
    assert set(got) == set(single)
    for k, (agg, cnt) in single.items():
        assert got[k][0] == pytest.approx(agg, rel=REL)
        assert got[k][1] == cnt
    # the JAX package's mesh over its 8 host devices: the same groups
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    jplan = JD.demo_plan()
    jcols_np, _ = JD.demo_columns(jplan, total, seed=3, n_cities=40)
    mesh = JS.make_mesh(8)
    rs = NamedSharding(mesh, P(JS.SHARD_AXIS))
    jcols = {k: (jax.device_put(jnp.asarray(v), rs),
                 jax.device_put(jnp.asarray(b), rs))
             for k, (v, b) in jcols_np.items()}
    n_valid = jax.device_put(
        jnp.asarray(JS.per_shard_valid(total, 8, rows_per_device)), rs)
    jout = JS.make_sharded_agg_kernel(jplan, rows_per_device, k_groups,
                                      mesh)(jcols, (), n_valid, jnp.int64(0))
    jkeys, jused, jagg = (np.asarray(jout[i]) for i in range(3))
    want = {int(k): float(a) for k, u, a in zip(jkeys, jused, jagg) if u}
    assert set(want) == set(got)
    for k, a in want.items():
        assert got[k][0] == pytest.approx(a, rel=REL)


def test_a_shard_past_capacity_raises_the_group_count():
    """The merged count is 3 = K while shard 0 alone holds 4 groups: the
    batch's count is shard 0's, so the executor reruns it."""
    plan = TD.demo_plan({
        "table": "trips", "measures": [{"sqlExpression": "count(*)"}],
        "dimensions": [{"sqlExpression": "city_id"}]})
    rows = 1024
    city = np.concatenate([np.resize([1, 2, 3, 4], rows),
                           np.resize([1, 2, 3], rows)]).astype(np.uint16)
    cols = {(0, cid): (np.zeros(2 * rows, np.uint32), np.ones(2 * rows,
                                                              bool))
            for cid in plan.used_columns}
    cols[(0, plan.main_schema.column_id("city_id"))] = (
        city, np.ones(2 * rows, bool))
    columns = columns_from_numpy(cols, 2 * rows, CPU)
    fn = S.make_sharded_agg_kernel(plan, rows, 3, [CPU] * 2)
    out = fn(columns, (), S.per_shard_valid(2 * rows, 2, rows), None)
    assert int(out[1].sum()) == 3
    assert int(out[4]) == 4


def test_sharded_hll_matches_single_device():
    rows_per_device = 256
    total = 4 * rows_per_device
    plan = TD.demo_plan({
        "table": "trips",
        "measures": [{"sqlExpression": "countdistincthll(request_at)"}],
        "dimensions": [{"sqlExpression": "city_id"}]})
    cols_np, _ = TD.demo_columns(plan, total, seed=5, n_cities=20)
    columns = columns_from_numpy(cols_np, total, CPU)
    single = _table(TK.hll_batch_body(plan, total, 256, columns, total, None,
                                      CPU), "hll")
    fn = S.make_sharded_hll_kernel(plan, rows_per_device, 256, [CPU] * 4)
    out = fn(columns, (), S.per_shard_valid(total, 4, rows_per_device), 0)
    assert out[2].dtype == torch.uint8 and out[2].shape == (256, 16384)
    assert int(out[4]) == len(single)
    assert _table(out, "hll") == single
