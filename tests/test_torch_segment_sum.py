"""K2, the slot-indexed segment sum, against the JAX package.

The port's `pallas_ops.segment_sum` (plain PyTorch version on the CPU) is
held against the Pallas kernel `factored_segment_sum_pallas` run in
interpret mode and against the XLA `factored_segment_sum`, on the same
numpy inputs. Channel 0 is an arbitrary float measure; channels 1 and 2
are the 0/1 count and presence indicators of the dense path.

Tolerances are the JAX package's (tests/test_fused_dense.py): the
indicator channels are exact, the measure channel is within rtol=2e-4,
atol=1e-3 (other summation order, and the reference's 2^-17 hi/lo split).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aresdb_tpu.query import pallas_ops as JP
from aresdb_tpu_torch.query import pallas_ops as P

RTOL, ATOL = 2e-4, 1e-3


def _inputs(n: int, n_slots: int, seed: int):
    rng = np.random.RandomState(seed)
    slots = rng.randint(-1, n_slots, n).astype(np.int32)   # -1 is dropped
    values = np.stack([(rng.rand(n) * 100 - 50).astype(np.float32),
                       (rng.rand(n) > 0.1).astype(np.float32),
                       np.ones(n, np.float32)], axis=1)
    return slots, values


def _port(slots, values, n_slots):
    out = P.segment_sum(torch.from_numpy(slots), torch.from_numpy(values),
                        n_slots)
    assert out.dtype == torch.float32 and out.shape == (n_slots, 3)
    return out.numpy()


def _assert_matches(got, want):
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_slots", [10, 513, 13_338, 65_536])
@pytest.mark.parametrize("n", [0, 100, 5000])
def test_matches_factored_pallas_kernel(n, n_slots):
    slots, values = _inputs(n, n_slots, seed=n + n_slots)
    want = np.asarray(JP.factored_segment_sum_pallas(
        slots, values, n_slots, interpret=True))
    _assert_matches(_port(slots, values, n_slots), want)


@pytest.mark.parametrize("n_slots", [10, 513, 13_338, 65_536])
@pytest.mark.parametrize("n", [0, 100, 5000])
def test_matches_factored_segment_sum(n, n_slots):
    slots, values = _inputs(n, n_slots, seed=7 * n + n_slots)
    if n == 0:
        # the XLA formulation scans row chunks and needs a row
        want = np.zeros((n_slots, 3), np.float32)
    else:
        want = np.asarray(JP.factored_segment_sum(slots, values, n_slots))
    _assert_matches(_port(slots, values, n_slots), want)


def test_out_of_range_slots_are_dropped():
    slots = torch.tensor([-5, -1, 0, 3, 4, 99], dtype=torch.int32)
    values = torch.ones((6, 3))
    out = P.segment_sum(slots, values, 4)
    np.testing.assert_array_equal(out[:, 0].numpy(), [1, 0, 0, 1])


def test_plain_version_is_the_cpu_path():
    slots, values = _inputs(300, 40, seed=1)
    s, v = torch.from_numpy(slots), torch.from_numpy(values)
    before = P.segment_sum.launches
    np.testing.assert_array_equal(P.segment_sum(s, v, 40).numpy(),
                                  P.segment_sum_plain(s, v, 40).numpy())
    assert P.segment_sum.launches == before   # no kernel launched on the CPU
