"""The inputs and checks of `chip_smoke.py`'s K3 phase, on the CPU.

The K3 phase holds the kernel against its plain version on the card; what
it feeds the kernel and how it compares the results is plain numpy and
torch, checked here: the Q5 batch is one real batch of the end-to-end
phase's data, the NaN and inf case puts each in a slot of its own, and
`check_close` holds non-finite values to the indices it is given.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import chip_smoke as S
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
