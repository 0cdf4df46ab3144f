"""The cluster histogram's layout (`csrc/block_hist.cuh`), built with g++.

K1, K2 and K3 reduce through a histogram that a thread-block cluster of G
blocks splits by slot range. Its layout arithmetic (which rank owns a slot,
the bytes of each block's slice, whether a table fits, the launch policy,
and K3's copies of the table a block, `k3_layout` in
`csrc/dense_segment_sum.cu`) is host-compilable and takes the card's
limits as arguments, so these tests check it here against an H100's:
232,448 opt-in bytes of shared memory a block, clusters of up to 8 blocks
(the portable size).
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as S
from aresdb_tpu_torch.utils import cuda_build

H100_OPTIN_BYTES = 232_448
H100_MAX_CLUSTER = 8
K1_STATIC_BYTES = 32 * 4    # fused_dense_template.cuh: block_sum_int's ints
CSRC = Path(cuda_build.__file__).resolve().parents[1] / "csrc"
ENGINE_SLOTS = (128, 13_338, 16_384, 16_416, 26_650, 65_536)

HARNESS = r"""
#include "block_hist.cuh"
#include "dense_segment_sum.cu"

extern "C" void k3_layout_host(int n_slots, int C, long long optin,
                               int max_cluster, int* G, int* copies,
                               int* private_, long long* block_bytes) {
  const HistLayout L = k3_layout(n_slots, C, optin, max_cluster);
  *G = L.G;
  *copies = L.copies;
  *private_ = k3_private(L);
  *block_bytes = hist_block_bytes(L);
}

extern "C" void layout_host(int n_slots, int C, int G, int* per,
                            long long* block_bytes) {
  const HistLayout L = hist_layout(n_slots, C, G);
  *per = L.per;
  *block_bytes = hist_block_bytes(L);
}

extern "C" void owners_host(int n_slots, int C, int G, int* owner) {
  const HistLayout L = hist_layout(n_slots, C, G);
  for (int s = 0; s < n_slots; ++s) owner[s] = hist_owner(L, s);
}

// Slots s below HIST_MAX_SLOTS whose owner is not floor(s / per), over
// every per in [2, HIST_MAX_SLOTS]. The owner is monotone in s, so it is
// floor(s / per) everywhere when it is at each multiple of per and just
// before it.
extern "C" long long owner_errors_host(void) {
  long long errors = 0;
  for (int per = 2; per <= HIST_MAX_SLOTS; ++per) {
    HistLayout L = hist_layout(per, 1, 1);
    for (long long q = 1; q * per - 1 < HIST_MAX_SLOTS; ++q) {
      const int below = (int)(q * per - 1);
      errors += hist_owner(L, below) != (int)(q - 1);
      if (q * per < HIST_MAX_SLOTS) errors += hist_owner(L, below + 1) != q;
    }
  }
  return errors;
}

extern "C" int fits_host(int n_slots, int C, int G, long long static_bytes,
                         long long optin) {
  return hist_fits(hist_layout(n_slots, C, G), static_bytes, optin);
}

extern "C" int policy_host(int n_slots, int C, long long static_bytes,
                           long long optin, int max_cluster) {
  return hist_policy(n_slots, C, static_bytes, optin, max_cluster);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.fail("the host C++ compiler g++ is required for this test")
    lib = cuda_build.load_library("block_hist_layout", HARNESS, "g++",
                                  tmp_path_factory.mktemp("block_hist"))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.layout_host.argtypes = [i, i, i, p, p]
    lib.layout_host.restype = None
    lib.owners_host.argtypes = [i, i, i, p]
    lib.owners_host.restype = None
    lib.owner_errors_host.argtypes = []
    lib.owner_errors_host.restype = ll
    lib.fits_host.argtypes = [i, i, i, ll, ll]
    lib.fits_host.restype = i
    lib.policy_host.argtypes = [i, i, ll, ll, i]
    lib.policy_host.restype = i
    lib.k3_layout_host.argtypes = [i, i, ll, i, p, p, p, p]
    lib.k3_layout_host.restype = None
    return lib


def _layout(lib, n_slots, c, g):
    per, nbytes = ctypes.c_int(), ctypes.c_longlong()
    lib.layout_host(n_slots, c, g, ctypes.byref(per), ctypes.byref(nbytes))
    return per.value, nbytes.value


def _owners(lib, n_slots, c, g):
    owner = np.full(n_slots, -1, np.int32)
    lib.owners_host(n_slots, c, g, owner.ctypes.data)
    return owner


def _policy(lib, n_slots, c, static_bytes=0, optin=H100_OPTIN_BYTES,
            max_cluster=H100_MAX_CLUSTER):
    return lib.policy_host(n_slots, c, static_bytes, optin, max_cluster)


def _k3_layout(lib, n_slots, c, optin=H100_OPTIN_BYTES,
               max_cluster=H100_MAX_CLUSTER):
    """(ranks, copies a block, one copy a warp, bytes a block) of K3."""
    g, copies, private = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = ctypes.c_longlong()
    lib.k3_layout_host(n_slots, c, optin, max_cluster, ctypes.byref(g),
                       ctypes.byref(copies), ctypes.byref(private),
                       ctypes.byref(nbytes))
    return g.value, copies.value, bool(private.value), nbytes.value


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_slots", (1, 2, 3, 7, 17) + ENGINE_SLOTS)
def test_every_slot_has_exactly_one_owner_rank(lib, n_slots, g):
    per, nbytes = _layout(lib, n_slots, 3, g)
    assert per == max(-(-n_slots // g), 2)
    assert nbytes == per * 3 * 4
    owner = _owners(lib, n_slots, 3, g)
    s = np.arange(n_slots)
    np.testing.assert_array_equal(owner, s // per)
    assert owner.min() >= 0 and owner.max() < g
    local = s - owner * per
    assert local.min() >= 0 and local.max() < per
    # each rank owns one contiguous range, and no two ranks share a slot
    for r in range(g):
        mine = s[owner == r]
        np.testing.assert_array_equal(
            mine, np.arange(r * per, min((r + 1) * per, n_slots)))
    assert len(set(zip(owner.tolist(), local.tolist()))) == n_slots


def test_owner_is_exact_floor_division_over_the_whole_slot_space(lib):
    assert lib.owner_errors_host() == 0


# n_slots -> the cluster size the policy takes at C = 3: one block holds
# up to 19,370 slots (232,448 / 12 bytes), beyond that the least power
# of two
ENGINE_RANKS = {128: 1, 13_338: 1, 16_384: 1, 16_416: 1, 26_650: 2,
                65_536: 4}


@pytest.mark.parametrize("kernel", ["k2", "k1"])
@pytest.mark.parametrize("n_slots", ENGINE_SLOTS)
def test_engine_shapes_take_the_cluster_path(lib, n_slots, kernel):
    # K1 keeps block_sum_int's ints in static shared memory
    static_bytes = 0 if kernel == "k2" else K1_STATIC_BYTES
    g = _policy(lib, n_slots, 3, static_bytes)
    assert g == ENGINE_RANKS[n_slots]
    # rows reach their owner through distributed shared memory only in K1,
    # whose integer counts make remote adds native; K2's float channels
    # take slot-range tiles. K1's launch is planned in its fixed launcher,
    # and its kernel reads its rows split the same way
    source, split = (("segment_sum.cu", "HIST_SPLIT_TILES") if kernel == "k2"
                     else ("fused_dense_launch.cu", "HIST_SPLIT_DSMEM"))
    assert f"hist_plan<{split}>" in (CSRC / source).read_text()
    if kernel == "k1":
        device_code = (CSRC / "fused_dense_template.cuh").read_text()
        assert f"hist_part<{split}>" in device_code
        assert f"hist_takes<{split}>" in device_code
    per, nbytes = _layout(lib, n_slots, 3, g)
    assert nbytes + static_bytes <= H100_OPTIN_BYTES
    assert per * g >= n_slots
    assert lib.fits_host(n_slots, 3, g, static_bytes, H100_OPTIN_BYTES)


@pytest.mark.parametrize("n_slots,g", [(65_536, 8), (65_536, 16),
                                       (26_650, 2), (16_416, 1)])
def test_fits_is_the_slice_bytes_against_the_opt_in_bytes(lib, n_slots, g):
    _, nbytes = _layout(lib, n_slots, 3, g)
    want = nbytes + K1_STATIC_BYTES <= H100_OPTIN_BYTES
    assert bool(lib.fits_host(n_slots, 3, g, K1_STATIC_BYTES,
                              H100_OPTIN_BYTES)) == want
    # one byte less than the slice needs never fits
    assert not lib.fits_host(n_slots, 3, g, 0, nbytes - 1)


def test_tables_no_cluster_holds_get_no_cluster(lib):
    # 65,536 slots x 8 channels: 262 KB a block at 8 ranks, so K2 takes
    # its global-atomic kernel there
    assert _policy(lib, 65_536, 8) == 0
    assert _policy(lib, 65_536, 8, max_cluster=16) == 16
    # beyond the slot space the owner arithmetic is exact for
    assert _policy(lib, 65_537, 1) == 0
    assert not lib.fits_host(65_537, 1, 16, 0, H100_OPTIN_BYTES)
    # a card without clusters
    assert _policy(lib, 13_338, 3, max_cluster=0) == 0
    # a table one block holds needs no cluster, whatever the card allows
    assert _policy(lib, 13_338, 3, max_cluster=1) == 1


K3_WARPS = 32    # warps of a 1,024-thread block: K3's copies where they fit
# (n_slots, C) -> (ranks, copies of each block's slice) at the H100's
# limits: one copy a warp where 32 fit a block (Q5's 128 slots at any C),
# else one a block; 8 x 8,192 floats (256 KB) fit no block, so a cluster
# of 2 holds 4,096 slots a rank
K3_LAYOUTS = {(128, 1): (1, 32), (128, 3): (1, 32), (128, 8): (1, 32),
              (4_104, 1): (1, 1), (4_104, 3): (1, 1), (4_104, 8): (1, 1),
              (8_192, 1): (1, 1), (8_192, 3): (1, 1), (8_192, 8): (2, 1)}


@pytest.mark.parametrize("n_slots,c", sorted(K3_LAYOUTS))
def test_k3_layout_at_its_phase_shapes(lib, n_slots, c):
    g, copies, private, nbytes = _k3_layout(lib, n_slots, c)
    assert (g, copies) == K3_LAYOUTS[(n_slots, c)]
    # the cluster is the smallest that holds one copy, as K1's and K2's
    assert g == _policy(lib, n_slots, c)
    # warps add without atomics only into a copy of their own
    assert private == (copies == K3_WARPS)
    per, one_copy = _layout(lib, n_slots, c, g)
    assert nbytes == one_copy * copies <= H100_OPTIN_BYTES
    # one copy a block only where a copy a warp does not fit
    assert copies == K3_WARPS or K3_WARPS * one_copy > H100_OPTIN_BYTES
    assert per * g >= n_slots


def test_k3_puts_eight_channels_at_8192_slots_on_a_cluster(lib):
    g, copies, private, nbytes = _k3_layout(lib, 8_192, 8)
    assert g >= 2 and not private
    assert 8_192 * 8 * 4 > H100_OPTIN_BYTES >= nbytes
    source = (CSRC / "dense_segment_sum.cu").read_text()
    assert "hist_size<HIST_SPLIT_TILES>" in source


@pytest.mark.parametrize("optin", [48 * 1024, 100_000, H100_OPTIN_BYTES])
@pytest.mark.parametrize("max_cluster", [0, 1, 8])
def test_k3_layout_never_exceeds_the_opt_in_bytes(lib, optin, max_cluster):
    for n_slots in (1, 2, 5, 128, 605, 606, 4_104, 8_192, 19_370, 58_112,
                    58_113, 65_536):
        for c in range(1, 9):
            g, copies, private, nbytes = _k3_layout(lib, n_slots, c, optin,
                                                    max_cluster)
            if g == 0:   # the global-atomic kernel: no cluster holds it
                assert _policy(lib, n_slots, c, 0, optin, max_cluster) == 0
                continue
            assert g <= max(max_cluster, 0) and nbytes <= optin
            assert copies in (1, K3_WARPS)
            assert private == (copies == K3_WARPS)


H100_SM_SHARED_BYTES = 233_472   # 228 KB an SM, 1 KB of it kept per block


@pytest.mark.parametrize("case", S.K3_CASES, ids=lambda case: case[0])
def test_each_chip_smoke_k3_case_names_the_kernel_its_layout_takes(lib,
                                                                    case):
    _, n_slots, c, _, want = case
    g, copies, private, nbytes = _k3_layout(lib, n_slots, c)
    got = ("dense_segment_sum_global" if g == 0 else
           "dense_segment_sum_warp" if private else
           "dense_segment_sum_cluster")
    assert got == want
    if private and c <= 3:
        # the warp kernel's blocks are held to 32 registers a thread up to
        # C = 3, so that two of them share an SM: their copies must fit
        assert 2 * (nbytes + 1024) <= H100_SM_SHARED_BYTES


def test_k3_takes_global_atomics_only_where_no_cluster_of_8_holds(lib):
    # C = 8: 7,264 slots a rank fit 232,448 bytes, so a cluster of 8 holds
    # up to 58,112 slots
    assert _k3_layout(lib, 58_112, 8)[0] == 8
    assert _k3_layout(lib, 58_113, 8)[0] == 0
    assert _k3_layout(lib, 65_536, 7)[0] == 8
    # a card without clusters takes the global kernel for every table
    assert _k3_layout(lib, 128, 3, max_cluster=0)[0] == 0
