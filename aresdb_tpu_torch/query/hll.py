"""HyperLogLog distinct counting: device register build + host estimation.

Reference: query/hll.cu (HyperLogLog kernel), query/common/hll.go (HLL
struct, Compute with Google bias correction, sparse/dense binary encodings,
magic 0xACED0101 wire format), utils/hll.go (ComputeHLLValue: group = low 14
bits of the 64-bit hash, rho = count of zero bits from bit 14, value encoded
rho<<16|group), client/connector.go computeHLLValue (murmur3-128 x64 first
half for ints, p1^p2 for UUIDs).

TPU design: the measure lane yields the 32-bit hll value per row; the
register build is one segment-max over (group_slot * 16384 + reg_id) —
static shape [K * 16384] — and estimation runs on host from the fetched
register planes.
"""

from __future__ import annotations

import struct
import numpy as np

from aresdb_tpu_torch.query.hll_bias_data import (
    BIASES,
    HLL_THRESHOLD,
    RAW_ESTIMATES,
)

HLL_BITS = 14
HLL_M = 1 << HLL_BITS  # 16384 registers
HLL_DENSE_THRESHOLD = HLL_M // 4  # reference DenseDataLength/4 heuristic

_RAW = np.asarray(RAW_ESTIMATES)
_BIAS = np.asarray(BIASES)


# ---------------------------------------------------------------------------
# murmur3 x64 128 (first 64 bits) for 4/8-byte keys — vectorized numpy/jnp
# ---------------------------------------------------------------------------

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _u64(x):
    return x.astype(np.uint64) if hasattr(x, "astype") else np.uint64(x)


def _rotl64(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _fmix64(k):
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xFF51AFD7ED558CCD)
    k = k ^ (k >> np.uint64(33))
    k = k * np.uint64(0xC4CEB9FE1A85EC53)
    k = k ^ (k >> np.uint64(33))
    return k


def murmur3_64(values, width_bytes: int, xp=np):
    """First 64 bits of murmur3 x64 128 with seed 0 for ≤8-byte LE keys.

    Matches utils.Murmur3Sum64 (reference utils/hash.go:202) for the tail-only
    case (len < 16).
    """
    if xp is np:
        k1 = values.astype(np.uint64)
        u = lambda v: np.uint64(v)
    else:
        k1 = values.astype(xp.uint64)
        u = lambda v: xp.uint64(v)
    if width_bytes < 8:
        k1 = k1 & u((1 << (8 * width_bytes)) - 1)
    length = u(width_bytes)
    h1 = u(0)
    h2 = u(0)
    k1 = k1 * u(_C1)
    k1 = _rotl64(k1, 31)
    k1 = k1 * u(_C2)
    h1 = h1 ^ k1
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    return h1


def hll_value_from_hash(hashed, xp=np):
    """hash(u64) → hll value (rho << 16 | group), vectorized.

    Go semantics (utils/hll.go ComputeHLLValue): rho = number of zero bits of
    the hash starting at bit 14 (capped so rho+14 < 64).
    """
    u = (lambda v: np.uint64(v)) if xp is np else (lambda v: xp.uint64(v))
    group = (hashed & u((1 << HLL_BITS) - 1)).astype(
        np.uint32 if xp is np else xp.uint32)
    rest = hashed >> u(HLL_BITS)
    # rho = count of trailing zeros of `rest` via progressive halving
    # (branch-free, vector friendly); Go's loop caps at rho + 14 < 64
    dtype = np.uint32 if xp is np else xp.uint32
    x = rest
    rho = xp.zeros(hashed.shape, dtype)
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (x & u((1 << shift) - 1)) == 0
        rho = rho + xp.where(mask, shift, 0).astype(dtype)
        x = xp.where(mask, x >> u(shift), x)
    rho = xp.minimum(rho, np.uint32(64 - HLL_BITS))
    return (rho.astype(group.dtype) << np.uint32(16)) | group


# ---------------------------------------------------------------------------
# estimation (reference HLL.Compute, query/common/hll.go:735)
# ---------------------------------------------------------------------------

def _estimate_bias(estimate: float) -> float:
    i = int(np.searchsorted(_RAW, estimate, side="right"))
    k = 6
    start = max(0, i - 1 - k)
    end = min(len(_RAW), i + k)
    d = (_RAW[start:end] - estimate) ** 2
    order = np.argsort(d, kind="stable")[:k]
    return float(_BIAS[start:end][order].mean())


def estimate_from_stats(sum_recip: float, non_zero: float) -> float:
    """HLL.Compute's scalar tail given the two register reductions
    (Σ 2^-rho + zeros, #non-zero) — the only register-dependent inputs.
    The executor computes these reductions ON DEVICE so JSON queries fetch
    16 bytes per group instead of the 16KB register plane."""
    m = float(HLL_M)
    alpha = 0.7213 / (1 + 1.079 / m)
    estimate = alpha * m * m / sum_recip
    if estimate <= 5.0 * m:
        estimate -= _estimate_bias(estimate)
    estimate_h = estimate
    if non_zero < m:
        estimate_h = m * np.log(m / (m - non_zero))
    if estimate_h <= HLL_THRESHOLD:
        estimate = estimate_h
    return float(int(estimate))


def compute_estimate(registers: np.ndarray) -> float:
    """registers: uint8[16384] holding the STORED rho (0 = never observed).

    The reference's write functor adds 1 to the raw trailing-zero count
    before storing ("rho must plus 1", query/functor.hpp:1364), so stored
    registers are the standard HLL rank (>= 1) and HLL.Compute
    (query/common/hll.go:735) uses them directly in 1/2^rho — as do we.
    """
    m = float(HLL_M)
    present = registers > 0
    non_zero = float(np.count_nonzero(present))
    rho = registers[present].astype(np.int64)
    sum_recip = float(np.sum(np.ldexp(1.0, -rho))) + (m - non_zero)
    return estimate_from_stats(sum_recip, non_zero)


# ---------------------------------------------------------------------------
# binary wire format (reference query/common/hll.go HLLData; magic 0xACED0101)
# ---------------------------------------------------------------------------

HLL_MAGIC = 0xACED0101


def encode_dense(registers: np.ndarray) -> bytes:
    """Dense wire bytes = the stored registers verbatim (0 = empty,
    else rho >= 1 — the +1 applied at write time, functor.hpp:1364,
    guarantees a present register is never 0)."""
    return registers.astype(np.uint8).tobytes()


def encode_sparse(registers: np.ndarray, padding: bool = True) -> bytes:
    idx = np.nonzero(registers)[0]
    rhos = registers[idx]  # wire format carries the stored (rho+1) value
    if padding:
        vals = (rhos.astype(np.uint32) << 16) | idx.astype(np.uint32)
        return vals.astype("<u4").tobytes()
    out = bytearray()
    for i, r in zip(idx.tolist(), rhos.tolist()):
        out += struct.pack("<HB", i, r)
    return bytes(out)


def decode_registers(data: bytes) -> np.ndarray:
    """Dense (16384 bytes) or padded-sparse (4-byte records) → stored regs."""
    registers = np.zeros(HLL_M, np.uint8)
    if len(data) == HLL_M:
        return np.frombuffer(data, np.uint8).copy()
    vals = np.frombuffer(data, "<u4")
    idx = vals & (HLL_M - 1)
    rho = (vals >> 16) & 0xFF
    np.maximum.at(registers, idx, rho.astype(np.uint8))
    return registers


def merge_registers(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)
