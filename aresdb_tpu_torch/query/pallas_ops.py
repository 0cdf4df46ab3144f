"""K2 and K3: the slot-indexed segment sums behind the group-by paths.

Port of `aresdb_tpu/query/pallas_ops.py`:
- K2, `segment_sum`: factored_segment_sum_pallas (the Pallas kernel
  `_make_factored_pallas_kernel`, routed by
  factored_segment_sum_indicator). CUDA source `csrc/segment_sum.cu`,
  plain version `segment_sum_plain`.
- K3, `dense_segment_sum`: the direct one-hot matmul kernel `_make_kernel`
  with its DMA pump `_chunk_pump`. CUDA source
  `csrc/dense_segment_sum.cu`, plain version `dense_segment_sum_plain`.

The JAX package's one-hot matmul formulations exist for the TPU's MXU; see
the sources for the Hopper design. `use_factored` and `use_pallas` route
the unfused dense kernel between K2, K3 and the plain scatter as the JAX
package's predicates of the same names do, with the tensor's CUDA device
in the place of the TPU.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from aresdb_tpu_torch.utils import cuda_build

SOURCE = "segment_sum.cu"
K3_SOURCE = "dense_segment_sum.cu"
PALLAS_MAX_SLOTS = 8192   # K3's slot cap, as in the JAX package
K2_MAX_SLOTS = 1 << 16    # K2's (FP_KLO * FP_MAX_KHI in the JAX package)
K3_MAX_CHANNELS = 8       # the kernel is instantiated for C = 1 .. 8


def use_factored(n_slots: int, device) -> bool:
    """Whether the dense kernel reduces through K2: on a CUDA device by
    default; ARES_FACTORED=0 turns it off, =1 on for any device."""
    del n_slots   # K2 takes every dense slot count (<= 65,536)
    flag = os.environ.get("ARES_FACTORED", "")
    if flag in ("0", "1"):
        return flag == "1"
    return torch.device(device).type == "cuda"


def use_pallas(n_slots: int, device) -> bool:
    """Whether the dense kernel reduces through K3 (when K2 is off): up to
    PALLAS_MAX_SLOTS, on a CUDA device by default; ARES_PALLAS=0 turns it
    off, =1 on for any device."""
    if n_slots > PALLAS_MAX_SLOTS:
        return False
    flag = os.environ.get("ARES_PALLAS", "")
    if flag in ("0", "1"):
        return flag == "1"
    return torch.device(device).type == "cuda"


def segment_sum_plain(slots: torch.Tensor, values: torch.Tensor,
                      n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of K2 and K3: values[n, C] summed by slots[n]
    into [n_slots, C] float32; slots outside [0, n_slots) are dropped."""
    c = values.shape[1]
    out = torch.zeros((n_slots + 1, c), dtype=torch.float32,
                      device=values.device)
    idx = torch.where((slots < 0) | (slots >= n_slots),
                      torch.full_like(slots, n_slots), slots).long()
    out.index_add_(0, idx, values.to(torch.float32))
    return out[:n_slots]


dense_segment_sum_plain = segment_sum_plain


@functools.lru_cache(maxsize=None)
def _library(source: str, symbol: str):
    lib = cuda_build.load_library(source.removesuffix(".cu"),
                                  cuda_build.csrc_text(source))
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, source: str, symbol: str, slots: torch.Tensor,
            values: torch.Tensor, n_slots: int, max_slots: int,
            max_channels: int):
    """Check the operands of a segment-sum kernel and launch it; the
    output, or None where the tensors lie on the CPU."""
    if slots.device.type == "cpu" and values.device.type == "cpu":
        return None
    if slots.device.type != "cuda" or values.device != slots.device:
        raise ValueError(f"{name}: slots on {slots.device}, values on "
                         f"{values.device}; both must be on one CUDA device")
    n = slots.shape[0]
    if values.dim() != 2 or values.shape[0] != n:
        raise ValueError(f"{name}: values {tuple(values.shape)} do not "
                         f"match slots [{n}]")
    if not 0 < n_slots <= max_slots:
        raise ValueError(f"{name}: n_slots {n_slots} outside "
                         f"(0, {max_slots}]")
    c = values.shape[1]
    if not 0 < c <= max_channels:
        raise ValueError(f"{name}: {c} channels outside [1, {max_channels}]")
    out = torch.zeros((n_slots, c), dtype=torch.float32, device=slots.device)
    if n == 0:
        return out
    slots = slots.to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()
    fn = _library(source, symbol)
    stream = torch.cuda.current_stream(slots.device)
    rc = fn(slots.data_ptr(), values.data_ptr(), n, c, n_slots,
            out.data_ptr(), slots.device.index or 0, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def segment_sum(slots: torch.Tensor, values: torch.Tensor, n_slots: int,
                ones_channels: tuple = ()) -> torch.Tensor:
    """K2: segment-sum values[n, C] by slots[n] into [n_slots, C] float32;
    slots outside [0, n_slots) are dropped.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. `ones_channels` (channels known to be all ones) is the JAX
    signature's hint for the MXU formulation and changes nothing here.
    """
    del ones_channels
    out = _launch("segment_sum", SOURCE, "ares_segment_sum", slots, values,
                  n_slots, K2_MAX_SLOTS, 1 << 30)
    if out is None:
        return segment_sum_plain(slots, values, n_slots)
    if slots.shape[0]:
        segment_sum.launches += 1
    return out


segment_sum.launches = 0


def dense_segment_sum(slots: torch.Tensor, values: torch.Tensor,
                      n_slots: int) -> torch.Tensor:
    """K3: segment-sum values[n, C] (every channel any float, C <= 8) by
    slots[n] into [n_slots, C] float32; slots outside [0, n_slots) are
    dropped and n == 0 gives zeros.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    out = _launch("dense_segment_sum", K3_SOURCE, "ares_dense_segment_sum",
                  slots, values, n_slots, 1 << 16, K3_MAX_CHANNELS)
    if out is None:
        return dense_segment_sum_plain(slots, values, n_slots)
    if slots.shape[0]:
        dense_segment_sum.launches += 1
    return out


dense_segment_sum.launches = 0
