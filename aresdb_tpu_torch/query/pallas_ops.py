"""K2: the slot-indexed segment sum behind the dense group-by.

Port of `aresdb_tpu/query/pallas_ops.py` factored_segment_sum_pallas (the
Pallas kernel `_make_factored_pallas_kernel`, routed by
factored_segment_sum_indicator). The CUDA kernel is
`csrc/segment_sum.cu`; its plain PyTorch version is
`segment_sum_plain`. The JAX package's one-hot matmul formulation exists
for the TPU's MXU; see the source for the Hopper design.

K3 (`dense_segment_sum`, the direct one-hot matmul, reached only with
ARES_FACTORED=0) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aresdb_tpu_torch.utils import cuda_build

SOURCE = "segment_sum.cu"


def segment_sum_plain(slots: torch.Tensor, values: torch.Tensor,
                      n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of K2: values[n, C] summed by slots[n] into
    [n_slots, C] float32; slots outside [0, n_slots) are dropped."""
    c = values.shape[1]
    out = torch.zeros((n_slots + 1, c), dtype=torch.float32,
                      device=values.device)
    idx = torch.where((slots < 0) | (slots >= n_slots),
                      torch.full_like(slots, n_slots), slots).long()
    out.index_add_(0, idx, values.to(torch.float32))
    return out[:n_slots]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load_library("segment_sum",
                                  cuda_build.csrc_text(SOURCE))
    fn = lib.ares_segment_sum
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def segment_sum(slots: torch.Tensor, values: torch.Tensor, n_slots: int,
                ones_channels: tuple = ()) -> torch.Tensor:
    """K2: segment-sum values[n, C] by slots[n] into [n_slots, C] float32;
    slots outside [0, n_slots) are dropped.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. `ones_channels` (channels known to be all ones) is the JAX
    signature's hint for the MXU formulation and changes nothing here.
    """
    del ones_channels
    if slots.device.type == "cpu" and values.device.type == "cpu":
        return segment_sum_plain(slots, values, n_slots)
    if slots.device.type != "cuda" or values.device != slots.device:
        raise ValueError(f"segment_sum: slots on {slots.device}, values on "
                         f"{values.device}; both must be on one CUDA device")
    n = slots.shape[0]
    if values.dim() != 2 or values.shape[0] != n:
        raise ValueError(f"segment_sum: values {tuple(values.shape)} do not "
                         f"match slots [{n}]")
    if not 0 < n_slots <= 1 << 16:
        raise ValueError(f"segment_sum: n_slots {n_slots} outside (0, 65536]")
    c = values.shape[1]
    out = torch.zeros((n_slots, c), dtype=torch.float32, device=slots.device)
    if n == 0:
        return out
    slots = slots.to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()
    fn = _library()
    stream = torch.cuda.current_stream(slots.device)
    rc = fn(slots.data_ptr(), values.data_ptr(), n, c, n_slots,
            out.data_ptr(), slots.device.index or 0, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {rc}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
