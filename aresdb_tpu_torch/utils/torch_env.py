"""Device selection and the device-to-host copy of the port.

The JAX package enables x64 globally so that group-table accumulators are
64-bit (`aresdb_tpu/utils/jax_env.py`). The port gets the same effect from
explicit `torch.float64` / `torch.int64` accumulators; hot-path lanes stay
32-bit.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from aresdb_tpu_torch.utils import tracing


def fetch_to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor's values on the host through ONE device-to-host copy:
    the tensors' bytes are packed into one buffer on their device.
    `fetch_to_host.calls` counts the copies. The copy waits for the card
    to finish the kernels queued before it: a `deviceWait` span."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    packed = torch.cat([t.view(torch.uint8) for t in flat])
    with tracing.span("deviceWait"):
        packed = packed.cpu()
    packed = packed.numpy()
    fetch_to_host.calls += 1
    out, off = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(packed[off:off + nbytes].view(np_dt).reshape(t.shape))
        off += nbytes
    return out


fetch_to_host.calls = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. A CUDA device comes back indexed (`cuda` is the current
    device, `cuda:0` as a rule), so that `cuda` and `cuda:0` are one key
    of the column and kernel caches. Raises when CUDA is asked for (or
    implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
