"""Device selection for the port.

The JAX package enables x64 globally so that group-table accumulators are
64-bit (`aresdb_tpu/utils/jax_env.py`). The port gets the same effect from
explicit `torch.float64` / `torch.int64` accumulators; hot-path lanes stay
32-bit.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Raises when CUDA is asked for (or implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
