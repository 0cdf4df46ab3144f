"""AresDB on PyTorch and CUDA: the port of `aresdb_tpu` to an NVIDIA H100.

The storage layer, the upsert wire format and the query front end are
copies of the JAX package's host modules. The device query layer is
rewritten on torch tensors, and each TPU kernel of the JAX package has a
hand-written CUDA kernel under `csrc/`, built with nvcc at first use and
loaded with ctypes. Every kernel keeps a plain PyTorch version beside it;
a kernel wrapper takes that plain version only for tensors on the CPU.

Entry point: `aresdb_tpu_torch.query.service.QueryService(store).handle_aql`.
Entry points run on `cuda` unless the caller passes `device="cpu"`.

This package imports neither `jax` nor `aresdb_tpu`.
"""

__version__ = "0.1.0"
