"""Build the port's hand-written kernels and load them with ctypes.

Each kernel is a shared library with a plain C interface, compiled from
`aresdb_tpu_torch/csrc/` (nvcc, `sm_90a`) at first use: no PyTorch headers,
so a build takes seconds. A library is keyed by the SHA-256 of its source
text, every header under `csrc/` and the compiler command, and cached on
disk under `aresdb_tpu_torch/build/` (listed in .gitignore) and in the
process. The same sources also build with the host C++ compiler, which is
how the CPU tests check the per-plan row functions of the fused kernel.
The fused kernel's source holds a plan's structure only, so one library
serves every window and column range of that structure.

`built` and `build_seconds` count the libraries this process compiled and
the wall seconds their builds took, for the smoke run and the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# -ffp-contract=off: no FMA contraction, as nvcc's -fmad=false, so float
# expressions round the way the plain PyTorch versions round them
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
             "-x", "c++"]

_lock = threading.Lock()
_loaded: Dict[tuple, ctypes.CDLL] = {}

built = 0            # libraries compiled by this process, every compiler
build_seconds = 0.0  # wall seconds of the build_all calls that compiled
_count_lock = threading.Lock()


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _command(compiler: str) -> List[str]:
    if compiler == "nvcc":
        return [nvcc_path()] + NVCC_FLAGS
    if compiler == "g++":
        return ["g++"] + GXX_FLAGS
    raise ValueError(f"unknown compiler {compiler!r}")


def _key(text: str, compiler: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_command(compiler)[1:]).encode())
    h.update(text.encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:24]


def library_path(name: str, text: str, compiler: str = "nvcc",
                 build_dir: Path = BUILD_DIR) -> Path:
    return Path(build_dir) / f"{name}-{compiler}-{_key(text, compiler)}.so"


def _start(name: str, text: str, compiler: str, build_dir: Path):
    """Start one compiler process; None when the library is already built."""
    out = library_path(name, text, compiler, build_dir)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    tmp_src = src.with_name(f"{src.name}.{os.getpid()}.cu")
    tmp_src.write_text(text)
    tmp_out = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = _command(compiler) + ["-I", str(CSRC), str(tmp_src), "-o",
                                str(tmp_out)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp_src, tmp_out, out


def _finish(job) -> None:
    proc, tmp_src, tmp_out, out = job
    log, _ = proc.communicate()
    tmp_src.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp_out.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp_out, out)


def build_all(items: Sequence[Tuple[str, str, str]],
              build_dir: Path = BUILD_DIR) -> float:
    """Build every (name, source text, compiler) at once, one compiler
    process each, all started together; a library already on disk is not
    built again. Returns the wall seconds."""
    global built, build_seconds
    t0 = time.perf_counter()
    jobs = [_start(n, t, c, build_dir) for n, t, c in dict.fromkeys(items)]
    jobs = [job for job in jobs if job is not None]
    errors = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    secs = time.perf_counter() - t0
    if jobs:
        with _count_lock:
            built += len(jobs) - len(errors)
            build_seconds += secs
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load_library(name: str, text: str, compiler: str = "nvcc",
                 build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library for this source, building it first if needed.
    A library loaded once is found again without hashing its sources."""
    key = (name, text, compiler, str(build_dir))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = library_path(name, text, compiler, build_dir)
            if not path.exists():
                build_all([(name, text, compiler)], build_dir)
            lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
        return lib


def csrc_text(filename: str) -> str:
    return (CSRC / filename).read_text()
