"""Build the port's hand-written kernels and load them.

Each source under `aresdb_tpu_torch/csrc/` is compiled at first use, by one
of four kinds of build:
- "nvcc": a shared library with a plain C interface (nvcc, `sm_90a`), loaded
  with ctypes: K2's and K3's kernels with their launchers. No PyTorch
  headers, so a build takes seconds.
- "cubin": device code only (`nvcc -cubin`, the same code generation
  flags): one fused kernel (K1) per plan structure, which its fixed
  launcher loads (`load_cubin` gives the image). No host compiler, no link.
- "host": a shared library of host code only (nvcc driving the host C++
  compiler, with the CUDA runtime linked in): K1's launcher.
- "g++": the same sources under the host C++ compiler, which is how the
  CPU tests check the per-plan row functions of the fused kernel.

A build is keyed by the SHA-256 of its source text, every header under
`csrc/` and the compiler command, and cached on disk under
`aresdb_tpu_torch/build/` (listed in .gitignore), with the compiler's log
beside it (`ptxas -v` for nvcc), and in the process. The fused kernel's
source holds a plan's structure only, so one cubin serves every window and
column range of that structure.

A build holds a lock of its own key only: one thread builds a key, the
others asking for it wait for that build, and what is already loaded is
found without waiting on anyone's compiler.

`built` and `build_seconds` count the libraries and cubins this process
compiled and the wall seconds their builds took, for the smoke run and the
tests.
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# code generation, the same for every build that makes device code
NVCC_CODEGEN = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-fmad=false", "-Xptxas", "-v"]
NVCC_FLAGS = NVCC_CODEGEN + ["-shared", "-Xcompiler", "-fPIC"]
CUBIN_FLAGS = NVCC_CODEGEN + ["-cubin"]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-cudart", "static"]
# -ffp-contract=off: no FMA contraction, as nvcc's -fmad=false, so float
# expressions round the way the plain PyTorch versions round them
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
             "-x", "c++"]
FLAGS = {"nvcc": NVCC_FLAGS, "cubin": CUBIN_FLAGS, "host": HOST_FLAGS,
         "g++": GXX_FLAGS}
SUFFIX = {"nvcc": ".so", "cubin": ".cubin", "host": ".so", "g++": ".so"}

_lock = threading.Lock()     # guards _loaded and _key_locks, never a build
_loaded: Dict[tuple, object] = {}
_key_locks: Dict[object, threading.Lock] = {}

built = 0            # libraries and cubins compiled by this process
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
    """The compiler and its flags for a kind of build; the file names
    follow."""
    if compiler not in FLAGS:
        raise ValueError(f"unknown compiler {compiler!r}")
    return (["g++"] if compiler == "g++" else [nvcc_path()]) + FLAGS[compiler]


def _key(text: str, compiler: str) -> str:
    if compiler not in FLAGS:
        raise ValueError(f"unknown compiler {compiler!r}")
    h = hashlib.sha256()
    h.update(" ".join(FLAGS[compiler]).encode())
    h.update(text.encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:24]


def library_path(name: str, text: str, compiler: str = "nvcc",
                 build_dir: Optional[Path] = None) -> Path:
    """The built file of this source: a shared library, or for "cubin"
    the device image; its compiler log has the suffix .log."""
    return Path(build_dir or BUILD_DIR) / \
        f"{name}-{compiler}-{_key(text, compiler)}{SUFFIX[compiler]}"


def _key_lock(key) -> threading.Lock:
    with _lock:
        return _key_locks.setdefault(key, threading.Lock())


def _start(name: str, text: str, compiler: str, build_dir: Path):
    """Start one compiler process; None when the output is already built."""
    out = library_path(name, text, compiler, build_dir)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp_src = out.with_name(f"{out.stem}.{tag}.cu")
    tmp_src.write_text(text)
    tmp_out = out.with_name(f"{out.name}.{tag}.tmp")
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
              build_dir: Optional[Path] = None) -> float:
    """Build every (name, source text, compiler) at once, one compiler
    process each, all started together; an output already on disk is not
    built again, and a key another thread is building is waited for.
    Returns the wall seconds."""
    global built, build_seconds
    build_dir = Path(build_dir or BUILD_DIR)
    t0 = time.perf_counter()
    missing = sorted({str(library_path(n, t, c, build_dir)): (n, t, c)
                      for n, t, c in items}.items())
    missing = [(path, item) for path, item in missing
               if not Path(path).exists()]
    # one lock a key, taken in path order, so that two builds never wait
    # on each other
    locks = [_key_lock(path) for path, _ in missing]
    for lock in locks:
        lock.acquire()
    jobs, errors = [], []
    try:
        for _, item in missing:
            job = _start(*item, build_dir)
            if job is not None:
                jobs.append(job)
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
    finally:
        for lock in reversed(locks):
            lock.release()
    secs = time.perf_counter() - t0
    if jobs:
        with _count_lock:
            built += len(jobs) - len(errors)
            build_seconds += secs
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def cached(key, make: Callable[[], object]):
    """make()'s result for `key`, made once a process: a caller finds it
    made without a lock; callers of one key that is not made yet wait for
    one make()."""
    obj = _loaded.get(key)
    if obj is not None:
        return obj
    with _key_lock(key):
        obj = _loaded.get(key)
        if obj is None:
            obj = make()
            with _lock:
                _loaded[key] = obj
    return obj


def load_library(name: str, text: str, compiler: str = "nvcc",
                 build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library for this source, building it first if needed.
    A library loaded once is found again without hashing its sources."""
    build_dir = Path(build_dir or BUILD_DIR)

    def make():
        build_all([(name, text, compiler)], build_dir)
        return ctypes.CDLL(str(library_path(name, text, compiler, build_dir)))
    return cached((name, text, compiler, str(build_dir)), make)


def load_cubin(name: str, text: str, build_dir: Optional[Path] = None
               ) -> bytes:
    """The device image (`nvcc -cubin`) of this source, building it first
    if needed; read once a process, and held for its life, as the loaded
    kernels may read it."""
    build_dir = Path(build_dir or BUILD_DIR)

    def make():
        build_all([(name, text, "cubin")], build_dir)
        return library_path(name, text, "cubin", build_dir).read_bytes()
    return cached((name, text, "cubin", str(build_dir)), make)


def csrc_text(filename: str) -> str:
    return (CSRC / filename).read_text()
