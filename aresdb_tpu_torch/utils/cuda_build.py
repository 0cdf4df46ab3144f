"""Build the port's hand-written kernels and load them.

Each source under `aresdb_tpu_torch/csrc/` is compiled at first use, by one
of four kinds of build:
- "nvcc": a shared library with a plain C interface (nvcc, `sm_90a`), loaded
  with ctypes: K2's and K3's kernels with their launchers. No PyTorch
  headers, so a build takes seconds.
- "nvrtc": device code only, compiled in this process by NVRTC (`libnvrtc`
  of the toolkit that holds nvcc, through ctypes) into a cubin for
  `sm_90a`, with the libraries' code generation (`--fmad=false`, C++17):
  one fused kernel (K1) per plan structure, which its fixed launcher loads
  (`load_cubin` gives the image). The csrc headers are passed in memory
  and the device code reaches no system header, so the compile parses a
  few hundred lines; no process is started. A call into NVRTC releases
  the interpreter lock, so other threads run meanwhile. NVRTC also keeps
  what it compiled in the CUDA compute cache under HOME
  (`~/.nv/ComputeCache`, as CUDA's JIT of PTX does; CUDA_CACHE_DISABLE=1
  turns it off); the build directory below is the cache the port relies
  on. No build falls back to nvcc: a missing libnvrtc or a failed compile
  raises, with NVRTC's log.
- "host": a shared library of host code only (nvcc driving the host C++
  compiler, with the CUDA runtime linked in): K1's launcher.
- "g++": the same sources under the host C++ compiler, which is how the
  CPU tests check the per-plan row functions of the fused kernel.

A build is keyed by the SHA-256 of its source text, every header under
`csrc/` and the compiler's flags (for "nvrtc" also NVRTC's version), and
cached on disk under `aresdb_tpu_torch/build/` (listed in .gitignore),
with the compiler's log beside it (`ptxas -v` for nvcc; NVRTC's log holds
ptxas's report only where its ptxas ran, not where the compute cache
answered), and in the process. The fused kernel's source holds a plan's
structure only, so one cubin serves every window and column range of that
structure.

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
# NVCC_CODEGEN in NVRTC's words: SASS for sm_90a (a cubin, no PTX), and
# ptxas's -v report in the program log. ARES_DEVICE_ONLY: none of
# block_hist.cuh's host helpers.
NVRTC_OPTIONS = ["--gpu-architecture=sm_90a", "--std=c++17", "--fmad=false",
                 "-DARES_DEVICE_ONLY", "--ptxas-options=-v"]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-cudart", "static"]
# -ffp-contract=off: no FMA contraction, as nvcc's -fmad=false, so float
# expressions round the way the plain PyTorch versions round them
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
             "-x", "c++"]
FLAGS = {"nvcc": NVCC_FLAGS, "nvrtc": NVRTC_OPTIONS, "host": HOST_FLAGS,
         "g++": GXX_FLAGS}
SUFFIX = {"nvcc": ".so", "nvrtc": ".cubin", "host": ".so", "g++": ".so"}

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


def nvrtc_path() -> Path:
    """libnvrtc of the toolkit that holds nvcc_path(), so that its ptxas is
    the one that built K2's and K3's libraries."""
    lib = Path(nvcc_path()).parent.parent / "lib64"
    for cand in [lib / "libnvrtc.so", *sorted(lib.glob("libnvrtc.so.*"))]:
        if cand.exists():
            return cand
    raise RuntimeError(f"libnvrtc not found in {lib}: K1's plan structures "
                       "cannot be built")


class NvrtcError(RuntimeError):
    """A compile NVRTC refused; the message holds its log."""


class Nvrtc:
    """The calls of libnvrtc that a build makes, through ctypes (a call
    releases the interpreter lock)."""

    def __init__(self, path: Path):
        # libnvrtc opens its builtins library by name; the toolkit's own,
        # loaded first by path, is the one it then finds
        builtins = sorted(path.parent.glob("libnvrtc-builtins.so.*"))
        if builtins:
            ctypes.CDLL(str(builtins[-1]))
        lib = ctypes.CDLL(str(path))
        i, p, sz = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
        strs = ctypes.POINTER(ctypes.c_char_p)
        sigs = {"nvrtcVersion": [ctypes.POINTER(i), ctypes.POINTER(i)],
                "nvrtcCreateProgram": [ctypes.POINTER(p), ctypes.c_char_p,
                                       ctypes.c_char_p, i, strs, strs],
                "nvrtcCompileProgram": [p, i, strs],
                "nvrtcGetProgramLogSize": [p, ctypes.POINTER(sz)],
                "nvrtcGetProgramLog": [p, ctypes.c_char_p],
                "nvrtcGetCUBINSize": [p, ctypes.POINTER(sz)],
                "nvrtcGetCUBIN": [p, ctypes.c_char_p],
                "nvrtcDestroyProgram": [ctypes.POINTER(p)]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        lib.nvrtcGetErrorString.argtypes = [i]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        self.lib = lib
        major, minor = i(), i()
        self._check(lib.nvrtcVersion(ctypes.byref(major),
                                     ctypes.byref(minor)), "nvrtcVersion")
        self._version = (major.value, minor.value)

    def _check(self, rc: int, what: str, log: str = "") -> None:
        if rc != 0:
            err = self.lib.nvrtcGetErrorString(rc).decode()
            raise NvrtcError(f"{what}: {err}\n{log}")

    def version(self) -> Tuple[int, int]:
        return self._version

    def compile(self, text: str, name: str, headers: Dict[str, str],
                options: Sequence[str]) -> Tuple[bytes, str]:
        """(the cubin, NVRTC's log) of `text`, whose `#include "h"` finds
        headers[h]; raises NvrtcError with the log where it fails."""
        def strings(items):
            return (ctypes.c_char_p * max(len(items), 1))(
                *[s.encode() for s in items])
        lib, prog = self.lib, ctypes.c_void_p()
        self._check(lib.nvrtcCreateProgram(
            ctypes.byref(prog), text.encode(), name.encode(), len(headers),
            strings(list(headers.values())), strings(list(headers))),
            "nvrtcCreateProgram")
        try:
            rc = lib.nvrtcCompileProgram(prog, len(options), strings(options))
            size = ctypes.c_size_t()
            self._check(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                        "nvrtcGetProgramLogSize")
            buf = ctypes.create_string_buffer(size.value + 1)
            self._check(lib.nvrtcGetProgramLog(prog, buf),
                        "nvrtcGetProgramLog")
            log = buf.value.decode(errors="replace")
            self._check(rc, f"compiling {name}", log)
            self._check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                        "nvrtcGetCUBINSize")
            image = ctypes.create_string_buffer(size.value)
            self._check(lib.nvrtcGetCUBIN(prog, image), "nvrtcGetCUBIN")
            return image.raw, log
        finally:
            lib.nvrtcDestroyProgram(ctypes.byref(prog))


def nvrtc() -> Nvrtc:
    """The toolkit's NVRTC, loaded once a process; raises where it is
    missing."""
    return cached(("nvrtc",), lambda: Nvrtc(nvrtc_path()))


def headers() -> Dict[str, str]:
    """Every header under csrc/, by the name a source includes it by."""
    return {h.name: h.read_text() for h in sorted(CSRC.glob("*.cuh"))}


def _command(compiler: str) -> List[str]:
    """The compiler and its flags for a kind of build run as a process;
    the file names follow."""
    if compiler not in FLAGS or compiler == "nvrtc":
        raise ValueError(f"no compiler process for {compiler!r}")
    return (["g++"] if compiler == "g++" else [nvcc_path()]) + FLAGS[compiler]


def _key(text: str, compiler: str) -> str:
    if compiler not in FLAGS:
        raise ValueError(f"unknown compiler {compiler!r}")
    h = hashlib.sha256()
    h.update(" ".join(FLAGS[compiler]).encode())
    if compiler == "nvrtc":
        h.update("nvrtc {}.{}".format(*nvrtc().version()).encode())
    h.update(text.encode())
    for name, hdr in headers().items():
        h.update(name.encode())
        h.update(hdr.encode())
    return h.hexdigest()[:24]


def library_path(name: str, text: str, compiler: str = "nvcc",
                 build_dir: Optional[Path] = None) -> Path:
    """The built file of this source: a shared library, or for "nvrtc"
    the device image; its compiler log has the suffix .log."""
    return Path(build_dir or BUILD_DIR) / \
        f"{name}-{compiler}-{_key(text, compiler)}{SUFFIX[compiler]}"


def _key_lock(key) -> threading.Lock:
    with _lock:
        return _key_locks.setdefault(key, threading.Lock())


def _start(name: str, text: str, compiler: str, build_dir: Path):
    """Start one build: a compiler process, or for "nvrtc" a thread that
    compiles in this process. Returns the function that waits for it and
    writes its output and log (raising where it failed), or None when the
    output is already built."""
    out = library_path(name, text, compiler, build_dir)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp_out = out.with_name(f"{out.name}.{tag}.tmp")
    if compiler == "nvrtc":
        return _start_nvrtc(name, text, tmp_out, out)
    tmp_src = out.with_name(f"{out.stem}.{tag}.cu")
    tmp_src.write_text(text)
    cmd = _command(compiler) + ["-I", str(CSRC), str(tmp_src), "-o",
                                str(tmp_out)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def finish() -> None:
        log, _ = proc.communicate()
        tmp_src.unlink(missing_ok=True)
        if proc.returncode != 0:
            tmp_out.unlink(missing_ok=True)
            raise RuntimeError(f"building {out.name} failed:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp_out, out)
    return finish


def _start_nvrtc(name: str, text: str, tmp_out: Path, out: Path):
    done = {}

    def run():
        try:
            done["image"], done["log"] = nvrtc().compile(
                text, f"{name}.cu", headers(), NVRTC_OPTIONS)
        except Exception as e:  # raised by finish(), in the caller
            done["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=run, name=f"nvrtc {out.name}",
                              daemon=True)
    thread.start()

    def finish() -> None:
        thread.join()
        if "image" not in done:
            raise RuntimeError(f"building {out.name} failed:\n"
                               f"{done.get('error', 'no image')}")
        tmp_out.write_bytes(done["image"])
        out.with_suffix(".log").write_text(done["log"])
        os.replace(tmp_out, out)
    return finish


def build_all(items: Sequence[Tuple[str, str, str]],
              build_dir: Optional[Path] = None) -> float:
    """Build every (name, source text, compiler) at once: a compiler
    process each, and a thread each for the NVRTC compiles, all started
    together; an output already on disk is not built again, and a key
    another thread is building is waited for. Returns the wall seconds."""
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
        for finish in jobs:
            try:
                finish()
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
    """The device image (NVRTC's cubin) of this source, building it first
    if needed; read once a process, and held for its life, as the loaded
    kernels may read it."""
    build_dir = Path(build_dir or BUILD_DIR)

    def make():
        build_all([(name, text, "nvrtc")], build_dir)
        return library_path(name, text, "nvrtc", build_dir).read_bytes()
    return cached((name, text, "nvrtc", str(build_dir)), make)


def csrc_text(filename: str) -> str:
    return (CSRC / filename).read_text()
