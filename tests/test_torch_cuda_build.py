"""The port's kernel builds (`aresdb_tpu_torch/utils/cuda_build.py`), on the
CPU with g++ and a stand-in NVRTC.

A build holds the lock of its own key only: a thread that loads a library
already built does not wait for another key's compiler, and two threads
that ask for one new key build it once. K1's per-plan build is a cubin of
device code that NVRTC compiles in the process, with the same code
generation as the fixed libraries; its image is built once a source and
found again in the process and on disk, keyed also on NVRTC's version and
every csrc header. A failed compile raises with NVRTC's log and leaves no
file; a missing libnvrtc raises and no nvcc runs in its place; NVRTC's
compiles run on threads beside the compiler processes of one build_all.
Here no NVRTC runs: its binding is stood in for by an object whose
"cubin" is the source text and whose log is a `ptxas -v` line, so what is
checked is the build's options, keying, caching and log, not the
compiler.
"""

from __future__ import annotations

import shutil
import stat
import threading
import time

import pytest

from aresdb_tpu_torch.utils import cuda_build

SLEEP_S = 3.0

SOURCE = """
extern "C" int answer(void) { return %d; }
"""


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.fail("the host C++ compiler g++ is required for this test")


def _script(path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def slow_gxx(tmp_path, monkeypatch, gxx):
    """Calling it puts g++ behind a wrapper that sleeps SLEEP_S seconds
    first, for the builds started from then on; the key is the flags', so
    a library built before is still found."""
    wrapper = _script(tmp_path / "slow-g++",
                      f'sleep {SLEEP_S}\nexec g++ "$@"\n')

    def slow_down():
        monkeypatch.setattr(cuda_build, "_command",
                            lambda c: [wrapper] + cuda_build.FLAGS[c])
    return slow_down


def test_a_loaded_library_is_found_while_another_key_builds(tmp_path,
                                                            slow_gxx):
    build_dir = tmp_path / "build"
    ready = cuda_build.load_library("answer", SOURCE % 1, "g++", build_dir)
    on_disk = SOURCE % 2
    cuda_build.build_all([("answer", on_disk, "g++")], build_dir)
    slow_gxx()
    done = {}

    def slow():
        cuda_build.load_library("answer", SOURCE % 3, "g++", build_dir)
        done["slow"] = time.perf_counter()

    t0 = time.perf_counter()
    slow_build = threading.Thread(target=slow)
    slow_build.start()
    time.sleep(0.2)   # the slow build holds its key's lock by now
    assert cuda_build.load_library("answer", SOURCE % 1, "g++",
                                   build_dir) is ready
    found = time.perf_counter()
    # built on disk, not loaded yet: loaded without the slow build's lock
    lib = cuda_build.load_library("answer", on_disk, "g++", build_dir)
    on_disk_found = time.perf_counter()
    slow_build.join()
    assert lib.answer() == 2
    assert found - t0 < SLEEP_S and on_disk_found - t0 < SLEEP_S
    assert done["slow"] - t0 >= SLEEP_S
    assert on_disk_found < done["slow"]


def test_two_threads_asking_for_one_new_key_build_it_once(tmp_path,
                                                          slow_gxx):
    slow_gxx()
    build_dir = tmp_path / "build"
    built = cuda_build.built
    libs = []

    def load():
        libs.append(cuda_build.load_library("answer", SOURCE % 4, "g++",
                                            build_dir))

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cuda_build.built == built + 1
    assert len(libs) == 2 and libs[0] is libs[1] and libs[0].answer() == 4
    assert len(list(build_dir.glob("*.so"))) == 1


def test_build_all_and_a_load_of_one_key_build_it_once(tmp_path, slow_gxx):
    slow_gxx()
    build_dir = tmp_path / "build"
    built = cuda_build.built
    item = ("answer", SOURCE % 5, "g++")
    loader = threading.Thread(
        target=lambda: cuda_build.load_library(*item, build_dir))
    loader.start()
    cuda_build.build_all([item, ("answer", SOURCE % 6, "g++")], build_dir)
    loader.join()
    assert cuda_build.built == built + 2
    assert len(list(build_dir.glob("*.so"))) == 2
    # nothing half-written is left beside them
    assert sorted(p.suffix for p in build_dir.iterdir()) == \
        [".log", ".log", ".so", ".so"]


def test_the_per_plan_command_is_a_cubin_with_the_libraries_codegen():
    """NVRTC's options are NVCC_CODEGEN's in NVRTC's words."""
    codegen = cuda_build.NVCC_CODEGEN
    options = cuda_build.NVRTC_OPTIONS
    assert cuda_build.FLAGS["nvcc"][:len(codegen)] == codegen
    assert cuda_build.FLAGS["nvrtc"] == options
    # SASS for the libraries' architecture: a real one, so no PTX
    assert "arch=compute_90a,code=sm_90a" in codegen
    assert "--gpu-architecture=sm_90a" in options
    assert not any("compute_" in o for o in options)
    for flag in ("-fmad=false", "-std=c++17"):
        assert flag in codegen and "-" + flag in options
    assert codegen[codegen.index("-Xptxas") + 1] == "-v"
    assert "--ptxas-options=-v" in options
    assert "-DARES_DEVICE_ONLY" in options
    assert not any(o.startswith(("--include-path", "-I")) for o in options)
    # the launcher is host code: no device code generation at all
    host = cuda_build.FLAGS["host"]
    assert host[:2] == ["-x", "c++"] and "-gencode" not in host
    assert cuda_build.SUFFIX["nvrtc"] == ".cubin"
    assert "cubin" not in cuda_build.FLAGS
    with pytest.raises(ValueError):
        cuda_build._command("nvrtc")


class FakeNvrtc:
    """Stands in for cuda_build.Nvrtc: the "cubin" is the source text, the
    log one ptxas line; `fail` makes a compile fail with that log, and
    `sleep` makes it take that long (the interpreter lock released, as
    ctypes releases it)."""

    def __init__(self):
        self.ver = (12, 9)
        self.calls = []
        self.fail = None
        self.sleep = 0.0

    def version(self):
        return self.ver

    def compile(self, text, name, headers, options):
        self.calls.append((name, dict(headers), list(options)))
        time.sleep(self.sleep)
        if self.fail is not None:
            raise cuda_build.NvrtcError(f"compiling {name}: "
                                        f"NVRTC_ERROR_COMPILATION\n{self.fail}")
        return text.encode(), ("ptxas info    : Function properties for "
                               "fused_dense_kernel\n")


@pytest.fixture
def fake_nvrtc(tmp_path, monkeypatch):
    """cuda_build's NVRTC stood in for, nothing loaded yet, and an nvcc
    that only lists each command it is given (in `nvrtc.nvcc_calls`)."""
    nvrtc = FakeNvrtc()
    monkeypatch.setattr(cuda_build, "nvrtc", lambda: nvrtc)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    nvrtc.nvcc_calls = tmp_path / "nvcc-calls"
    nvcc = _script(tmp_path / "nvcc", f'echo "$@" >> {nvrtc.nvcc_calls}\n'
                   "exit 1\n")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    return nvrtc


K1_TEXT = '#define ARES_NI 1\n#define ARES_NF 0\n' \
          '#include "fused_dense_template.cuh"\n'


def test_one_cubin_a_source_built_once_and_found_again(tmp_path, fake_nvrtc,
                                                        monkeypatch):
    build_dir = tmp_path / "build"
    built = cuda_build.built
    image = cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir)
    assert image == K1_TEXT.encode()
    assert cuda_build.built == built + 1
    # found in the process, then on disk by a process that has loaded
    # nothing
    assert cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir) is image
    monkeypatch.setattr(cuda_build, "_loaded", {})
    again = cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir)
    assert again == image and again is not image
    cuda_build.build_all([("fused_dense", K1_TEXT, "nvrtc")], build_dir)
    assert cuda_build.built == built + 1
    path = cuda_build.library_path("fused_dense", K1_TEXT, "nvrtc",
                                   build_dir)
    assert path.suffix == ".cubin" and path.read_bytes() == image
    assert "fused_dense_kernel" in path.with_suffix(".log").read_text()
    assert sorted(p.name for p in build_dir.iterdir()) == \
        sorted([path.name, path.with_suffix(".log").name])
    # one NVRTC compile, with NVRTC_OPTIONS and every csrc header in memory
    (call,) = fake_nvrtc.calls
    name, headers, options = call
    assert name == "fused_dense.cu" and options == cuda_build.NVRTC_OPTIONS
    assert headers == {h.name: h.read_text()
                       for h in cuda_build.CSRC.glob("*.cuh")}
    assert {"fused_dense_template.cuh", "ares_common.cuh", "block_hist.cuh",
            "ares_cluster.cuh"} <= set(headers)
    assert not fake_nvrtc.nvcc_calls.exists()


HEADERS = sorted(h.name for h in cuda_build.CSRC.glob("*.cuh"))


@pytest.mark.parametrize("header", HEADERS)
def test_the_cubin_key_moves_with_nvrtc_and_each_header(header, tmp_path,
                                                        fake_nvrtc,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)

    def path():
        return cuda_build.library_path("fused_dense", K1_TEXT, "nvrtc",
                                       tmp_path)
    base = path()
    assert path() == base
    fake_nvrtc.ver = (12, 8)
    assert path() != base
    fake_nvrtc.ver = (12, 9)
    assert path() == base
    hdr = csrc / header
    text = hdr.read_text()
    hdr.write_text(text + "\n// one more line\n")
    assert path() != base
    hdr.write_text(text)
    assert path() == base
    # a header no source includes yet is hashed too
    (csrc / "new.cuh").write_text("#pragma once\n")
    assert path() != base


def test_a_failed_compile_raises_with_its_log_and_leaves_no_file(
        tmp_path, fake_nvrtc):
    build_dir = tmp_path / "build"
    built, secs = cuda_build.built, cuda_build.build_seconds
    fake_nvrtc.fail = 'fused_dense.cu(4): error: identifier "x" is undefined'
    with pytest.raises(RuntimeError, match='identifier "x" is undefined'):
        cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir)
    assert cuda_build.built == built
    assert list(build_dir.iterdir()) == []
    # nothing of it is cached: the next load compiles again
    fake_nvrtc.fail = None
    image = cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir)
    assert image == K1_TEXT.encode() and len(fake_nvrtc.calls) == 2
    assert cuda_build.built == built + 1 and cuda_build.build_seconds > secs
    assert not fake_nvrtc.nvcc_calls.exists()


def test_a_missing_libnvrtc_raises_and_runs_no_nvcc(tmp_path, monkeypatch):
    """A toolkit whose lib64 holds no libnvrtc: the build raises before
    any compiler starts, the nvcc library of the same build_all included."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    (cuda / "lib64").mkdir()
    calls = tmp_path / "nvcc-calls"
    _script(cuda / "bin" / "nvcc", f'echo "$@" >> {calls}\nexit 1\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match="libnvrtc not found"):
        cuda_build.load_cubin("fused_dense", K1_TEXT, build_dir)
    with pytest.raises(RuntimeError, match="libnvrtc not found"):
        cuda_build.build_all([("answer", SOURCE % 7, "nvcc"),
                              ("fused_dense", K1_TEXT, "nvrtc")], build_dir)
    assert not calls.exists() and not build_dir.exists()


NVRTC_SLEEP_S = 1.5


def test_nvrtc_compiles_run_on_threads_beside_a_compiler_process(
        tmp_path, fake_nvrtc, slow_gxx):
    """One build_all of a library behind a compiler that sleeps SLEEP_S
    and two NVRTC compiles of NVRTC_SLEEP_S each: all three at once."""
    slow_gxx()
    fake_nvrtc.sleep = NVRTC_SLEEP_S
    build_dir = tmp_path / "build"
    built = cuda_build.built
    secs = cuda_build.build_all([("answer", SOURCE % 8, "g++"),
                                 ("fused_dense", K1_TEXT, "nvrtc"),
                                 ("fused_dense", K1_TEXT + "// b\n",
                                  "nvrtc")], build_dir)
    assert cuda_build.built == built + 3
    assert len(fake_nvrtc.calls) == 2
    # one after another they take SLEEP_S + 2 * NVRTC_SLEEP_S at least
    assert SLEEP_S <= secs < SLEEP_S + 2 * NVRTC_SLEEP_S - 1.0
    assert sorted(p.suffix for p in build_dir.iterdir()) == \
        [".cubin", ".cubin", ".log", ".log", ".log", ".so"]
