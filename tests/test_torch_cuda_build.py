"""The port's kernel builds (`aresdb_tpu_torch/utils/cuda_build.py`), on the
CPU with g++ and a stand-in compiler.

A build holds the lock of its own key only: a thread that loads a library
already built does not wait for another key's compiler, and two threads
that ask for one new key build it once. K1's per-plan build is a cubin of
device code, made with the same code generation flags as the fixed
libraries; its image is built once a source and found again on disk and
in the process. Here no nvcc runs: the cubin's compiler is a script that
copies its input to its output and prints a `ptxas -v` line, so what is
checked is the build's keying, caching and log, not the compiler.
"""

from __future__ import annotations

import os
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
    lib = cuda_build.FLAGS["nvcc"]
    cubin = cuda_build.FLAGS["cubin"]
    assert "-cubin" in cubin
    assert "-shared" not in cubin and "-Xcompiler" not in cubin
    codegen = cuda_build.NVCC_CODEGEN
    for flags in (lib, cubin):
        assert flags[:len(codegen)] == codegen
    assert "arch=compute_90a,code=sm_90a" in codegen
    for flag in ("-O3", "-fmad=false", "-std=c++17"):
        assert flag in codegen
    assert codegen[codegen.index("-Xptxas") + 1] == "-v"
    # the launcher is host code: no device code generation at all
    host = cuda_build.FLAGS["host"]
    assert host[:2] == ["-x", "c++"] and "-gencode" not in host
    assert cuda_build.SUFFIX["cubin"] == ".cubin"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc: copies its input to `-o`, prints a ptxas
    line. Returns the file that lists each command it ran."""
    calls = tmp_path / "calls"
    script = _script(tmp_path / "nvcc", f"""echo "$@" >> {calls}
out=""; src=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  case "$a" in *.cu) src="$a";; esac
  prev="$a"
done
cp "$src" "$out"
echo "ptxas info    : Function properties for fused_dense_kernel"
""")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: script)
    return calls


def test_one_cubin_a_source_built_once_and_found_again(tmp_path, fake_nvcc):
    build_dir = tmp_path / "build"
    text = '#define ARES_NI 1\n#include "fused_dense_template.cuh"\n'
    built = cuda_build.built
    image = cuda_build.load_cubin("fused_dense", text, build_dir)
    assert image == text.encode()
    assert cuda_build.built == built + 1
    # found in the process, then on disk
    assert cuda_build.load_cubin("fused_dense", text, build_dir) is image
    cuda_build.build_all([("fused_dense", text, "cubin")], build_dir)
    assert cuda_build.built == built + 1
    path = cuda_build.library_path("fused_dense", text, "cubin", build_dir)
    assert path.suffix == ".cubin" and path.exists()
    assert "fused_dense_kernel" in path.with_suffix(".log").read_text()
    # one nvcc, -cubin with the libraries' code generation
    (call,) = fake_nvcc.read_text().splitlines()
    assert call.startswith(" ".join(cuda_build.CUBIN_FLAGS))
    assert os.path.basename(call.split()[-1]).endswith(".tmp")
