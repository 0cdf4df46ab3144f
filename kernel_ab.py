"""Measure the slot-histogram kernels K1, K2 and K3 on one GPU.

    python3 kernel_ab.py [--parent DIR] [--parent-tree ROOT]
                         [--modes sass,ab,trees,split,cache]
                         [--toolkit-include]
                         [--out FILE]

- sass:  the parent commit's kernels against this tree's, function by
         function (cuobjdump -sass and -res-usage): SASS instruction
         counts, LDC and constant-bank operands, each atomic opcode
         (shared-memory, distributed shared-memory and global atomics,
         native or a compare-and-swap loop) and registers, stack, shared
         and local bytes. K1 on chip_smoke.py's nine plans (the parent's
         template as `nvcc -cubin` against this tree's NVRTC cubin), K2's
         and K3's libraries (each built from the parent's csrc files and
         this tree's); then small probes of the PTX forms of a remote
         shared-memory add.
- ab:    the parent commit's K1, K2 and K3 against this tree's, at the
         shapes of chip_smoke.py's kernel phases (K3 also on one real Q5
         batch), in turns (old, new, new, old); each is checked against
         the plain version before it is timed. DIR holds the parent's
         `aresdb_tpu_torch/csrc/` files (e.g. from `git show`); its sources
         are built beside this tree's and never imported (its K1 by
         `nvcc -cubin`, launched by this tree's launcher).
- trees: the parent commit's whole tree against this one, where the
         kernels' interface or build changed: ROOT is the parent unpacked
         (`git archive HEAD | tar -x -C ROOT`). Each tree runs in a
         process of its own, in turns (parent, change, change, parent),
         with its own `chip_smoke.py` and `aresdb_tpu_torch` first on
         sys.path: its phase_k1 (K1 on the nine plans, each checked
         against the plain version) and each K1 cubin's SASS counts and
         resource usage; and, on its first turn (the build directory as
         the machine has it, empty on a fresh copy), the window probe: Q1
         (4 batches of trips) cold, twice warm and a quarter-hour on, a
         plan structure neither tree has built (Q1 with NEW_STRUCTURE's
         measure) cold and twice warm, and A6 (4 batches of atrips, two
         days archived) cold, twice warm and one and two seconds on, each
         run's ms, the builds it made and their seconds; then mode split
         on the tree's own sources.
- split: where K1's per-structure build spends its time: Q1's and J1's
         generated sources as `nvcc -time -cubin` (the fixed libraries'
         code generation: each phase nvcc runs, cicc and ptxas) and as an
         NVRTC compile in this process (cuda_build.NVRTC_OPTIONS), each
         twice, with each command's wall seconds; and whether NVRTC
         declares the cluster built-ins with no header. --toolkit-include
         times a tree whose device code reaches <cooperative_groups.h> and
         the C headers: NVRTC also gets the toolkit's include directory and
         C_HEADER_STANDINS.
- cache: whether NVRTC keeps what it compiled across processes, and
         where (mode_cache).

Times are device milliseconds per call from torch.profiler: `ms` with the
output memset the wrapper launches, `kernel_ms` of the kernels alone. Every
result is printed as one JSON line, and written to FILE where --out names
one. Needs one card, nvcc and NVRTC.
"""

from __future__ import annotations

import argparse
import csv
import ctypes
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as S

OUT = None    # --out: the file every result is also written to
N = S.BATCH_ROWS

# chip_smoke.py's K2 cases at the engine's C = 3 but the NaN one, which
# times as uniform slots
K2_SHAPES = tuple(case for case in S.K2_CASES
                  if case[2] == 3 and "NaN" not in case[0])
K1_SHAPES = ("Q1 sum(fare) hour x city", S.WIDE_K1_CASE)
# chip_smoke.py's K3 cases but the NaN and inf one, which times as Q5's
K3_SHAPES = tuple(case for case in S.K3_CASES if "nan" not in case[3])

PROBES = {
    "local shared atomicAdd": r"""
__global__ void probe(const int* s, const float* v, float* out) {
  __shared__ float h[1024];
  h[threadIdx.x] = 0.f;
  __syncthreads();
  atomicAdd(&h[s[threadIdx.x] & 1023], v[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = h[threadIdx.x];
}
""",
    "remote atomicAdd through map_shared_rank": r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __cluster_dims__(2, 1, 1)
probe(const int* s, const float* v, float* out) {
  __shared__ float h[1024];
  cg::cluster_group cl = cg::this_cluster();
  h[threadIdx.x] = 0.f;
  cl.sync();
  float* p = cl.map_shared_rank(h, (int)(cl.block_rank() ^ 1));
  atomicAdd(p + (s[threadIdx.x] & 1023), v[threadIdx.x]);
  cl.sync();
  out[blockIdx.x * 1024 + threadIdx.x] = h[threadIdx.x];
}
""",
    "remote red.shared::cluster.add.f32 (PTX)": r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __cluster_dims__(2, 1, 1)
probe(const int* s, const float* v, float* out) {
  __shared__ float h[1024];
  cg::cluster_group cl = cg::this_cluster();
  h[threadIdx.x] = 0.f;
  cl.sync();
  unsigned a = (unsigned)__cvta_generic_to_shared(h + (s[threadIdx.x] & 1023));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"((unsigned)(cl.block_rank() ^ 1)));
  asm volatile("red.relaxed.cluster.shared::cluster.add.f32 [%0], %1;"
               :: "r"(r), "f"(v[threadIdx.x]) : "memory");
  cl.sync();
  out[blockIdx.x * 1024 + threadIdx.x] = h[threadIdx.x];
}
""",
}


TREE_ROWS = 4 * N   # the window probe's trips and atrips rows


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)
    if OUT is not None:
        with open(OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")


# the __global__ functions of K1, K2 and K3, old and new
KERNEL_NAMES = ("segment_sum", "fused_dense")


def measure(fn, iters: int = 20, attempts: int = 3) -> tuple:
    """(ms, kernel_ms): device ms per call of fn(), all of its device work
    (the output memset included) and K1's or K2's kernel alone (one launch
    a call), from one profiler session after a warm-up. A session that
    recorded other than `iters` launches is taken again."""
    for _ in range(3):
        fn()
    for _ in range(attempts):
        events = S.device_events(fn, iters)
        own = [us for name, us in events
               if any(k in name for k in KERNEL_NAMES)]
        if len(own) == iters:
            break
        print(f"profiler: {len(own)} of {iters} launches recorded; taken "
              "again", flush=True)
    total = sum(us for _, us in events)
    if total <= 0 or len(own) != iters:
        raise RuntimeError("the profiler saw no device activity, or not "
                           "every launch")
    return total / iters / 1e3, sum(own) / iters / 1e3


def k2_inputs(n_slots, live, dropped, rng, device):
    """chip_smoke.k2_inputs of one K2 shape at C = 3, on the card."""
    slots, vals = S.k2_inputs(n_slots, 3, live, dropped, rng)
    return (torch.from_numpy(slots).to(device),
            torch.from_numpy(vals).to(device))


def k1_setups(device):
    """name -> (kernel wrapper, columns, n_valid, cutoff) of chip_smoke's
    K1 shapes."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.query.executor import columns_from_numpy

    out = {}
    cases = S.k1_cases(demo)
    for name in K1_SHAPES:
        query, city_max = cases[name]
        plan, dp, spec = S.k1_spec(demo, FD, plan_dense, query, city_max)
        cols_np, _ = demo.demo_columns(plan, N, seed=3,
                                       n_cities=max(city_max, 300))
        kern = FD.FusedDenseKernel(plan, N, dp, spec, device)
        out[name] = (kern, columns_from_numpy(cols_np, N, device), N - 777,
                     demo.DEMO_NOW - 15 * 3600)
    return out


def k1_pointers(kern, columns):
    lanes = kern._lanes(columns)
    p = ctypes.c_void_p
    vals = (p * len(lanes))(*[v.data_ptr() for v, _ in lanes])
    valids = (p * len(lanes))(*[b.data_ptr() for _, b in lanes])
    tcol = columns[(0, 0)][0].data_ptr() if (0, 0) in columns else None
    return vals, valids, len(lanes), tcol


def cuobjdump(*args) -> str:
    from aresdb_tpu_torch.utils import cuda_build

    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), *map(str, args)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump {args}: {proc.stderr[-1500:]}")
    return proc.stdout


ATOMIC = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG|REDAS)"
                    r"(?:\.[A-Z0-9_]+)*)\b")


def sass_functions(path) -> dict:
    """function -> its SASS instruction count, its LDC and constant-bank
    operands, each opcode's and each atomic's count (cuobjdump -sass of a
    cubin or a library), and its resource usage (cuobjdump -res-usage: REG, STACK,
    SHARED, LOCAL, ...)."""
    out, fn = {}, None
    for line in cuobjdump("-sass", path).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"instructions": 0, "LDC": 0, "c[0x0] operands": 0,
                       "atomics": {}, "opcodes": {}}
            continue
        if fn is None or not re.search(r"/\*[0-9a-f]{4}\*/", line):
            continue
        rec = out[fn]
        rec["instructions"] += 1
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if op:
            rec["opcodes"][op.group(1)] = rec["opcodes"].get(op.group(1),
                                                             0) + 1
        rec["LDC"] += len(re.findall(r"\bLDC\b", line))
        rec["c[0x0] operands"] += len(re.findall(r"c\[0x0\]", line))
        op = ATOMIC.search(line)
        if op:
            rec["atomics"][op.group(1)] = rec["atomics"].get(op.group(1),
                                                             0) + 1
    usage = cuobjdump("-res-usage", path)
    for m in re.finditer(r"Function (\S+):\s*\n\s*((?:[A-Z_\[\]0-9]+:\d+"
                         r"\s*)+)", usage):
        fields = dict((k, int(v)) for k, v in
                      re.findall(r"([A-Z_\[\]0-9]+):(\d+)", m.group(2)))
        out.setdefault(m.group(1), {})["usage"] = fields
    return out


def nvcc_cubin(name: str, text: str) -> Path:
    """`nvcc -cubin` of `text` under the fixed libraries' code generation
    (cuda_build.NVCC_CODEGEN), as K1's structures were built before NVRTC:
    for a parent tree's K1 source, its headers inlined. Kept under the
    build directory by the text's hash."""
    import hashlib

    from aresdb_tpu_torch.utils import cuda_build

    out = cuda_build.BUILD_DIR / "kernel_ab" / \
        f"{name}-{hashlib.sha256(text.encode()).hexdigest()[:24]}.cubin"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        proc = subprocess.run(
            [cuda_build.nvcc_path()] + cuda_build.NVCC_CODEGEN +
            ["-cubin", "-I", str(cuda_build.CSRC), str(src), "-o", str(out)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -cubin of {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def parent_k1_source(source: str, parent: Path) -> str:
    """A K1 source of this tree with the parent's template and headers in
    place of this tree's."""
    return source.replace(
        '#include "fused_dense_template.cuh"',
        inline_includes((parent / "fused_dense_template.cuh").read_text(),
                        parent))


def mode_sass(parent: Path, seed: int) -> None:
    """The parent's kernels against this tree's, function by function:
    SASS instruction counts, atomics and resource usage (sass_functions).
    K1 on each of chip_smoke's nine plans: the parent's template built by
    `nvcc -cubin` against this tree's cubin (NVRTC); K2's and K3's
    libraries, each built from the parent's csrc files and from this
    tree's. Then the probes: the PTX forms of a remote shared-memory add."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.utils import cuda_build

    pairs = {}
    for name, (query, city_max) in S.k1_cases(demo, seed).items():
        spec = S.k1_spec(demo, FD, plan_dense, query, city_max)[2]
        pairs[f"K1 {name}"] = (
            nvcc_cubin("parent_fused_dense",
                       parent_k1_source(spec.source, parent)),
            FD.build_item(spec.source))
    for label, src in (("K2", P.SOURCE), ("K3", P.K3_SOURCE)):
        old = ("parent_" + Path(src).stem,
               inline_includes((parent / src).read_text(), parent), "nvcc")
        pairs[label] = (old, (Path(src).stem, cuda_build.csrc_text(src),
                              "nvcc"))
    items = [item for _, (old, new) in pairs.items()
             for item in (old, new) if isinstance(item, tuple)]
    emit({"mode": "sass", "built_s": cuda_build.build_all(items)})
    for label, (old, new) in pairs.items():
        paths = [item if isinstance(item, Path) else
                 cuda_build.library_path(*item) for item in (old, new)]
        parent_fns, change_fns = map(sass_functions, paths)
        equal = {fn: {k: parent_fns.get(fn, {}).get(k) == rec.get(k)
                      for k in ("instructions", "atomics", "usage")}
                 for fn, rec in change_fns.items()}
        emit({"mode": "sass", "kernel": label, "parent": parent_fns,
              "change": change_fns, "equal": equal})
    for k, (label, src) in enumerate(PROBES.items()):
        try:
            cuda_build.build_all([(f"probe{k}", src, "nvcc")])
            fns = sass_functions(cuda_build.library_path(f"probe{k}", src,
                                                         "nvcc"))
            emit({"mode": "sass", "probe": label,
                  "atomics": {fn: r.get("atomics") for fn, r in fns.items()}})
        except RuntimeError as e:
            emit({"mode": "sass", "probe": label, "built": False,
                  "error": str(e)[-1500:]})


def ptxas_usage(log: str) -> dict:
    """function -> its registers and spills, from a `ptxas -v` log."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in line or "spill" in line):
            usage[fn] = (usage.get(fn, "") + " " + line.split(": ")[-1]
                         .strip()).strip()
    return usage


def check_k2(out, slots, vals, n_slots, name) -> float:
    from aresdb_tpu_torch.query import pallas_ops as P

    want = P.segment_sum_plain(slots, vals, n_slots)
    torch.cuda.synchronize()
    return S.check_close(name, out.t(), want.t(), exact_rows=(1, 2))


def inline_includes(text: str, src_dir: Path, seen=None) -> str:
    """text with each `#include "x"` whose x is in src_dir replaced by x's
    own text, recursively (the parent's headers, not this tree's); a
    header already inlined is left out, as its `#pragma once` would."""
    seen = set() if seen is None else seen

    def sub(m):
        f = src_dir / m.group(1)
        if not f.exists():
            return m.group(0)
        if f.name in seen:
            return ""
        seen.add(f.name)
        return inline_includes(f.read_text(), src_dir, seen)
    return re.sub(r'#include "([^"]+)"', sub, text)


def k3_setups(rng, q5, device):
    """(name, n_slots, c, exact count rows, slots, values) of every K3
    shape, on the card."""
    out = []
    for name, n_slots, c, traffic, _ in K3_SHAPES:
        slots, vals, _ = S.k3_inputs(n_slots, c, traffic, rng, q5)
        out.append((name, n_slots, c,
                    () if traffic == "floats" else (1, 2),
                    torch.from_numpy(slots).to(device),
                    torch.from_numpy(vals).to(device)))
    return out


def k3_call(fn, slots, vals, n_slots):
    """The parent's K3 entry fn launched into a new zeroed table."""
    c = vals.shape[1]
    out = torch.zeros((n_slots, c), device=slots.device)
    rc = fn(slots.data_ptr(), vals.data_ptr(), N, c, n_slots, out.data_ptr(),
            0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent K3: CUDA error {rc}")
    return out


def check_k3(out, slots, vals, n_slots, exact, name) -> float:
    from aresdb_tpu_torch.query import pallas_ops as P

    want = P.dense_segment_sum_plain(slots, vals, n_slots)
    torch.cuda.synchronize()
    return S.check_close(name, out.t(), want.t(), exact_rows=exact)


def parent_k1_kernel(text: str, spec, device) -> int:
    """The parent's K1 source `text` (headers inlined), built by `nvcc
    -cubin` and loaded by this tree's launcher (the kernel's ABI is the
    launcher's check)."""
    from aresdb_tpu_torch.query import fused_dense as FD

    image = nvcc_cubin("parent_fused_dense", text).read_bytes()
    PARENT_IMAGES.append(image)   # held for the life of the process
    handle = ctypes.c_void_p()
    rc = FD._launcher().ares_fused_dense_load(
        image, len(spec.lits_i), len(spec.lits_f), device.index or 0,
        ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"parent K1: load failed ({rc})")
    return handle.value


PARENT_IMAGES = []


def mode_ab(parent: Path, k1, k3, rng, device) -> None:
    """Parent and change at every K2, K1 and K3 shape: old, new, new,
    old."""
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.utils import cuda_build

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old_k2 = cuda_build.load_library(
        "parent_segment_sum",
        inline_includes((parent / "segment_sum.cu").read_text(), parent))
    old_k2 = old_k2.ares_segment_sum
    old_k2.argtypes = [p, p, ll, i, i, p, i, p]
    old_k2.restype = i
    for name, n_slots, _, live, dropped in K2_SHAPES:
        slots, vals = k2_inputs(n_slots, live, dropped, rng, device)

        def old():
            out = torch.zeros((n_slots, 3), device=device)
            rc = old_k2(slots.data_ptr(), vals.data_ptr(), N, 3, n_slots,
                        out.data_ptr(), 0,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent K2: CUDA error {rc}")
            return out

        def new():
            return P.segment_sum(slots, vals, n_slots)

        errs = [check_k2(f(), slots, vals, n_slots, f"K2 {name} {tag}")
                for tag, f in (("parent", old), ("change", new))]
        runs = [(tag, measure(f)) for tag, f in
                (("parent", old), ("change", new), ("change", new),
                 ("parent", old))]
        emit({"mode": "ab", "kernel": "K2", "shape": name,
              "max_abs_err": errs, "runs": runs})
    for name, (kern, columns, n_valid, cutoff) in k1.items():
        # the parent's template, a cubin launched by this tree's launcher
        old_k = parent_k1_kernel(parent_k1_source(kern.spec.source, parent),
                                 kern.spec, device)
        ni, nf = len(kern.spec.lits_i), len(kern.spec.lits_f)
        vals_p, valids_p, n_cols, tptr = k1_pointers(kern, columns)
        n_slots = kern.spec.n_slots

        def old():
            out = torch.zeros((3, n_slots), device=device)
            ovf = torch.zeros(1, dtype=torch.int32, device=device)
            rc = FD._launcher().ares_fused_dense(
                old_k, ni, nf, vals_p, valids_p, n_cols, *kern._lits, N,
                n_valid, tptr, cutoff, n_slots, out.data_ptr(),
                ovf.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent K1: CUDA error {rc}")
            return out

        def new():
            return kern.reduce(columns, n_valid, cutoff)[0]

        want, _ = kern.reduce_plain(columns, n_valid, cutoff)
        errs = []
        for tag, f in (("parent", old), ("change", new)):
            got = f()
            torch.cuda.synchronize()
            errs.append(S.check_close(f"K1 {name} {tag}", got, want,
                                      exact_rows=(1, 2)))
        runs = [(tag, measure(f)) for tag, f in
                (("parent", old), ("change", new), ("change", new),
                 ("parent", old))]
        emit({"mode": "ab", "kernel": "K1", "shape": name,
              "n_slots": n_slots, "max_abs_err": errs, "runs": runs})
    old_k3 = cuda_build.load_library(
        "parent_dense_segment_sum",
        inline_includes((parent / "dense_segment_sum.cu").read_text(),
                        parent)).ares_dense_segment_sum
    old_k3.argtypes = [p, p, ll, i, i, p, i, p]
    old_k3.restype = i
    # read before each cold call: 128 MB, which leaves none of a K3
    # call's inputs in the 50 MB L2, as in the engine, where a batch's
    # evaluation runs between two K3 calls
    flush = torch.ones(32 << 20, device=device)
    for name, n_slots, c, exact, slots, vals in k3:
        def old():
            return k3_call(old_k3, slots, vals, n_slots)

        def new():
            return P.dense_segment_sum(slots, vals, n_slots)

        errs = [check_k3(f(), slots, vals, n_slots, exact,
                         f"K3 {name} {tag}")
                for tag, f in (("parent", old), ("change", new))]
        turns = (("parent", old), ("change", new), ("change", new),
                 ("parent", old))
        runs = [(tag, measure(f)) for tag, f in turns]
        cold = [(tag, measure(lambda f=f: (flush.sum(), f())))
                for tag, f in turns]
        emit({"mode": "ab", "kernel": "K3", "shape": name, "n_slots": n_slots,
              "channels": c, "max_abs_err": errs, "runs": runs,
              "cold_l2_runs": cold})


# Q1 with a measure no other query of either tree plans: a structure that
# neither tree has built when the window probe reaches it
NEW_STRUCTURE = {"sqlExpression": "sum(fare * 3 - 1)",
                 "rowFilters": ["status='completed'", "city_id != 13"]}


def window_probe(device, seed: int, rows: int = TREE_ROWS,
                 batch_rows: int = N) -> dict:
    """Q1 over `rows` trips cold, twice warm and a quarter-hour on, then a
    new structure (Q1 with NEW_STRUCTURE's measure) cold and twice warm;
    and A6 over `rows` atrips (two days archived) cold, twice warm and one
    and two seconds on, through the tree's QueryService on `device`: each
    run's ms, groups, the builds it made and their seconds."""
    import tempfile

    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils import cuda_build

    built = []
    start = cuda_build._start

    def counting_start(name, text, compiler, build_dir):
        job = start(name, text, compiler, build_dir)
        if job is not None:
            built.append(name)
        return job

    def runs(svc, name, q, moves):
        out = []
        for move in moves:
            n0, s0 = len(built), cuda_build.build_seconds
            t0 = time.perf_counter()
            answer, _ = S.ask(svc, name, dict(q, now=q["now"] + move))
            if svc.device.type == "cuda":
                torch.cuda.synchronize()
            out.append({"move_s": move, "groups": len(S.flatten(answer)),
                        "ms": 1e3 * (time.perf_counter() - t0),
                        "builds": len(built) - n0,
                        "build_s": cuda_build.build_seconds - s0})
        return out

    cuda_build._start = counting_start
    try:
        store, _, _ = S.ingest_trips(rows, seed, batch_rows)
        svc = QueryService(store, device=device)
        rec = {"Q1": runs(svc, "Q1", demo.DEMO_QUERY, (0, 0, 0, 900)),
               "new structure": runs(svc, "new structure", dict(
                   demo.DEMO_QUERY, measures=[NEW_STRUCTURE]), (0, 0, 0))}
        with tempfile.TemporaryDirectory() as root:
            store = S.ingest_atrips(rows, seed, batch_rows, root)[0]
            rec["A6"] = runs(QueryService(store, device=device), "A6",
                             S.atrips_queries()["A6"][0], (0, 0, 0, 1, 2))
    finally:
        cuda_build._start = start
    return rec


def tree_child(tag: str, window: bool, seed: int) -> None:
    """One turn of mode trees, in a process whose sys.path starts with
    the tree's root: prints one JSON line of its results."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.query.executor import columns_from_numpy
    from aresdb_tpu_torch.utils import cuda_build

    device = torch.device("cuda")
    rec = {"tree": tag, "root": str(Path(S.__file__).parent)}
    if window:
        rec.update(window_probe(device, seed))
        rec["split"] = mode_split(seed)
    sources = []
    for query, city_max in S.k1_cases(demo, seed).values():
        spec = S.k1_spec(demo, FD, plan_dense, query, city_max)[2]
        sources.append(FD.build_item(spec.source))
    rec["k1_build_s"] = cuda_build.build_all(sources)
    # the parent's nvcc cubins and this tree's NVRTC ones alike
    rec["k1_sass"] = {
        k: sass_functions(cuda_build.library_path(*src))
        .get("fused_dense_kernel") for k, src in
        zip(S.k1_cases(demo, seed), sources)}
    k1 = S.phase_k1(demo, FD, columns_from_numpy, plan_dense, cuda_build,
                    device, seed)
    rec["k1"] = {k: {m: r[m] for m in ("ms", "kernel_ms", "max_abs_err")}
                 for k, r in k1.items()}
    print("TREE " + json.dumps(rec), flush=True)


def mode_trees(parent: Path, seed: int) -> None:
    """The parent tree and this one in turns, each turn a process
    (tree_child); emits each turn's results. NVRTC keeps what it compiles
    in the CUDA compute cache under HOME (mode_cache), where an earlier
    run on the machine may have left a structure: the turns run with
    CUDA_CACHE_DISABLE=1, so that each NVRTC build is a whole compile, as
    each nvcc build is."""
    here = Path(__file__).resolve().parent
    seen = set()
    for tag, root in (("parent", parent.resolve()), ("change", here),
                      ("change", here), ("parent", parent.resolve())):
        # this file, loaded by its path: the tree's root, first on
        # sys.path, gives chip_smoke and aresdb_tpu_torch
        code = ("import importlib.util, sys; sys.path.insert(0, sys.argv[1]);"
                " s = importlib.util.spec_from_file_location('kernel_ab_turn',"
                " sys.argv[2]); m = importlib.util.module_from_spec(s); "
                "s.loader.exec_module(m); m.tree_child(sys.argv[3], "
                "sys.argv[4] == '1', int(sys.argv[5]))")
        proc = subprocess.run(
            [sys.executable, "-c", code, str(root), str(Path(__file__)
                                                         .resolve()), tag,
             "0" if tag in seen else "1", str(seed)],
            cwd=str(root), capture_output=True, text=True, timeout=900,
            env=dict(os.environ, CUDA_CACHE_DISABLE="1"))
        seen.add(tag)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("TREE ")]
        if proc.returncode != 0 or len(lines) != 1:
            raise RuntimeError(f"{tag} turn failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        emit({"mode": "trees", **json.loads(lines[0][5:])})


def nvcc_phases(csv_text: str) -> dict:
    """phase name -> ms, summed over the rows of one `nvcc -time` csv."""
    phases = {}
    for row in csv.reader(io.StringIO(csv_text)):
        cells = [c.strip() for c in row]
        nums = [c for c in cells if re.fullmatch(r"[0-9]+(\.[0-9]+)?", c)]
        if len(cells) < 2 or not nums or cells[0].startswith("source"):
            continue
        phases[cells[1]] = phases.get(cells[1], 0.0) + float(nums[-1])
    return phases


# NVRTC's cluster built-ins, the ones cooperative_groups' cluster_group
# calls, with no header: whether NVRTC declares them itself
CLUSTER_PROBE = r"""
extern "C" __global__ void __cluster_dims__(2, 1, 1) probe(float* out) {
  __shared__ float h[32];
  h[threadIdx.x] = 1.f;
  __cluster_barrier_arrive();
  __cluster_barrier_wait();
  const unsigned r = __clusterRelativeBlockRank();
  float* p = (float*)__cluster_map_shared_rank(h, r ^ 1);
  out[blockIdx.x * 32 + threadIdx.x] = p[threadIdx.x];
  __cluster_barrier_arrive();
  __cluster_barrier_wait();
}
"""


# For NVRTC, which has no C library headers: what the three that a tree's
# ares_common.cuh may include give the device code, in the words of the
# toolkit's own cuda/std/__cuda/cstdint_prelude.h and cuda/std/climits
C_HEADER_STANDINS = {
    "stdint.h": "#pragma once\n" + "".join(
        f"typedef {t} {n};\n" for t, n in (
            ("signed char", "int8_t"), ("short", "int16_t"),
            ("int", "int32_t"), ("signed long long", "int64_t"),
            ("unsigned char", "uint8_t"), ("unsigned short", "uint16_t"),
            ("unsigned int", "uint32_t"), ("unsigned long long", "uint64_t"),
            ("uint64_t", "uintptr_t"))),
    "limits.h": "#pragma once\n#define INT_MAX 0x7fffffff\n"
                "#define INT_MIN (-INT_MAX - 1)\n",
    "math.h": "#pragma once\n",   # NVRTC declares the math functions
}


def python_loop(seconds: float) -> float:
    """Iterations a second of a plain Python loop over `seconds`."""
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        n += 1
    return n / (time.perf_counter() - t0)


def nvrtc_beside_python(rtc, source: str, headers: dict, options: list,
                        seconds: float) -> dict:
    """Whether an NVRTC compile on one thread lets another thread run
    Python, as a daemon's other query threads must: a Python loop's rate
    over the first `seconds` of the compile (less than the compile takes)
    against its rate alone."""
    import threading

    alone = python_loop(seconds)
    thread = threading.Thread(
        target=rtc.compile, args=(source, "fused_dense.cu", headers,
                                  options))
    t0 = time.perf_counter()
    thread.start()
    during = python_loop(seconds)
    thread.join()
    return {"mode": "split", "probe": "python beside a compile",
            "compile_s": time.perf_counter() - t0, "loop_s": seconds,
            "loop_per_s_during": during, "loop_per_s_alone": alone,
            "share": during / alone}


CACHE_PROBE = r"""
extern "C" __global__ void probe(float* out, float x) {
  out[threadIdx.x] = x * %d.0f + (float)threadIdx.x;
}
"""


def cache_child(text: str) -> None:
    """One NVRTC compile of `text` in this process: prints its seconds."""
    from aresdb_tpu_torch.utils import cuda_build

    rtc = cuda_build.nvrtc()
    t0 = time.perf_counter()
    _, log = rtc.compile(text, "probe.cu", {}, cuda_build.NVRTC_OPTIONS)
    print("CACHE " + json.dumps({"compile_s": time.perf_counter() - t0,
                                 "ptxas_ran": "Used" in log}), flush=True)


def mode_cache() -> list:
    """Whether NVRTC keeps compiles across processes, and where: a source
    no run has compiled, compiled in two processes one after another, then
    another under CUDA_CACHE_DISABLE=1; each with its seconds, whether its
    ptxas ran (its -v report), and the files that appeared or changed
    under HOME, TMPDIR and XDG_CACHE_HOME meanwhile."""
    import random
    import tempfile

    roots = {os.environ.get(k) or d for k, d in (
        ("HOME", "~"), ("TMPDIR", tempfile.gettempdir()),
        ("XDG_CACHE_HOME", "~/.cache"))}
    roots = sorted({str(Path(r).expanduser()) for r in roots})

    def files():
        seen = {}
        for root in roots:
            for path in Path(root).rglob("*"):
                try:
                    if path.is_file():
                        seen[str(path)] = path.stat().st_mtime_ns
                except OSError:
                    pass
        return seen

    code = ("import importlib.util, sys; s = importlib.util."
            "spec_from_file_location('kernel_ab_cache', sys.argv[1]); "
            "m = importlib.util.module_from_spec(s); "
            "s.loader.exec_module(m); m.cache_child(sys.argv[2])")
    out = []
    for disable in (False, True):
        text = CACHE_PROBE % random.randrange(1 << 30)
        env = dict(os.environ)
        if disable:
            env["CUDA_CACHE_DISABLE"] = "1"
        for turn in (1, 2):
            before = files()
            proc = subprocess.run(
                [sys.executable, "-c", code, str(Path(__file__).resolve()),
                 text], capture_output=True, text=True, env=env,
                cwd=str(Path(__file__).resolve().parent), timeout=300)
            after = files()
            lines = [l for l in proc.stdout.splitlines()
                     if l.startswith("CACHE ")]
            rec = {"mode": "cache", "CUDA_CACHE_DISABLE": disable,
                   "turn": turn, "roots": roots,
                   "changed": sorted(p for p, t in after.items()
                                     if before.get(p) != t)[:40]}
            if proc.returncode != 0 or len(lines) != 1:
                rec["error"] = (proc.stdout + proc.stderr)[-2000:]
            else:
                rec.update(json.loads(lines[0][6:]))
            out.append(rec)
    return out


def mode_split(seed: int, toolkit_include: bool = False) -> list:
    """Where K1's per-structure build spends its time: Q1's and J1's
    sources as `nvcc -time -cubin` (the fixed libraries' code generation)
    and as an NVRTC compile in this process (cuda_build.NVRTC_OPTIONS, the
    csrc headers in memory), twice each (the second with the headers in
    the page cache): one record each, with nvcc's phases and NVRTC's
    ptxas report, or its error; then the cluster built-ins' probe under
    NVRTC. toolkit_include, for a tree whose device code reaches
    <cooperative_groups.h> and the C headers: NVRTC also gets the
    toolkit's include directory and C_HEADER_STANDINS."""
    import tempfile

    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.utils import cuda_build

    nvcc = cuda_build.nvcc_path()
    cubin_cmd = [nvcc] + cuda_build.NVCC_CODEGEN + ["-cubin"]
    # a tree from before the NVRTC build times nvcc alone
    rtc = cuda_build.nvrtc() if hasattr(cuda_build, "nvrtc") else None
    options = list(getattr(cuda_build, "NVRTC_OPTIONS", ()))
    headers = {h.name: h.read_text()
               for h in sorted(cuda_build.CSRC.glob("*.cuh"))}
    if toolkit_include:
        options.append("--include-path="
                       f"{Path(nvcc).parent.parent / 'include'}")
        headers.update(C_HEADER_STANDINS)
    cases = S.k1_cases(demo, seed)
    out = []
    for name in ("Q1 sum(fare) hour x city", S.J1_K1_CASE):
        spec = S.k1_spec(demo, FD, plan_dense, *cases[name])[2]
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "k1.cu"
            src.write_text(spec.source)
            for turn in (1, 2):
                # nvcc -time appends: a file a command
                csv_path = Path(tmp) / f"{len(out)}.csv"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    cubin_cmd + ["-time", str(csv_path), "-I",
                                 str(cuda_build.CSRC), str(src), "-o",
                                 str(Path(tmp) / "out")],
                    capture_output=True, text=True)
                wall = time.perf_counter() - t0
                rec = {"mode": "split", "plan": name, "build": "nvcc -cubin",
                       "turn": turn, "wall_s": wall,
                       "command": " ".join(cubin_cmd[1:])}
                if proc.returncode != 0:
                    rec["error"] = (proc.stdout + proc.stderr)[-3000:]
                else:
                    text = csv_path.read_text()
                    rec.update(phases_ms=nvcc_phases(text),
                               ptxas=ptxas_usage(proc.stdout + proc.stderr),
                               csv=text[-4000:])
                out.append(rec)
        for turn in (1, 2) if rtc is not None else ():
            rec = {"mode": "split", "plan": name, "build": "nvrtc",
                   "turn": turn, "nvrtc": "{}.{}".format(*rtc.version()),
                   "options": options, "headers": sorted(headers)}
            t0 = time.perf_counter()
            try:
                image, log = rtc.compile(spec.source, "fused_dense.cu",
                                         headers, options)
                rec.update(wall_s=time.perf_counter() - t0,
                           cubin_bytes=len(image), ptxas=ptxas_usage(log),
                           log=log[-3000:])
            except cuda_build.NvrtcError as e:
                rec.update(wall_s=time.perf_counter() - t0,
                           error=str(e)[-3000:])
            out.append(rec)
    if rtc is None:
        return out
    # over half of the last compile's seconds: inside the next one
    out.append(nvrtc_beside_python(rtc, spec.source, headers, options,
                                   out[-1]["wall_s"] / 2))
    try:
        image, log = rtc.compile(CLUSTER_PROBE, "probe.cu", {},
                                 ["--gpu-architecture=sm_90a",
                                  "--std=c++17"])
        out.append({"mode": "split", "probe": "cluster built-ins",
                    "compiled": True, "log": log[-2000:]})
    except cuda_build.NvrtcError as e:
        out.append({"mode": "split", "probe": "cluster built-ins",
                    "compiled": False, "log": str(e)[-2000:]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="directory with the parent commit's csrc/ files")
    ap.add_argument("--parent-tree", type=Path,
                    help="the parent commit's whole tree, for mode trees")
    ap.add_argument("--modes", default="sass,ab")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--toolkit-include", action="store_true",
                    help="mode split: give NVRTC the toolkit's include "
                         "directory and C_HEADER_STANDINS (a tree whose "
                         "device code reaches <cooperative_groups.h> and "
                         "the C headers)")
    ap.add_argument("--out", type=Path,
                    help="file to write the JSON lines to as well")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    modes = args.modes.split(",")
    for mode in ("ab", "sass"):
        if mode in modes and args.parent is None:
            ap.error(f"mode {mode} needs --parent")
    if "trees" in modes and args.parent_tree is None:
        ap.error("mode trees needs --parent-tree")
    global OUT
    OUT = args.out
    if OUT is not None:
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.unlink(missing_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if "cache" in modes:
        for rec in mode_cache():
            emit(rec)
    if "split" in modes:
        for rec in mode_split(args.seed, args.toolkit_include):
            emit(rec)
    if "trees" in modes:
        mode_trees(args.parent_tree, args.seed)
    if "sass" in modes:
        mode_sass(args.parent, args.seed)
    if "ab" not in modes:
        return 0
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.utils import cuda_build

    device = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    k1 = k1_setups(device)
    sources = [("segment_sum", cuda_build.csrc_text(P.SOURCE), "nvcc"),
               ("dense_segment_sum", cuda_build.csrc_text(P.K3_SOURCE),
                "nvcc")] + [
        FD.build_item(kern.spec.source) for kern, *_ in k1.values()]
    emit({"built_s": cuda_build.build_all(sources)})
    k3 = k3_setups(rng, S.q5_batch(args.seed), device)
    mode_ab(args.parent, k1, k3, rng, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
