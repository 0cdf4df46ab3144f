"""The port's own spans over a cell's windows: what the readers of
`portbench/metrics/` that read the program's spans give, the card's idle
time while a query is in the service split by the host span open then,
and what the port's tracing costs when it is on.

    python3 portbench/span_run.py --workload uber_trips.dash --seed <n> \
        --seconds 51 --order 0110 --profile 1 --out spans.json

Sets the cell up once, then runs one window for each letter of --order:
0 with the port's tracing off, 1 with it on (`utils/tracing.py`); with
--profile 1, one more window with the port's tracing and the profiler's
device trace both on. Each window logs one line to standard error with
its end-to-end numbers and its per-layer readings; the profiled window
also logs the in-query idle split and where each K1 launch fell among
its query's spans. --out takes every window's readings as JSON. The
harness's own run (`run.py`) does not switch the port's tracing on: its
`Tracer` has no hook for it, so the five readers of the program's spans
are in no cell yet, and this command is how they are measured.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402
from portbench import stats as S  # noqa: E402

SPAN_METRICS = ["queue_wait_ms", "http_self_ms", "batch_cpu_ms",
                "host_wait_pct", "device_wait_ms"]
DEVICE_METRICS = ["idle_in_query_pct", "device_idle_pct"]
PLAN_METRICS = ["batch_exec_ms", "stage_ms", "result_ms", "http_ms"]
K1 = "fused_dense"


def _s(ns: int) -> float:
    return ns / 1e9


def window_services(spans, lo: float, hi: float) -> list:
    return [s for s in spans if s.name == "service"
            and lo <= _s(s.start) and _s(s.end) <= hi]


def subtract(a: list, b: list) -> list:
    """The sorted disjoint intervals a less the sorted disjoint
    intervals b."""
    out, j = [], 0
    for lo, hi in a:
        at = lo
        while j < len(b) and b[j][1] <= at:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > at:
                out.append((at, b[k][0]))
            at = max(at, b[k][1])
            k += 1
        if at < hi:
            out.append((at, hi))
    return out


def idle_split(spans, device, lo: float, hi: float) -> dict:
    """The card's idle seconds while a query was in the service (the
    union of the window's `service` spans, less every device interval),
    each instant given to the innermost span open then on a thread that
    ran a query, shared evenly where several threads had one open."""
    svc = window_services(spans, lo, hi)
    threads = {s.thread for s in svc}
    served = S.union([(_s(s.start), _s(s.end)) for s in svc])
    idle = subtract(served, S.union([(a, b) for _, a, b in device]))
    events = sorted(
        [(_s(s.start), 1, i, s) for i, s in enumerate(spans)
         if s.thread in threads] +
        [(_s(s.end), 0, i, s) for i, s in enumerate(spans)
         if s.thread in threads], key=lambda e: (e[0], e[1], e[2]))
    stacks, split, i, t_prev = {}, {}, 0, lo
    for t, opening, _, s in events:
        if t > t_prev:
            while i < len(idle) and idle[i][1] <= t_prev:
                i += 1
            k, got = i, 0.0
            while k < len(idle) and idle[k][0] < t:
                got += min(t, idle[k][1]) - max(t_prev, idle[k][0])
                k += 1
            if got > 0:
                tops = [st[-1].name for st in stacks.values() if st] \
                    or ["(no span)"]
                for name in tops:
                    split[name] = split.get(name, 0.0) + got / len(tops)
            t_prev = t
        st = stacks.setdefault(s.thread, [])
        if opening:
            st.append(s)
        elif s in st:
            st.remove(s)
    return {"served_s": sum(b - a for a, b in served),
            "idle_in_query_s": sum(b - a for a, b in idle),
            "split_s": dict(sorted(split.items(), key=lambda kv: -kv[1]))}


def k1_placement(spans, device, lo: float, hi: float) -> dict:
    """Where each K1 launch of the window fell among the spans of the one
    query in the service at its start: inside a `batchExec` span, after
    the first `batchExec` and before the last `deviceWait` ended, or
    elsewhere; `ambiguous` where no or several queries were in the
    service. `example`: one query of eight batches or more, its spans
    and its K1 launches, in ms from its `service` span's start."""
    svc = sorted(window_services(spans, lo, hi), key=lambda s: s.start)
    starts = [_s(s.start) for s in svc]
    traces = {}
    for s in spans:
        traces.setdefault(s.trace, []).append(s)
    k1 = [(a, b) for name, a, b in device if name.startswith(K1)]
    out = {"inside_batchExec": 0, "after_batchExec_before_wait_end": 0,
           "other": 0, "ambiguous": 0, "example": None}
    for a, b in k1:
        j = bisect.bisect_right(starts, a)
        open_ = [s for s in svc[max(0, j - 64):j] if _s(s.end) >= a]
        if len(open_) != 1:
            out["ambiguous"] += 1
            continue
        q = open_[0]
        trace = traces[q.trace]
        execs = [s for s in trace if s.name == "batchExec"]
        waits = [s for s in trace if s.name == "deviceWait"]
        if any(_s(s.start) <= a <= _s(s.end) for s in execs):
            out["inside_batchExec"] += 1
        elif execs and waits and a >= min(_s(s.start) for s in execs) \
                and b <= max(_s(s.end) for s in waits):
            out["after_batchExec_before_wait_end"] += 1
        else:
            out["other"] += 1
        if out["example"] is None and len(execs) >= 8:
            t0 = q.start

            def ms(ns):
                return round((ns - t0) / 1e6, 3)
            out["example"] = {
                "trace": q.trace,
                "spans": [[s.name, ms(s.start), ms(s.end)]
                          for s in sorted(trace, key=lambda s: s.start)
                          if s.name not in ("http", "queue", "respond")],
                "k1": [[ms(x * 1e9), ms(y * 1e9)] for x, y in k1
                       if _s(q.start) <= x <= _s(q.end)]}
    return out


def per_query(spans, lo: float, hi: float) -> dict:
    """{span name: its mean wall ms, CPU ms and count a query} over the
    window's queries, each query's trace summed."""
    svc = window_services(spans, lo, hi)
    traces = {}
    for s in spans:
        traces.setdefault(s.trace, []).append(s)
    sums = {}
    for q in svc:
        for s in traces[q.trace]:
            w, c, n = sums.get(s.name, (0.0, 0.0, 0))
            sums[s.name] = (w + (s.end - s.start) / 1e6,
                            c + (s.cpu or 0) / 1e6, n + 1)
    k = max(1, len(svc))
    return {name: {"wall_ms": w / k, "cpu_ms": c / k, "n": n / k}
            for name, (w, c, n) in sorted(sums.items())}


def _read(metric: str, ctx):
    import importlib

    return importlib.import_module(f"portbench.metrics.{metric}").read(ctx)


def run(cell, seed: int, seconds: float, order: str, profile: bool,
        device: str = "cuda", cpus=None, log=None) -> list:
    """One window for each letter of order (0: the port's tracing off, 1:
    on), and with profile one more (P: tracing and, on the card, the
    profiler). [{mode, end-to-end numbers, readings, ...}] of each."""
    import torch

    from aresdb_tpu_torch.utils import tracing
    from portbench.devtrace import DeviceTrace, Spans

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cuda = device == "cuda"
    rows = []
    with tempfile.TemporaryDirectory(prefix="spans-") as work:
        dep, daemon, _ = bench.set_up(cell, seed, device, work, log)
        qb = bench.query_bytes(cell, dep)
        try:
            for mode in list(order) + (["P"] if profile else []):
                on = mode != "0"
                wrapper = Spans()
                wrapper.install()
                dtrace = DeviceTrace() if mode == "P" and cuda else None
                kept = {}

                def at_start():
                    if on:
                        tracing.start()
                    if dtrace is not None:
                        dtrace.start()

                def at_close():
                    if dtrace is not None:
                        dtrace.stop()
                    if on:
                        kept["spans"] = tracing.stop()
                        kept["dropped"] = tracing.dropped()

                if cuda:
                    torch.cuda.synchronize()
                try:
                    w = bench.drive(cell, dep, daemon.port, seed, seconds,
                                    work, cpus, at_start, at_close)
                finally:
                    wrapper.remove()
                lo, hi = w["start"], w["end"]
                queries = bench.query_records(w["results"])
                e2e = bench.end_to_end(cell, queries, [], lo, hi, 0.0)
                dev = None if dtrace is None else \
                    S.clip_events(dtrace.events, lo, hi)
                spans = kept.get("spans")
                ctx = bench.Context(window=(lo, hi), records=queries,
                                    upserts=[], spans=wrapper.query,
                                    store_spans=[], device=dev,
                                    program_spans=spans, query_bytes=qb,
                                    groups={})
                row = {"mode": mode,
                       "query_p95_ms": e2e["query_p95_ms"]["value"],
                       "queries_per_s": e2e["queries_per_s"]["value"],
                       "failed": sum(1 for r in queries if not r[4]),
                       "cpu_s": w["cpu"]}
                row.update((m, _read(m, ctx)) for m in
                           PLAN_METRICS + SPAN_METRICS + DEVICE_METRICS)
                if spans is not None:
                    row.update(spans=len(spans), dropped=kept["dropped"],
                               per_query=per_query(spans, lo, hi))
                if spans is not None and dev:
                    row["idle_split"] = idle_split(spans, dev, lo, hi)
                    row["k1"] = k1_placement(spans, dev, lo, hi)
                rows.append(row)
                log("window " + json.dumps(
                    {k: v for k, v in row.items()
                     if k not in ("per_query", "idle_split", "k1")}))
                if "idle_split" in row:
                    sp = row["idle_split"]
                    log("idle in query by innermost span: " + ", ".join(
                        f"{k} {v:.3f} s" for k, v in sp["split_s"].items())
                        + f" (of {sp['idle_in_query_s']:.3f} s idle in "
                        f"{sp['served_s']:.3f} s served)")
                    k1 = {k: v for k, v in row["k1"].items()
                          if k != "example"}
                    log(f"K1 launches by the span around them: {k1}")
        finally:
            daemon.stop()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/span_run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--order", default="01",
                   help="a window per letter: 0 tracing off, 1 on")
    p.add_argument("--profile", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    if set(a.order) - {"0", "1"}:
        p.error("--order is made of 0 and 1")
    import torch

    if not torch.cuda.is_available():
        print("portbench: span_run needs a CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    cell = bench.Cell(a.workload)
    cpus = bench.split_cores()
    rows = run(cell, a.seed, a.seconds, a.order, bool(a.profile),
               cpus=cpus)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"workload": a.workload, "seed": a.seed,
                   "device": torch.cuda.get_device_name(0),
                   "seconds_total": time.monotonic() - T_START,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
