"""A cell's load sweep: one set-up, then one short window at each step
of load, to find the highest load at which the requests' lateness does
not grow over the window.

    python3 portbench/sweep.py --workload uber_trips.dash --seed <n> \
        --seconds <s> --steps '{"dashboards": 10}' '{"dashboards": 20}'

A step is a JSON object of traffic keys set anew (an ingest cell's
`"ingest"` keys merge into the file's). Prints a JSON line a step: the
queries due and answered, their median ms from due over the first and
the last fifth of the window, their p95, the rate answered, and in an
ingest cell the same of the upserts. PERF.md keeps the sweeps and the
load each traffic file was given from them.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import bench  # noqa: E402
from portbench import stats as S  # noqa: E402


def growth(lat: list, start: float, end: float) -> dict:
    """[(due, ms)]: the median ms over the first and the last fifth of
    the window, and the p95 over all."""
    fifth = (end - start) / 5
    first = [ms for due, ms in lat if due < start + fifth]
    last = [ms for due, ms in lat if due >= end - fifth]
    return {"n": len(lat),
            "median_first_ms": S.percentile(first, 50) if first else None,
            "median_last_ms": S.percentile(last, 50) if last else None,
            "p95_ms": S.percentile([ms for _, ms in lat], 95) if lat
            else None}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="uber_trips.dash")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--steps", nargs="+", required=True)
    args = p.parse_args()
    cpus = bench.split_cores()
    base = bench.Cell(args.workload)
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        dep, daemon, _ = bench.set_up(base, args.seed, "cuda", work, log)
        try:
            for step in map(json.loads, args.steps):
                if "ingest" in step:
                    step = dict(step, ingest=dict(base.traffic["ingest"],
                                                  **step["ingest"]))
                cell = bench.Cell(args.workload, traffic=step)
                w = bench.drive(cell, dep, daemon.port, args.seed,
                                args.seconds, work, cpus)
                start, end = w["start"], w["end"]
                qs = bench.query_records(w["results"])
                ups = bench.upsert_records(w["results"])
                out = {"step": step, "queries_due": len(qs),
                       "answered_per_s": sum(
                           1 for r in qs if r[4] and r[3] <= end)
                       / (end - start),
                       "queries": growth([(r[1], (r[3] - r[1]) * 1e3)
                                          for r in qs if r[4]], start, end),
                       "failed": sum(1 for r in qs if not r[4]),
                       "cpu_s": w["cpu"]}
                if ups:
                    out["upserts"] = growth(
                        [(u[2], (u[4] - u[2]) * 1e3) for u in ups if u[5]],
                        start, end)
                print(json.dumps(out), flush=True)
                log(bench.summary(qs, ups, start, end, w["cpu"]))
        finally:
            daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
