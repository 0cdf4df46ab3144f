"""The lower-precision control of a cell's comparison, at the cell's own
size: the reference computed on bfloat16 values (the precision below the
configuration's float32), put in the port's place and judged as the
port's answers are, once for each seed.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints a JSON line a seed with the largest relative error of a sum or an
average over the cell's queries (`sum_rel_err`) beside the cell's limit.
The benchmark's runs do not run it; it sets the upper reading of the
limit (PERF.md). Standard library and numpy only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import bench  # noqa: E402
from portbench.reference import engine as E  # noqa: E402


def nest(flat: dict) -> dict:
    """A flat {(key, ...): value} answer as the daemon nests it."""
    out = {}
    for k, v in flat.items():
        d = out
        for part in k[:-1]:
            d = d.setdefault(part, {})
        d[k[-1]] = v
    return out


def control(cell, seed: int, clock: int) -> dict:
    dep = cell.gen.generate(cell.config, seed, clock)
    worst = {"group_mismatches": 0, "count_mismatches": 0,
             "sum_rel_err": 0.0}
    for q in cell.queries.values():
        spec = q["spec"]
        want = E.answer(spec, dep.rows, dep.now)
        low = E.answer(spec, dep.rows, dep.now, values_bf16=True)
        c = E.compare(spec, nest(low), want)
        worst["group_mismatches"] += c["group_mismatch"]
        worst["count_mismatches"] += c["count_mismatch"]
        worst["sum_rel_err"] = max(worst["sum_rel_err"], c["sum_rel_err"])
    return worst


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    cell = bench.Cell(args.workload)
    for seed in args.seeds:
        t0 = time.monotonic()
        got = control(cell, seed, int(time.time()))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16 values", **got,
                          "limit": cell.traffic["limits"]["sum_rel_err"],
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
