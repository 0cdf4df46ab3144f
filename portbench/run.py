"""The benchmark of the port, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs an NVIDIA card (exits with 2 and prints no result without one,
with fewer cards than the cell asks for, or without the port beside it).
Prints each number compared with its limit as the last lines of standard
error, and as the last line of standard output one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device (and with --trace 1 busy_s,
window_s and a breakdown), and the numbers compared under `checks`.
Exits with 3, printing no result, if jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the repo's root, not this folder, heads the import path
sys.path[0] = str(ROOT)


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import bench

    try:
        cell = bench.Cell(args.workload)
    except (OSError, ValueError, KeyError) as e:
        return fail(f"cannot read the cell: {e!r}")
    if not (ROOT / "aresdb_tpu_torch").is_dir():
        return fail("the port, aresdb_tpu_torch/, is not beside the "
                    "benchmark")
    cpus = bench.split_cores()
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA device(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}")
    os.environ.setdefault("USE_FLAX", "0")
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START, cpus=cpus)
    found = bench.forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{found}", 3)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
