"""On the card: each cell of BENCHMARK.json runs through the measuring
command, at its own size, for a short window, and comes out correct.
Skipped without a card. On the card:

    python3 -m pytest -q portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import bench

CELLS = [w["name"] for w in bench.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(card, name):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
