"""The benchmark's CPU tests. Tests that need an NVIDIA card take the
`card` fixture, which skips them where there is none; whether there is
one is decided inside the fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes of each configuration, and a light load, for a rehearsal on
# the CPU
TINY = {"uber_trips": {"rows_per_day": 3000, "upsert_rows": 1024,
                       "batchSize": 1024}}
TINY_LOAD = {"dashboards": 2, "refresh_s": 1.0, "connections": 3,
             "answers_checked": 8}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
