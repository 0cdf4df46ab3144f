"""Importing the benchmark's entry, its clients and its reference loads
no module whose top-level name (the part before the first dot, compared
whole) is jax, jaxlib, flax or aresdb_tpu; the reference and the clients
load nothing of aresdb_tpu_torch either. Each import runs in a process
of its own."""

import subprocess
import sys

import pytest

from conftest import ROOT

_CHECK = """
import importlib, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
{extra}
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
print(bad)
"""

JAX = ("jax", "jaxlib", "flax", "aresdb_tpu")
ENTRY = ["portbench.run", "portbench.bench", "portbench.devtrace",
         "portbench.control", "portbench.metrics.http_ms",
         "portbench.metrics.stage_ms", "portbench.metrics.cache_hit_pct",
         "portbench.metrics.batch_exec_ms", "portbench.metrics.result_ms",
         "portbench.metrics.scan_roofline",
         "portbench.metrics.device_idle_pct",
         "portbench.metrics.upsert_store_ms"]
PLAIN = ["portbench.client", "portbench.wire", "portbench.stats",
         "portbench.reference.engine", "portbench.reference.uber_trips"]


def loaded(modules, forbidden, extra=""):
    out = subprocess.run(
        [sys.executable, "-c", _CHECK.format(
            root=str(ROOT), modules=modules, forbidden=forbidden,
            extra=extra)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_entry_and_what_a_run_imports_load_no_jax():
    # what a run imports of the port, as set-up and the spans do
    extra = ("import aresdb_tpu_torch.cmd.aresd, "
             "aresdb_tpu_torch.query.executor, "
             "aresdb_tpu_torch.memstore.archiving, "
             "aresdb_tpu_torch.query.service, "
             "aresdb_tpu_torch.memstore.table_shard")
    assert loaded(ENTRY + PLAIN, JAX, extra) == []


@pytest.mark.parametrize("module", PLAIN)
def test_the_reference_and_the_clients_load_nothing_of_the_port(module):
    assert loaded([module], JAX + ("aresdb_tpu_torch", "torch")) == []
