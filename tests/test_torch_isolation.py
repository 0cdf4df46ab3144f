"""The PyTorch port (`aresdb_tpu_torch`) stands alone.

It imports neither JAX, the JAX package nor `ml_dtypes` (which the JAX
package's geo module loads), `tornado`, `requests` or `yaml` (which the
JAX package's server, client and configuration load): the GPU machine
has none of them. Its entry points default to the GPU and refuse to fall
back to the CPU silently, and its kernel
wrappers take their plain versions only for tensors on the CPU.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aresdb_tpu_torch.query import pallas_ops as P
from aresdb_tpu_torch.utils.torch_env import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "aresdb_tpu_torch"

_IMPORT_ALL = """
import importlib, pathlib, sys
names = sorted(".".join(p.with_suffix("").parts).replace(".__init__", "")
               for p in pathlib.Path("aresdb_tpu_torch").rglob("*.py"))
for name in names:
    importlib.import_module(name)
import chip_smoke, kernel_ab
bad = [n for n in sys.modules
       if n.split(".")[0] in ("jax", "aresdb_tpu", "ml_dtypes", "tornado",
                              "requests", "yaml")]
assert not bad, bad
print(len(names))
"""


def test_importing_every_module_loads_neither_jax_nor_the_jax_package():
    """Every module, the geo, MemStore, redo-log, server and daemon modules
    included, the cluster's: controller, datanode, broker and the HTTP
    client that stands in for `requests`; the client, subscriber,
    arescli and example tools, which talk HTTP through that client; and
    the single-process mesh, `parallel/`."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20   # every module was imported
    for name in ("query/geo.py", "memstore/memstore.py",
                 "memstore/host_memory.py", "redolog/manager.py",
                 "redolog/file_redolog.py", "redolog/kafka.py",
                 "api/server.py", "cmd/aresd.py", "query/admission.py",
                 "api/httpbase.py", "controller/server.py",
                 "broker/server.py", "datanode/datanode.py",
                 "datanode/bootstrap.py", "utils/http_client.py",
                 "cmd/controller.py", "cmd/broker.py",
                 "client/__init__.py", "client/connector.py",
                 "client/query.py", "subscriber/__init__.py",
                 "subscriber/subscriber.py", "cmd/arescli.py",
                 "cmd/subscriber.py", "cmd/examples.py",
                 "cmd/example_data.py", "utils/gorand.py",
                 "utils/racetool.py", "parallel/__init__.py",
                 "parallel/sharded.py"):
        assert (PORT / name).is_file(), name


def test_every_module_of_the_jax_package_has_a_counterpart():
    """Each module of the JAX package has one of the same path in the
    port, but utils/jax_env.py, which utils/torch_env.py replaces; and no
    docstring of the port says that a part is not ported yet."""
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if "build" not in p.relative_to(root).parts}

    missing = modules(ROOT / "aresdb_tpu") - modules(PORT)
    assert missing == {"utils/jax_env.py"}
    assert (PORT / "utils/torch_env.py").is_file()
    for path in sorted(PORT.rglob("*.py")):
        assert "not ported yet" not in path.read_text().lower(), path


_READ_KNOB = re.compile(r'environ(?:\.get)?[(\[]\s*"(ARES_[A-Z0-9_]+)"')


def _knobs_read(root: Path) -> set:
    """The ARES_* environment names that a package's modules read."""
    return {m.group(1) for p in root.rglob("*.py")
            for m in _READ_KNOB.finditer(p.read_text())}


def test_every_knob_of_the_jax_package_is_read_or_not_carried_over():
    """Every ARES_* name that aresdb_tpu/ reads is read by the port, or
    named in ROADMAP.md's "Not carried over" list with its reason."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    start = roadmap.index("**Not carried over, by design.**")
    not_carried = roadmap[start:roadmap.index("### ", start)]
    jax_knobs = _knobs_read(ROOT / "aresdb_tpu")
    assert {"ARES_PREFIX", "ARES_FUSED", "ARES_FD_T"} <= jax_knobs
    missing = {k for k in jax_knobs - _knobs_read(PORT)
               if k not in not_carried}
    assert not missing, sorted(missing)
    assert "ARES_PREFIX" in _knobs_read(PORT)


_FORBIDDEN = (re.compile(r"\bimport jax\b|\bfrom jax\b"),
              re.compile(r"(from|import) aresdb_tpu(\.|\s)"),
              re.compile(r"\bimport ml_dtypes\b|\bfrom ml_dtypes\b"),
              re.compile(r"\bimport requests\b|\bfrom requests\b"))


def _port_files():
    files = [p for p in sorted(PORT.rglob("*"))
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")
             and "build" not in p.relative_to(PORT).parts]
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax_or_the_jax_package(path):
    text = path.read_text()
    for pattern in _FORBIDDEN:
        hit = pattern.search(text)
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_resolve_device_defaults_to_cuda_and_cpu_only_when_asked():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_query_service_defaults_to_cuda():
    from aresdb_tpu_torch.query.service import QueryService

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryService(None)


def test_kernel_wrapper_refuses_a_tensor_that_is_neither_cpu_nor_cuda():
    slots = torch.zeros(8, dtype=torch.int32, device="meta")
    values = torch.zeros((8, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        P.segment_sum(slots, values, 16)
