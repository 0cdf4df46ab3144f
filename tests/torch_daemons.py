"""Two daemons side by side for the port's client-side tests: the JAX
package's ApiServer and the port's (on the CPU), each over a MemStore in a
temporary root of its own, with a Scheduler that is not started and both
packages' clocks frozen at `now` (following the wall's for None). A test
drives each with its own package's client and holds the answers against
each other.
"""

from __future__ import annotations

import contextlib
import math

from aresdb_tpu.api.server import ApiServer as JaxApiServer
from aresdb_tpu.diskstore.local_diskstore import \
    LocalDiskStore as JaxDiskStore
from aresdb_tpu.memstore.memstore import MemStore as JaxMemStore
from aresdb_tpu.memstore.scheduler import Scheduler as JaxScheduler
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JaxMetaStore
from aresdb_tpu.utils import clock as jax_clock
from aresdb_tpu_torch.api.server import ApiServer
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.memstore.scheduler import Scheduler
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.utils import clock

RTOL = 2.0 ** -17
SIDES = ("jax", "port")


@contextlib.contextmanager
def daemons(tmp_path_factory, now):
    """{"jax": port, "port": port} of the two daemons, stopped after."""
    set_clocks(now)
    running = []
    try:
        for side in SIDES:
            root = str(tmp_path_factory.mktemp(side))
            if side == "jax":
                ms = JaxMemStore(JaxMetaStore(root), JaxDiskStore(root))
                ms.fetch_schema()
                srv = JaxApiServer(ms, JaxScheduler(ms), port=0)
            else:
                ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
                ms.fetch_schema()
                srv = ApiServer(ms, Scheduler(ms), port=0, device="cpu")
            running.append((side, srv, srv.start_background(), ms))
        yield {side: port for side, _, port, _ in running}
    finally:
        for _, srv, _, ms in running:
            srv.stop()
            ms.host_memory_manager.stop()
            ms.redolog_master.stop_all()
        set_clocks(None)


def set_clocks(now) -> None:
    """Both packages' clocks frozen at now; following the wall for None."""
    jax_clock.set_current_time(now)
    clock.set_current_time(now)


def close(a, b, where="answer"):
    """a and b equal as JSON: numbers within RTOL, the rest exactly."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (where, a, b)
        if not (math.isnan(a) and math.isnan(b)):
            assert a == b or abs(a - b) <= RTOL * max(abs(a), abs(b)), \
                (where, a, b)
    else:
        assert a == b, (where, a, b)
