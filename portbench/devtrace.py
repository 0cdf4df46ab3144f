"""The traced run's device trace and the benchmark's own spans.

The device trace is torch.profiler's CUDA activity (kernels, copies and
memsets), read from the raw kineto events and put on the clock that every
process of the host shares (time.monotonic()). The spans are the
benchmark's own wrappers around two calls of the port, installed only in
the traced run: `QueryService.handle_aql` (a request's service time and
its plan's stage seconds, `plan.stats`, keyed by the request id that the
dashboard sends) and `TableShard.save_upsert_batch`.
"""

from __future__ import annotations

import threading
import time


class Spans:
    def __init__(self):
        self.query = {}     # request id -> (start, end, stage seconds)
        self.store = []     # (start, end) of each save_upsert_batch
        self._lock = threading.Lock()
        self._undo = []

    def install(self) -> None:
        from aresdb_tpu_torch.memstore.table_shard import TableShard
        from aresdb_tpu_torch.query.service import QueryService

        real_aql = QueryService.handle_aql
        real_save = TableShard.save_upsert_batch
        spans = self

        def handle_aql(svc, request, *args, **kwargs):
            rid = request.get("portbenchId")
            t0 = time.monotonic()
            resp = real_aql(svc, dict(request, verbose=1), *args, **kwargs)
            t1 = time.monotonic()
            contexts = resp.get("context") if request.get("verbose") \
                else resp.pop("context", None)
            if rid is not None:
                with spans._lock:
                    spans.query[rid] = (t0, t1, (contexts or [None])[0])
            return resp

        def save_upsert_batch(shard, *args, **kwargs):
            t0 = time.monotonic()
            try:
                return real_save(shard, *args, **kwargs)
            finally:
                t1 = time.monotonic()
                with spans._lock:
                    spans.store.append((t0, t1))

        QueryService.handle_aql = handle_aql
        TableShard.save_upsert_batch = save_upsert_batch
        self._undo = [(QueryService, "handle_aql", real_aql),
                      (TableShard, "save_upsert_batch", real_save)]

    def remove(self) -> None:
        for cls, name, fn in self._undo:
            setattr(cls, name, fn)
        self._undo = []


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.events = []
        self.clock = None

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__enter__()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        results = self.prof.profiler.kineto_results
        mono_ns = time.monotonic_ns()
        wall_ns = time.time_ns()
        raw = []
        for e in results.events():
            if e.device_type() != self.torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            raw.append((e.name(), s, d))
        if not raw:
            return
        # kineto's clock: the host's monotonic clock or the wall clock
        first = min(s for _, s, _ in raw)
        if abs(first - mono_ns) < abs(first - wall_ns):
            off, self.clock = 0, "monotonic"
        else:
            off, self.clock = wall_ns - mono_ns, "wall"
        self.events = [(name, (s - off) / 1e9, (s - off + d) / 1e9)
                       for name, s, d in raw]


def is_copy(name: str) -> bool:
    """A copy or memset, as CUPTI names them, rather than a kernel."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))
