"""Query admission control: device-memory estimation + reservation gate.

Reference: query/device_manager.go (DeviceManager.FindDevice waits on a
condition variable until `requiredMem` fits under deviceMemoryUtilization ×
device memory, or times out after DeviceChoosingTimeout) and
query/aql_processor.go:985 calculateMemoryRequirement (max per-batch input
bytes + intermediate vectors; HLL queries use a fixed 10 GiB budget slice).

Port of `aresdb_tpu/query/admission.py`: the estimate, the one-device
gate (`DeviceMemoryManager`) and the multi-device pool (`DevicePool`)
are host code, copied; the budgets come from torch devices
(`device_memory_budget`, `_per_device_budget`). The pool places each
admitted query on ONE device, the one with the most free budget (or the
`?device=` one where it fits), waits FIFO-ish on a Condition otherwise,
and hands out a `DeviceLease` that makes its device the thread's current
CUDA device. Queries whose estimate exceeds the whole budget are
rejected immediately, mirroring FindDevice's `requiredMem >
MaxAvailableMemory` early exit. Peak usage is the largest single (batch
× staged columns) working set — the executor stages one batch at a time
— plus wholly-staged foreign (joined) tables.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query.kernels import round_up_pow2
from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils.torch_env import resolve_device

HLL_QUERY_REQUIRED_BYTES = 10 << 30  # aql_processor.go:34 (10 GiB, in MB)
# pipeline fudge: deferred async dispatch keeps ~2 batches of device input
# alive (previous batch may not be freed before the next is staged)
PIPELINE_FACTOR = 2
CPU_MEMORY_BYTES = 16 << 30  # the budget's total for a `cpu` device
# The device column cache (executor.DeviceColumnCache) keeps staged columns
# between queries: this share of a CUDA device's total memory, which the
# admission budget leaves to it, so that the two together stay within the
# card; CPU_DEVICE_CACHE_BYTES on `cpu`.
DEVICE_CACHE_SHARE = 0.25
CPU_DEVICE_CACHE_BYTES = 4 << 30


class AdmissionError(Exception):
    """Raised when a query cannot be admitted (too big, or timed out)."""


def _dtype_bytes(data_type: int) -> int:
    try:
        item = np.dtype(mdt.numpy_dtype(data_type)).itemsize
    except ValueError:
        item = 4
    return item * mdt.lanes(data_type) + 1  # +1 validity byte per row


def device_cache_budget(device) -> int:
    """The device column cache's bytes on `device`: DEVICE_CACHE_SHARE of
    a CUDA device's total memory (`torch.cuda.mem_get_info`), else
    CPU_DEVICE_CACHE_BYTES."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1] * DEVICE_CACHE_SHARE)
    return CPU_DEVICE_CACHE_BYTES


def _card_budget(device: torch.device, utilization: float) -> int:
    """A CUDA device's admission bytes: `utilization` of its total memory
    less the column cache's share."""
    total = torch.cuda.mem_get_info(device)[1]
    return max(0, int(total * utilization) - device_cache_budget(device))


def _per_device_budget(device: torch.device, utilization: float,
                       fallback: int) -> int:
    """One device's usable bytes: a CUDA device's own (`_card_budget`),
    else `fallback`."""
    if device.type == "cuda":
        return _card_budget(device, utilization)
    return fallback


def device_memory_budget(utilization: float = 0.95, device=None) -> int:
    """Usable device bytes: `utilization` of the `ARES_DEVICE_MEMORY` env
    override, else of the `cuda` device's total memory
    (`torch.cuda.mem_get_info`; `cuda` unless `device` names another) less
    the column cache's share (`_card_budget`), else of 16 GiB for `cpu`."""
    if not (0.0 < utilization <= 1.0):
        utilization = 0.95
    env = os.environ.get("ARES_DEVICE_MEMORY")
    if env:
        return int(int(env) * utilization)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return _card_budget(dev, utilization)
    return int(CPU_MEMORY_BYTES * utilization)


def estimate_query_memory(plan, memstore) -> int:
    """Per-query device-memory estimate from the compiled plan and the
    staged column footprint (aql_processor.go:985).

    max over batches of (rows × bytes/row of used columns), × pipeline
    factor, + foreign tables staged whole, + per-dim/measure intermediates.
    """
    if (plan.measure is not None and not plan.is_non_agg
            and plan.measure.agg == "hll"):
        return HLL_QUERY_REQUIRED_BYTES

    schema = plan.main_schema
    bytes_per_row = sum(
        _dtype_bytes(schema.table.columns[cid].data_type)
        for cid in plan.used_columns
        if cid < len(schema.table.columns))
    # intermediate vectors: dim values + measure + mask per row (f32-ish)
    bytes_per_row += (len(plan.dimensions) + 2) * 5

    max_batch_rows = 0
    for shard_id in (plan.shards or [0]):
        try:
            shard = memstore.get_table_shard(schema.table.name, shard_id)
        except KeyError:
            continue
        live = shard.live_store
        with live.lock:
            for bid in live.get_batch_ids():
                if live.batches.get(bid) is None:
                    continue
                # the executor stages vp.values[:visible] padded to the
                # next power of two, not the allocated batch_size
                vis = live.visible_rows_in_batch(bid)
                if vis > 0:
                    max_batch_rows = max(max_batch_rows, round_up_pow2(vis))
        if schema.table.is_fact_table:
            version = shard.archive_store.get_current_version()
            for b in list(version.batches.values()):
                max_batch_rows = max(max_batch_rows, round_up_pow2(b.size))

    total = max_batch_rows * bytes_per_row * PIPELINE_FACTOR

    # foreign (joined) tables are staged whole
    for ft in plan.foreign_tables:
        fschema = ft.schema
        frows = 0
        try:
            fshard = memstore.get_table_shard(fschema.table.name, 0)
            flive = fshard.live_store
            with flive.lock:
                frows = sum(flive.visible_rows_in_batch(bid)
                            for bid in flive.get_batch_ids())
        except KeyError:
            pass
        fbytes = sum(_dtype_bytes(c.data_type)
                     for c in fschema.table.columns if not c.deleted)
        total += frows * fbytes
    return int(total)


class DeviceMemoryManager:
    """Byte-budget admission gate for one device.

    reserve() blocks (FIFO via Condition broadcast) until the estimate fits
    or `timeout` elapses; over-budget estimates fail fast. Mirrors
    device_manager.go FindDevice/ReleaseMemory. The budget is
    `total_bytes × utilization` where given, else `device`'s
    (`device_memory_budget`).
    """

    def __init__(self, total_bytes: Optional[int] = None,
                 utilization: float = 0.95,
                 default_timeout: float = 30.0, device=None):
        self.budget = (int(total_bytes * utilization)
                       if total_bytes is not None
                       else device_memory_budget(utilization, device))
        self.default_timeout = default_timeout
        self.in_use = 0
        self.running = 0
        self.waiting = 0
        self._cond = threading.Condition()

    def reserve(self, nbytes: int, timeout: Optional[float] = None) -> None:
        if nbytes > self.budget:
            raise AdmissionError(
                f"query requires ~{nbytes >> 20} MiB device memory; "
                f"budget is {self.budget >> 20} MiB")
        if timeout is None or timeout <= 0:
            timeout = self.default_timeout
        start = time.perf_counter()
        deadline = start + timeout
        with self._cond:
            while self.in_use + nbytes > self.budget:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    M.root().count(M.QUERY_FAILED, 1)
                    raise AdmissionError(
                        f"timed out after {timeout:.0f}s waiting for "
                        f"{nbytes >> 20} MiB of device memory "
                        f"({self.in_use >> 20} MiB in use by "
                        f"{self.running} queries)")
                self.waiting += 1
                try:
                    self._cond.wait(remaining)
                finally:
                    self.waiting -= 1
            self.in_use += nbytes
            self.running += 1
        M.root().record_timer(M.QUERY_WAIT_FOR_MEMORY,
                              time.perf_counter() - start)

    def release(self, nbytes: int) -> None:
        with self._cond:
            self.in_use = max(0, self.in_use - nbytes)
            self.running = max(0, self.running - 1)
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {"budgetBytes": self.budget, "inUseBytes": self.in_use,
                    "running": self.running, "waiting": self.waiting}


class DeviceLease:
    """One admitted query's pinned device. Context manager: entering makes
    a CUDA device the thread's current device (`torch.cuda.device`), so
    the kernels it launches and the tensors it makes without a device
    land there; exiting releases the reservation."""

    def __init__(self, pool: "DevicePool", index: int, nbytes: int):
        self.pool = pool
        self.index = index
        self.nbytes = nbytes
        self.device = pool.devices[index]
        self._ctx = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._ctx = torch.cuda.device(self.device)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self._ctx is not None:
                self._ctx.__exit__(*exc)
        finally:
            self.pool.release(self.index, self.nbytes)


class DevicePool:
    """Query-level multi-device placement: each admitted query pins to ONE
    device; different queries run concurrently on different devices.

    Reference: query/device_manager.go DeviceManager.FindDevice — pick the
    device with the most free estimated memory that fits the query, wait on
    a condition variable otherwise (aql_processor.go:1311 runs the whole
    query on the chosen device). Mesh batches (parallel/sharded.py) are the
    opposite trade (one query over ALL devices) and stay opt-in via
    ARES_MESH; this pool is the daemon's default on multi-GPU hosts.
    devices: torch devices, repeats allowed; None is every CUDA device.
    """

    def __init__(self, devices=None, total_bytes: Optional[int] = None,
                 utilization: float = 0.95, default_timeout: float = 30.0):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in devices]
        if total_bytes is not None:
            fallback = int(total_bytes * utilization)
            self.budgets = [fallback] * len(self.devices)
        else:
            # per-device budgets from each device's own memory
            fallback = device_memory_budget(
                utilization, self.devices[0] if self.devices else "cpu")
            self.budgets = [
                _per_device_budget(d, utilization, fallback)
                for d in self.devices]
        self.budget = max(self.budgets) if self.budgets else fallback
        self.in_use = [0] * len(self.devices)
        self.running = [0] * len(self.devices)
        self.served = [0] * len(self.devices)
        self.waiting = 0
        self.default_timeout = default_timeout
        self._cond = threading.Condition()

    def acquire(self, nbytes: int,
                timeout: Optional[float] = None,
                preferred: Optional[int] = None) -> DeviceLease:
        """preferred: requested device index (?device= query param) — used
        when it fits, otherwise falls back to most-free-first, matching
        device_manager.go:193 findDevice's preferredDevice handling."""
        if nbytes > self.budget:
            raise AdmissionError(
                f"query requires ~{nbytes >> 20} MiB device memory; "
                f"per-device budget is {self.budget >> 20} MiB")
        if timeout is None or timeout <= 0:
            timeout = self.default_timeout
        start = time.perf_counter()
        deadline = start + timeout
        with self._cond:
            while True:
                # most-free-first placement (device_manager.go findDevice),
                # free = that device's OWN budget minus its reservations
                best = max(range(len(self.devices)),
                           key=lambda i: (self.budgets[i] - self.in_use[i],
                                          -self.running[i]))
                if (preferred is not None
                        and 0 <= preferred < len(self.devices)
                        and self.in_use[preferred] + nbytes
                        <= self.budgets[preferred]):
                    best = preferred
                if self.in_use[best] + nbytes <= self.budgets[best]:
                    self.in_use[best] += nbytes
                    self.running[best] += 1
                    self.served[best] += 1
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    M.root().count(M.QUERY_FAILED, 1)
                    raise AdmissionError(
                        f"timed out after {timeout:.0f}s waiting for "
                        f"{nbytes >> 20} MiB on any of "
                        f"{len(self.devices)} devices")
                self.waiting += 1
                try:
                    self._cond.wait(remaining)
                finally:
                    self.waiting -= 1
        M.root().record_timer(M.QUERY_WAIT_FOR_MEMORY,
                              time.perf_counter() - start)
        return DeviceLease(self, best, nbytes)

    def release(self, index: int, nbytes: int) -> None:
        with self._cond:
            self.in_use[index] = max(0, self.in_use[index] - nbytes)
            self.running[index] = max(0, self.running[index] - 1)
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {
                "perDeviceBudgetBytes": self.budget,
                "waiting": self.waiting,
                "devices": [
                    {"id": i if d.index is None else d.index,
                     "platform": "gpu" if d.type == "cuda" else d.type,
                     "budgetBytes": self.budgets[i],
                     "inUseBytes": self.in_use[i],
                     "running": self.running[i],
                     "served": self.served[i]}
                    for i, d in enumerate(self.devices)
                ],
            }
