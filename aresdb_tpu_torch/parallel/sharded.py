"""Intra-query multi-device execution over a list of torch devices.

The reference's multi-GPU story is query-level only (DeviceManager assigns a
whole query to one GPU, query/device_manager.go:56; the port's
admission.DevicePool); its horizontal scaling is broker scatter-gather over
datanodes (broker/query_plan_agg.go). Port of `aresdb_tpu/parallel/
sharded.py`, which shards one query's batch rows over a JAX mesh: here the
mesh is a list of torch devices in one process, with no
torch.distributed. Device d runs the single-device batch body
(kernels.agg_batch_body or hll_batch_body, with K2 in its runtime-dense
branch) on rows [d*R, (d+1)*R) of the main table's columns; joined
tables, geo shapes and the other whole-table entries go to every device
whole. The K-row partial tables then move to the first device (`.to()`,
the counterpart of the JAX package's ICI all_gather) and merge there by
key, so only O(devices × K) rows cross between devices. The devices run
in turn: each body fetches its key statistics to the host once
(kernels._runtime_dense_slots).

Unlike the JAX package's merge, a shard whose own groups outgrew K makes
the batch's group count exceed K, so that the executor reruns the batch:
the merged count alone can stay at K when the other shards' keys lie
among that shard's first K, and the group past them would be lost.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query.compiler import CompiledQuery


def make_mesh(n_devices: int = 0, devices=None) -> List[torch.device]:
    """The mesh's devices: `devices` (repeats allowed), by default every
    CUDA device; the first `n_devices` of them where given."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices:
        devs = devs[:n_devices]
    return devs


def _on(device: torch.device):
    """The device as the thread's current CUDA device, where it is one."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to(entry, device: torch.device):
    """A column entry (a tuple of tensors, or staged geo shapes) on
    `device`; a no-op where it is there already."""
    if isinstance(entry, tuple):
        return tuple(t.to(device) for t in entry)
    return entry.to(device)


def shard_inputs(columns, foreign, d: int, rows_per_device: int,
                 device: torch.device):
    """Device d's columns and joined-table probes: rows [d*R, (d+1)*R) of
    every main-table entry (key[0] == 0: scalar pairs and array
    stagings, all row-aligned on dimension 0); joined columns, geo
    shapes (key[0] < 0) and the probes whole."""
    lo, hi = d * rows_per_device, (d + 1) * rows_per_device
    cols = {}
    for key, entry in columns.items():
        if key[0] == 0:
            cols[key] = tuple(t[lo:hi].to(device) for t in entry)
        else:
            cols[key] = _to(entry, device)
    return cols, tuple(_to(probe, device) for probe in foreign)


def _gather(parts, device: torch.device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts])


def _shard_tables(body, plan: CompiledQuery, rows_per_device: int,
                  k_groups: int, devices: List[torch.device], columns,
                  foreign, n_valid, live_cutoff):
    """Each device's group table from `body` (kernels.agg_batch_body or
    hll_batch_body) over its rows, gathered on devices[0]: (keys, agg or
    registers, cnt, the largest shard group count, dim values, dim
    valids), the shards' tables one after another."""
    parts = []
    for d, dev in enumerate(devices):
        cols, fidx = shard_inputs(columns, foreign, d, rows_per_device, dev)
        with _on(dev):
            parts.append(body(plan, rows_per_device, k_groups, cols,
                              int(n_valid[d]), live_cutoff, dev, fidx))
    target = devices[0]
    n_dims = len(plan.dimensions)
    return (_gather([p[0] for p in parts], target),
            _gather([p[2] for p in parts], target),
            _gather([p[3] for p in parts], target),
            _gather([p[4].reshape(1) for p in parts], target).max(),
            [_gather([p[5][i] for p in parts], target)
             for i in range(n_dims)],
            [_gather([p[6][i] for p in parts], target)
             for i in range(n_dims)])


def _overflowed(merged: torch.Tensor, shard_groups: torch.Tensor,
                k_groups: int) -> torch.Tensor:
    """The batch's group count: the merged one, unless a shard alone
    outgrew k_groups while the merge did not, then that shard's."""
    hidden = (merged <= k_groups) & (shard_groups > k_groups)
    return torch.where(hidden, shard_groups.to(merged.dtype), merged)


def make_sharded_agg_kernel(plan: CompiledQuery, rows_per_device: int,
                            k_groups: int, devices: List[torch.device]):
    """Multi-device aggregation of one padded batch of
    len(devices) × rows_per_device rows: fn(columns, foreign, n_valid,
    live_cutoff) with n_valid the rows valid in each shard
    (per_shard_valid). Returns the single-device kernel's group table
    (gkeys, slot_used, agg, cnt, n_groups, dim_values, dim_valids) on
    devices[0]; n_groups exceeds k_groups where any shard's did."""
    target = devices[0]

    def fn(columns, foreign, n_valid, live_cutoff):
        all_keys, all_agg, all_cnt, shard_groups, dims, dvalids = \
            _shard_tables(K.agg_batch_body, plan, rows_per_device,
                          k_groups, devices, columns, foreign, n_valid,
                          live_cutoff)
        with _on(target):
            # the merge of the n_dev × K partial tables, as the JAX
            # package's per_shard does after its all_gather
            mvalid = torch.ones(all_keys.shape[0], dtype=torch.bool,
                                device=target)
            fkeys, f_used, f_agg, _, f_groups, f_dims, f_dvalids = \
                K.reduce_by_key(all_keys, all_agg, mvalid, plan.measure.agg,
                                plan.measure.out_float, k_groups,
                                [K._Val(v, b) for v, b in zip(dims, dvalids)])
            # counts must be summed with the same segmentation
            f_cnt = K.reduce_by_key(all_keys, all_cnt, mvalid, "sum", False,
                                    k_groups, None)[2]
            n_groups = _overflowed(f_groups, shard_groups, k_groups)
        return (fkeys, f_used, f_agg, f_cnt, n_groups, tuple(f_dims),
                tuple(f_dvalids))

    return fn


def make_sharded_hll_kernel(plan: CompiledQuery, rows_per_device: int,
                            k_groups: int, devices: List[torch.device]):
    """Multi-device HLL: each device builds its partial [K, 16384] register
    planes with the single-device body (kernels.hll_batch_body), the
    planes move to devices[0], and a register-max merge by group key
    there gives the final table: (gkeys, slot_used, registers, cnt,
    n_groups, dim_values, dim_valids), as hll_batch_body returns it.
    Reference peers: query/hll.cu (per-batch planes) + broker HLL merge."""
    target = devices[0]

    def fn(columns, foreign, n_valid, live_cutoff):
        all_keys, all_regs, all_cnt, shard_groups, dims, dvalids = \
            _shard_tables(K.hll_batch_body, plan, rows_per_device,
                          k_groups, devices, columns, foreign, n_valid,
                          live_cutoff)
        with _on(target):
            f_keys, used, m_regs, m_cnt, n_uniq, f_dims, f_dvalids = \
                _merge_hll(all_keys, all_regs, all_cnt, dims, dvalids,
                           k_groups)
            n_groups = _overflowed(n_uniq, shard_groups, k_groups)
        return (f_keys, used, m_regs, m_cnt, n_groups, f_dims, f_dvalids)

    return fn


def _merge_hll(all_keys, all_regs, all_cnt, all_dims, all_dvalid,
               k_groups: int):
    """Register-max merge of gathered HLL tables into the first k_groups
    keys in ascending order (unused slots hold the sentinel key)."""
    n, m = all_regs.shape
    device = all_keys.device
    iota = torch.arange(n, device=device)
    skeys, order = torch.sort(all_keys ^ K._SIGN, stable=True)
    skeys = skeys ^ K._SIGN
    regs_s = all_regs[order]
    cnt_s = all_cnt[order]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    live = skeys != K.SENTINEL
    seg = torch.cumsum(first, 0) - 1
    seg_c = torch.where(live & (seg < k_groups), seg, k_groups)
    num = k_groups + 1
    n_uniq = (first & live).sum().to(torch.int32)
    m_regs = torch.zeros((num, m), dtype=torch.int32, device=device) \
        .scatter_reduce_(0, seg_c[:, None].expand(n, m),
                         regs_s.to(torch.int32), "amax")[:k_groups]
    m_regs = m_regs.to(torch.uint8)
    m_cnt = torch.zeros(num, dtype=cnt_s.dtype, device=device) \
        .index_add_(0, seg_c, cnt_s)[:k_groups]
    rep = torch.full((num,), n, dtype=torch.int64, device=device) \
        .scatter_reduce_(0, seg_c, iota, "amin")[:k_groups]
    rep = rep.clamp(0, n - 1)
    f_keys = skeys[rep]
    used = torch.arange(k_groups, device=device) < n_uniq
    f_keys = torch.where(used, f_keys, K.SENTINEL)
    src = order[rep]
    f_dims = tuple(dv[src] for dv in all_dims)
    f_dvalids = tuple(dv[src] & used for dv in all_dvalid)
    return f_keys, used, m_regs, m_cnt, n_uniq, f_dims, f_dvalids


def shard_rows(values: np.ndarray, validity: np.ndarray, n_dev: int,
               rows_per_device: int):
    """Pad + reshape host rows so row i of shard d is global row d*R+i."""
    total = n_dev * rows_per_device
    n = len(validity)
    if n < total:
        pad = (total - n,) + values.shape[1:]
        values = np.concatenate([values, np.zeros(pad, values.dtype)])
        validity = np.concatenate([validity, np.zeros(total - n, bool)])
    return values[:total], validity[:total]


def per_shard_valid(n: int, n_dev: int, rows_per_device: int) -> np.ndarray:
    """int32[n_dev] valid-row counts after contiguous row sharding."""
    out = np.zeros(n_dev, np.int32)
    remaining = n
    for d in range(n_dev):
        out[d] = max(0, min(rows_per_device, remaining))
        remaining -= out[d]
    return out
