"""Query executor: batch loop over a shard's live and archive batches,
device staging, dense, keyed, run-length, HLL or select kernels, few
fetches, exact host merge.

Port of the dense, keyed (sort), run-length, HLL and non-aggregate paths
of `aresdb_tpu/query/executor.py`, with joins to dimension tables:
- A fact table's archive day batches follow its live batches
  (`_iter_batches`): day-ranged by a time filter on column 0, narrowed by
  a binary search of the sorted columns (`_prefilter_slice`) and staged
  in chunks of at most ARCHIVE_CHUNK_ROWS rows (`_stage_archive_batch`),
  expanded from their run-length (mode-3) form, or, under ARES_RUNLEN=1,
  as per-run lanes (`_stage_runlen`) for the run-length kernel
  (`kernels.make_runlen_agg_kernel`), whose group tables join the sort
  path's merge.
- A batch whose dimensions all have a bounded domain runs one dense
  kernel (K1, or the unfused kernel over K2, K3 or a scatter) whose
  per-slot table folds into a device-resident float64 accumulator. A K1
  batch is recorded, not launched (`_record_k1`): after the last batch
  the query's K1 batches of one structure, literal block and dense plan
  go out in ONE launcher call and fold at once (`_launch_k1`; a kernel
  that gathers joined lanes takes `fused_dense.launch_calls`' few
  batches a call). A query plans a batch's dense domains once for each
  batch shape and stats, and looks its kernel up once for each dense
  plan (`_dense_route`). After that ONE device-to-host copy brings back
  every batch's overflow count and every accumulator
  (`_resolve_pending`); a batch that overflowed its planned domain
  reruns on the sort path.
- Any other batch runs the keyed kernel (`kernels.make_agg_kernel`) at a
  group capacity K from the per-plan hint. `_resolve_sort_pending`
  fetches the group counts, reruns batches whose groups outgrew K on the
  capacity ladder, merges the partial tables on the device by key, and
  fetches one merged table.
- An HLL query runs every batch through the HLL kernel
  (`kernels.make_hll_kernel`) on its own capacity ladder;
  `_resolve_hll_pending` merges the register tables on the device and
  fetches per-group estimator sums (or the registers, for the binary
  wire format).
- A non-aggregate query runs the select kernel batch by batch until its
  limit is collected (`_execute_non_agg`).
- Each joined dimension table is staged once per query
  (`_stage_foreign_tables`, cached on its batches' versions) and probed
  per batch by the kernels (`kernels._EvalCtx.foreign_row`).
- A geo join's shapes are read from the geo table's live store and
  staged once per query (`_stage_geo`); every batch matches its points
  against them (`kernels._geo_matched`, `geo.matched`).
- Array columns stage as padded ragged lanes (`_pad_array_column`) from
  live and archive batches; a joined table's array column stages as
  all-null, so an array op on it answers "not staged", as in the JAX
  package.
- Under ARES_MESH=1 an aggregate or HLL batch instead spreads over the
  executor's mesh devices (`_run_mesh_batch`, `_run_mesh_hll_batch`,
  parallel/sharded.py): each device runs the keyed body on its rows, and
  the partial tables merge on the first device. The merged table joins
  the sort (or HLL) path's pending merge like any batch's; a batch whose
  groups outgrew its capacity reruns on the single-device ladder (an HLL
  batch on the mesh again, at the larger capacity). A mesh batch that
  raises runs on the single-device path, and is counted.
GroupTable merges the piles exactly on the host.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.parallel import sharded as S
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query import fused_dense as FD
from aresdb_tpu_torch.query import geo as G
from aresdb_tpu_torch.query import hll as H
from aresdb_tpu_torch.query import kernels as K
from aresdb_tpu_torch.query import runlen as RL
from aresdb_tpu_torch.query.admission import device_cache_budget
from aresdb_tpu_torch.query.compiler import CompiledQuery, QueryError
from aresdb_tpu_torch.query.dense import (CALENDAR_STARTS,
                                         _underlying_column_key, plan_dense)
from aresdb_tpu_torch.query.kernels import (
    SENTINEL, SENTINEL64, KernelCache, _packing_type, dense_acc_init,
    dense_signature, np_pack_dim_keys, pack_modes, plan_signature,
    round_up_pow2)
from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils import tracing
from aresdb_tpu_torch.utils.torch_env import fetch_to_host

DEFAULT_GROUP_CAPACITY = 4096
MAX_GROUP_CAPACITY = 1 << 22
DEFAULT_HLL_CAPACITY = 256   # HLL group capacity before the ladder climbs
MAX_HLL_CAPACITY = 4096      # 16 KB of registers a group
SMALL_K_FULL_FETCH = 4096  # sort tables at/below this capacity fetch whole
                           # with their group counts (one copy)


def _check_deadline(plan) -> None:
    """Per-batch query-timeout check: `plan.deadline` (unix seconds,
    stamped by QueryService._admit) has passed."""
    dl = getattr(plan, "deadline", None)
    if dl and time.time() > dl:
        raise QueryError("query timed out")


class DeviceColumnCache:
    """LRU cache of staged device column tensors.

    Live batch columns carry mutation versions, so staged tensors stay
    resident on the device across queries and only changed data pays the
    host→device copy again. The device is part of every key, and each
    device holds at most its own budget: `max_bytes` where given, else
    `admission.device_cache_budget` (a share of a CUDA device's memory,
    4 GiB on `cpu`); past it, that device's least recently used entries
    go.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        self._entries = OrderedDict()
        self._bytes = 0
        self._device_bytes: Dict[str, int] = {}
        self._budgets: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _entry_bytes(entry) -> int:
        return sum(t.numel() * t.element_size() for t in entry)

    def budget(self, device) -> int:
        """The bytes `device` may hold (read once a device)."""
        name = str(device)
        with self._lock:
            got = self._budgets.get(name)
        if got is None:
            got = (self.max_bytes if self.max_bytes is not None
                   else device_cache_budget(device))
            with self._lock:
                self._budgets[name] = got
        return got

    def get_or_stage(self, device: torch.device, key, stage_fn):
        dev = str(device)
        limit = self.budget(device)
        key = (dev,) + key
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit
        if tracing.active:
            tracing.add("cacheMisses")
        entry = stage_fn()
        nbytes = self._entry_bytes(entry)
        with self._lock:
            self.misses += 1
            if key not in self._entries:
                self._entries[key] = entry
                self._bytes += nbytes
                held = self._device_bytes.get(dev, 0) + nbytes
                if held > limit:
                    # this device's oldest entries first, never the new one
                    for old_key in [k for k in self._entries
                                    if k[0] == dev and k != key]:
                        if held <= limit:
                            break
                        old = self._entry_bytes(self._entries.pop(old_key))
                        held -= old
                        self._bytes -= old
                self._device_bytes[dev] = held
        return entry

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}


def _nbytes(columns) -> int:
    """The bytes of a batch's staged (values, validity) column pairs."""
    return sum(t.numel() * t.element_size()
               for pair in columns.values() for t in pair)


GLOBAL_DEVICE_CACHE = DeviceColumnCache()
GLOBAL_KERNEL_CACHE = KernelCache()


class GroupTable:
    """Exact merge of per-batch partial aggregates, finalized COLUMNAR.

    Dense slot tables accumulate per slot space and decode at finalize();
    keyed tables (the sort path) arrive as piles of live groups. Piles
    merge on the canonical u64 group key (np_pack_dim_keys for dense
    piles), or by dim values where the key pack is inexact
    (_finalize_dict). sum/count/avg add, min/min, max/max, HLL register
    rows max. Copied from the JAX package.
    """

    def __init__(self, plan: CompiledQuery):
        self.plan = plan
        # dense_sig -> [dense_plan, agg_array, cnt_array, rows_array]
        self._dense_acc: Dict[tuple, list] = {}
        # keyed piles: (gkeys, agg, cnt, dim_values, dim_valids), each
        # sliced to its live groups
        self._keyed_acc: list = []
        self.n_groups = 0
        self.dim_values: List[np.ndarray] = []
        self.dim_valids: List[np.ndarray] = []
        self.aggs: np.ndarray = np.zeros(0, np.float64)
        self.cnts: np.ndarray = np.zeros(0, np.int64)

    def merge_dense(self, dense_sig: tuple, dense_plan, aggv, cnt, rows):
        """Accumulate whole dense slot tables elementwise; decoded into
        columns at finalize()."""
        agg_kind = self.plan.measure.agg
        acc = self._dense_acc.get(dense_sig)
        if acc is None:
            self._dense_acc[dense_sig] = [dense_plan, np.array(aggv),
                                          np.array(cnt), np.array(rows)]
            return
        if agg_kind in ("sum", "count", "avg"):
            acc[1] += aggv
        elif agg_kind == "min":
            acc[1] = np.minimum(acc[1], aggv)
        else:
            acc[1] = np.maximum(acc[1], aggv)
        acc[2] += cnt
        acc[3] += rows

    def merge_keyed(self, gkeys, slot_used, agg, cnt, dim_values,
                    dim_valids):
        """Accumulate one keyed group table (u64 keys on the host)."""
        sel = np.asarray(slot_used).astype(bool)
        if not sel.any():
            return
        self._keyed_acc.append((
            np.asarray(gkeys)[sel], np.asarray(agg)[sel],
            np.asarray(cnt)[sel],
            [np.asarray(v)[sel] for v in dim_values],
            [np.asarray(b)[sel] for b in dim_valids]))

    def _dense_piles(self) -> list:
        piles = []
        for dense_plan, aggv, cnt, rows in self._dense_acc.values():
            used = np.asarray(rows) > 0
            slots = np.nonzero(used)[0]
            decoded = dense_plan.decode_slots(slots)
            piles.append((None,
                          np.asarray(aggv)[slots], np.asarray(cnt)[slots],
                          [np.asarray(v) for v, _ in decoded],
                          [np.asarray(b, bool) for _, b in decoded]))
        self._dense_acc.clear()
        return piles

    def finalize(self) -> None:
        """Merge all piles into the final columnar group table."""
        piles = self._keyed_acc + self._dense_piles()
        self._keyed_acc = []
        if not piles:
            self._set_empty()
            return
        if len(piles) > 1:
            # cross-pile merge needs canonical keys for every pile
            ptypes = [_packing_type(d) for d in self.plan.dimensions]
            exact, _ = pack_modes(ptypes)
            keyed = []
            for keys, agg, cnt, dvals, dvalids in piles:
                if keys is None:
                    if not exact:
                        # an inexact pack (UUID, > 63 bits of dims) mixed
                        # with a dense pile: merge by dim values
                        self._finalize_dict(piles)
                        return
                    keys = np_pack_dim_keys(dvals, dvalids, ptypes)
                keyed.append((keys, agg, cnt, dvals, dvalids))
            piles = [self._merge_piles(keyed)]
        keys, aggs, cnts, dvals, dvalids = piles[0]
        kind = self.plan.measure.agg
        if kind != "hll" and aggs.dtype.kind == "f":
            aggs = aggs.astype(np.float64)
        self.n_groups = len(cnts)
        self.dim_values = dvals
        self.dim_valids = [np.asarray(b, bool) for b in dvalids]
        self.aggs = aggs
        self.cnts = np.asarray(cnts).astype(np.int64)

    def _set_empty(self) -> None:
        n_dims = len(self.plan.dimensions)
        self.n_groups = 0
        self.dim_values = [np.zeros(0) for _ in range(n_dims)]
        self.dim_valids = [np.zeros(0, bool) for _ in range(n_dims)]
        self.aggs = np.zeros(0, np.float64)
        self.cnts = np.zeros(0, np.int64)

    def _merge_piles(self, piles):
        """Vectorized exact merge of keyed piles on the canonical u64 key."""
        gkeys = np.concatenate([p[0] for p in piles])
        aggs = np.concatenate([p[1] for p in piles])
        cnts = np.concatenate([p[2] for p in piles])
        uniq, inv = np.unique(gkeys, return_inverse=True)
        g = len(uniq)
        kind = self.plan.measure.agg
        if kind in ("sum", "count", "avg"):
            m_agg = np.zeros(g, np.float64 if aggs.dtype.kind == "f"
                             else aggs.dtype)
            np.add.at(m_agg, inv, aggs)
        elif kind == "min":
            m_agg = np.full(g, np.inf if aggs.dtype.kind == "f"
                            else np.iinfo(aggs.dtype).max, aggs.dtype)
            np.minimum.at(m_agg, inv, aggs)
        elif kind == "max":
            m_agg = np.full(g, -np.inf if aggs.dtype.kind == "f"
                            else np.iinfo(aggs.dtype).min, aggs.dtype)
            np.maximum.at(m_agg, inv, aggs)
        else:  # hll register rows
            m_agg = np.zeros((g,) + aggs.shape[1:], aggs.dtype)
            np.maximum.at(m_agg, inv, aggs)
        m_cnt = np.zeros(g, np.int64)
        np.add.at(m_cnt, inv, cnts)
        # dims from the first occurrence of each key (same key → same dims)
        first = np.full(g, len(gkeys), np.int64)
        np.minimum.at(first, inv, np.arange(len(gkeys)))
        n_dims = len(piles[0][3])
        dim_values = []
        dim_valids = []
        for d in range(n_dims):
            vals = np.concatenate([p[3][d] for p in piles])
            valids = np.concatenate([p[4][d] for p in piles])
            dim_values.append(vals[first])
            dim_valids.append(valids[first])
        return uniq, m_agg, m_cnt, dim_values, dim_valids

    def _finalize_dict(self, piles) -> None:
        """Exact merge keyed by dim values, for piles that cannot all give
        canonical u64 keys (inexact packs mixed with dense piles). Costs
        Python per group; this shape is rare."""
        agg_kind = self.plan.measure.agg
        groups: Dict[tuple, list] = {}
        for _, agg, cnt, dim_values, dim_valids in piles:
            dvals = [[tuple(x) for x in dv.tolist()] if dv.ndim > 1
                     else dv.tolist() for dv in dim_values]
            dvalids = [np.asarray(bv).astype(bool).tolist()
                       for bv in dim_valids]
            aggs = agg if agg_kind == "hll" else agg.tolist()
            cnts = np.asarray(cnt).tolist()
            rng = range(len(dvals))
            for j in range(len(cnts)):
                dvalid = tuple(dvalids[i][j] for i in rng)
                dims = tuple(dvals[i][j] for i in rng)
                k = tuple((valid, value if valid else None)
                          for valid, value in zip(dvalid, dims))
                entry = groups.get(k)
                if entry is None:
                    groups[k] = [dims, dvalid, aggs[j], int(cnts[j])]
                    continue
                if agg_kind in ("sum", "count", "avg"):
                    entry[2] += aggs[j]
                elif agg_kind == "min":
                    entry[2] = min(entry[2], aggs[j])
                elif agg_kind == "hll":
                    entry[2] = np.maximum(entry[2], aggs[j])
                else:
                    entry[2] = max(entry[2], aggs[j])
                entry[3] += int(cnts[j])
        entries = list(groups.values())
        self.n_groups = len(entries)
        self.dim_values = [np.asarray([e[0][d] for e in entries])
                           for d in range(len(self.plan.dimensions))]
        self.dim_valids = [np.asarray([e[1][d] for e in entries], bool)
                           for d in range(len(self.plan.dimensions))]
        if agg_kind == "hll" and entries and np.asarray(
                entries[0][2]).ndim > 0:
            self.aggs = np.stack([np.asarray(e[2]) for e in entries])
        else:
            self.aggs = np.asarray([e[2] for e in entries], np.float64)
        self.cnts = np.asarray([e[3] for e in entries], np.int64)

    @property
    def groups(self) -> Dict[tuple, list]:
        """Dict view of the FINALIZED columns, keyed by
        ((valid, value or None), ...) per dim (per-group Python cost;
        prefer the columnar fields)."""
        out: Dict[tuple, list] = {}
        dvals = [[tuple(x) for x in dv.tolist()] if dv.ndim > 1
                 else dv.tolist() for dv in self.dim_values]
        dvalids = [b.tolist() for b in self.dim_valids]
        kind = self.plan.measure.agg if self.plan.measure else "sum"
        aggs = self.aggs if kind == "hll" and self.aggs.ndim > 1 \
            else self.aggs.tolist()
        cnts = self.cnts.tolist()
        rng = range(len(self.dim_values))
        for j in range(self.n_groups):
            dvalid = tuple(dvalids[i][j] for i in rng)
            dims = tuple(dvals[i][j] for i in rng)
            k = tuple((valid, value if valid else None)
                      for valid, value in zip(dvalid, dims))
            out[k] = [dims, dvalid, aggs[j], int(cnts[j])]
        return out


class ShardExecutor:
    """Executes one compiled query against table shards."""

    FOREIGN_LUT_CAP = 1 << 22  # max dense key domain for the LUT join probe
    NON_AGG_SORT_SCAN_CAP = 100_000

    def __init__(self, memstore, device: torch.device,
                 kernel_cache: KernelCache = GLOBAL_KERNEL_CACHE,
                 device_cache: DeviceColumnCache = GLOBAL_DEVICE_CACHE,
                 mesh_devices=None, k_hints: Optional[Dict[str, int]] = None):
        """mesh_devices: the devices of a mesh batch (ARES_MESH=1),
        repeats allowed; by default every device of `device`'s type.
        k_hints: a capacity-hint dict shared with other executors (a
        device pool's), else one of its own."""
        self.memstore = memstore
        self.device = device
        self.kernel_cache = kernel_cache
        self.device_cache = device_cache
        if mesh_devices is None:
            mesh_devices = [device] if device.type != "cuda" else None
        self.mesh_devices = S.make_mesh(devices=mesh_devices)
        # plan signature → observed group capacity: warm repeats of a
        # high-cardinality query start the ladder at the right K
        self._k_hints: Dict[str, int] = {} if k_hints is None else k_hints
        # (vp.uid, vp.version, n) → (min, max) over valid values; columns
        # are immutable at a given mutation version so stats memoize
        self._stat_memo: Dict[tuple, tuple] = {}
        # staged dimension tables keyed on their live batches' (uid,
        # version) and the device
        self._foreign_cache: Dict[tuple, tuple] = {}
        # composite run boundaries of run-length batches, keyed on the
        # run columns' uids and the row slice (immutable for both)
        self._runlen_memo: Dict[tuple, np.ndarray] = {}

    # -- public --

    def execute(self, plan: CompiledQuery):
        """Returns (GroupTable, None) for an aggregate query, (None, rows)
        for a non-aggregate one. Per-stage seconds accumulate into
        plan.stats (reference: query/stats.go stage timers), beside the
        batches rerun on the sort path (`overflowReruns`), on a larger
        group capacity (`ladderReruns`, HLL reruns included), the batches
        that took the sort route (`sortBatches`, overflow reruns included)
        with the host seconds of their work (`sortExec`) and of resolving
        them (`sortMerge`), and the process's device-to-host copies during
        the query
        (`hostFetches`), and the archive rows a prefilter skipped
        (`prefilterRowsSkipped`) and the run-length batches, runs and
        rows (`runlenBatches`, `runlenRuns`, `runlenRowsCompressed`) where
        there are any."""
        plan.stats = {"batches": 0, "rows_scanned": 0, "stagedBytes": 0,
                      "peakBatchStagedBytes": 0, "overflowReruns": 0,
                      "ladderReruns": 0, "sortBatches": 0, "sortExec": 0.0,
                      "sortMerge": 0.0}
        fetches0 = fetch_to_host.calls
        with tracing.stage(plan.stats, "foreignTransfer"):
            foreign = self._stage_foreign_tables(plan)
            plan._exec_geo = self._stage_geo(plan)
        plan.stats["stagedBytes"] = sum(
            t.numel() * t.element_size() for probe, fcols in foreign
            for t in list(probe) + [t for pair in fcols.values()
                                    for t in pair])
        if plan._exec_geo is not None:
            plan.stats["stagedBytes"] += plan._exec_geo.nbytes()
        shards = plan.shards or [0]
        if plan.is_non_agg:
            rows = self._execute_non_agg(plan, foreign, shards)
            plan.stats["hostFetches"] = fetch_to_host.calls - fetches0
            return None, rows

        table = GroupTable(plan)
        try:
            self._aggregate(plan, foreign, shards, table)
        finally:
            # the query's batches go with it: a cached kernel keeps its
            # plan (FusedDenseKernel.plan), so nothing staged may stay on
            # it, an error's included
            plan._exec_pending, plan._exec_dense_dev = [], {}
            plan._exec_dense_routes, plan._exec_k1 = {}, {}
            plan._exec_sort_pending, plan._exec_hll_pending = [], []
        plan.stats["hostFetches"] = fetch_to_host.calls - fetches0
        M.root().count(M.QUERY_ROWS_RETURNED, table.n_groups)
        M.root().record_timer(M.QUERY_BATCH_TRANSFER_TIME,
                              plan.stats.get("transfer", 0.0))
        return table, None

    def _aggregate(self, plan: CompiledQuery, foreign, shards,
                   table: GroupTable) -> None:
        """The batch loop of an aggregate query, then its K1 groups'
        launcher calls, then the one fetch that resolves every batch into
        `table`."""
        stat_keys = self._dense_stat_keys(plan)
        plan._exec_pending = []
        plan._exec_dense_dev = {}
        plan._exec_dense_routes = {}
        plan._exec_k1 = {}
        plan._exec_sort_pending = []
        plan._exec_hll_pending = []
        # one span a batch for each while tracing; the last `transfer`
        # of a shard ends its batches
        transfer = tracing.stage(plan.stats, "transfer")
        batch_exec = tracing.stage(plan.stats, "batchExec")
        for shard_id in shards:
            shard = self.memstore.get_table_shard(
                plan.main_schema.table.name, shard_id)
            it = self._iter_batches(plan, shard, stat_keys)
            while True:
                with transfer as span:
                    try:
                        (batch_cols, n_valid, n_padded, stats, cutoff,
                         runinfo) = next(it)
                    except StopIteration:
                        break
                    if span is not None:
                        span.attrs.update(rows=n_valid,
                                          stagedBytes=_nbytes(batch_cols))
                with batch_exec as span:
                    route = self._run_agg_batch(plan, foreign, batch_cols,
                                                n_valid, n_padded, stats,
                                                cutoff, runinfo)
                    if span is not None:
                        span.attrs["route"] = route
                plan.stats["batches"] += 1
                plan.stats["rows_scanned"] += n_valid
                nb = _nbytes(batch_cols)
                plan.stats["stagedBytes"] += nb
                plan.stats["peakBatchStagedBytes"] = max(
                    plan.stats["peakBatchStagedBytes"], nb)
        groups, plan._exec_k1 = plan._exec_k1, {}
        plan._exec_dense_routes = {}
        for dense_sig, dense_plan, batches in groups.values():
            for call in FD.launch_calls(batches):
                with batch_exec as span:
                    self._launch_k1(plan, dense_sig, dense_plan, call)
                    if span is not None:
                        span.attrs.update(route="dense_batches",
                                          batches=len(call))
        with tracing.stage(plan.stats, "resultFetch"):
            self._resolve_pending(plan, table)
            if plan._exec_sort_pending:
                with tracing.stage(plan.stats, "sortMerge"):
                    self._resolve_sort_pending(plan, table)
            self._resolve_hll_pending(plan, table)
            table.finalize()

    @staticmethod
    def _dense_stat_keys(plan: CompiledQuery):
        """Main-table columns whose (min, max) stats unlock dense mode:
        raw integer dims, and the column under FLOOR time-bucket,
        calendar-start and numeric-bucket dims."""
        keys = set()
        for d in plan.dimensions:
            e = d.expr
            under = None
            if isinstance(e, E.VarRef) and e.table_id == 0 and \
                    e.data_type in (mdt.Uint16, mdt.Uint32):
                keys.add((0, e.column_id))
            elif isinstance(e, E.BinaryExpr) and e.op == "FLOOR":
                under = e.lhs
            elif isinstance(e, E.UnaryExpr) and e.op in CALENDAR_STARTS:
                under = e.expr
            elif isinstance(e, E.Call) and e.name == "__numeric_bucket":
                under = e.args[0]
            key = None if under is None else _underlying_column_key(under)
            if key is not None:
                keys.add(key)
        return keys

    # -- batch iteration + staging --

    def _iter_batches(self, plan: CompiledQuery, shard, stat_keys=frozenset()):
        """Yield (columns, n_valid, n_padded, stats, live_cutoff, runinfo)
        for the shard's live batches, then, for a fact table, its archive
        chunks (live_cutoff 0; runinfo a runlen.RunLenInfo for a
        run-length chunk, else None)."""
        live = shard.live_store
        used = plan.used_columns
        schema = plan.main_schema
        # snapshot LIVE first, then take the archive version ONCE: under a
        # concurrent archiving swap the snapshot keeps the pre-purge live
        # batches, and whichever version is then observed either excludes
        # the moved rows (old cutoff, no archive copy) or filters their
        # live copies by its cutoff while the archive copy is scanned once.
        # The cutoff and the batch list come from that ONE version object.
        with live.lock:
            snapshots = live.snapshot_columns(used)
        version = None
        live_cutoff = 0
        if schema.table.is_fact_table:
            version = shard.archive_store.get_current_version()
            live_cutoff = version.archiving_cutoff

        # live batches, skipped by time column min/max like
        # shouldSkipLiveBatch (reference aql_processor.go:1435)
        for _, n, batch in snapshots:
            if plan.time_column_id >= 0 and (plan.from_ts or plan.to_ts):
                vp = batch.column(plan.time_column_id)
                if vp is not None and vp.values is not None and n > 0:
                    mm = self._minmax(vp, vp.values[:n], vp.validity[:n], n)
                    if mm is not None:
                        tmin, tmax = mm
                        if plan.from_ts and tmax < plan.from_ts:
                            continue
                        if plan.to_ts and tmin >= plan.to_ts:
                            continue
            _check_deadline(plan)
            staged = self._stage_live_batch(schema, batch, n, used,
                                            stat_keys)
            M.root().count(M.QUERY_LIVE_BATCH_PROCESSED, 1)
            M.root().count(M.QUERY_LIVE_RECORDS_PROCESSED, staged[1])
            if tracing.active:
                tracing.note(store="live")
            yield staged + (live_cutoff, None)

        # archive batches (fact tables), day-ranged by the time filter only
        # when it is on the event time column (column 0): a time filter on
        # another column is a plain row filter and skips no archive day
        # (reference processTimeFilter, aql_compiler_test.go:1206)
        if version is None:
            return
        if plan.time_column_id == 0:
            day_ids = version.get_batch_ids_for_range(plan.from_ts or 0,
                                                      plan.to_ts or 0)
        else:
            day_ids = version.get_batch_ids_for_range(0, 0)
        for day in day_ids:
            _check_deadline(plan)
            ab = version.request_batch(day)
            for staged in self._stage_archive_batch(schema, ab, used,
                                                    stat_keys, plan):
                M.root().count(M.QUERY_ARCHIVE_BATCH_PROCESSED, 1)
                M.root().count(M.QUERY_ARCHIVE_RECORDS_PROCESSED, staged[1])
                if tracing.active:
                    tracing.note(store="archive")
                yield staged[:4] + (0, staged[4])

    @staticmethod
    def _prefilter_slice(prefilters, vps, n: int, stats: dict):
        """Candidate [lo, hi) row range of a sorted archive batch: each
        prefilter narrows it by a binary search of its sort column.
        Archive batches are ordered by raw value first, validity second
        (archiving._lexsort_order), so a raw-value run is a superset of
        the matching valid rows; deeper sort columns are sorted only
        within each parent run, so narrowing stops where the slice is not
        monotone. A mode-3 column is searched in its entry space (the
        runs' sorted values) and mapped back to rows through its counts,
        without expansion (reference iterator.hpp:214). Adds the rows
        skipped to stats["prefilterRowsSkipped"]."""
        lo, hi = 0, n
        for cid, op, val in prefilters:
            if hi <= lo:
                break
            vp = vps.get(cid)
            if vp is None or vp.is_list or vp.values is None or \
                    vp.values.ndim != 1:
                break
            if vp.is_compressed:
                counts = vp.counts.astype(np.int64)
                e0 = max(int(np.searchsorted(counts, lo, "right")) - 1, 0)
                e1 = int(np.searchsorted(counts, hi, "left"))
                seg = vp.values[e0:e1]
                if len(seg) > 1 and not np.all(seg[1:] >= seg[:-1]):
                    break
                if op == "=":
                    a = e0 + int(np.searchsorted(seg, val, "left"))
                    b = e0 + int(np.searchsorted(seg, val, "right"))
                    lo = max(lo, int(counts[a]))
                    hi = min(hi, int(counts[b]))
                elif op in (">=", ">"):
                    side = "left" if op == ">=" else "right"
                    a = e0 + int(np.searchsorted(seg, val, side))
                    lo = max(lo, int(counts[a]))
                elif op in ("<", "<="):
                    side = "left" if op == "<" else "right"
                    a = e0 + int(np.searchsorted(seg, val, side))
                    hi = min(hi, int(counts[a]))
                continue
            seg = vp.values[lo:hi]
            if len(seg) > 1 and not np.all(seg[1:] >= seg[:-1]):
                break
            if op == "=":
                lo, hi = (lo + int(np.searchsorted(seg, val, "left")),
                          lo + int(np.searchsorted(seg, val, "right")))
            elif op == ">=":
                lo += int(np.searchsorted(seg, val, "left"))
            elif op == ">":
                lo += int(np.searchsorted(seg, val, "right"))
            elif op == "<":
                hi = lo + int(np.searchsorted(seg, val, "left"))
            elif op == "<=":
                hi = lo + int(np.searchsorted(seg, val, "right"))
        if (lo, hi) != (0, n):
            stats["prefilterRowsSkipped"] = \
                stats.get("prefilterRowsSkipped", 0) + (n - max(hi - lo, 0))
        return lo, hi

    def _minmax(self, vp, values, validity, n_key):
        """Memoized (min, max) over valid values (None = all invalid)."""
        key = (getattr(vp, "uid", None), getattr(vp, "version", 0), n_key)
        if key[0] is not None and key in self._stat_memo:
            return self._stat_memo[key]
        if len(validity) and validity.any() and values.ndim == 1:
            sel = values[validity]
            out = (np.min(sel).item(), np.max(sel).item())
        else:
            out = None
        if key[0] is not None:
            if len(self._stat_memo) > 4096:
                self._stat_memo.clear()
            self._stat_memo[key] = out
        return out

    def _column_stat(self, stats, stat_keys, cid, vp, values, validity,
                     n_key):
        if (0, cid) in stat_keys:
            mm = self._minmax(vp, values, validity, n_key)
            if mm is not None:
                stats[(0, cid)] = mm

    def _stage_live_batch(self, schema, batch, n: int, used: List[int],
                          stat_keys=frozenset()):
        n_padded = round_up_pow2(max(n, 1))
        cols = {}
        stats = {}
        dev = self.device
        for cid in used:
            vp = batch.column(cid)
            col_schema = schema.table.columns[cid]
            if vp is not None and vp.is_list:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("live-arr", vp.uid, vp.version, n, n_padded),
                    lambda: _pad_array_column(
                        vp.list_values[:n], vp.validity[:n], n_padded,
                        col_schema.data_type, dev))
                continue
            if vp is None or vp.values is None:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("default", col_schema.data_type,
                          col_schema.default_value, n_padded),
                    lambda: _default_column(col_schema, n_padded, dev))
                continue
            self._column_stat(stats, stat_keys, cid, vp, vp.values[:n],
                              vp.validity[:n], n)
            # keyed on VP identity + mutation version: invalidated by writes
            cols[(0, cid)] = self.device_cache.get_or_stage(
                dev, ("live", vp.uid, vp.version, n, n_padded),
                lambda: _pad_column(vp.values[:n], vp.validity[:n],
                                    n_padded, dev))
        return cols, n, n_padded, stats

    # Archive day batches stage in slices of at most this many rows. It
    # also bounds the run-length path's float32 lanes: a run's and a
    # group's row counts in one slice stay below 2^24, where float32
    # counts are exact (kernels.make_runlen_agg_kernel).
    ARCHIVE_CHUNK_ROWS = 1 << 22

    def _stage_archive_batch(self, schema, ab, used: List[int],
                             stat_keys=frozenset(), plan=None):
        """Yield (columns, n_rows, n_padded, stats, runinfo) for one
        archive day batch, sliced to ARCHIVE_CHUNK_ROWS-row chunks after
        prefilter narrowing. The row count comes from the raw (possibly
        mode-3) columns."""
        vps_raw = {}
        n = ab.size
        for cid in used:
            vp = ab.request_column(cid)
            if vp is not None:
                n = max(n, vp.num_rows)
            vps_raw[cid] = vp
        if n == 0:
            return
        # binary-search the sorted batch down to the candidate rows before
        # staging anything on the device
        lo, hi = 0, n
        if plan is not None and plan.prefilters:
            lo, hi = self._prefilter_slice(plan.prefilters, vps_raw, n,
                                           plan.stats)
            if hi <= lo:
                return
        chunk = self.ARCHIVE_CHUNK_ROWS
        for clo in range(lo, hi, chunk):
            yield self._stage_archive_slice(schema, vps_raw, used, clo,
                                            min(clo + chunk, hi), plan,
                                            stat_keys)

    def _stage_archive_slice(self, schema, vps_raw, used: List[int],
                             lo: int, hi: int, plan, stat_keys=frozenset()):
        """Stage rows [lo, hi) of an archive batch: per-run lanes under
        ARES_RUNLEN=1 where the plan and the batch allow
        (_stage_runlen), else the expanded columns, cached on the device
        under ("arch", uid, lo, hi, n_padded). The run-length path is
        opt-in, as in the JAX package: it saves the expansion's host
        memory and host-to-device bytes."""
        if plan is not None and os.environ.get("ARES_RUNLEN") == "1":
            staged = self._stage_runlen(schema, vps_raw, lo, hi, plan)
            if staged is not None:
                return staged
        vps = {cid: (vp.expanded() if vp is not None else None)
               for cid, vp in vps_raw.items()}
        n_rows = hi - lo
        n_padded = round_up_pow2(max(n_rows, 1))
        cols = {}
        stats = {}
        dev = self.device
        for cid in used:
            vp = vps[cid]
            col_schema = schema.table.columns[cid]
            if vp is None:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("default", col_schema.data_type,
                          col_schema.default_value, n_padded),
                    lambda: _default_column(col_schema, n_padded, dev))
                continue
            if vp.is_list:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("arch", vp.uid, lo, hi, n_padded),
                    lambda: _pad_array_column(
                        vp.list_values[lo:hi], vp.validity[lo:hi], n_padded,
                        col_schema.data_type, dev))
                continue
            self._column_stat(stats, stat_keys, cid, vp, vp.values[lo:hi],
                              vp.validity[lo:hi], (lo, hi))
            cols[(0, cid)] = self.device_cache.get_or_stage(
                dev, ("arch", vp.uid, lo, hi, n_padded),
                lambda: _pad_column(vp.values[lo:hi], vp.validity[lo:hi],
                                    n_padded, dev))
        return cols, n_rows, n_padded, stats, None

    RUNLEN_MIN_RATIO = 2   # runs must compress >= 2:1 to beat expansion

    def _stage_runlen(self, schema, vps, lo: int, hi: int, plan):
        """Stage rows [lo, hi) of an archive batch for the run-length
        kernel, or None where runlen.plan_runlen finds the plan and batch
        ineligible or the runs compress less than RUNLEN_MIN_RATIO:1 (the
        caller then expands). The composite run boundaries (host,
        memoized) give n_runs; run-level columns stage one value a run,
        row-level columns their expanded rows, (-2, 0) the runs' (starts,
        lengths) relative to lo and, for an integer row-level sum, (-2, 1)
        each row's run id."""
        spec = RL.plan_runlen(plan, vps)
        if spec is None:
            return None
        bkey = (tuple(sorted(getattr(vps[c], "uid", 0) or 0
                             for c in spec.run_cols)), lo, hi)
        bnds = self._runlen_memo.get(bkey)
        if bnds is None:
            bnds = RL.composite_boundaries(vps, spec.run_cols, lo, hi)
            if len(self._runlen_memo) > 512:
                self._runlen_memo.clear()
            self._runlen_memo[bkey] = bnds
        n_runs = len(bnds) - 1
        n_rows = hi - lo
        if n_runs <= 0 or n_runs * self.RUNLEN_MIN_RATIO > n_rows:
            return None
        n_runs_pad = round_up_pow2(n_runs, 256)
        n_rows_pad = round_up_pow2(max(n_rows, 1))
        starts_rel = (bnds[:-1] - lo).astype(np.int32)
        lens = np.diff(bnds).astype(np.int32)
        dev = self.device
        cols = {}

        def _meta():
            # padded runs start at n_rows and hold no rows
            s = np.full(n_runs_pad, n_rows, np.int32)
            s[:n_runs] = starts_rel
            ln = np.zeros(n_runs_pad, np.int32)
            ln[:n_runs] = lens
            return torch.from_numpy(s).to(dev), torch.from_numpy(ln).to(dev)

        cols[(-2, 0)] = self.device_cache.get_or_stage(
            dev, ("archrunmeta",) + bkey + (n_runs_pad,), _meta)
        if spec.measure_level == "row" and plan.measure.agg == "sum" \
                and not plan.measure.out_float:
            def _rid():
                r = np.zeros(n_rows_pad, np.int32)
                r[:n_rows] = np.repeat(np.arange(n_runs, dtype=np.int32),
                                       lens)
                return (torch.from_numpy(r).to(dev),
                        torch.zeros(1, dtype=torch.int32, device=dev))

            cols[(-2, 1)] = self.device_cache.get_or_stage(
                dev, ("archrunrid",) + bkey + (n_rows_pad,), _rid)
        for cid in spec.run_cols:
            vp = vps[cid]
            col_schema = schema.table.columns[cid]
            if vp is None:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("default", col_schema.data_type,
                          col_schema.default_value, n_runs_pad),
                    lambda cs=col_schema: _default_column(cs, n_runs_pad,
                                                          dev))
                continue

            def _run_col(vp=vp):
                vals, valid = RL.run_values_at(vp, bnds[:-1])
                return _pad_column(vals, valid, n_runs_pad, dev)

            cols[(0, cid)] = self.device_cache.get_or_stage(
                dev, ("archrun", vp.uid) + bkey + (n_runs_pad,), _run_col)
        for cid in spec.row_cols:
            vp = vps[cid]
            col_schema = schema.table.columns[cid]
            if vp is None:
                cols[(0, cid)] = self.device_cache.get_or_stage(
                    dev, ("default", col_schema.data_type,
                          col_schema.default_value, n_rows_pad),
                    lambda cs=col_schema: _default_column(cs, n_rows_pad,
                                                          dev))
                continue
            vp = vp.expanded()
            cols[(0, cid)] = self.device_cache.get_or_stage(
                dev, ("arch", vp.uid, lo, hi, n_rows_pad),
                lambda vp=vp: _pad_column(vp.values[lo:hi],
                                          vp.validity[lo:hi], n_rows_pad,
                                          dev))
        plan.stats["runlenBatches"] = plan.stats.get("runlenBatches", 0) + 1
        plan.stats["runlenRuns"] = plan.stats.get("runlenRuns", 0) + n_runs
        plan.stats["runlenRowsCompressed"] = \
            plan.stats.get("runlenRowsCompressed", 0) + n_rows
        return cols, n_rows, n_rows_pad, {}, RL.RunLenInfo(
            spec=spec, n_runs=n_runs, n_runs_pad=n_runs_pad)

    # -- agg execution --

    @staticmethod
    def _with_foreign(plan, foreign, batch_cols):
        """(the batch's columns with every joined table's staged columns
        under their (table_id, column_id) keys and a geo join's staged
        shapes under kernels.GEO_SHAPES, the joined tables' probes)."""
        columns = dict(batch_cols)
        shapes = getattr(plan, "_exec_geo", None)   # set by execute()
        if shapes is not None:
            columns[K.GEO_SHAPES] = shapes
        for ft, (_, fcols) in zip(plan.foreign_tables, foreign):
            for (_, cid), pair in fcols.items():
                columns[(ft.table_id, cid)] = pair
        return columns, tuple(probe for probe, _ in foreign)

    def _run_agg_batch(self, plan, foreign, batch_cols, n_valid, n_padded,
                       batch_stats=None, live_cutoff=0, runinfo=None) -> str:
        """Run one batch; the route it took: hll, runlen, mesh, sort or
        dense."""
        columns, foreign_idx = self._with_foreign(plan, foreign, batch_cols)
        if plan.measure.agg == "hll":
            self._run_hll_batch(plan, columns, foreign_idx, n_valid,
                                n_padded, live_cutoff)
            return "hll"
        if runinfo is not None:
            self._run_runlen_batch(plan, columns, foreign_idx, n_valid,
                                   n_padded, runinfo)
            return "runlen"
        # mesh batches (ARES_MESH=1): the batch's rows over every mesh
        # device, their partial group tables merged on the first; geo
        # shapes and joined tables go whole, array stagings split by rows
        if os.environ.get("ARES_MESH") == "1" and self._mesh_batch(
                self._run_mesh_batch, plan, columns, foreign_idx, n_valid,
                n_padded, live_cutoff):
            return "mesh"
        # dense slot aggregation when every dim is bounded, else the sort
        dense_plan, dense_sig, kernel = self._dense_route(plan, batch_stats,
                                                          n_padded)
        if dense_plan is None:
            self._run_sort_route(plan, columns, foreign_idx, n_valid,
                                 n_padded, live_cutoff)
            return "sort"
        if self._collects(kernel):
            self._record_k1(plan, kernel, dense_plan, dense_sig, columns,
                            foreign_idx, n_valid, live_cutoff)
            return "dense"
        # device-resident running aggregate, folded in place by the kernel
        acc = plan._exec_dense_dev.get(dense_sig)
        acc_arrays = acc[1] if acc is not None else dense_acc_init(
            plan, dense_plan.n_slots, self.device)
        folded, overflow = kernel(columns, n_valid, live_cutoff, acc_arrays,
                                  foreign_idx)
        plan._exec_dense_dev[dense_sig] = (dense_plan, folded)
        plan._exec_pending.append(
            (overflow.reshape(1),
             [(columns, foreign_idx, n_valid, n_padded, live_cutoff)]))
        return "dense"

    def _dense_route(self, plan, batch_stats, n_padded):
        """(dense plan, its signature, dense kernel) of a batch, or (None,
        None, None) where a dimension has no bounded domain. `plan_dense`
        and `dense_signature` run on the query's first batch of these
        stats and padded size; the kernel cache's lookup (and its plan
        signature) on its first batch of this dense plan and size. Both
        are reused on a match: a time column's stats move every batch,
        while the domains they give mostly do not."""
        routes = plan._exec_dense_routes
        key = ("stats", n_padded,
               tuple(sorted((batch_stats or {}).items())))
        route = routes.get(key)
        if route is None:
            dense_plan = plan_dense(plan, batch_stats)
            route = (None, None, None)
            if dense_plan is not None:
                dense_sig = dense_signature(dense_plan)
                kernel = routes.get(("kernel", n_padded, dense_sig))
                if kernel is None:
                    kernel = routes[("kernel", n_padded, dense_sig)] = \
                        self.kernel_cache.dense_agg_kernel(
                            plan, n_padded, dense_plan, self.device)
                route = (dense_plan, dense_sig, kernel)
            routes[key] = route
        return route

    @staticmethod
    def _collects(kernel) -> bool:
        """Whether the query collects this dense kernel's batches for one
        launcher call (K1) rather than launching each."""
        return isinstance(kernel, FD.FusedDenseKernel)

    @staticmethod
    def _record_k1(plan, kernel, dense_plan, dense_sig, columns,
                   foreign_idx, n_valid, live_cutoff) -> None:
        """Add a K1 batch to its query's launch list, under its structure
        and literal block and its dense plan's signature."""
        key = (kernel.group_key, dense_sig)
        group = plan._exec_k1.get(key)
        if group is None:
            group = plan._exec_k1[key] = (dense_sig, dense_plan, [])
        group[2].append(kernel.record(columns, n_valid, live_cutoff,
                                      foreign_idx))

    def _launch_k1(self, plan, dense_sig, dense_plan, batches) -> None:
        """One launcher call for K1 batches of one group, their tables
        folded at once into the accumulator of their dense plan; the
        overflow vector joins the pending fetch, each batch with what its
        rerun on the sort path needs."""
        tables, overflow = FD.reduce_batches(batches)
        acc = plan._exec_dense_dev.get(dense_sig)
        plan._exec_dense_dev[dense_sig] = (dense_plan, K.dense_fold_batches(
            None if acc is None else acc[1], tables, overflow))
        plan._exec_pending.append(
            (overflow, [(b.columns, b.foreign, b.n_valid, b.kernel.n_rows,
                         b.live_cutoff) for b in batches]))
        plan.stats["denseLaunchCalls"] = \
            plan.stats.get("denseLaunchCalls", 0) + 1
        plan.stats["denseBatchesLaunched"] = \
            plan.stats.get("denseBatchesLaunched", 0) + len(batches)
        M.root().count(M.QUERY_DENSE_LAUNCH_CALLS)
        M.root().count(M.QUERY_DENSE_BATCHES_LAUNCHED, len(batches))

    def _mesh_batch(self, run, *args) -> bool:
        """Run one batch on the mesh (`run` is _run_mesh_batch or
        _run_mesh_hll_batch); False where the caller must run it on the
        single-device path: the mesh is ineligible, or it raised. A mesh
        failure must never fail a query, but it is a fault to look into,
        so it is logged and counted."""
        try:
            if run(*args):
                M.root().count("query.mesh_batches")
                return True
            M.root().count("query.mesh_ineligible_batches")
        except Exception:  # noqa: BLE001
            M.root().count("query.mesh_fallback_batches")
            logging.getLogger("aresdb.executor").exception(
                "mesh batch execution failed; falling back to "
                "single-chip path")
        return False

    def _mesh_table(self, make_kernel, plan, columns, foreign_idx,
                    n_valid, n_padded, k_groups: int, live_cutoff):
        """One batch's group table from a mesh kernel (`make_kernel` is
        sharded.make_sharded_agg_kernel or make_sharded_hll_kernel) at
        capacity k_groups, on this executor's device; None where the
        batch is ineligible: fewer than 2 mesh devices, or rows that do
        not split evenly."""
        devs = self.mesh_devices
        if len(devs) < 2 or n_padded % len(devs) != 0:
            return None
        rows_per_device = n_padded // len(devs)
        key = (make_kernel.__name__, plan_signature(plan), rows_per_device,
               k_groups, tuple(str(d) for d in devs))
        fn = self.kernel_cache.get(key, make_kernel, plan, rows_per_device,
                                   k_groups, devs)
        out = fn(columns, foreign_idx,
                 S.per_shard_valid(int(n_valid), len(devs), rows_per_device),
                 live_cutoff)
        return self._here(out)

    def _run_mesh_batch(self, plan, columns, foreign_idx, n_valid, n_padded,
                        live_cutoff=0) -> bool:
        """One aggregate batch over the mesh devices at the default group
        capacity; its merged table joins the sort path's pending merge,
        and a batch whose groups outgrew it reruns on the single-device
        sort ladder. False where ineligible (see _mesh_table)."""
        k_groups = DEFAULT_GROUP_CAPACITY
        out = self._mesh_table(S.make_sharded_agg_kernel, plan, columns,
                               foreign_idx, n_valid, n_padded, k_groups,
                               live_cutoff)
        if out is None:
            return False
        plan._exec_sort_pending.append(
            (k_groups, out, columns, foreign_idx, n_valid, n_padded,
             live_cutoff, None))
        return True

    def _here(self, out):
        """A mesh kernel's group table on this executor's device, where
        the single-device tables it merges with lie."""
        *heads, dims, dvalids = out
        return (*(t.to(self.device) for t in heads),
                tuple(t.to(self.device) for t in dims),
                tuple(t.to(self.device) for t in dvalids))

    def _run_sort_route(self, plan, *batch) -> None:
        """A batch that takes the sort route (no dense domain, or a dense
        overflow's rerun): _run_sort_batch, timed in `sortExec` and
        counted in `sortBatches` and `query.sort_batches`. Capacity
        reruns are not counted here (`ladderReruns`)."""
        with tracing.stage(plan.stats, "sortExec"):
            self._run_sort_batch(plan, *batch)
        plan.stats["sortBatches"] += 1
        M.root().count(M.QUERY_SORT_BATCHES)

    def _run_sort_batch(self, plan, columns, foreign_idx, n_valid, n_padded,
                        live_cutoff=0, k: int = 0):
        """Keyed aggregation of one batch at group capacity k (default:
        the plan's hint); resolved after all batches
        (_resolve_sort_pending)."""
        if not k:
            k = self._k_hints.get(plan_signature(plan),
                                  DEFAULT_GROUP_CAPACITY)
        kernel = self.kernel_cache.agg_kernel(plan, n_padded, k, self.device)
        out = kernel(columns, n_valid, live_cutoff, foreign_idx)
        plan._exec_sort_pending.append(
            (k, out, columns, foreign_idx, n_valid, n_padded, live_cutoff,
             None))

    def _run_runlen_batch(self, plan, columns, foreign_idx, n_valid,
                          n_padded, runinfo, k: int = 0):
        """Keyed aggregation of one run-length archive chunk
        (_stage_runlen) at group capacity k (default: the plan's hint);
        its group table joins the sort path's pending merge, and a
        capacity rerun takes this kernel again."""
        if not k:
            k = self._k_hints.get(plan_signature(plan),
                                  DEFAULT_GROUP_CAPACITY)
        kernel = self.kernel_cache.runlen_kernel(
            plan, n_padded, runinfo.n_runs_pad, k, runinfo.spec, self.device)
        out = kernel(columns, n_valid, runinfo.n_runs, foreign_idx)
        plan._exec_sort_pending.append(
            (k, out, columns, foreign_idx, n_valid, n_padded, 0, runinfo))

    def _resolve_pending(self, plan, table: GroupTable) -> None:
        """ONE host fetch for every dense batch's overflow count (a vector
        for each K1 launcher call, one count for each other batch) and
        every accumulated dense table; overflowed batches (a domain
        understated by stale stats, folded as identity) rerun on the sort
        ladder."""
        pending, plan._exec_pending = plan._exec_pending, []
        accs, plan._exec_dense_dev = plan._exec_dense_dev, {}
        if not pending and not accs:
            return
        sigs = list(accs.keys())
        tensors = [overflow for overflow, _ in pending]
        for s in sigs:
            tensors.extend(accs[s][1])
        host = fetch_to_host(tensors)
        for (_, reruns), overflow in zip(pending, host[:len(pending)]):
            for count, rerun in zip(overflow.tolist(), reruns):
                if count > 0:
                    self._run_sort_route(plan, *rerun)
                    plan.stats["overflowReruns"] += 1
        tables = host[len(pending):]
        for j, sig in enumerate(sigs):
            aggv, cnt, rows = tables[3 * j:3 * j + 3]
            table.merge_dense(sig, accs[sig][0], aggv, cnt, rows)

    def _resolve_sort_pending(self, plan, table: GroupTable) -> None:
        """Resolve every pending keyed batch with one device-side merge:
        the group counts come first (one copy, with the whole tables of
        small capacities), batches whose groups outgrew their capacity
        rerun at the next power of two (a run-length chunk on the
        run-length kernel, any other on the sort kernel; each pending
        entry's last element is the chunk's RunLenInfo or None), live
        slots are sliced on the
        device, the slices concatenate and fold by key
        (_merge_big_device, _keyed_merge_device), and one merged table is
        fetched."""
        sliced = []
        total_live = 0
        while True:
            pending, plan._exec_sort_pending = plan._exec_sort_pending, []
            if not pending:
                break
            tensors, full = [], []
            for k, out, *_ in pending:
                tensors.append(out[4].reshape(1))
                full.append(k <= SMALL_K_FULL_FETCH)
                if full[-1]:
                    gkeys, _, agg, cnt, _, dims, dvalids = out
                    tensors += [gkeys, agg, cnt, *dims, *dvalids]
            host = fetch_to_host(tensors)
            i = 0
            for entry, whole in zip(pending, full):
                k, out = entry[0], entry[1]
                ng = int(host[i][0])
                i += 1
                if whole:
                    tab = _host_table(plan, host[i:i + 3 + 2 * len(out[5])])
                    i += 3 + 2 * len(out[5])
                    if ng <= k:
                        kg = min(round_up_pow2(max(ng, 1), 64), k)
                        gkeys, agg, cnt, dims, dvalids = tab
                        table.merge_keyed(
                            gkeys[:kg], gkeys[:kg] != SENTINEL64, agg[:kg],
                            cnt[:kg], [d[:kg] for d in dims],
                            [d[:kg] for d in dvalids])
                        continue
                if ng > k:
                    if ng > MAX_GROUP_CAPACITY:
                        raise QueryError(
                            f"group cardinality {ng} exceeds maximum "
                            f"capacity {MAX_GROUP_CAPACITY}")
                    k2 = min(round_up_pow2(ng), MAX_GROUP_CAPACITY)
                    sig = plan_signature(plan)
                    self._k_hints[sig] = max(self._k_hints.get(sig, 0), k2)
                    (_, _, columns, foreign_idx, n_valid, n_padded,
                     live_cutoff, runinfo) = entry
                    if runinfo is not None:
                        self._run_runlen_batch(plan, columns, foreign_idx,
                                               n_valid, n_padded, runinfo,
                                               k=k2)
                    else:
                        self._run_sort_batch(plan, columns, foreign_idx,
                                             n_valid, n_padded, live_cutoff,
                                             k=k2)
                    plan.stats["ladderReruns"] += 1
                    M.root().count(M.QUERY_LADDER_RERUNS)
                    continue
                kg = min(round_up_pow2(max(ng, 1), 64), k)
                gkeys, _, agg, cnt, _, dims, dvalids = out
                sliced.append((gkeys[:kg], agg[:kg], cnt[:kg],
                               tuple(d[:kg] for d in dims),
                               tuple(d[:kg] for d in dvalids)))
                total_live += ng
        if not sliced:
            return
        if len(sliced) == 1:
            gkeys, agg, cnt, dims, dvalids = sliced[0]
            gkeys_h, agg_h, cnt_h, dims_h, dvalids_h = _host_table(
                plan, fetch_to_host([gkeys, agg, cnt, *dims, *dvalids]))
            table.merge_keyed(gkeys_h, gkeys_h != SENTINEL64, agg_h, cnt_h,
                              dims_h, dvalids_h)
            return
        gkeys = torch.cat([s[0] for s in sliced])
        agg = torch.cat([s[1] for s in sliced])
        cnt = torch.cat([s[2] for s in sliced])
        n_dims = len(sliced[0][3])
        dims = tuple(torch.cat([s[3][d] for s in sliced])
                     for d in range(n_dims))
        dvalids = tuple(torch.cat([s[4][d] for s in sliced])
                        for d in range(n_dims))
        plan.stats["deviceMergedTables"] = len(sliced)
        kind = plan.measure.agg
        k_out = round_up_pow2(max(total_live, 1), 64)
        # the union count first (one scalar copy): total_live counts a
        # group once per batch that holds it
        n_u = int(fetch_to_host([_count_unique_keys(gkeys)])[0])
        kg = min(round_up_pow2(max(n_u, 1), 64), k_out)
        if kind in ("sum", "count", "avg"):
            m_keys, m_used, m_agg, m_cnt, _, m_dims, m_dvalids = \
                _merge_big_device(gkeys, agg, cnt, dims, dvalids, kg)
        else:
            m_keys, m_used, m_agg, m_cnt, m_dims, m_dvalids, _ = \
                _keyed_merge_device(gkeys, agg, cnt, dims, dvalids, kind, kg)
        # keys matter only where other piles join the final merge; per-group
        # counts only for avg or another merge
        other_piles = bool(table._keyed_acc) or bool(table._dense_acc)
        need_cnt = other_piles or kind == "avg"
        req = [m_used, m_agg, *m_dims, *m_dvalids]
        if other_piles:
            req.append(m_keys)
        if need_cnt:
            req.append(m_cnt)
        host = fetch_to_host(req)
        used_h, agg_h = host[0], host[1]
        dims_h = _unsigned_dims(plan, host[2:2 + n_dims])
        dvalids_h = host[2 + n_dims:2 + 2 * n_dims]
        rest = host[2 + 2 * n_dims:]
        keys_h = rest.pop(0).view(np.uint64) if other_piles \
            else np.arange(kg, dtype=np.uint64)   # positional placeholder
        cnt_h = rest.pop(0) if need_cnt else np.zeros(kg, np.float64)
        table.merge_keyed(keys_h, used_h, agg_h, cnt_h, dims_h, dvalids_h)

    # -- HLL --

    def _run_hll_batch(self, plan, columns, foreign_idx, n_valid, n_padded,
                       live_cutoff=0, k: int = 0):
        """HLL register build of one batch at group capacity k (default:
        the plan's hint); resolved after all batches
        (_resolve_hll_pending)."""
        if not k:
            k = self._k_hints.get("hll:" + plan_signature(plan),
                                  DEFAULT_HLL_CAPACITY)
        if os.environ.get("ARES_MESH") == "1" and self._mesh_batch(
                self._run_mesh_hll_batch, plan, columns, foreign_idx,
                n_valid, n_padded, k, live_cutoff):
            return
        kernel = self.kernel_cache.hll_kernel(plan, n_padded, k, self.device)
        out = kernel(columns, n_valid, live_cutoff, foreign_idx)
        plan._exec_hll_pending.append(
            (k, out, columns, foreign_idx, n_valid, n_padded, live_cutoff))

    def _run_mesh_hll_batch(self, plan, columns, foreign_idx, n_valid,
                            n_padded, k_groups, live_cutoff=0) -> bool:
        """One HLL batch over the mesh devices at capacity k_groups
        (register planes merged by max on the first device); resolved with
        the single-device batches, and an overflow reruns through
        _run_hll_batch, on the mesh again. False where ineligible (see
        _mesh_table)."""
        out = self._mesh_table(S.make_sharded_hll_kernel, plan, columns,
                               foreign_idx, n_valid, n_padded, k_groups,
                               live_cutoff)
        if out is None:
            return False
        plan._exec_hll_pending.append(
            (k_groups, out, columns, foreign_idx, n_valid, n_padded,
             live_cutoff))
        return True

    def _resolve_hll_pending(self, plan, table: GroupTable) -> None:
        """Resolve every pending HLL batch with ONE device-side register
        merge: the group counts come first (one copy), batches whose
        groups outgrew their capacity rerun on the ladder (256 up to
        MAX_HLL_CAPACITY groups), the live slots are sliced on the device
        and merged by key (_hll_merge_device). A JSON query then fetches
        per group only the estimator's two register sums (16 B, not the
        16 KB register row); a binary wire query (plan.hll_registers)
        fetches the merged registers, sliced to the live groups."""
        sliced = []
        while True:
            pending, plan._exec_hll_pending = plan._exec_hll_pending, []
            if not pending:
                break
            counts = fetch_to_host([out[4].reshape(1) for _, out, *_ in
                                    pending])
            for entry, n_groups in zip(pending, counts):
                k, out = entry[0], entry[1]
                ng = int(n_groups[0])
                if ng <= k:
                    kg = min(round_up_pow2(max(ng, 1), 8), k)
                    gkeys, slot_used, registers, cnt, _, dims, dvalids = out
                    sliced.append((gkeys[:kg], slot_used[:kg],
                                   registers[:kg], cnt[:kg],
                                   tuple(d[:kg] for d in dims),
                                   tuple(d[:kg] for d in dvalids)))
                    continue
                if ng > MAX_HLL_CAPACITY:
                    raise QueryError(f"hll group cardinality {ng} exceeds "
                                     f"{MAX_HLL_CAPACITY}")
                k2 = min(round_up_pow2(ng, 256), MAX_HLL_CAPACITY)
                sig = "hll:" + plan_signature(plan)
                self._k_hints[sig] = max(self._k_hints.get(sig, 0), k2)
                (_, _, columns, foreign_idx, n_valid, n_padded,
                 live_cutoff) = entry
                self._run_hll_batch(plan, columns, foreign_idx, n_valid,
                                    n_padded, live_cutoff, k=k2)
                plan.stats["ladderReruns"] += 1
                M.root().count(M.QUERY_LADDER_RERUNS)
        if not sliced:
            return
        n_dims = len(sliced[0][4])
        merged = _hll_merge_device(
            torch.cat([s[0] for s in sliced]),
            torch.cat([s[1] for s in sliced]),
            torch.cat([s[2] for s in sliced]),
            torch.cat([s[3] for s in sliced]),
            tuple(torch.cat([s[4][d] for s in sliced]) for d in range(n_dims)),
            tuple(torch.cat([s[5][d] for s in sliced]) for d in range(n_dims)),
            bool(getattr(plan, "hll_registers", False)))
        m_keys, m_used, m_cnt, m_dims, m_dvalids, n_uniq = merged[:6]
        if getattr(plan, "hll_registers", False):
            n_u = int(fetch_to_host([n_uniq.reshape(1)])[0][0])
            kg = min(round_up_pow2(max(n_u, 1), 8), m_keys.shape[0])
            host = fetch_to_host([m_keys[:kg], m_used[:kg], merged[6][:kg],
                                  m_cnt[:kg], *(d[:kg] for d in m_dims),
                                  *(d[:kg] for d in m_dvalids)])
            table.merge_keyed(host[0].view(np.uint64), host[1], host[2],
                              host[3],
                              _unsigned_dims(plan, host[4:4 + n_dims]),
                              host[4 + n_dims:])
            return
        host = fetch_to_host([m_keys, m_used, m_cnt, merged[6], merged[7],
                              *m_dims, *m_dvalids])
        keys_h, used_h, cnt_h, sum_recip, non_zero = host[:5]
        ests = np.array([H.estimate_from_stats(float(sr), float(nz))
                         if u else 0.0
                         for sr, nz, u in zip(sum_recip, non_zero, used_h)])
        table.merge_keyed(keys_h.view(np.uint64), used_h, ests, cnt_h,
                          _unsigned_dims(plan, host[5:5 + n_dims]),
                          host[5 + n_dims:])

    # -- non-aggregate queries --

    def _execute_non_agg(self, plan, foreign, shards):
        """Collect up to `limit` rows of dimension values, in scan order:
        one select kernel and one host copy a batch, and no batch is
        scanned once the limit is collected (reference non-agg path).
        With ORDER BY, matching rows are collected up to
        NON_AGG_SORT_SCAN_CAP, sorted, then limited (sorting needs rows
        past the limit; the cap bounds memory)."""
        rows: List[Tuple] = []
        limit = plan.limit
        sorts = plan.query.sorts or []
        limit_collect = self.NON_AGG_SORT_SCAN_CAP if sorts else limit
        n_dims = len(plan.dimensions)
        for shard_id in shards:
            shard = self.memstore.get_table_shard(
                plan.main_schema.table.name, shard_id)
            for batch_cols, n_valid, n_padded, _, cutoff, _ in \
                    self._iter_batches(plan, shard):
                columns, foreign_idx = self._with_foreign(plan, foreign,
                                                          batch_cols)
                # only the first L passing rows of a batch reach the host
                top_l = 0
                if limit_collect and limit_collect < n_padded:
                    top_l = round_up_pow2(limit_collect)
                kernel = self.kernel_cache.select_kernel(plan, n_padded,
                                                         top_l, self.device)
                head, dim_values, dim_valids = kernel(columns, n_valid,
                                                      cutoff, foreign_idx)
                host = fetch_to_host([head.reshape(-1), *dim_values,
                                      *dim_valids])
                plan.stats["batches"] += 1
                plan.stats["rows_scanned"] += n_valid
                dvs = _unsigned_dims(plan, host[1:1 + n_dims])
                dvds = host[1 + n_dims:]
                if top_l:
                    take = min(int(host[0][0]), top_l)
                    if limit_collect:
                        take = min(take, limit_collect - len(rows))
                    sel = range(take)
                else:
                    sel = np.nonzero(host[0])[0]
                    if limit_collect and len(rows) + len(sel) > limit_collect:
                        sel = sel[:limit_collect - len(rows)]
                for i in sel:
                    rows.append(tuple((dvs[d][i], bool(dvds[d][i]))
                                      for d in range(n_dims)))
                if limit_collect and len(rows) >= limit_collect:
                    break
            else:
                continue
            break
        if sorts:
            rows = self._sort_non_agg(plan, rows, sorts)
        if limit:
            rows = rows[:limit]
        return rows

    @staticmethod
    def _sort_non_agg(plan, rows, sorts):
        """Sort collected rows by dim name/alias (SortField order)."""
        name_to_idx = {}
        for i, d in enumerate(plan.dimensions):
            if d.raw is not None:
                if d.raw.alias:
                    name_to_idx[d.raw.alias] = i
                if d.raw.expr:
                    name_to_idx[d.raw.expr] = i
        for sf in reversed(sorts):
            idx = name_to_idx.get(sf.name)
            if idx is None:
                raise QueryError(f"unknown sort field {sf.name!r}")
            rows = sorted(
                rows,
                key=lambda r: (not r[idx][1],
                               r[idx][0].item()
                               if hasattr(r[idx][0], "item") else r[idx][0]),
                reverse=(sf.order == "desc"))
        return rows

    # -- joins --

    def _stage_foreign_tables(self, plan: CompiledQuery):
        """Stage each joined dimension table for the device probe, as
        (probe, {(0, column_id): (values, validity)}). The probe is a
        dense key → row table (int32, -1 = no row) where the valid keys
        lie in [0, FOREIGN_LUT_CAP): one gather. Otherwise it is the
        keys sorted on the host, invalid keys last, with their row
        permutation: a binary search and a gather
        (kernels._EvalCtx.foreign_row). An empty table stages one
        never-matching key. Cached on the table's batches' (uid, version)
        and the device."""
        staged = []
        dev = self.device
        for ft in plan.foreign_tables:
            shard = self.memstore.get_table_shard(ft.schema.table.name, 0)
            live = shard.live_store
            with live.lock:
                snaps = live.snapshot_columns(ft.used_columns)
            ckey_parts = [str(dev), ft.schema.table.name,
                          tuple(ft.used_columns)]
            for _, n, batch in snaps:
                for cid in ft.used_columns:
                    vp = batch.column(cid)
                    ckey_parts.append((cid, n, getattr(vp, "uid", None),
                                       getattr(vp, "version", 0)))
            ckey = tuple(ckey_parts)
            hit = self._foreign_cache.get(ckey)
            if hit is not None:
                staged.append(hit)
                continue
            # the visible rows of every live batch, concatenated
            parts: Dict[int, list] = {cid: [] for cid in ft.used_columns}
            valid_parts: Dict[int, list] = {cid: [] for cid in ft.used_columns}
            total = 0
            for _, n, batch in snaps:
                for cid in ft.used_columns:
                    vp = batch.column(cid)
                    col_schema = ft.schema.table.columns[cid]
                    # an array column (values None) stages as all-null,
                    # as in the JAX package: array ops on it answer
                    # "not staged" (kernels._array_entry)
                    if vp is None or vp.values is None:
                        npdt = mdt.numpy_dtype(col_schema.data_type)
                        shape = (n, 2) if mdt.lanes(col_schema.data_type) \
                            == 2 else (n,)
                        parts[cid].append(np.zeros(shape, npdt))
                        valid_parts[cid].append(np.zeros(n, bool))
                    else:
                        parts[cid].append(np.asarray(vp.values[:n]))
                        valid_parts[cid].append(np.asarray(vp.validity[:n]))
                total += n
            if total == 0:
                columns = {(0, cid): _default_column(
                    ft.schema.table.columns[cid], 1, dev)
                    for cid in ft.used_columns}
                probe = (torch.tensor([np.iinfo(np.int64).max],
                                      dtype=torch.int64, device=dev),
                         torch.zeros(1, dtype=torch.int64, device=dev))
                entry = (probe, columns)
                self._remember_foreign(ckey, entry)
                staged.append(entry)
                continue
            key_cid = ft.foreign_key_column
            keys = np.concatenate(parts[key_cid]).astype(np.int64)
            keys_valid = np.concatenate(valid_parts[key_cid])
            columns = {}
            for cid in ft.used_columns:
                vals = np.concatenate(parts[cid])
                valid = np.concatenate(valid_parts[cid])
                columns[(0, cid)] = (
                    torch.from_numpy(_signed_view(vals)).to(dev),
                    torch.from_numpy(valid).to(dev))
            vk = keys[keys_valid]
            if len(vk) and vk.min() >= 0 and vk.max() < self.FOREIGN_LUT_CAP:
                lut = np.full(int(vk.max()) + 2, -1, np.int32)
                rows_idx = np.nonzero(keys_valid)[0].astype(np.int32)
                # reversed write: the first row of a repeated key wins, as
                # in the sorted probe
                lut[vk[::-1]] = rows_idx[::-1]
                entry = ((torch.from_numpy(lut).to(dev),), columns)
            else:
                # invalid keys sort last and never match
                keys = np.where(keys_valid, keys, np.iinfo(np.int64).max)
                perm = np.argsort(keys, kind="stable")
                entry = ((torch.from_numpy(keys[perm]).to(dev),
                          torch.from_numpy(perm).to(dev)), columns)
            self._remember_foreign(ckey, entry)
            staged.append(entry)
        return staged

    def _remember_foreign(self, ckey, entry) -> None:
        if len(self._foreign_cache) > 128:
            self._foreign_cache.clear()
        self._foreign_cache[ckey] = entry

    def _stage_geo(self, plan: CompiledQuery):
        """The geo join's candidate shapes on the device (geo.DeviceShapes,
        with the bbox walk's tables unless ARES_GEO2=0), or None for a
        plan with no geo join. The shapes are read from the geo table's
        live store at each query, in its row order, kept or dropped by
        the geo filter's candidate keys, and their keys become
        plan.geo.shape_values (the geo dimension's values).
        Reference: prepareForGeoIntersect (query/aql_processor.go:333)."""
        if plan.geo is None:
            return None
        geo = plan.geo
        shard = self.memstore.get_table_shard(geo.schema.table.name, 0)
        live = shard.live_store
        with live.lock:
            snaps = live.snapshot_columns([geo.pk_column, geo.shape_column])
        shapes, values = [], []
        cands = None
        if geo.candidates is not None:
            cands = {tuple(c) if isinstance(c, (list, tuple)) else c
                     for c in geo.candidates}
        for _, n, batch in snaps:
            pk_vp = batch.column(geo.pk_column)
            sh_vp = batch.column(geo.shape_column)
            if pk_vp is None or sh_vp is None:
                continue
            for r in range(n):
                pk = pk_vp.read_value(r)
                shape = sh_vp.read_value(r)
                if pk is None or shape is None:
                    continue
                key = tuple(pk) if isinstance(pk, (list, tuple)) else pk
                # IN keeps the candidates; NOT IN also stages only them,
                # and the kernel keeps the rows that match none
                if cands is not None and key not in cands:
                    continue
                shapes.append(shape)
                values.append(pk)
        batch_ = G.build_shape_batch(shapes, values)
        geo.shape_values = values
        if batch_ is None:
            # no candidate shapes: nothing matches
            batch_ = G.empty_shape_batch()
        return G.stage_shapes(batch_, self.device, G.use_pruned())


def _host_table(plan, host: List[np.ndarray]):
    """A keyed table fetched as [gkeys, agg, cnt, *dims, *dim valids]:
    (u64 keys, agg, cnt, dims, dim valids) on the host."""
    n_dims = (len(host) - 3) // 2
    return (host[0].view(np.uint64), host[1], host[2],
            _unsigned_dims(plan, host[3:3 + n_dims]), host[3 + n_dims:])


def _unsigned_dims(plan, dims: List[np.ndarray]) -> List[np.ndarray]:
    """UUID dim lanes, staged as int64 bit views, back to uint64."""
    return [v.view(np.uint64) if d.data_type == mdt.UUID and not d.geo_dim
            else v for v, d in zip(dims, plan.dimensions)]


def _count_unique_keys(gkeys: torch.Tensor) -> torch.Tensor:
    """Live-unique count of a concatenated key column (one sort)."""
    sk = torch.sort(gkeys)[0]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return (first & (sk != SENTINEL)).sum()


def _merge_big_device(gkeys, wsum, wcnt, dims, dvalids, k_out: int):
    """Cross-batch merge of keyed tables for sum/count/avg: the weighted
    sort + segmented reduce over the concatenated partial tables. Float
    sums and counts fold in float64: a float32 cross-batch count or sum
    would round groups past 2^24 rows. k_out is bounded by the union
    count (_count_unique_keys). Returns (gkeys, slot_used, agg, cnt,
    n_groups, dims, dvalids)."""
    if wsum.is_floating_point():
        wsum = wsum.to(torch.float64)
    wcnt = wcnt.to(torch.float64)
    dim_vals = [K._Val(d, v) for d, v in zip(dims, dvalids)]
    return K._reduce_by_key_sorted_weighted(gkeys, wsum, wcnt, k_out,
                                            dim_vals, None)


def _keyed_merge_device(gkeys, agg, cnt, dims, dvalids, kind: str,
                        k_out: int):
    """Cross-batch merge of keyed group tables on the device, for any
    measure lattice: the concatenated partial tables sort by key and fold
    per key (sums in float64, min/min, max/max), so one table crosses to
    the host. Unused slots arrive with the sentinel key and sort last.
    Returns (m_keys[k_out], m_used, m_agg, m_cnt, m_dims, m_dvalids,
    n_uniq)."""
    n = gkeys.shape[0]
    skeys, order = torch.sort(gkeys ^ K._SIGN, stable=True)
    skeys = skeys ^ K._SIGN
    sagg, scnt = agg[order], cnt[order]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    live = skeys != SENTINEL
    seg = torch.cumsum(first, 0) - 1
    seg_c = torch.where(live & (seg < k_out), seg, k_out)
    idx = K._scatter_index(seg_c, k_out)
    n_uniq = (first & live).sum().to(torch.int32)
    if kind in ("sum", "count", "avg"):
        wide = torch.float64 if sagg.is_floating_point() else sagg.dtype
        m_agg = K._segment_add(sagg, idx, k_out, wide)
    elif kind in ("min", "max"):
        info = torch.finfo if sagg.is_floating_point() else torch.iinfo
        ident = info(sagg.dtype).max if kind == "min" \
            else info(sagg.dtype).min
        m_agg = torch.full((k_out + K._SPILL,), ident, dtype=sagg.dtype,
                           device=gkeys.device).scatter_reduce_(
            0, idx, sagg, "amin" if kind == "min" else "amax")[:k_out]
    else:
        raise ValueError(f"unsupported keyed merge kind {kind}")
    m_cnt = K._segment_add(scnt, idx, k_out, torch.float64)
    rep = torch.searchsorted(seg_c, torch.arange(k_out, device=gkeys.device))
    rep = rep.clamp(0, max(n - 1, 0))
    m_used = torch.arange(k_out, device=gkeys.device) < n_uniq
    m_keys = torch.where(m_used, skeys[rep], SENTINEL)
    src = order[rep]
    return (m_keys, m_used, m_agg, m_cnt, tuple(d[src] for d in dims),
            tuple(v[src] & m_used for v in dvalids), n_uniq)


def _hll_merge_device(gkeys, used, regs, cnt, dims, dvalids,
                      want_regs: bool):
    """Cross-batch HLL merge on the device: the concatenated per-batch
    group tables sort by key and the register rows of equal keys fold by
    max, so at most one [G, 16384] register table (for a JSON query,
    only two sums per group) crosses to the host. Returns (keys, used,
    cnt, dims, dvalids, n_uniq, regs uint8) when want_regs, else (keys,
    used, cnt, dims, dvalids, n_uniq, sum_recip float64, non_zero int32):
    the inputs of hll.estimate_from_stats, 2^-rho built bit-exactly from
    its float64 exponent bits. Reference peer: query/hll.cu:21 builds
    per-batch planes, query/hll.go:28 merges them."""
    n = gkeys.shape[0]
    device = gkeys.device
    keyed = torch.where(used, gkeys, SENTINEL)
    skeys, order = torch.sort(keyed ^ K._SIGN, stable=True)
    skeys = skeys ^ K._SIGN
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    seg = torch.cumsum(first, 0) - 1
    n_uniq = (first & (skeys != SENTINEL)).sum().to(torch.int32)
    m = regs.shape[1]
    m_regs = torch.zeros((n, m), dtype=torch.int32, device=device) \
        .scatter_reduce_(0, seg[:, None].expand(n, m),
                         regs[order].to(torch.int32), "amax")
    m_cnt = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, seg, cnt[order].to(torch.float64))
    rep = torch.searchsorted(seg, torch.arange(n, device=device)).clamp(
        0, max(n - 1, 0))
    m_used = torch.arange(n, device=device) < n_uniq
    m_keys = torch.where(m_used, skeys[rep], SENTINEL)
    src = order[rep]
    m_dims = tuple(d[src] for d in dims)
    m_dvalids = tuple(v[src] & m_used for v in dvalids)
    if want_regs:
        return (m_keys, m_used, m_cnt, m_dims, m_dvalids, n_uniq,
                m_regs.to(torch.uint8))
    # zero registers add 1.0 each (hll.compute_estimate)
    present = m_regs > 0
    non_zero = present.sum(1, dtype=torch.int32)
    rho = m_regs.to(torch.int64).clamp(max=1022)
    recip = ((1023 - rho) << 52).view(torch.float64)
    sum_recip = torch.where(present, recip, 0.0).sum(1) + (
        float(m) - non_zero.to(torch.float64))
    return (m_keys, m_used, m_cnt, m_dims, m_dvalids, n_uniq, sum_recip,
            non_zero)


def _signed_view(a: np.ndarray) -> np.ndarray:
    """Unsigned 16/32/64-bit arrays as the signed ints of the same bits
    (torch's unsigned wide types lack most ops); other dtypes unchanged."""
    signed = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint64): np.int64}.get(a.dtype)
    return a if signed is None else a.view(signed)


def _pad_column(values: np.ndarray, validity: np.ndarray, n_padded: int,
                device: torch.device):
    """(values, validity) padded to n_padded rows on `device`; padded rows
    are invalid."""
    n = len(validity)
    v = np.zeros((n_padded,) + values.shape[1:], values.dtype)
    v[:n] = values
    b = np.zeros(n_padded, bool)
    b[:n] = validity
    return (torch.from_numpy(_signed_view(v)).to(device),
            torch.from_numpy(b).to(device))


def _pad_array_column(list_values, validity, n_padded: int, data_type: int,
                      device: torch.device):
    """Ragged array column -> (items[n, L], item_valid[n, L], lengths[n],
    row_valid[n]) on `device`, padded to n_padded rows (padded rows are
    null). L is the power-of-two bucket of the longest row; UUID and
    GeoPoint items are (n, L, 2) lanes; unsigned items are signed views
    of their bits (_signed_view). The JAX package's layout, built with one
    vectorized scatter of the flattened items."""
    item_dt = mdt.item_type(data_type)
    two_lane = mdt.lanes(item_dt) == 2  # UUID / GeoPoint items
    npdt = mdt.numpy_dtype(item_dt)
    n = len(validity)
    lens = np.fromiter((0 if v is None else len(v) for v in list_values),
                       np.int64, n)
    width = 1
    while width < (int(lens.max()) if n else 0):
        width <<= 1
    shape = (n_padded, width, 2) if two_lane else (n_padded, width)
    items = np.zeros(shape, npdt)
    item_valid = np.zeros((n_padded, width), bool)
    lengths = np.zeros(n_padded, np.int32)
    lengths[:n] = lens
    row_valid = np.zeros(n_padded, bool)
    row_valid[:n] = np.asarray(validity, bool)
    row_valid[:n] &= np.fromiter((v is not None for v in list_values), bool,
                                 n)
    flat = [x for v in list_values if v is not None for x in v]
    if flat:
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        present = np.fromiter((x is not None for x in flat), bool, len(flat))
        zero = (0, 0) if two_lane else 0
        items[rows, cols] = np.asarray(
            [zero if x is None else x for x in flat], npdt)
        item_valid[rows, cols] = present
    return (torch.from_numpy(_signed_view(items)).to(device),
            torch.from_numpy(item_valid).to(device),
            torch.from_numpy(lengths).to(device),
            torch.from_numpy(row_valid).to(device))


def _default_column(col_schema, n_padded: int, device: torch.device):
    """Column never written in this batch: default value or all-null."""
    data_type = col_schema.data_type
    npdt = mdt.numpy_dtype(data_type)
    shape = (n_padded, 2) if mdt.lanes(data_type) == 2 else (n_padded,)
    values = np.zeros(shape, npdt)
    if col_schema.default_value is not None:
        v = mdt.parse_value(col_schema.default_value, data_type)
        if mdt.lanes(data_type) == 2:
            values[:, 0] = v[0]
            values[:, 1] = v[1]
        else:
            values[:] = v
        validity = np.ones(n_padded, bool)
    else:
        validity = np.zeros(n_padded, bool)
    return (torch.from_numpy(_signed_view(values)).to(device),
            torch.from_numpy(validity).to(device))


def columns_from_numpy(cols, n_padded: int, device) -> dict:
    """Staged device columns from {(table_id, col_id): (values, validity)}
    numpy pairs (as `demo.demo_columns` returns them), padded to n_padded
    rows — the port's side of the JAX package's staged-column dict."""
    device = torch.device(device)
    return {key: _pad_column(np.asarray(v), np.asarray(b, bool), n_padded,
                             device)
            for key, (v, b) in cols.items()}
