"""Query executor, dense group-by path: batch loop over a shard's live
batches, device staging, dense kernels, one fetch, exact host merge.

Port of the dense path of `aresdb_tpu/query/executor.py`. Each batch
runs one dense kernel (K1, or the unfused kernel over K2) whose per-slot
table folds into a device-resident float64 accumulator; after the last
batch ONE device-to-host copy brings back every batch's overflow count and
every accumulator (`_resolve_pending`), and GroupTable merges them exactly.

What is not ported yet raises QueryError, never a wrong answer: plans that
are not dense (the sort path), batches that overflow their planned domain
(they rerun on the sort path in the JAX package), non-aggregate queries,
HLL, joins, geo, array columns and archive batches.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query.compiler import CompiledQuery, QueryError
from aresdb_tpu_torch.query.dense import _underlying_column_key, plan_dense
from aresdb_tpu_torch.query.kernels import (
    KernelCache, _packing_type, dense_acc_init, dense_signature,
    np_pack_dim_keys, pack_modes, round_up_pow2)
from aresdb_tpu_torch.utils import metrics as M

DEVICE_CACHE_BYTES = 4 << 30  # device residency budget for staged columns


def not_ported(what: str, path: str = "") -> QueryError:
    """The error for work the port does not do yet; `path` names the JAX
    package's code path that does it there."""
    return QueryError(f"{what} not ported yet" + (f": {path}" if path else ""))


class DeviceColumnCache:
    """LRU cache of staged device column tensors.

    Live batch columns carry mutation versions, so staged tensors stay
    resident on the device across queries and only changed data pays the
    host→device copy again. The device is part of every key.
    """

    def __init__(self, max_bytes: int = DEVICE_CACHE_BYTES):
        self.max_bytes = max_bytes
        self._entries = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _entry_bytes(entry) -> int:
        return sum(t.numel() * t.element_size() for t in entry)

    def get_or_stage(self, device: torch.device, key, stage_fn):
        key = (str(device),) + key
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit
        entry = stage_fn()
        nbytes = self._entry_bytes(entry)
        with self._lock:
            self.misses += 1
            if key not in self._entries:
                self._entries[key] = entry
                self._bytes += nbytes
                while self._bytes > self.max_bytes and len(self._entries) > 1:
                    _, old = self._entries.popitem(last=False)
                    self._bytes -= self._entry_bytes(old)
        return entry

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses}


GLOBAL_DEVICE_CACHE = DeviceColumnCache()
GLOBAL_KERNEL_CACHE = KernelCache()


class GroupTable:
    """Exact merge of per-batch partial aggregates, finalized COLUMNAR.

    Dense slot tables accumulate per slot space and decode at finalize();
    piles from different slot spaces (batches whose stats gave different
    domains) merge on the canonical u64 group key (np_pack_dim_keys).
    sum/count/avg add, min/min, max/max. Copied from the JAX package
    (dense piles only; keyed piles come with the sort path).
    """

    def __init__(self, plan: CompiledQuery):
        self.plan = plan
        # dense_sig -> [dense_plan, agg_array, cnt_array, rows_array]
        self._dense_acc: Dict[tuple, list] = {}
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
        piles = self._dense_piles()
        if not piles:
            self._set_empty()
            return
        if len(piles) > 1:
            # cross-pile merge needs canonical keys for every pile
            ptypes = [_packing_type(d) for d in self.plan.dimensions]
            exact, _ = pack_modes(ptypes)
            if not exact:
                raise not_ported("merging dense piles of inexact key packs is")
            keyed = [(np_pack_dim_keys(dvals, dvalids, ptypes), agg, cnt,
                      dvals, dvalids)
                     for _, agg, cnt, dvals, dvalids in piles]
            piles = [self._merge_piles(keyed)]
        keys, aggs, cnts, dvals, dvalids = piles[0]
        if aggs.dtype.kind == "f":
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
        else:
            m_agg = np.full(g, -np.inf if aggs.dtype.kind == "f"
                            else np.iinfo(aggs.dtype).min, aggs.dtype)
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


def fetch_to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Every tensor's values on the host through ONE device-to-host copy:
    the tensors' bytes are packed into one buffer on their device."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    packed = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        nbytes = f.numel() * f.element_size()
        np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(packed[off:off + nbytes].view(np_dt).reshape(t.shape))
        off += nbytes
    return out


class ShardExecutor:
    """Executes one compiled dense aggregate query against table shards."""

    def __init__(self, memstore, device: torch.device,
                 kernel_cache: KernelCache = GLOBAL_KERNEL_CACHE,
                 device_cache: DeviceColumnCache = GLOBAL_DEVICE_CACHE):
        self.memstore = memstore
        self.device = device
        self.kernel_cache = kernel_cache
        self.device_cache = device_cache
        # (vp.uid, vp.version, n) → (min, max) over valid values; columns
        # are immutable at a given mutation version so stats memoize
        self._stat_memo: Dict[tuple, tuple] = {}

    # -- public --

    def execute(self, plan: CompiledQuery):
        """Returns (GroupTable, None). Per-stage seconds accumulate into
        plan.stats (reference: query/stats.go stage timers)."""
        plan.stats = {"batches": 0, "rows_scanned": 0, "stagedBytes": 0,
                      "peakBatchStagedBytes": 0}

        class _Stage:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                plan.stats[self.name] = plan.stats.get(self.name, 0.0) + (
                    time.perf_counter() - self.t0)

        if plan.is_non_agg:
            raise not_ported("non-aggregate queries are")
        if plan.measure.agg == "hll":
            raise not_ported("HLL queries are")
        if plan.foreign_tables:
            raise not_ported("joins are")
        if plan.geo is not None:
            raise not_ported("geo queries are")

        table = GroupTable(plan)
        stat_keys = self._dense_stat_keys(plan)
        plan._exec_pending = []
        plan._exec_dense_dev = {}
        for shard_id in plan.shards or [0]:
            shard = self.memstore.get_table_shard(
                plan.main_schema.table.name, shard_id)
            it = self._iter_batches(plan, shard, stat_keys)
            while True:
                with _Stage("transfer"):
                    try:
                        (batch_cols, n_valid, n_padded, stats,
                         cutoff) = next(it)
                    except StopIteration:
                        break
                with _Stage("batchExec"):
                    self._run_agg_batch(plan, batch_cols, n_valid, n_padded,
                                        stats, cutoff)
                plan.stats["batches"] += 1
                plan.stats["rows_scanned"] += n_valid
                nb = sum(t.numel() * t.element_size()
                         for pair in batch_cols.values() for t in pair)
                plan.stats["stagedBytes"] += nb
                plan.stats["peakBatchStagedBytes"] = max(
                    plan.stats["peakBatchStagedBytes"], nb)
        with _Stage("resultFetch"):
            self._resolve_pending(plan, table)
            table.finalize()
        M.root().count(M.QUERY_ROWS_RETURNED, table.n_groups)
        M.root().record_timer(M.QUERY_BATCH_TRANSFER_TIME,
                              plan.stats.get("transfer", 0.0))
        return table, None

    @staticmethod
    def _dense_stat_keys(plan: CompiledQuery):
        """Main-table columns whose (min, max) stats unlock dense mode:
        raw integer dims, and the column under FLOOR time-bucket and
        numeric-bucket dims."""
        keys = set()
        for d in plan.dimensions:
            e = d.expr
            if isinstance(e, E.VarRef) and e.table_id == 0 and \
                    e.data_type in (mdt.Uint16, mdt.Uint32):
                keys.add((0, e.column_id))
            elif isinstance(e, E.BinaryExpr) and e.op == "FLOOR":
                key = _underlying_column_key(e.lhs)
                if key is not None:
                    keys.add(key)
            elif isinstance(e, E.Call) and e.name == "__numeric_bucket":
                key = _underlying_column_key(e.args[0])
                if key is not None:
                    keys.add(key)
        return keys

    # -- batch iteration + staging --

    def _iter_batches(self, plan: CompiledQuery, shard, stat_keys=frozenset()):
        """Yield (columns, n_valid, n_padded, stats, live_cutoff) for the
        shard's live batches."""
        live = shard.live_store
        used = plan.used_columns
        schema = plan.main_schema
        # snapshot LIVE first, then take the archive version ONCE (the
        # order the JAX executor needs under a concurrent archiving swap)
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
            staged = self._stage_live_batch(schema, batch, n, used,
                                            stat_keys)
            M.root().count(M.QUERY_LIVE_BATCH_PROCESSED, 1)
            M.root().count(M.QUERY_LIVE_RECORDS_PROCESSED, staged[1])
            yield staged + (live_cutoff,)

        if version is not None and version.get_batch_ids_for_range(0, 0):
            raise not_ported("archive batches are")

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
                raise not_ported("array columns are")
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

    # -- agg execution --

    def _run_agg_batch(self, plan, columns, n_valid, n_padded,
                       batch_stats=None, live_cutoff=0):
        dense_plan = plan_dense(plan, batch_stats)
        if dense_plan is None:
            raise not_ported("group-by over unbounded dimensions is",
                             "sort path")
        kernel = self.kernel_cache.dense_agg_kernel(plan, n_padded,
                                                    dense_plan, self.device)
        dense_sig = dense_signature(dense_plan)
        # device-resident running aggregate, folded in place by the kernel
        acc = plan._exec_dense_dev.get(dense_sig)
        acc_arrays = acc[1] if acc is not None else dense_acc_init(
            plan, dense_plan.n_slots, self.device)
        folded, overflow = kernel(columns, n_valid, live_cutoff, acc_arrays)
        plan._exec_dense_dev[dense_sig] = (dense_plan, folded)
        plan._exec_pending.append(overflow)

    def _resolve_pending(self, plan, table: GroupTable) -> None:
        """ONE host fetch for every batch's overflow count and every
        accumulated dense table."""
        flags, plan._exec_pending = plan._exec_pending, []
        accs, plan._exec_dense_dev = plan._exec_dense_dev, {}
        if not flags and not accs:
            return
        sigs = list(accs.keys())
        tensors = [f.reshape(1) for f in flags]
        for s in sigs:
            tensors.extend(accs[s][1])
        host = fetch_to_host(tensors)
        overflowed = int(sum(int(h[0]) for h in host[:len(flags)]))
        if overflowed:
            raise not_ported(f"rerunning {overflowed} rows outside the "
                             f"planned dense domain is", "sort path")
        tables = host[len(flags):]
        for j, sig in enumerate(sigs):
            aggv, cnt, rows = tables[3 * j:3 * j + 3]
            table.merge_dense(sig, accs[sig][0], aggv, cnt, rows)


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
