"""Archiving pipeline: live→archive migration, backfill, snapshot, purge.

Reference: memstore/archiving.go (Archive/createArchivingPatches/
createNewArchiveStoreVersion), memstore/merge.go (k-sorted merge with mode-3
count compression), memstore/backfill.go, memstore/snapshot.go,
memstore/purge.go.

Archive merge design (parity with merge.go's two-pass shape, vectorized):
the base day batch is already sorted, so merging a day's patch never
re-sorts the base. Pass 1 lexsorts the PATCH only, builds memcmp-orderable
key bytes for both sides' SORT columns, and derives every row's merged
position from two np.searchsorted calls (_merge_positions — ties keep base
rows first, the reference merge's iteration order). Pass 2 materializes
one column at a time (_StreamingDayMerge.merged_column), so transient
memory is the patch + one expanded base column + the narrow key matrices
instead of 2x the whole expanded base (merge.go:333,509). Run-length
compression boundaries come from the merged key matrix and are identical
to what a full re-sort would produce (differential-tested in
tests/test_streaming_merge.py). Patch-only days (no base) still use the
direct lexsort+compress path (_sort_and_compress).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.memstore.common import SECONDS_PER_DAY
from aresdb_tpu_torch.memstore.primary_key import build_keys
from aresdb_tpu_torch.memstore.vector_party import ArchiveVectorParty
from aresdb_tpu_torch.utils import clock


class ArchiveJobStats:
    def __init__(self):
        self.rows_archived = 0
        self.days = 0
        self.batches_purged = 0


# ---------------------------------------------------------------------------
# column gathering helpers
# ---------------------------------------------------------------------------

def _is_array_column(col) -> bool:
    return getattr(col, "is_array", False) or col.data_type == mdt.GeoShape


def _gather_live_columns(shard, row_sel: List[Tuple[int, np.ndarray]],
                         column_ids: List[int]):
    """Gather (values, validity) per column for selected live rows.

    row_sel: [(batch_id, row_indices)] in iteration order.
    """
    schema = shard.schema
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    total = sum(len(idx) for _, idx in row_sel)
    for cid in column_ids:
        col = schema.table.columns[cid]
        if _is_array_column(col):
            values = np.empty(total, object)
            validity = np.zeros(total, bool)
            pos = 0
            for batch_id, idx in row_sel:
                vp = shard.live_store.batches[batch_id].column(cid)
                if vp is not None and vp.is_list:
                    for j, r in enumerate(idx.tolist()):
                        item = vp.list_values[r]
                        if item is not None:
                            values[pos + j] = item
                            validity[pos + j] = True
                pos += len(idx)
            out[cid] = (values, validity)
            continue
        npdt = mdt.numpy_dtype(col.data_type)
        lanes = mdt.lanes(col.data_type)
        shape = (total, 2) if lanes == 2 else (total,)
        values = np.zeros(shape, npdt)
        validity = np.zeros(total, bool)
        pos = 0
        for batch_id, idx in row_sel:
            n = len(idx)
            vp = shard.live_store.batches[batch_id].column(cid)
            if vp is not None and vp.values is not None:
                values[pos:pos + n] = vp.values[idx]
                validity[pos:pos + n] = vp.validity[idx]
            elif col.default_value is not None:
                v = mdt.parse_value(col.default_value, col.data_type)
                if lanes == 2:
                    values[pos:pos + n, 0] = v[0]
                    values[pos:pos + n, 1] = v[1]
                else:
                    values[pos:pos + n] = v
                validity[pos:pos + n] = True
            pos += n
        out[cid] = (values, validity)
    return out


def _expand_archive_columns(batch, column_ids: List[int], schema,
                            n_rows: Optional[int] = None):
    """Expanded (values, validity) per column of an archive batch ('' if empty)."""
    n = 0 if n_rows is None else n_rows
    vps = {}
    for cid in column_ids:
        vp = batch.request_column(cid) if batch is not None else None
        if vp is not None:
            vp = vp.expanded()
            n = max(n, vp.num_rows)
        vps[cid] = vp
    out = {}
    for cid in column_ids:
        col = schema.table.columns[cid]
        vp = vps[cid]
        if _is_array_column(col):
            values = np.empty(n, object)
            validity = np.zeros(n, bool)
            if vp is not None and vp.is_list:
                for i, item in enumerate(vp.list_values):
                    if item is not None:
                        values[i] = item
                        validity[i] = bool(vp.validity[i])
            out[cid] = (values, validity)
            continue
        npdt = mdt.numpy_dtype(col.data_type)
        lanes = mdt.lanes(col.data_type)
        if vp is None or vp.values is None:
            shape = (n, 2) if lanes == 2 else (n,)
            values = np.zeros(shape, npdt)
            validity = np.zeros(n, bool)
            if col.default_value is not None and n:
                v = mdt.parse_value(col.default_value, col.data_type)
                if lanes == 2:
                    values[:, 0], values[:, 1] = v[0], v[1]
                else:
                    values[:] = v
                validity[:] = True
        else:
            values = np.asarray(vp.values)
            validity = np.asarray(vp.validity)
            if len(validity) < n:  # defensive
                pad = n - len(validity)
                values = np.concatenate(
                    [values, np.zeros((pad,) + values.shape[1:], values.dtype)])
                validity = np.concatenate([validity, np.zeros(pad, bool)])
        out[cid] = (values, validity)
    return out, n


def _orderable_lane(values: np.ndarray) -> np.ndarray:
    """Monotone UNSIGNED representation of one sort lane: unsigned ints
    pass through, signed ints flip the sign bit, floats use the IEEE
    total-order trick (so NaNs order deterministically by their bit
    pattern instead of np.lexsort's all-NaN-last vs memcmp's split-by-sign
    disagreement). Integer order of the result == memcmp order of its
    big-endian bytes == the archive sort order of the lane."""
    v = np.ascontiguousarray(values)
    if v.dtype == np.bool_:
        return v.astype(np.uint8)
    if v.dtype.kind == "f":
        w = v.dtype.itemsize
        v = v + v.dtype.type(0)  # -0.0 → +0.0
        u = v.view(f"u{w}")
        sign = np.uint64(1) << np.uint64(w * 8 - 1)
        return np.where(u & u.dtype.type(sign), ~u, u | u.dtype.type(sign))
    if v.dtype.kind == "i":
        w = v.dtype.itemsize
        return v.view(f"u{w}") ^ np.uint64(1 << (w * 8 - 1)).astype(f"u{w}")
    return v


def _lexsort_order(columns: Dict[int, Tuple[np.ndarray, np.ndarray]],
                   sort_cols: List[int]) -> np.ndarray:
    """Stable row order by the sort columns. Per column, validity is the
    MOST significant lane: NULL sorts before ANY value, negatives included
    (reference memstore/common/data_value.go:150 CompareBool(Valid,
    Valid)). Lanes sort by their _orderable_lane representation so the
    order is EXACTLY the memcmp order of _sort_key_matrix — both the
    compress path and the streaming merge derive run boundaries from the
    same ordering (NaN payloads included)."""
    keys = []
    for cid in sort_cols:
        values, validity = columns[cid]
        keys.append(validity.astype(np.uint8))
        if values.ndim == 2:
            keys.append(_orderable_lane(values[:, 1]))
            keys.append(_orderable_lane(values[:, 0]))
        else:
            keys.append(_orderable_lane(values))
    return np.lexsort(keys[::-1])


def _sort_and_compress(columns: Dict[int, Tuple[np.ndarray, np.ndarray]],
                       sort_cols: List[int], n: int,
                       dtypes: Dict[int, int]
                       ) -> Dict[int, ArchiveVectorParty]:
    """Stable lexsort by sort columns, mode-3 compress the sorted prefix.

    Compression parity with the reference (memstore/merge.go): sort column k
    stores one entry per distinct (col_0..col_k) prefix run with a cumulative
    count vector; non-sort columns stay row-per-entry (mode 0/1/2), nulls
    sort before values within each parent run.
    """
    if n == 0:
        return {}
    order = (_lexsort_order(columns, sort_cols) if sort_cols
             else np.arange(n))

    out: Dict[int, ArchiveVectorParty] = {}
    prefix_change = np.zeros(n, bool)
    prefix_change[0] = True
    for k, cid in enumerate(sort_cols):
        values, validity = columns[cid]
        sv = values[order]
        sb = validity[order]
        # run detection on the orderable representation: raw float compare
        # would split every NaN into its own run (NaN != NaN) while the
        # merge's memcmp keys treat equal NaN payloads as one run
        change = np.zeros(n, bool)
        if sv.ndim == 2:
            change[1:] = (
                (_orderable_lane(sv[:, 0])[1:]
                 != _orderable_lane(sv[:, 0])[:-1])
                | (_orderable_lane(sv[:, 1])[1:]
                   != _orderable_lane(sv[:, 1])[:-1]))
        else:
            ov = _orderable_lane(sv)
            change[1:] = ov[1:] != ov[:-1]
        change[1:] |= sb[1:] != sb[:-1]
        prefix_change |= change
        starts = np.nonzero(prefix_change)[0]
        counts = np.zeros(len(starts) + 1, np.uint32)
        counts[1:] = np.append(starts[1:], n)
        out[cid] = ArchiveVectorParty(
            dtypes[cid], values=sv[starts],
            validity=sb[starts], counts=counts)
    for cid, (values, validity) in columns.items():
        if cid in out:
            continue
        if values.dtype == object:   # array/GeoShape columns: list VP
            sv = values[order]
            sb = validity[order]
            out[cid] = ArchiveVectorParty(
                dtypes[cid], values=None, validity=sb,
                list_values=[sv[i] if sb[i] else None
                             for i in range(len(sb))])
            continue
        out[cid] = ArchiveVectorParty(
            dtypes[cid], values=values[order],
            validity=validity[order])
    return out


def _orderable_bytes(values: np.ndarray, validity: np.ndarray) -> np.ndarray:
    """(n, w+1) uint8 whose memcmp order equals the archive sort order of
    one sort-column lane: validity FIRST (NULL before any value — reference
    memstore/common/data_value.go:150), then raw value ascending (matches
    _sort_and_compress's key construction exactly).

    Signed ints flip the sign bit; floats use the IEEE total-order trick
    (negatives bit-flipped, positives sign-bit set); everything lands in
    big-endian unsigned so np.void memcmp == lexicographic compare.
    """
    iv = _orderable_lane(values)
    n = len(iv)
    w = iv.dtype.itemsize
    be = np.ascontiguousarray(iv.astype(f">u{w}")).view(np.uint8)
    be = be.reshape(n, w)
    out = np.empty((n, w + 1), np.uint8)
    out[:, 0] = validity.astype(np.uint8)
    out[:, 1:] = be
    return out


def _sort_key_matrix(columns: Dict[int, Tuple[np.ndarray, np.ndarray]],
                     sort_cols: List[int]) -> np.ndarray:
    """Concatenated orderable bytes over the sort columns — one (n, K)
    uint8 matrix whose row-wise memcmp order is the archive sort order.
    2-lane types contribute the high lane before the low lane (same
    significance order as _sort_and_compress)."""
    parts = []
    for cid in sort_cols:
        values, validity = columns[cid]
        if values.ndim == 2:
            # [validity, hi bytes, lo bytes] — validity leads the column
            parts.append(_orderable_bytes(values[:, 1], validity))
            parts.append(_orderable_bytes(values[:, 0], validity)[:, 1:])
        else:
            parts.append(_orderable_bytes(values, validity))
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


def _as_sortable_void(mat: np.ndarray) -> np.ndarray:
    mat = np.ascontiguousarray(mat)
    return mat.view(np.dtype((np.void, mat.shape[1]))).ravel()


def _rows_lex_sorted(mat: np.ndarray) -> bool:
    """True if the rows of a uint8 key matrix are lexicographically
    non-decreasing (vectorized: the first differing byte of each adjacent
    pair must increase)."""
    if len(mat) < 2:
        return True
    a, b = mat[:-1], mat[1:]
    diff = a != b
    any_diff = diff.any(axis=1)
    col = np.argmax(diff, axis=1)
    rows = np.arange(len(col))
    return bool(np.all(~any_diff | (b[rows, col] >= a[rows, col])))


def _merge_positions(base_keys: np.ndarray, patch_keys: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Output row index for each base row and each (sorted) patch row when
    merging two sorted runs; ties place base rows first (stable, matching
    the reference merge's base-precedes-patch iteration, merge.go:333)."""
    bk = _as_sortable_void(base_keys)
    pk = _as_sortable_void(patch_keys)
    base_pos = np.arange(len(bk), dtype=np.int64) + np.searchsorted(
        pk, bk, side="left")
    patch_pos = np.arange(len(pk), dtype=np.int64) + np.searchsorted(
        bk, pk, side="right")
    return base_pos, patch_pos


class _StreamingDayMerge:
    """Bounded-memory merge of a sorted base day batch with a day's patch.

    The reference's two-pass trick (memstore/merge.go:333): pass 1 reads
    only the SORT columns to compute the merged row placement; pass 2
    materializes one column at a time. Peak transient memory is the patch
    plus one expanded base column (+ the narrow key matrices), instead of
    the whole expanded base times two that a full rebuild costs.
    """

    def __init__(self, base_batch, patch: Dict[int, tuple], n_patch: int,
                 sort_cols: List[int], schema, dtypes: Dict[int, int]):
        self.base_batch = base_batch
        self.schema = schema
        self.dtypes = dtypes
        self.sort_cols = sort_cols
        self.patch = patch
        self.n_patch = n_patch

        # pass 1a: sort the patch (patch-sized lexsort, shared null-first
        # key order)
        self.order_p = (_lexsort_order(patch, sort_cols) if sort_cols
                        else np.arange(n_patch))

        # pass 1b: placement from the sort columns only
        base_sort_cols, self.n_base = _expand_archive_columns(
            base_batch, sort_cols, schema,
            n_rows=base_batch.size if base_batch is not None else 0)
        self.base_reorder: Optional[np.ndarray] = None
        if sort_cols:
            base_keys = _sort_key_matrix(base_sort_cols, sort_cols)
            if not _rows_lex_sorted(base_keys):
                # base written under a different (pre-null-first) key
                # encoding: re-sort it once (stable, so same-key base rows
                # keep their relative order) instead of silently merging
                # against a non-ascending run and corrupting placement
                self.base_reorder = np.argsort(
                    _as_sortable_void(base_keys), kind="stable")
                base_keys = base_keys[self.base_reorder]
            patch_keys = _sort_key_matrix(
                {c: (v[self.order_p], b[self.order_p])
                 for c, (v, b) in ((c, patch[c]) for c in sort_cols)},
                sort_cols)
            self.base_pos, self.patch_pos = _merge_positions(
                base_keys, patch_keys)
            merged_keys = np.empty(
                (self.n_base + n_patch, base_keys.shape[1]), np.uint8)
            merged_keys[self.base_pos] = base_keys
            merged_keys[self.patch_pos] = patch_keys
        else:
            self.base_pos = np.arange(self.n_base, dtype=np.int64)
            self.patch_pos = self.n_base + np.arange(n_patch, dtype=np.int64)
            merged_keys = None
        self.n_total = self.n_base + n_patch

        # run boundaries per sort column from the merged key matrix: the
        # byte span of columns 0..k changes exactly where the (col_0..col_k)
        # prefix changes — the same cumulative-prefix runs the full lexsort
        # rebuild derives from re-sorted values
        self.starts: Dict[int, np.ndarray] = {}
        if sort_cols and self.n_total:
            width = 0
            change = np.zeros(self.n_total, bool)
            change[0] = True
            for cid in sort_cols:
                values, _ = self.patch[cid]
                # _sort_key_matrix widths: 1-lane = 1+w bytes (validity +
                # value); 2-lane = 1+w (validity + hi) + w (lo)
                w = values.dtype.itemsize
                w_col = (2 * w + 1) if values.ndim == 2 else (w + 1)
                change[1:] |= np.any(
                    merged_keys[1:, width:width + w_col]
                    != merged_keys[:-1, width:width + w_col], axis=1)
                width += w_col
                self.starts[cid] = np.nonzero(change)[0]
        del merged_keys

    def merged_column(self, cid: int) -> ArchiveVectorParty:
        """Materialize ONE merged column (pass 2) and compress it if it is
        a sort column."""
        base_col, _ = _expand_archive_columns(
            self.base_batch, [cid], self.schema, n_rows=self.n_base) \
            if self.n_base else ({}, 0)
        pv, pb = self.patch[cid]
        pv = pv[self.order_p]
        pb = pb[self.order_p]
        is_obj = pv.dtype == object
        if self.n_base:
            bv, bb = base_col[cid]
            if self.base_reorder is not None:
                bv, bb = bv[self.base_reorder], bb[self.base_reorder]
            is_obj = is_obj or bv.dtype == object
            out_v = (np.empty(self.n_total, object) if is_obj else
                     np.zeros((self.n_total,) + bv.shape[1:], bv.dtype))
            out_b = np.zeros(self.n_total, bool)
            out_v[self.base_pos] = bv
            out_b[self.base_pos] = bb
        else:
            out_v = (np.empty(self.n_total, object) if is_obj else
                     np.zeros((self.n_total,) + pv.shape[1:], pv.dtype))
            out_b = np.zeros(self.n_total, bool)
        out_v[self.patch_pos] = pv
        out_b[self.patch_pos] = pb
        if is_obj:
            return ArchiveVectorParty(
                self.dtypes[cid], values=None, validity=out_b,
                list_values=[out_v[i] if out_b[i] else None
                             for i in range(self.n_total)])
        if cid in self.starts:
            starts = self.starts[cid]
            counts = np.zeros(len(starts) + 1, np.uint32)
            counts[1:] = np.append(starts[1:], self.n_total)
            return ArchiveVectorParty(
                self.dtypes[cid], values=out_v[starts],
                validity=out_b[starts], counts=counts)
        return ArchiveVectorParty(self.dtypes[cid], values=out_v,
                                  validity=out_b)


class Archiver:
    """Runs archiving / backfill / snapshot / purge for one TableShard."""

    def __init__(self, shard, metastore, diskstore):
        self.shard = shard
        self.metastore = metastore
        self.diskstore = diskstore
        self.lock = threading.RLock()

    # -- archiving (fact tables) ---------------------------------------

    def archive(self, new_cutoff: int) -> ArchiveJobStats:
        """Move records with event time in [old_cutoff, new_cutoff) to archive.

        Reference: memstore/archiving.go:251 Archive.
        """
        shard = self.shard
        schema = shard.schema
        stats = ArchiveJobStats()
        if not schema.table.is_fact_table:
            raise ValueError("archiving applies to fact tables only")
        live = shard.live_store
        old_cutoff = live.archiving_cutoff_high_watermark
        if new_cutoff <= old_cutoff:
            return stats

        dtypes = {i: c.data_type
                  for i, c in enumerate(schema.table.columns)}
        all_cols = [i for i, c in enumerate(schema.table.columns)
                    if not c.deleted]
        sort_cols = list(schema.table.archiving_sort_columns)

        # Advance the high watermark UNDER THE WRITER LOCK **BEFORE**
        # snapshotting, so ingestion redirects every new sub-cutoff row to
        # the backfill queue from this point on (reference archiving.go:283
        # "so ingestion won't update records below the new target cutoff").
        # Advancing it after the snapshot loses rows: an ingest that
        # classified against the old watermark could append a [old, new)
        # row to live AFTER the snapshot — hidden by the published cutoff,
        # never archived. Found by tests/test_race_harness.py's storm.
        # Queries stay consistent throughout: they filter live rows by the
        # CURRENT VERSION's cutoff (still old until the swap below), so
        # rows captured in the snapshot remain visible exactly once.
        with shard.writer_lock:
            with live.lock:
                live.archiving_cutoff_high_watermark = new_cutoff
                live.primary_key.update_event_time_cutoff(new_cutoff)
                snapshots = [(bid, live.visible_rows_in_batch(bid),
                              live.batches[bid])
                             for bid in live.get_batch_ids()]

        # select rows to archive, grouped by day
        day_rows: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        batch_max_time: Dict[int, int] = {}
        for bid, n, batch in snapshots:
            tvp = batch.column(0)
            if tvp is None or tvp.values is None or n == 0:
                continue
            t = tvp.values[:n].astype(np.int64)
            batch_max_time[bid] = int(t.max()) if n else 0
            sel = (t >= old_cutoff) & (t < new_cutoff) & tvp.validity[:n]
            if not sel.any():
                continue
            days = t[sel] // SECONDS_PER_DAY
            idx = np.nonzero(sel)[0]
            for day in np.unique(days):
                day_rows.setdefault(int(day), []).append(
                    (bid, idx[days == day]))

        version = shard.archive_store.get_current_version()
        from aresdb_tpu_torch.memstore.archive_store import (
            ArchiveBatch, ArchiveStoreVersion)
        new_version = ArchiveStoreVersion(new_cutoff, shard.archive_store)
        new_version.batches.update(version.batches)

        for day, row_sel in sorted(day_rows.items()):
            patch = _gather_live_columns(shard, row_sel, all_cols)
            n_patch = sum(len(i) for _, i in row_sel)
            base_batch = version.batches.get(day)
            n_base = base_batch.size if base_batch is not None else 0

            old = version.batches.get(day)
            seq = (old.seq + 1) if (old is not None and
                                    old.version == new_cutoff) else 0
            n_total = n_base + n_patch
            nb = ArchiveBatch(day, new_cutoff, seq, n_total,
                              shard.archive_store)

            def _emit(cid, vp):
                self.diskstore.write_archive_column(
                    schema.table.name, shard.shard_id, day, new_cutoff, seq,
                    cid, vp.to_bytes())
                nb.set_column(cid, vp)

            if n_base:
                # streaming two-pass merge: placement from sort columns,
                # then one column materialized at a time (merge.go:333)
                m = _StreamingDayMerge(base_batch, patch, n_patch,
                                       sort_cols, schema, dtypes)
                for cid in all_cols:
                    _emit(cid, m.merged_column(cid))
            else:
                for cid, vp in _sort_and_compress(
                        patch, sort_cols, n_patch, dtypes).items():
                    _emit(cid, vp)
            self.metastore.add_archive_batch_version(
                schema.table.name, shard.shard_id, day, new_cutoff, seq,
                n_total)
            new_version.batches[day] = nb
            stats.days += 1
            stats.rows_archived += n_patch

        # publish: cutoff + version swap + live purge (the watermark and PK
        # expiry advanced up front, before the snapshot)
        self.metastore.update_archiving_cutoff(
            schema.table.name, shard.shard_id, new_cutoff)
        shard.archive_store.swap_version(new_version)
        with live.lock:
            last = live.last_read_record
            for bid in sorted(live.batches):
                if bid >= last.batch_id:
                    break
                if batch_max_time.get(bid, 1 << 62) < new_cutoff:
                    del live.batches[bid]

        # redolog checkpoint: files fully below the cutoff are obsolete once
        # backfill progress covers them (redolog_manager.go CheckpointRedolog)
        if shard.redolog_manager is not None:
            bm = shard.backfill_manager
            rf, off = ((bm.last_redo_file, bm.last_batch_offset)
                       if bm is not None else (1 << 62, 0))
            shard.redolog_manager.checkpoint(new_cutoff, rf, off)
        return stats

    # -- backfill (late records into archive batches) -------------------

    def backfill(self) -> int:
        """Apply queued pre-cutoff upserts into their day batches.

        Reference: memstore/backfill.go:30 — per-day patches; PK-matched rows
        update in place, new keys append; the batch is then re-sorted/
        compressed and written as a new seq. Vectorized: rows flatten into
        per-column patch arrays, key matching is one void-dtype searchsorted
        against the base, and dup-key last-valid-wins falls out of numpy
        fancy-assignment ordering (backfill.go applies rows sequentially —
        same result).
        """
        shard = self.shard
        schema = shard.schema
        bm = shard.backfill_manager
        if bm is None or not bm.qualifies_for_backfill():
            return 0
        queued, redo_file, batch_offset = bm.drain()
        if not queued:
            return 0

        from aresdb_tpu_torch.memstore.native_primary_key import build_key_matrix
        from aresdb_tpu_torch.memstore.primary_key import (
            key_columns_from_batch_columns)

        dtypes = {i: c.data_type
                  for i, c in enumerate(schema.table.columns)}
        all_cols = [i for i, c in enumerate(schema.table.columns)
                    if not c.deleted]
        sort_cols = list(schema.table.archiving_sort_columns)
        key_ids = schema.table.primary_key_columns
        array_cols = {cid for cid in all_cols
                      if _is_array_column(schema.table.columns[cid])}
        scalar_cols = [cid for cid in all_cols if cid not in array_cols]

        # group queued rows by day
        day_groups: Dict[int, List[Tuple[object, np.ndarray]]] = {}
        for batch, rows in queued:
            cols_by_id = {c.column_id: c for c in batch.columns}
            tcol = cols_by_id.get(0)
            if tcol is None or tcol.values is None:
                continue
            t = tcol.values[rows].astype(np.int64)
            days = t // SECONDS_PER_DAY
            for day in np.unique(days):
                day_groups.setdefault(int(day), []).append(
                    (batch, rows[days == day]))

        version = shard.archive_store.get_current_version()
        from aresdb_tpu_torch.memstore.archive_store import (
            ArchiveBatch, ArchiveStoreVersion)
        new_version = ArchiveStoreVersion(version.archiving_cutoff,
                                          shard.archive_store)
        new_version.batches.update(version.batches)
        applied = 0

        def _as_void(mat: np.ndarray) -> np.ndarray:
            mat = np.ascontiguousarray(mat)
            return mat.view(np.dtype((np.void, mat.shape[1]))).ravel()

        for day, groups in sorted(day_groups.items()):
            base_batch = version.batches.get(day)
            base_cols, n_base = _expand_archive_columns(
                base_batch, all_cols, schema)

            # -- flatten this day's queued rows into patch arrays (queue
            #    order preserved: later rows override earlier on dup keys) --
            m = sum(len(rows) for _, rows in groups)
            pvals: Dict[int, np.ndarray] = {}
            pvalid: Dict[int, np.ndarray] = {}
            for cid in scalar_cols:
                npdt = mdt.numpy_dtype(dtypes[cid])
                shape = (m, 2) if mdt.lanes(dtypes[cid]) == 2 else (m,)
                pvals[cid] = np.zeros(shape, npdt)
                pvalid[cid] = np.zeros(m, bool)
            for cid in array_cols:
                pvals[cid] = np.empty(m, object)
                pvalid[cid] = np.zeros(m, bool)
            key_mats = []
            kvalid_all = np.zeros(m, bool)
            pos = 0
            for batch, rows in groups:
                nb_rows = len(rows)
                cols_by_id = {c.column_id: c for c in batch.columns}
                kcols, kvalid = key_columns_from_batch_columns(
                    key_ids, cols_by_id, batch.num_rows)
                key_mats.append(build_key_matrix(
                    [np.ascontiguousarray(k[rows]) for k in kcols],
                    nb_rows))
                kvalid_all[pos:pos + nb_rows] = np.asarray(kvalid)[rows]
                for cid in scalar_cols:
                    col = cols_by_id.get(cid)
                    if col is not None and col.values is not None:
                        pvals[cid][pos:pos + nb_rows] = col.values[rows]
                        pvalid[cid][pos:pos + nb_rows] = col.validity[rows]
                for cid in array_cols:
                    col = cols_by_id.get(cid)
                    if col is None:
                        continue
                    # wire arrays live in col.array_values (values is None)
                    items = (col.array_values if col.is_array
                             else col.values)
                    if items is None:
                        continue
                    for j, r in enumerate(rows.tolist()):
                        if col.validity[r] and items[r] is not None:
                            pvals[cid][pos + j] = items[r]
                            pvalid[cid][pos + j] = True
                pos += nb_rows

            valid_idx = np.nonzero(kvalid_all)[0]
            applied += int(valid_idx.size)
            if valid_idx.size == 0:
                continue
            patch_keys = _as_void(np.vstack(key_mats)[valid_idx])

            # -- match patch keys against the (unique-key) base --
            if n_base:
                base_keys = _as_void(build_key_matrix(
                    [np.ascontiguousarray(base_cols[cid][0])
                     for cid in key_ids], n_base))
                base_order = np.argsort(base_keys)
                sorted_base = base_keys[base_order]
                loc = np.searchsorted(sorted_base, patch_keys)
                loc_cl = np.minimum(loc, n_base - 1)
                hit = sorted_base[loc_cl] == patch_keys
                dest = np.where(hit, base_order[loc_cl], -1).astype(np.int64)
            else:
                hit = np.zeros(patch_keys.size, bool)
                dest = np.full(patch_keys.size, -1, np.int64)

            # appends: one slot per distinct new key, first-occurrence order
            uniq_new, first_idx, inv = np.unique(
                patch_keys[~hit], return_index=True, return_inverse=True)
            slot_rank = np.empty(len(uniq_new), np.int64)
            slot_rank[np.argsort(first_idx)] = np.arange(len(uniq_new))
            dest[~hit] = n_base + slot_rank[inv]
            n_appends = len(uniq_new)
            n_total = n_base + n_appends

            # -- apply per column: extend base, masked-assign in queue order
            #    (duplicate dests: numpy keeps the LAST write, i.e. the
            #    latest queued value — sequential upsert semantics) --
            merged = {}
            for cid in all_cols:
                bv, bb = base_cols[cid]
                pv = pvals[cid][valid_idx]
                pb = pvalid[cid][valid_idx]
                if cid in array_cols:
                    nv = np.empty(n_total, object)
                    nv[:n_base] = bv[:n_base] if len(bv) >= n_base else None
                else:
                    nv = np.zeros((n_total,) + bv.shape[1:], bv.dtype)
                    nv[:n_base] = bv
                nbv = np.zeros(n_total, bool)
                nbv[:n_base] = bb
                if cid in key_ids:
                    # key columns identify the row — updates never touch them
                    write = np.nonzero(pb & ~hit)[0]
                else:
                    # scalar AND array columns take patch values; rows whose
                    # patch does not carry the column (pb False) keep the
                    # base value (reference backfill.go array in-place/fork)
                    write = np.nonzero(pb)[0]
                nv[dest[write]] = pv[write]
                nbv[dest[write]] = True
                merged[cid] = (nv, nbv)
            vps = _sort_and_compress(merged, sort_cols, n_total, dtypes)

            old = version.batches.get(day)
            ver = version.archiving_cutoff
            seq = (old.seq + 1) if (old is not None and old.version == ver) else 0
            for cid, vp in vps.items():
                self.diskstore.write_archive_column(
                    schema.table.name, shard.shard_id, day, ver, seq, cid,
                    vp.to_bytes())
            self.metastore.add_archive_batch_version(
                schema.table.name, shard.shard_id, day, ver, seq, n_total)
            nb = ArchiveBatch(day, ver, seq, n_total, shard.archive_store)
            for cid, vp in vps.items():
                nb.set_column(cid, vp)
            new_version.batches[day] = nb

        shard.archive_store.swap_version(new_version)
        self.metastore.update_backfill_progress(
            schema.table.name, shard.shard_id, redo_file, batch_offset)
        return applied

    # -- snapshot (dimension tables) ------------------------------------

    def snapshot(self) -> int:
        """Dump the dimension table's live store to disk.

        Reference: memstore/snapshot.go:25 Snapshot.
        """
        shard = self.shard
        schema = shard.schema
        sm = shard.snapshot_manager
        if sm is None:
            return 0
        with sm.lock:
            redo_file = sm.last_redo_file
            offset = sm.last_batch_offset
            pending = sm.num_mutations
            record = sm.last_record
        if pending == 0:
            return 0
        live = shard.live_store
        rows = 0
        with live.lock:
            snapshots = [(bid, live.visible_rows_in_batch(bid),
                          live.batches[bid]) for bid in live.get_batch_ids()]
        for bid, n, batch in snapshots:
            if n == 0:
                continue
            for cid, col in enumerate(schema.table.columns):
                if col.deleted:
                    continue
                vp = batch.column(cid)
                if vp is None:
                    continue
                avp = vp.slice(n)
                self.diskstore.write_snapshot_column(
                    schema.table.name, shard.shard_id, redo_file, offset,
                    bid, cid, avp.to_bytes())
            rows += n
        self.metastore.update_snapshot_progress(
            schema.table.name, shard.shard_id, redo_file, offset,
            record.batch_id, record.index)
        self.diskstore.delete_snapshot(
            schema.table.name, shard.shard_id, redo_file, offset)
        sm.done(redo_file, offset, pending)
        if shard.redolog_manager is not None:
            shard.redolog_manager.checkpoint(1 << 62, redo_file, offset)
        return rows

    # -- purge ----------------------------------------------------------

    def purge(self, now_ts: Optional[int] = None) -> int:
        """Drop archive batches beyond retention (memstore/purge.go:23)."""
        shard = self.shard
        schema = shard.schema
        retention_days = schema.table.config.record_retention_in_days
        if not schema.table.is_fact_table or retention_days <= 0:
            return 0
        now_ts = now_ts or clock.now_unix()
        cutoff_day = now_ts // SECONDS_PER_DAY - retention_days
        version = shard.archive_store.get_current_version()
        purged = [bid for bid in version.batches if bid < cutoff_day]
        if not purged:
            return 0
        from aresdb_tpu_torch.memstore.archive_store import ArchiveStoreVersion
        new_version = ArchiveStoreVersion(version.archiving_cutoff,
                                          shard.archive_store)
        new_version.batches.update(
            {bid: b for bid, b in version.batches.items()
             if bid >= cutoff_day})
        shard.archive_store.swap_version(new_version)
        for bid in purged:
            version.batches[bid].release()  # zero host-memory accounting
            self.diskstore.delete_archive_batch(
                schema.table.name, shard.shard_id, bid)
        self.metastore.purge_archive_batches(
            schema.table.name, shard.shard_id, cutoff_day)
        return len(purged)
