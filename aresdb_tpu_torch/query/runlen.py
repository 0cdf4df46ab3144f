"""Run-length (mode-3) archive aggregation: aggregate the compressed runs
of a sorted archive batch without expanding them.

Port of `aresdb_tpu/query/runlen.py`; the planning half is the JAX
package's, unchanged. Composite run boundaries come from the union of the
used compressed columns' count vectors (host side, cached per column set
and row slice); filters and dims whose columns are all compressed
evaluate once per run; a row-level measure sums over each run's
contiguous rows (kernels.make_runlen_agg_kernel); and the group-by takes
per-run (key, weighted measure, weighted count) lanes, n_runs in place of
n rows, through kernels.reduce_by_key_weighted (K2 where the groups fit
the runtime-dense slot budget). Reference semantics: the compressed
iteration of query/iterator.hpp:214-240.

Eligibility (per batch): sum/count/avg aggregates; no geo; every dim's
columns compressed in THIS batch and untouched by row-level exprs; each
filter purely run-level or purely row-level (row-level filters weight the
per-run sums through the row mask). Everything else takes the
expand-on-stage path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np

from aresdb_tpu_torch.query import expr as E
from aresdb_tpu_torch.query.compiler import CompiledQuery


@dataclass(frozen=True)
class RunLenSpec:
    """Static per-(plan, batch-compression-pattern) kernel configuration."""

    run_cols: Tuple[int, ...]      # main col ids staged per-RUN
    row_cols: Tuple[int, ...]      # main col ids staged per-ROW
    run_filters: Tuple[int, ...]   # indices into plan.filters+time_filter
    row_filters: Tuple[int, ...]
    measure_level: str             # "run" | "row"

    def key(self) -> tuple:
        return (self.run_cols, self.row_cols, self.run_filters,
                self.row_filters, self.measure_level)


@dataclass
class RunLenInfo:
    """Per-batch dynamic staging facts."""

    spec: RunLenSpec
    n_runs: int
    n_runs_pad: int


def _expr_main_cols(plan: CompiledQuery, node) -> FrozenSet[int]:
    """Main-table columns an expression depends on; foreign-table refs
    resolve through their join-key expression's main columns."""
    cols = set()

    def visit(n):
        if isinstance(n, E.VarRef):
            if n.table_id == 0:
                cols.add(n.column_id)
            else:
                fidx = plan.table_id_to_foreign[n.table_id]
                ft = plan.foreign_tables[fidx]
                cols.update(_expr_main_cols(plan, ft.main_key_expr))

    E.walk(node, visit)
    return frozenset(cols)


def plan_runlen(plan: CompiledQuery, vps: Dict[int, object]
                ) -> Optional[RunLenSpec]:
    """Classify the plan's expressions for THIS batch's compression
    pattern; None = ineligible (caller expands as before)."""
    m = plan.measure
    if m is None or m.agg not in ("sum", "count", "avg"):
        return None
    if plan.is_non_agg or plan.geo is not None:
        return None
    if not plan.dimensions:
        return None  # no-dims: 1-slot dense on expanded rows is fine
    # compressed set: columns whose VP is mode-3 in this batch; missing
    # (default-valued) columns are constant, i.e. trivially run-stageable
    comp = set()
    for cid, vp in vps.items():
        if vp is None:
            comp.add(cid)
        elif getattr(vp, "is_list", False):
            return None
        elif vp.is_compressed and vp.values is not None and \
                vp.values.ndim == 1:
            comp.add(cid)
    if not any(vps.get(c) is not None and
               getattr(vps.get(c), "is_compressed", False) for c in comp):
        return None

    filters = list(plan.filters) + list(plan.time_filter_expr)
    f_cols = [_expr_main_cols(plan, f) for f in filters]
    m_cols = _expr_main_cols(plan, m.expr)
    d_cols = [_expr_main_cols(plan, d.expr) for d in plan.dimensions]

    # fixed point: row_set grows until filter classification stabilizes
    measure_level = "run" if m_cols <= comp else "row"
    row_set = set() if measure_level == "run" else set(m_cols)
    while True:
        run_f, row_f = [], []
        new_row = set(row_set)
        for i, fc in enumerate(f_cols):
            if fc <= comp and not (fc & row_set):
                run_f.append(i)
            else:
                row_f.append(i)
                new_row |= fc
        if new_row == row_set:
            break
        row_set = new_row
    if measure_level == "run" and (m_cols & row_set):
        measure_level = "row"
        row_set |= m_cols
        # re-run the filter fixed point with the widened row set
        while True:
            run_f, row_f = [], []
            new_row = set(row_set)
            for i, fc in enumerate(f_cols):
                if fc <= comp and not (fc & row_set):
                    run_f.append(i)
                else:
                    row_f.append(i)
                    new_row |= fc
            if new_row == row_set:
                break
            row_set = new_row
    # every dim must be purely run-level
    for dc in d_cols:
        if not (dc <= comp) or (dc & row_set):
            return None
    used = set(plan.used_columns)
    run_cols = tuple(sorted((used & comp) - row_set))
    row_cols = tuple(sorted(used - set(run_cols)))
    return RunLenSpec(run_cols=run_cols, row_cols=row_cols,
                      run_filters=tuple(run_f), row_filters=tuple(row_f),
                      measure_level=measure_level)


def composite_boundaries(vps: Dict[int, object], run_cols, lo: int,
                         hi: int) -> np.ndarray:
    """Row offsets (ascending, includes lo and hi) where any run-staged
    column changes value — the composite run boundary set. Mirrors the
    reference's per-column base-counts, unioned (iterator.hpp:214)."""
    parts = [np.asarray([lo, hi], np.int64)]
    for cid in run_cols:
        vp = vps.get(cid)
        if vp is None or not getattr(vp, "is_compressed", False):
            continue  # constant or absent: no boundaries of its own
        counts = vp.counts.astype(np.int64)
        e0 = int(np.searchsorted(counts, lo, "right"))
        e1 = int(np.searchsorted(counts, hi, "left"))
        parts.append(counts[e0:e1])
    b = np.unique(np.concatenate(parts))
    return b[(b >= lo) & (b <= hi)]


def run_values_at(vp, starts: np.ndarray):
    """Per-composite-run (values, validity) of one run-staged column: the
    entry each run's first row falls in."""
    if not vp.is_compressed:
        # only compressed or missing columns classify as run-level
        raise AssertionError("run-level staging of uncompressed column")
    counts = vp.counts.astype(np.int64)
    idx = np.searchsorted(counts, starts, "right") - 1
    idx = np.clip(idx, 0, len(vp.validity) - 1)
    return vp.values[idx], vp.validity[idx]
