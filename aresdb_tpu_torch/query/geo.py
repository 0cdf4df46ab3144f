"""Geo intersection: batch point-in-polygon on torch tensors.

Port of `aresdb_tpu/query/geo.py`. Reference: query/geo_intersects.cu
(ray casting, one thread per (point, edge), atomicXor into per-shape
parity bits) and query/iterator.hpp:1322 GeoBatchIntersectIterator (the
exact crossing test).

The host half is the JAX package's: every shape's edges flattened in
ring order, each shape's run padded to a BLOCK multiple with degenerate
edges (lng1 == lng2 == 0, which the crossing test rejects), the block
count padded to a multiple of 8, float32 slopes precomputed on the host,
and, for the bbox-pruned route, conservative per-shape bounds. Two routes
answer each point's first matching shape, bit for bit alike:

- `matched_shape`, the dense sweep: the crossing test of every point
  against every edge, in row chunks that bound the [chunk, E]
  intermediates, with the crossings counted per shape in integers.
- `matched_shape_pruned`, the bbox walk: each point's bbox candidates in
  shape order, each candidate's edge slab gathered in float32 and put to
  the same test; the first candidate with odd parity wins.

The crossing test is the reference's cancellation-free form
((lng1 > p) != (lng2 > p)) & (lat < slope * (p - lng1) + lat1), computed
in float32 as separate tensor ops (no fused multiply-add), which is what
makes the routes bit-equal and the JAX package's near-edge precision
guard (tests/test_geo.py's steep edge) hold.

Not carried over, by design: the JAX package's 3 x bfloat16 split of the
edge slab (`tab3`), which exists to gather through the TPU's matrix unit
(a plain float32 gather is exact and needs no `ml_dtypes`), the one-hot
block -> shape matmul that counts crossings (integer sums here), and the
`lax.map` row tiles of 1,024 points.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from aresdb_tpu_torch.utils.torch_env import fetch_to_host

MAX_SHAPES = 256        # reference uses an 8-bit shape index (uint8)
BLOCK = 32              # edges per block: each block belongs to one shape

# bbox-pruned route (matched_shape_pruned) eligibility limits, the JAX
# package's
PRUNE_S = 128           # shapes a pruned batch may hold
PRUNE_MAX_EDGES = 128   # per-shape edge slab cap
PRUNE_ROUNDS_CAP = 32   # more bbox candidates than this -> the dense sweep

# elements of the largest [rows, edges] (or [rows, shapes]) intermediate
# one chunk of points builds
CHUNK_ELEMENTS = 1 << 26


@dataclass
class GeoShapeBatch:
    """Host-staged shapes: per-edge line parameters and each block's shape.

    When prune_ok, slab and bbox stage the bbox-pruned route: slab
    [4, e_max, PRUNE_S] float32 holds each shape's edge slab (lng1, lng2,
    lat1, slope rows; degenerate zeros past its edges), bbox [4, PRUNE_S]
    float32 the conservative per-shape (lo_lng, hi_lng, lo_lat - margin,
    hi_lat + margin) bounds (+inf / -inf for no shape: never a candidate).
    """

    slope: np.ndarray       # f32[E]  (lat2-lat1)/(lng2-lng1); 0 if vertical
    lat1: np.ndarray        # f32[E]  edge start latitude
    lng1: np.ndarray        # f32[E]
    lng2: np.ndarray        # f32[E]
    block_shape: np.ndarray  # i64[E/BLOCK] shape of each block, -1 for none
    n_shapes: int
    shape_values: List = field(default_factory=list)  # pk value per shape
    slab: Optional[np.ndarray] = None    # f32 [4, e_max, PRUNE_S]
    bbox: Optional[np.ndarray] = None    # f32 [4, PRUNE_S]
    prune_ok: bool = False


def build_shape_batch(shapes: List[List[List[Tuple[float, float]]]],
                      shape_values: List) -> Optional[GeoShapeBatch]:
    """shapes: per shape, list of rings of (lat, lng) vertices."""
    if not shapes:
        return None
    if len(shapes) > MAX_SHAPES:
        raise ValueError(
            f"geo intersection supports at most {MAX_SHAPES} shapes, "
            f"got {len(shapes)}")
    lat1, lat2, lng1, lng2 = [], [], [], []
    blk_sid = []
    shape_runs = []          # (padded_start, n_real_edges) per shape
    rings_closed = True      # prune path soundness needs closed rings
    for s, polygons in enumerate(shapes):
        n0 = len(lat1)
        for ring in polygons or []:
            if len(ring) >= 2 and tuple(ring[0]) != tuple(ring[-1]):
                rings_closed = False
            for i in range(len(ring) - 1):
                a, b = ring[i], ring[i + 1]
                lat1.append(a[0])
                lat2.append(b[0])
                lng1.append(a[1])
                lng2.append(b[1])
        shape_runs.append((n0, len(lat1) - n0))
        # pad this shape's edge run to a BLOCK multiple with degenerate edges
        while (len(lat1) - n0) % BLOCK:
            lat1.append(0.0)
            lat2.append(0.0)
            lng1.append(0.0)
            lng2.append(0.0)
        blk_sid.extend([s] * ((len(lat1) - n0) // BLOCK))
    if not blk_sid:
        return None
    # pad the block count to a multiple of 8 (empty blocks map to no shape)
    while len(blk_sid) % 8:
        for _ in range(BLOCK):
            lat1.append(0.0)
            lat2.append(0.0)
            lng1.append(0.0)
            lng2.append(0.0)
        blk_sid.append(-1)
    a1, a2 = np.asarray(lat1, np.float32), np.asarray(lat2, np.float32)
    g1, g2 = np.asarray(lng1, np.float32), np.asarray(lng2, np.float32)
    denom = g2 - g1
    vertical = denom == 0
    slope = np.where(vertical, np.float32(0),
                     (a2 - a1) / np.where(vertical, 1, denom)).astype(np.float32)
    batch = GeoShapeBatch(
        slope=slope, lat1=a1, lng1=g1, lng2=g2,
        block_shape=np.asarray(blk_sid, np.int64),
        n_shapes=len(shapes), shape_values=list(shape_values))
    max_edges = max((ne for _, ne in shape_runs), default=0)
    if (rings_closed and 0 < max_edges <= PRUNE_MAX_EDGES
            and len(shapes) <= PRUNE_S):
        _build_prune_tables(batch, shape_runs)
    return batch


def _build_prune_tables(batch: GeoShapeBatch, shape_runs) -> None:
    """Per-shape float32 edge slabs + conservative bboxes.

    bbox soundness (so a skipped (point, shape) pair matches the dense
    test's verdict bit for bit): the straddle test cond1 is pure f32
    comparisons, so p outside [min lng, max lng) exactly yields zero
    crossings. The line test cond2 = lat < slope·(p−lng1)+lat1 rounds, so
    the lat bounds carry a margin ≥ the worst f32 evaluation error of any
    edge line: above hi_lat+margin every cond2 is certainly false (zero
    crossings); below lo_lat−margin every straddling edge's cond2 is
    certainly true, and a CLOSED ring straddles any vertical line an even
    number of times — even parity, i.e. "outside", same as skipping.
    Open rings break the below-case, so build_shape_batch gates on ring
    closure. A non-finite edge parameter keeps the dense route (the JAX
    package's bfloat16 split refuses those values too).
    """
    e_max = max(ne for _, ne in shape_runs)
    e_max = ((e_max + 31) // 32) * 32
    s_dim = PRUNE_S
    tab = np.zeros((4, e_max, s_dim), np.float32)
    bbox = np.zeros((4, s_dim), np.float32)
    bbox[0, :], bbox[1, :] = np.inf, -np.inf     # lo/hi lng: never candidate
    bbox[2, :], bbox[3, :] = np.inf, -np.inf
    eps = np.float64(np.finfo(np.float32).eps)
    for s, (ofs, ne) in enumerate(shape_runs):
        if ne == 0:
            continue
        sl = slice(ofs, ofs + ne)
        tab[0, :ne, s] = batch.lng1[sl]
        tab[1, :ne, s] = batch.lng2[sl]
        tab[2, :ne, s] = batch.lat1[sl]
        tab[3, :ne, s] = batch.slope[sl]
        lngs = np.concatenate([batch.lng1[sl], batch.lng2[sl]])
        lats = batch.lat1[sl].astype(np.float64)
        lo_lng, hi_lng = float(np.min(lngs)), float(np.max(lngs))
        span = np.float64(hi_lng) - np.float64(lo_lng)
        slopes = batch.slope[sl].astype(np.float64)
        worst = np.max(np.abs(slopes) * span + np.abs(lats))
        margin = 16.0 * eps * max(worst, 1.0)
        lat_end = lats + slopes * (batch.lng2[sl].astype(np.float64)
                                   - batch.lng1[sl].astype(np.float64))
        bbox[0, s], bbox[1, s] = lo_lng, hi_lng
        bbox[2, s] = np.float32(min(np.min(lats), np.min(lat_end)) - margin)
        bbox[3, s] = np.float32(max(np.max(lats), np.max(lat_end)) + margin)
    if not np.isfinite(tab).all():
        return
    batch.slab = tab
    batch.bbox = bbox
    batch.prune_ok = True


def empty_shape_batch() -> GeoShapeBatch:
    """Zero-shape placeholder: 8 degenerate blocks of no shape; nothing
    matches."""
    z = np.zeros(8 * BLOCK, np.float32)
    return GeoShapeBatch(slope=z, lat1=z, lng1=z, lng2=z,
                         block_shape=np.full(8, -1, np.int64),
                         n_shapes=0, shape_values=[])


def use_pruned() -> bool:
    """bbox-pruned geo route (ARES_GEO2=0 disables it); its results are
    bit-equal to matched_shape's."""
    return os.environ.get("ARES_GEO2", "") != "0"


@dataclass
class DeviceShapes:
    """A GeoShapeBatch staged on one device: the edge lanes, each block's
    shape (n_shapes for a block of no shape) and, for the pruned route,
    the slabs of the n_shapes shapes as [n_shapes, 4, e_max] (shape-major,
    one gather a candidate) and their bboxes [4, n_shapes]."""

    slope: torch.Tensor
    lat1: torch.Tensor
    lng1: torch.Tensor
    lng2: torch.Tensor
    block_shape: torch.Tensor
    n_shapes: int
    slab: Optional[torch.Tensor] = None
    bbox: Optional[torch.Tensor] = None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.slope, self.lat1, self.lng1, self.lng2,
                             self.block_shape, self.slab, self.bbox)
                   if t is not None)

    def to(self, device: torch.device) -> "DeviceShapes":
        """The same shapes on `device` (a mesh batch's other devices)."""
        def move(t):
            return None if t is None else t.to(device)

        return DeviceShapes(
            slope=move(self.slope), lat1=move(self.lat1),
            lng1=move(self.lng1), lng2=move(self.lng2),
            block_shape=move(self.block_shape), n_shapes=self.n_shapes,
            slab=move(self.slab), bbox=move(self.bbox))


def stage_shapes(batch: GeoShapeBatch, device: torch.device,
                 pruned: bool) -> DeviceShapes:
    """batch on `device`; with the pruned route's tables where `pruned`
    and the batch is eligible."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = batch.n_shapes
    out = DeviceShapes(
        slope=dev(batch.slope), lat1=dev(batch.lat1), lng1=dev(batch.lng1),
        lng2=dev(batch.lng2),
        block_shape=dev(np.where(batch.block_shape < 0, n,
                                 batch.block_shape)),
        n_shapes=n)
    if pruned and batch.prune_ok:
        out.slab = dev(np.transpose(batch.slab[:, :, :n], (2, 0, 1)))
        out.bbox = dev(batch.bbox[:, :n])
    return out


def _crossings(plat, plng, lat1, lng1, lng2, slope) -> torch.Tensor:
    """The reference's crossing test (iterator.hpp:1404) over broadcast
    float32 operands, as separate ops in the JAX package's order."""
    cond1 = (lng1 > plng) != (lng2 > plng)
    line = slope * (plng - lng1)
    line = line + lat1
    return cond1 & (plat < line)


def _row_chunks(n: int, width: int):
    step = max(1, CHUNK_ELEMENTS // max(width, 1))
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def matched_shape(point_lat, point_lng, point_valid,
                  shapes: DeviceShapes) -> torch.Tensor:
    """Per-row first matching shape index (int32, -1 = none): the dense
    sweep of every point against every edge.

    Mirrors the reference crossing test exactly: ((lng1 > p) != (lng2 >
    p)) && (lat < slope * (p - lng1) + lat1), with the slope precomputed
    and the (p - lng1) subtraction kept per element. Crossings add per
    block of BLOCK edges, then per shape, in int32; a shape holds the
    point where its count is odd (even-odd semantics, holes included).
    """
    n = point_lat.shape[0]
    device = point_lat.device
    out = torch.full((n,), -1, dtype=torch.int32, device=device)
    s = shapes.n_shapes
    if s == 0 or n == 0:
        return out
    e = shapes.slope.shape[0]
    nb = e // BLOCK
    slope, lat1 = shapes.slope[None, :], shapes.lat1[None, :]
    lng1, lng2 = shapes.lng1[None, :], shapes.lng2[None, :]
    sid = torch.arange(s + 1, dtype=torch.int32, device=device)
    for lo, hi in _row_chunks(n, e):
        plat = point_lat[lo:hi, None].to(torch.float32)
        plng = point_lng[lo:hi, None].to(torch.float32)
        cross = _crossings(plat, plng, lat1, lng1, lng2, slope)
        blk = cross.view(hi - lo, nb, BLOCK).sum(-1, dtype=torch.int32)
        counts = torch.zeros((hi - lo, s + 1), dtype=torch.int32,
                             device=device).index_add_(
            1, shapes.block_shape, blk)[:, :s]
        odd = (counts & 1) == 1
        first = torch.where(odd, sid[:s], s).min(dim=1).values
        out[lo:hi] = torch.where(first < s, first, -1)
    return torch.where(point_valid, out, -1)


def matched_shape_pruned(point_lat, point_lng, point_valid,
                         shapes: DeviceShapes
                         ) -> Tuple[Optional[torch.Tensor], bool]:
    """The bbox walk; bit-equal to matched_shape.

    Pass 1 tests every point against the shapes' bboxes ([chunk, S]
    compares) and counts its candidates. ONE host copy a call brings back
    the largest count: above PRUNE_ROUNDS_CAP the walk stops and returns
    (None, True), and the caller takes the dense sweep (the JAX package's
    `lax.cond`); else it is the number of rounds. Round k of pass 2 takes
    each point's k-th candidate in shape order (the least candidate shape
    above round k-1's, one min-reduction over the shapes), gathers its
    edge slab in float32 and puts it to matched_shape's crossing test; the
    first candidate with odd parity wins. Invalid and NaN points are never
    candidates.

    Returns (matched [n] int32, False), or (None, True) on overflow.
    """
    n = point_lat.shape[0]
    device = point_lat.device
    s = shapes.n_shapes
    if s == 0 or n == 0:
        return torch.full((n,), -1, dtype=torch.int32, device=device), False
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=device)
    pa_all = torch.where(point_valid, point_lat.to(torch.float32), nan)
    pg_all = torch.where(point_valid, point_lng.to(torch.float32), nan)
    lo_lng, hi_lng, lo_lat, hi_lat = (shapes.bbox[i][None, :]
                                      for i in range(4))

    def candidates(lo, hi):
        pa, pg = pa_all[lo:hi, None], pg_all[lo:hi, None]
        return (pg >= lo_lng) & (pg < hi_lng) & (pa > lo_lat) & (pa < hi_lat)

    most = torch.stack([candidates(lo, hi).sum(1, dtype=torch.int32).max()
                        for lo, hi in _row_chunks(n, s)]).max()
    rounds = int(fetch_to_host([most.reshape(1)])[0][0])
    if rounds > PRUNE_ROUNDS_CAP:
        return None, True
    out = torch.full((n,), -1, dtype=torch.int32, device=device)
    sid = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    for lo, hi in _row_chunks(n, max(s, 4 * shapes.slab.shape[2])):
        cand = candidates(lo, hi)
        pa, pg = pa_all[lo:hi, None], pg_all[lo:hi, None]
        taken = torch.full((hi - lo,), -1, dtype=torch.int32, device=device)
        found = taken.clone()
        for _ in range(rounds):
            # the point's next candidate (s where it has no more)
            taken = torch.where(cand & (sid > taken[:, None]), sid,
                                s).amin(dim=1)
            g = shapes.slab[taken.clamp(max=s - 1)]   # [T, 4, e_max]
            cross = _crossings(pa, pg, g[:, 2], g[:, 0], g[:, 1], g[:, 3])
            odd = (cross.sum(-1, dtype=torch.int32) & 1) == 1
            found = torch.where((found < 0) & odd & (taken < s), taken,
                                found)
        out[lo:hi] = found
    return out, False


def matched(point_lat, point_lng, point_valid,
            shapes: DeviceShapes) -> torch.Tensor:
    """Each point's first matching shape (int32, -1 = none): the bbox walk
    where the shapes were staged for it, falling back to the dense sweep
    on a candidate overflow, else the dense sweep."""
    if shapes.slab is not None:
        out, overflow = matched_shape_pruned(point_lat, point_lng,
                                             point_valid, shapes)
        if not overflow:
            return out
    return matched_shape(point_lat, point_lng, point_valid, shapes)
