"""The benchmark's own count of the kernels' work, and the card's peaks.

Frozen at commit 622041211370967fed91c3d03b9d93712cf20ff8, so that a
later change to a kernel or to the range rule cannot move the count:

- PEAK_BYTES_S, PEAK_OPS_S, OPS_PER (its chain and fill entries),
  _bound and band_cells are chip_smoke.py's (:3460-3495); chain_work
  counts as its chain_bound and fill_work as its dp_bound;
- compute_ranges and cut_segments are the NumPy branch of
  mm2_gb_tpu_torch/ops/chain_gpu.py (mm2-gb's plrange rule): the pairs
  an anchor is scored against are its range.
"""

from __future__ import annotations

import numpy as np

# the card's peaks (H100 SXM data sheet, at 700 W): HBM bytes per second,
# and float32 operations per second outside the tensor cores, against
# which the DPs' int8/int32 scalar operations are counted
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# scalar operations per unit of work, counted from the kernels' inner
# loops: a chain pair (pair_total and the reduction), a DP cell of the fill
OPS_PER = {"chain": 40, "fill": 50}


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for moving nbytes
    and doing ops on the card."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def band_cells(ql, tl, w):
    """In-band DP cells of each fill, sum over rows r of en0 - st0 + 1
    (ksw2._row_window): qlen * tlen when the band holds the whole
    matrix (w >= max(qlen, tlen)), else counted row by row."""
    ql, tl, w = (np.asarray(a, np.int64) for a in (ql, tl, w))
    w = np.where(w < 0, np.maximum(ql, tl), w)
    cells = ql * tl
    for k in np.nonzero(w < np.maximum(ql, tl))[0].tolist():
        r = np.arange(ql[k] + tl[k] - 1)
        st0 = np.maximum(np.maximum(0, r - ql[k] + 1), (r - w[k] + 1) >> 1)
        en0 = np.minimum(np.minimum(tl[k] - 1, r), (r + w[k]) >> 1)
        cells[k] = int(np.maximum(en0 - st0 + 1, 0).sum())
    return cells


def compute_ranges(ax: np.ndarray, read_bounds: np.ndarray,
                   max_dist_x: int, max_iter: int) -> np.ndarray:
    """Successor count per anchor (plrange analog): range[i] = #succ j>i
    in the same (read, strand, rid) group with rpos_j <= rpos_i +
    max_dist_x, capped at max_iter."""
    n = ax.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    hi = (ax >> np.uint64(32)).astype(np.int64)       # rev|rid
    grp_change = np.zeros(n, dtype=bool)
    grp_change[0] = True
    grp_change[1:] = hi[1:] != hi[:-1]
    starts = read_bounds[:-1]
    grp_change[starts[starts < n]] = True  # anchor-less reads share bounds
    g = np.cumsum(grp_change).astype(np.int64)
    rpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    comp = (g << 33) | rpos
    hi_idx = np.searchsorted(comp, (g << 33) | (rpos + max_dist_x),
                             side="right")
    rng = hi_idx - np.arange(n, dtype=np.int64) - 1
    return np.minimum(rng, max_iter).astype(np.int32)


def cut_segments(rng: np.ndarray) -> np.ndarray:
    """Segment start offsets (with trailing total): a cut after every
    anchor with range 0."""
    n = rng.shape[0]
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    ends = np.nonzero(rng == 0)[0] + 1
    return np.concatenate(([0], ends)).astype(np.int64)


def chain_work(calls) -> tuple[int, int]:
    """(bytes, operations) of chain launches [(ax, read_bounds,
    max_dist_x, max_iter)]: x, y and the range of each anchor read once
    and the segment bounds, f and p written once (20 bytes an anchor, 8
    a segment); OPS_PER["chain"] operations per pair.  A batch whose
    anchors have no successor launches nothing and counts nothing."""
    nbytes = ops = 0
    for ax, bounds, max_dist_x, max_iter in calls:
        rng = compute_ranges(ax, bounds, max_dist_x, max_iter)
        pairs = int(rng.sum(dtype=np.int64))
        if pairs == 0:
            continue
        n_seg = cut_segments(rng).shape[0] - 1
        nbytes += 20 * ax.shape[0] + 8 * n_seg
        ops += pairs * OPS_PER["chain"]
    return nbytes, ops


def fill_work(metas) -> tuple[int, int]:
    """(bytes, operations) of gap-fill launches, from each batch's meta
    rows [qlen, tlen, w, zdrop]: each base read once, one direction byte
    per in-band cell written once, a 4-byte score per fill;
    OPS_PER["fill"] operations per cell.  Fills with an empty side are
    solved on the host and count nothing."""
    nbytes = ops = 0
    for meta in metas:
        meta = np.asarray(meta, np.int64).reshape(-1, 4)
        meta = meta[(meta[:, 0] > 0) & (meta[:, 1] > 0)]
        cells = int(band_cells(meta[:, 0], meta[:, 1], meta[:, 2]).sum())
        nbytes += (int(meta[:, 0].sum()) + int(meta[:, 1].sum()) + cells
                   + 4 * meta.shape[0])
        ops += cells * OPS_PER["fill"]
    return nbytes, ops


def share(nbytes: int, ops: int, seconds: float) -> float | None:
    """The kernel's share of its roofline, in %: the least time for the
    work over the time it took; None when nothing ran."""
    if seconds <= 0 or (nbytes == 0 and ops == 0):
        return None
    return _bound(nbytes, ops)[0] / 1e3 / seconds * 100.0
