"""Gap fills and extensions on the GPU: the extd2 DP and its backtrack.

Port of the host half of mm2_gb_tpu/ops/ksw2_tpu.py for the gap fills
of `--gpu-align` (cigar + KSW_EZ_APPROX_MAX, optional KSW_EZ_RIGHT and
KSW_EZ_REV_CIGAR, no in-DP Z-drop), every fill the C++ aligner records
in its collect pass, and for the extensions (KSW_EZ_EXTZ_ONLY, with H
tracking and Z-drop) that the Python align driver records.  Hand-written
CUDA kernels do the work (csrc/extd2_kernel.cu):

- `extd2_fill`: the dual affine-gap anti-diagonal DP of
  ops/ksw2.py::extd2 (ksw2_extd2_sse.c semantics: 16-aligned stale
  windows, the unaligned score-row store span, the boundary fallbacks,
  the approx-max H0 walk), a warp per narrow fill and a block per wide
  or long one in one launch (`fill_shape`).  It writes each row's
  direction bytes over [st, en] into the fill's own region of `p` (rows
  packed at a running sum of their widths) and the score.
- `extd2_ext`: the same kernel in extension mode, in the same classes
  (`ext_shape`): the H row, the ranked row maximum, mqe, mte, Z-drop and
  the backtrack start of each fill.
- `ksw2_backtrack`: ksw_backtrack with is_rot (ksw2.h:126-158), a
  warp per fill walking tiles of direction bytes it stages in shared
  memory, run-length CIGAR words into a slot of qlen + tlen words per
  fill, from the last cell or a per-fill start; with
  min_intron_len > 0 the intron mode of the splice fills
  (ops/ksw2s_gpu.py).

`extd2_fill_torch`, `extd2_ext_torch` and `ksw2_backtrack_torch` are
their plain PyTorch twins, same inputs and outputs; the wrappers take
them only for tensors on the CPU.  `extd2_fill_batch` takes what the
native collect pass returns (`native.fill_fetch`) and gives back what
`native.fill_table_bulk` loads; `extd2_ext_batch` solves a batch of
extensions.  Host route (ksw2.extd2, counted): band collapse, the
`-mat.min() > 2*(q+e)` gate and empty sides.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mm2_gb_tpu_torch.ops import ksw2
from mm2_gb_tpu_torch.utils import kernels

KSW_NEG_INF = ksw2.KSW_NEG_INF
APPROX_MAX = ksw2.KSW_EZ_APPROX_MAX

fill_launches = 0       # extd2_fill kernel launches (CUDA tensors)
ext_launches = 0        # extd2_ext kernel launches (CUDA tensors)
backtrack_launches = 0  # ksw2_backtrack kernel launches (CUDA tensors)
start_backtrack_launches = 0   # of those, the ones from per-fill starts

# the fill kernel's state rows: u, y, y2, the score row, and x, v, x2
# twice (double-buffered by row parity)
STATE_ROWS = 10
# fill mode (extd2_fill): the state rows and the target row of nbytes
# lanes, the reversed query (QUERY_PAD zero bytes before it, 32 after)
# and the H0 walk's four int32 slots (fill_bytes).  A fill of at most
# WARP_LANES lanes (nbytes) whose state fits WARP_FILL_MAX takes a warp
# (FILL_WARPS to a block, here and in the splice fill kernel), any other
# a block of 256 threads; a block-class fill past FILL_SMEM_MAX bytes
# keeps its state in a global scratch region of its own.
FILL_WARPS = 8
WARP_LANES = 512
QUERY_PAD = 16
# a launch lasts as long as its longest fill, and a block runs a row
# faster than a warp: the LONG_FILLS longest fills of a launch with at
# least half its longest fill's rows take a block whatever their width
# (both fill kernels)
LONG_FILLS = 132
FILL_SMEM_MAX = 72 * 1024   # three blocks an SM share its 227 KB
# the state holds the whole reversed query: a narrow fill beside a query
# past ~3.5 kb takes a block, so that FILL_WARPS warps' state stays
# within FILL_SMEM_MAX
WARP_FILL_MAX = FILL_SMEM_MAX // FILL_WARPS
# extension mode (extd2_ext): the fill kernel's classes and state with
# the int32 H row beside it (ext_bytes).  An extension of at most
# WARP_LANES lanes whose state fits WARP_EXT_MAX takes a warp (eight
# warps' state stays within 96 KiB of a block), a wider one a block,
# with its state in global scratch past EXT_SMEM_MAX.  No LONG_FILLS
# rule: a warp runs a short extension's row faster than a block
# (PERF.md, `chip_smoke.py --dp-probe`).
WARP_EXT_MAX = 12 * 1024
EXT_SMEM_MAX = 44 * 1024
# extd2_ext's per-fill output: the Extz fields, then the backtrack start
EXT_FIELDS = ("score", "max", "max_t", "max_q", "mqe", "mqe_t", "mte",
              "mte_q", "zdropped", "reach_end")


@dataclass
class FillParams:
    """Kernel constants of one option set (extd2_batch_device's
    derivation, ksw2_tpu.py:1318-1327).  q/e/q2/e2 are the options' own
    (the host route passes them to ksw2.extd2, which swaps itself);
    qq/ee/qq2/ee2 are swapped so that qq + ee <= qq2 + ee2."""
    mat: np.ndarray
    q: int
    e: int
    q2: int
    e2: int
    qq: int
    ee: int
    qq2: int
    ee2: int
    mat0: int
    mat1: int
    sc_n: int
    long_thres: int
    long_diff: int
    mat_gate: bool   # -mat.min() > 2*(qq+ee): every fill on the host


def fill_params_from(mat: np.ndarray, q: int, e: int, q2: int,
                     e2: int) -> FillParams:
    mat = np.asarray(mat, np.int8)
    mat0, mat1 = int(mat[0]), int(mat[1])
    qq, ee, qq2, ee2 = (q, e, q2, e2) if q + e <= q2 + e2 else (q2, e2, q, e)
    sc_n = -ee2 if int(mat[24]) == 0 else int(mat[24])
    long_thres = (qq2 - qq) // (ee - ee2) - 1 if ee != ee2 else 0
    if qq2 + ee2 + long_thres * ee2 > qq + ee + long_thres * ee:
        long_thres += 1
    long_diff = long_thres * (ee - ee2) - (qq2 - qq) - ee2
    return FillParams(mat, q, e, q2, e2, qq, ee, qq2, ee2, mat0, mat1, sc_n,
                      long_thres, long_diff,
                      -int(mat.min()) > 2 * (qq + ee))


def fill_params(opt) -> FillParams:
    """FillParams of a MapOptions (its scoring matrix and gap costs)."""
    return fill_params_from(ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi),
                            opt.q, opt.e, opt.q2, opt.e2)


@dataclass
class FillStats:
    """Counters of extd2_fill_batch, extd2_ext_batch and
    ksw2s_gpu.exts2_fill_batch, summed over calls."""
    fills: int = 0          # fills asked for
    device_fills: int = 0   # solved by the fill + backtrack kernels
    host_fills: int = 0     # host route: collapse, mat gate, empty side
    scratch_fills: int = 0  # device fills and extensions whose state
    #                         is in global scratch
    chunks: int = 0         # kernel launch pairs
    cells: int = 0          # sum of qlen * tlen over device fills
    fill_ms: float = 0.0    # extd2_fill kernel time (CUDA events)
    backtrack_ms: float = 0.0
    batch_s: float = 0.0    # wall time of the batch calls
    # extensions (extd2_ext_batch), counted apart from the gap fills
    ext_fills: int = 0
    ext_host_fills: int = 0  # host route: collapse, mat gate, empty side
    ext_chunks: int = 0
    ext_cells: int = 0       # sum of qlen * tlen over device extensions
    ext_ms: float = 0.0      # extd2_ext kernel time (CUDA events)
    ext_backtrack_ms: float = 0.0
    # the Python align driver's real pass: fills and extensions its
    # collect pass did not record, which therefore align on the host
    misses: dict = field(default_factory=lambda: dict.fromkeys(
        ("fill", "ext", "splice"), 0))


# --------------------------------------------------------------------------
# band geometry (ksw2._row_window), vectorized
# --------------------------------------------------------------------------

def band_collapses(qlen: np.ndarray, tlen: np.ndarray,
                   w: np.ndarray) -> np.ndarray:
    """True where some anti-diagonal's window is empty (ksw2._row_window
    returns None; the oracle stops there with zdropped).  w >= 0.

    st0 = max(0, r-qlen+1, (r-w+1)>>1) and en0 = min(tlen-1, r, (r+w)>>1):
    every lower term minus every upper term is non-decreasing in r, so
    the last row r = qlen+tlen-2 decides, except (r-w+1)>>1 > (r+w)>>1,
    which holds at r = 1 exactly when w == 0."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    w = np.asarray(w, np.int64)
    r = qlen + tlen - 2
    return ((tlen - 1 > (r + w) >> 1) | ((r - w + 1) >> 1 > tlen - 1)
            | ((w == 0) & (r >= 1)))


def n_col(qlen, tlen, w):
    """Widest row of a fill's direction bytes (the C++ kernel's n_col);
    numpy arrays or tensors."""
    mn = torch.minimum if isinstance(qlen, torch.Tensor) else np.minimum
    m = mn(mn(qlen, tlen), w + 1)
    return (m + 15) // 16 * 16 + 16


def p_bound(qlen: np.ndarray, tlen: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Direction bytes a fill's rows may take: each row [st, en] is at
    most n_col wide and at most 30 wider than its in-band cells, which
    sum to at most qlen * tlen."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    rows = qlen + tlen - 1
    return np.minimum(rows * n_col(qlen, tlen, np.asarray(w, np.int64)),
                      qlen * tlen + 30 * rows)


def _windows(r, qlen, tlen, w):
    """(st0, en0) of anti-diagonal r; r an int or a tensor."""
    st0 = torch.clamp(r - qlen + 1, min=0)
    st0 = torch.maximum(st0, (r - w + 1) >> 1)
    en0 = torch.minimum(torch.clamp(tlen - 1, max=r) if isinstance(r, int)
                        else torch.minimum(tlen - 1, r), (r + w) >> 1)
    return st0, en0


def fill_bytes(qlen, tlen):
    """Bytes of a fill's state in the fill kernel, a multiple of 16
    (numpy arrays)."""
    nbytes = (np.asarray(tlen, np.int64) + 15) // 16 * 16
    query = (np.asarray(qlen, np.int64) + QUERY_PAD + 32 + 15) // 16 * 16
    return (STATE_ROWS + 1) * nbytes + query + 16


@dataclass
class FillShape:
    """A fill launch over n fills in two classes (class_shape)."""
    work: np.ndarray      # int32: block-class fills, then warp-class ones
    #                       (FILL_WARPS to a block, -1 padding)
    n_block: int          # block-class fills (a block each)
    n_warp: int           # warp-class fills (a warp each)
    scr_off: np.ndarray   # int64 [n]: the state's offset in scratch, or -1
    scratch: int          # bytes of global scratch
    warp_stride: int      # shared-memory bytes of a warp-class fill
    smem: int             # dynamic shared memory of a block


def class_shape(need, rows, warp_ok, smem_max: int,
                long_fills: int = LONG_FILLS) -> FillShape:
    """Each fill's class and the launch's shape, for the fill and the
    extension kernels (numpy arrays of the n fills in launch order:
    need, the bytes of its state; rows, its rows; warp_ok, whether it is
    narrow enough for a warp): a warp for a narrow fill, else a block,
    and a block for the long_fills longest fills with at least half the
    longest one's rows; a block-class fill past smem_max keeps its state
    in scratch.  One launch holds both classes, block-class blocks
    first, so that every fill of a chunk runs at once; its shared memory
    is the larger of FILL_WARPS warp-class fills' and the largest
    block-class fill in shared memory."""
    need = np.asarray(need, np.int64)
    rows = np.asarray(rows, np.int64)
    long = np.zeros(rows.shape[0], bool)
    if rows.shape[0]:
        top = np.argsort(-rows, kind="stable")[:long_fills]
        long[top[rows[top] * 2 >= rows.max()]] = True
    warp = np.asarray(warp_ok, bool) & ~long
    big = ~warp & (need > smem_max)
    scr_off = np.where(big, np.cumsum(np.where(big, need, 0)) - need, -1)
    w_idx = np.nonzero(warp)[0]
    b_idx = np.nonzero(~warp)[0]
    pad = -len(w_idx) % FILL_WARPS
    work = np.concatenate([b_idx, w_idx, np.full(pad, -1)]).astype(np.int32)
    stride = int(need[warp].max()) if len(w_idx) else 0
    in_smem = ~warp & ~big
    smem = max(FILL_WARPS * stride,
               int(need[in_smem].max()) if in_smem.any() else 0, 16)
    return FillShape(work, len(b_idx), len(w_idx), scr_off.astype(np.int64),
                     int(need[big].sum()), stride, smem)


def scratch_bytes(need, smem_max: int) -> np.ndarray:
    """The global scratch each fill's state takes in its launch: its
    bytes past smem_max, else 0.  A warp-class fill's state is within
    smem_max (WARP_FILL_MAX, WARP_EXT_MAX), so these are class_shape's
    scratch regions whatever each fill's class (the chunker's budget)."""
    need = np.asarray(need, np.int64)
    return np.where(need > smem_max, need, 0)


def fill_shape(qlen, tlen) -> FillShape:
    """extd2_fill's launch over n fills (numpy arrays, in launch order,
    longest first): a warp for a fill of at most WARP_LANES lanes whose
    state fits WARP_FILL_MAX, else a block (class_shape, with
    FILL_SMEM_MAX)."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    need = fill_bytes(qlen, tlen)
    return class_shape(need, qlen + tlen - 1,
                       ((tlen + 15) // 16 * 16 <= WARP_LANES)
                       & (need <= WARP_FILL_MAX), FILL_SMEM_MAX)


def ext_bytes(qlen, tlen):
    """Bytes of an extension's state in the extension kernel: the fill
    kernel's and the int32 H row of nbytes lanes (numpy arrays)."""
    return fill_bytes(qlen, tlen) + 4 * ((np.asarray(tlen, np.int64) + 15)
                                         // 16 * 16)


def ext_shape(qlen, tlen) -> FillShape:
    """extd2_ext's launch over n extensions (numpy arrays, in launch
    order, longest first): a warp for an extension of at most WARP_LANES
    lanes whose state fits WARP_EXT_MAX, else a block (class_shape, with
    EXT_SMEM_MAX and no LONG_FILLS rule)."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    need = ext_bytes(qlen, tlen)
    return class_shape(need, qlen + tlen - 1,
                       ((tlen + 15) // 16 * 16 <= WARP_LANES)
                       & (need <= WARP_EXT_MAX), EXT_SMEM_MAX, 0)


def shape_operands(sh: FillShape, dev):
    """(scr_off, work, scratch) of a fill shape on the device."""
    scr_off, work = (torch.from_numpy(a).to(dev) for a in (sh.scr_off,
                                                           sh.work))
    return scr_off, work, torch.empty(max(sh.scratch, 1), dtype=torch.int8,
                                      device=dev)


def _c8(v: int) -> int:
    """The int8 value an int truncates to (the kernels' casts)."""
    return ((v + 128) & 255) - 128


# --------------------------------------------------------------------------
# the fill: plain twin and kernel wrapper
# --------------------------------------------------------------------------

def extd2_fill_torch(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
                     p_total: int, prm: FillParams, right: bool):
    """Plain PyTorch extd2 fill (the twin of the extd2_fill kernel).

    Anti-diagonals r = 0, 1, ... are stepped in Python; each step is
    vectorized over the fills still that long x the columns of their
    windows, in int8 tensors whose arithmetic wraps as the kernels'
    int8 casts do.  Returns
    (score int32 [n], p uint8 [p_total]): fill k's row r lies at
    p_off[k] + (sum of its earlier rows' widths), over [st, en]."""
    return _extd2_rows(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
                       p_total, prm, right)


def extd2_ext_torch(qblob, tblob, qoff, toff, qlen, tlen, w, zdrop, p_off,
                    p_total: int, prm: FillParams, right: bool,
                    end_bonus: int):
    """Plain PyTorch extd2 extension (the twin of the extd2_ext kernel):
    the fill twin's row loop with the H row, the ranked row maximum,
    mqe, mte and Z-drop (ksw2.py:566-585) and ext_batch_device's choice
    of the backtrack start.  Returns (ext int32 [n, 12]: the EXT_FIELDS,
    then the backtrack start i0, j0 (-1: none); p uint8 [p_total], rows
    after a Z-drop left 0)."""
    return _extd2_rows(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
                       p_total, prm, right, zdrop, end_bonus)


def _extd2_rows(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
                p_total: int, prm: FillParams, right: bool, zdrop=None,
                end_bonus: int = 0):
    """The row loop of both twins; extension mode when zdrop is given."""
    dev = qblob.device
    n = qlen.shape[0]
    track_h = zdrop is not None
    if track_h:
        out = torch.full((n, 12), -1, dtype=torch.int32, device=dev)
    else:
        out = torch.full((n,), KSW_NEG_INF, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total, dtype=torch.uint8, device=dev)
    if n == 0:
        return out, p
    i64, i8, u8 = torch.int64, torch.int8, torch.uint8
    ql0, tl0 = qlen.to(i64), tlen.to(i64)
    order = torch.argsort(ql0 + tl0, descending=True, stable=True)
    ql, tl, wv = ql0[order], tl0[order], w.to(i64)[order]
    wv = torch.where(wv < 0, torch.maximum(ql, tl), wv)
    qo, to, po = qoff.to(i64)[order], toff.to(i64)[order], \
        p_off.to(i64)[order]
    rt = bool(right)
    n_rows = ql + tl - 1
    rows_h = n_rows.cpu().numpy()
    nbytes = (tl + 15) // 16 * 16
    nb_max = int(nbytes.max())
    ncol_max = int(n_col(ql, tl, wv).max())
    width = nb_max + ncol_max + 18       # column c holds t = c - 1
    trash = width - 1                    # masked-off scatters land here
    q, e, q2, e2 = prm.qq, prm.ee, prm.qq2, prm.ee2
    nqe, nqe2 = _c8(-q - e), _c8(-q2 - e2)
    qe8, qe28, q8, q28 = _c8(q + e), _c8(q2 + e2), _c8(q), _c8(q2)
    # state channels per (fill, column): the six DP rows, the score row
    # and (fixed) the target byte, zero past tlen; int8, so that +, - wrap
    # as the kernels' int8 casts do
    U, V, X, Y, X2, Y2, S, TB = range(8)
    st8 = torch.tensor([nqe, nqe, nqe, nqe, nqe2, nqe2, 0, 0], dtype=i8,
                       device=dev)
    Z = st8.repeat(n, width, 1)
    cols = torch.arange(width - 2, device=dev)
    tsrc = to[:, None] + torch.minimum(cols, tl[:, None] - 1)
    Z[:, 1:-1, TB] = torch.where(cols < tl[:, None],
                                 tblob.to(i8)[tsrc], 0)
    # the query, one leading zero for r - t < 0
    qw = int(ql.max()) + 1
    qcols = torch.arange(qw - 1, device=dev)
    qsrc = qo[:, None] + torch.minimum(qcols, ql[:, None] - 1)
    QP = torch.zeros((n, qw), dtype=i8, device=dev)
    QP[:, 1:] = torch.where(qcols < ql[:, None], qblob.to(i8)[qsrc], 0)
    mat0, mat1, sc_n = prm.mat0, prm.mat1, prm.sc_n
    c8 = {v: torch.tensor(v, dtype=i8, device=dev)
          for v in (mat0, mat1, sc_n)}
    d8 = [torch.tensor(v, dtype=u8, device=dev) for v in range(5)]
    H0 = torch.zeros(n, dtype=i64, device=dev)
    lh = torch.zeros(n, dtype=i64, device=dev)
    last_st = torch.full((n,), -1, dtype=i64, device=dev)
    last_en = torch.full((n,), -1, dtype=i64, device=dev)
    row_off = torch.zeros(n, dtype=i64, device=dev)
    sc_out = torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev)
    if track_h:   # the H row and the oracle's Extz fields (ksw2.py:62-75)
        Hs = torch.full((n, width), KSW_NEG_INF, dtype=i64, device=dev)
        zd = zdrop.to(dev, i64)[order]
        mx = torch.zeros(n, dtype=i64, device=dev)
        max_t, max_q, mqe_t, mte_q = (torch.full((n,), -1, dtype=i64,
                                                 device=dev)
                                      for _ in range(4))
        mqe = torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev)
        mte = mqe.clone()
        dropped = torch.zeros(n, dtype=torch.bool, device=dev)

    def bound_v(r):
        if r == 0:
            return nqe
        if r < prm.long_thres:
            return _c8(-e)
        if r == prm.long_thres:
            return _c8(prm.long_diff)
        return _c8(-e2)

    def dirs(z, av, bv, a2, b2, right_rule):
        """The direction state and the new z of the cell update, under
        KSW_EZ_RIGHT's tie rules or the default ones."""
        if right_rule:
            d = torch.where(z > av, d8[0], d8[1])
            z = torch.maximum(z, av)
            d = torch.where(z > bv, d, d8[2])
            z = torch.maximum(z, bv)
            d = torch.where(z > a2, d, d8[3])
            z = torch.maximum(z, a2)
            d = torch.where(z > b2, d, d8[4])
            return d, torch.maximum(z, b2)
        d = torch.where(av > z, d8[1], d8[0])
        z = torch.maximum(z, av)
        d = torch.where(bv > z, d8[2], d)
        z = torch.maximum(z, bv)
        d = torch.where(a2 > z, d8[3], d)
        z = torch.maximum(z, a2)
        d = torch.where(b2 > z, d8[4], d)
        return d, torch.maximum(z, b2)

    for r in range(int(rows_h[0])):
        a = int(np.searchsorted(-rows_h, -r, side="left"))  # n_rows > r
        if track_h and r % 64 == 63 and bool(dropped[:a].all()):
            break   # every fill still this long has dropped
        qla, tla, wa = ql[:a], tl[:a], wv[:a]
        st0, en0 = _windows(r, qla, tla, wa)
        st, en = st0 & -16, en0 | 15
        hi = torch.minimum(st0 + 16 * ((en0 - st0) // 16 + 1), nbytes[:a])
        last = torch.maximum(en, hi - 1)
        J = int((last - st).max()) + 1
        t = st[:, None] + torch.arange(J, device=dev)
        col = t + 1
        dp = t <= en[:, None]
        fresh = (t >= st0[:, None]) & (t < hi[:, None])
        Za = Z[:a]
        cur = Za.gather(1, col[:, :, None].expand(a, J, 8))
        # the score row (ksw2._row_scores over [st0, hi))
        qbyte = QP[:a].gather(1, torch.clamp(r - t + 1, 0, qw - 1))
        tbyte = cur[:, :, TB]
        sc = torch.where(tbyte == qbyte, c8[mat0], c8[mat1])
        sc = torch.where((tbyte == 4) | (qbyte == 4), c8[sc_n], sc)
        z = torch.where(fresh, sc, cur[:, :, S])
        # x, v, x2 of the previous row at t - 1, and the boundary values
        xt1 = Za[:, :, X].gather(1, col - 1)
        vt1 = Za[:, :, V].gather(1, col - 1)
        x2t1 = Za[:, :, X2].gather(1, col - 1)
        inb = (st > 0) & (last_st[:a] <= st - 1) & (st - 1 <= last_en[:a])
        xt1[:, 0] = torch.where(inb, xt1[:, 0], nqe)
        x2t1[:, 0] = torch.where(inb, x2t1[:, 0], nqe2)
        vt1[:, 0] = torch.where(st > 0, torch.where(inb, vt1[:, 0], nqe),
                                bound_v(r))
        reset = (t == r) & (en >= r)[:, None]
        ut = torch.where(reset, bound_v(r), cur[:, :, U])
        yt = torch.where(reset, nqe, cur[:, :, Y])
        y2t = torch.where(reset, nqe2, cur[:, :, Y2])
        # the cell update (csrc/ksw2kit.cpp extd2_row), int8 wrapping
        av = xt1 + vt1
        bv = yt + ut
        a2 = x2t1 + vt1
        b2 = y2t + ut
        d, z = dirs(z, av, bv, a2, b2, rt)
        z = torch.clamp(z, max=mat0)
        tq, tq2 = z - q8, z - q28
        av, bv = av - tq, bv - tq
        a2, b2 = a2 - tq2, b2 - tq2
        ta, tb = (av >= 0, bv >= 0) if rt else (av > 0, bv > 0)
        ta2, tb2 = (a2 >= 0, b2 >= 0) if rt else (a2 > 0, b2 > 0)
        new = torch.stack([
            z - vt1, z - ut, av * ta - qe8, bv * tb - qe8, a2 * ta2 - qe28,
            b2 * tb2 - qe28], -1)
        cur[:, :, :6] = torch.where(dp[:, :, None], new, cur[:, :, :6])
        cur[:, :, S] = torch.where(fresh, sc, cur[:, :, S])
        keep = dp | fresh
        Za.scatter_(1, torch.where(keep, col, trash)[:, :, None]
                    .expand(a, J, 8), cur)
        d = (d | (ta.to(u8) << 3) | (tb.to(u8) << 4) | (ta2.to(u8) << 5)
             | (tb2.to(u8) << 6))
        dst = po[:a, None] + row_off[:a, None] + (t - st[:, None])
        wr = dp & ~dropped[:a, None] if track_h else dp
        p[dst[wr]] = d[wr]
        row_off[:a] += en - st + 1
        last_st[:a], last_en[:a] = st, en
        if track_h:
            _track_h_row(r, a, t, col, st, st0, en, en0, new, Hs, trash,
                         dict(ql=ql, tl=tl, n_rows=n_rows, zd=zd, mx=mx,
                              max_t=max_t, max_q=max_q, mqe=mqe,
                              mqe_t=mqe_t, mte=mte, mte_q=mte_q,
                              dropped=dropped, sc_out=sc_out), q + e, e2)
            continue
        # the approx-max H0 walk (ksw2.py:587-608)
        lha = lh[:a]
        vl = Za[:, :, V].gather(1, (lha + 1)[:, None])[:, 0].to(i64)
        ul = Za[:, :, U].gather(1, (lha + 2)[:, None])[:, 0].to(i64)
        if r == 0:
            H0[:a] = vl - (q + e)
        else:
            in0 = (lha >= st0) & (lha <= en0)
            in1 = (lha + 1 >= st0) & (lha + 1 <= en0)
            up = in0 & in1 & (vl <= ul)
            H0[:a] += torch.where(in0 & ~up, vl, ul)
            lh[:a] = lha + up.to(i64) + (~in0).to(i64)
        done = (n_rows[:a] - 1 == r) & (en0 == tla - 1)
        sc_out[:a] = torch.where(done, H0[:a], sc_out[:a])
    if not track_h:
        out[order] = sc_out.to(torch.int32)
        return out, p
    # ext_batch_device's epilogue (ksw2_tpu.py:1741-1762): the start
    reach = ~dropped & (mqe + int(end_bonus) > mx)
    has_max = (max_t >= 0) & (max_q >= 0)
    i0 = torch.where(reach, mqe_t, torch.where(has_max, max_t, -1))
    j0 = torch.where(reach, ql - 1, torch.where(has_max, max_q, -1))
    out[order] = torch.stack([sc_out, mx, max_t, max_q, mqe, mqe_t, mte,
                              mte_q, dropped.to(i64), reach.to(i64), i0,
                              j0], 1).to(torch.int32)
    return out, p


def _track_h_row(r, a, t, col, st, st0, en, en0, new, Hs, trash, ez, qe,
                 e2):
    """One row of the extension twin's H tracking (ksw2.py:566-585) for
    the a fills still this long: H[en0] from the previous row's
    H[en0 - 1] + u (H[en0] + v when en0 == 0), H[st0:en0] += v, the row
    maximum under row_max's lane ranking, mte, mqe, Z-drop and the score.
    Fills that dropped earlier keep their state."""
    i64 = torch.int64
    alive = ~ez["dropped"][:a]
    un, vn = new[:, :, 0].to(i64), new[:, :, 1].to(i64)
    k_en0 = (en0 - st)[:, None]
    Ha = Hs[:a]
    if r == 0:
        h = vn - qe
        h_en0 = h[:, 0]
    else:
        h_en0 = torch.where(
            en0 > 0, Ha.gather(1, en0[:, None])[:, 0]
            + un.gather(1, k_en0)[:, 0],
            Ha.gather(1, (en0 + 1)[:, None])[:, 0]
            + vn.gather(1, k_en0)[:, 0])
        h = torch.where(t == en0[:, None], h_en0[:, None],
                        Ha.gather(1, col) + vn)
    inw = (t >= st0[:, None]) & (t <= en0[:, None])
    Ha.scatter_(1, torch.where(inw & alive[:, None], col, trash), h)
    # the ranked row maximum (csrc/ksw2kit.cpp row_max): en0 first, the
    # 4-lane blocks by ((t-st0)%4, (t-st0)/4), then the tail lanes
    d = t - st0[:, None]
    nb = ((en0 - st0) // 4)[:, None]
    rank = torch.where(t == en0[:, None], 0,
                       torch.where(d < 4 * nb, 1 + (d % 4) * nb + d // 4,
                                   1 + d))
    key = torch.where(inw, h * 2**32 + (0x7fffffff - rank),
                      torch.iinfo(i64).min)
    best = key.argmax(1)
    max_h = h.gather(1, best[:, None])[:, 0]
    mt = st + best
    h_st0 = h.gather(1, (st0 - st)[:, None])[:, 0]
    ql, tl = ez["ql"][:a], ez["tl"][:a]
    mte, mqe = ez["mte"], ez["mqe"]
    up = alive & (en0 == tl - 1) & (h_en0 > mte[:a])
    mte[:a] = torch.where(up, h_en0, mte[:a])
    ez["mte_q"][:a] = torch.where(up, r - en, ez["mte_q"][:a])
    up = alive & (r - st0 == ql - 1) & (h_st0 > mqe[:a])
    mqe[:a] = torch.where(up, h_st0, mqe[:a])
    ez["mqe_t"][:a] = torch.where(up, st0, ez["mqe_t"][:a])
    # apply_zdrop (ksw2.py:143-154) with e2
    mx, max_t, max_q = ez["mx"], ez["max_t"], ez["max_q"]
    gt = max_h > mx[:a]
    near = ~gt & (mt >= max_t[:a]) & (r - mt >= max_q[:a])
    ll = ((mt - max_t[:a]) - (r - mt - max_q[:a])).abs()
    zd = ez["zd"][:a]
    drop = alive & near & (zd >= 0) & (mx[:a] - max_h > zd + ll * e2)
    up = alive & gt
    mx[:a] = torch.where(up, max_h, mx[:a])
    max_t[:a] = torch.where(up, mt, max_t[:a])
    max_q[:a] = torch.where(up, r - mt, max_q[:a])
    ez["dropped"][:a] |= drop
    done = (alive & ~drop & (ez["n_rows"][:a] - 1 == r)
            & (en0 == tl - 1))
    ez["sc_out"][:a] = torch.where(done, h_en0, ez["sc_out"][:a])


def _check_fill_operands(qblob, tblob, qoff, toff, qlen, tlen, w, p_off):
    for name, t, dt in (("qblob", qblob, torch.uint8),
                        ("tblob", tblob, torch.uint8),
                        ("qoff", qoff, torch.int64),
                        ("toff", toff, torch.int64),
                        ("qlen", qlen, torch.int32),
                        ("tlen", tlen, torch.int32), ("w", w, torch.int32),
                        ("p_off", p_off, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"extd2_fill: {name} must be a contiguous 1-D "
                             f"{dt} tensor")
        if t.device != qblob.device:
            raise ValueError(f"extd2_fill: {name} is on {t.device}, qblob "
                             f"on {qblob.device}")
    n = qlen.shape[0]
    for name, t in (("qoff", qoff), ("toff", toff), ("tlen", tlen),
                    ("w", w), ("p_off", p_off)):
        if t.shape[0] != n:
            raise ValueError(f"extd2_fill: {name} has {t.shape[0]} "
                             f"elements, expected {n}")


def _record(events, i: int) -> None:
    """Record events[i] on the current stream (a kernel wrapper's timing:
    the pair sits right around the launch, after its host work)."""
    if events is not None:
        events[i].record()


def extd2_fill(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
               p_total: int, prm: FillParams, right: bool, events=None):
    """The extd2 fill DP of n fills (APPROX_MAX, no Z-drop).

    qblob/tblob: uint8 base codes (0..4) of all queries and targets;
    fill k is qblob[qoff[k]:qoff[k] + qlen[k]] against
    tblob[toff[k]:toff[k] + tlen[k]] with band w[k] (< 0: the whole
    matrix).  Every fill must be non-empty and its band must not
    collapse (`band_collapses`), and `prm.mat_gate` must be False: those
    fills belong to the host route.  Region k of p starts at p_off[k]
    and holds p_bound(qlen[k], tlen[k], w[k]) bytes.

    Returns (score int32 [n], p uint8 [p_total]).  CPU tensors take the
    plain twin; CUDA tensors launch the kernel (built on first use); a
    build or launch failure raises.  events: a (start, end) pair of CUDA
    events recorded right around the launch, or None."""
    global fill_launches
    _check_fill_operands(qblob, tblob, qoff, toff, qlen, tlen, w, p_off)
    if prm.mat_gate:
        raise ValueError("extd2_fill: this scoring matrix takes the host "
                         "route (-mat.min() > 2*(q+e))")
    if qblob.device.type == "cpu":
        return extd2_fill_torch(qblob, tblob, qoff, toff, qlen, tlen, w,
                                p_off, p_total, prm, right)
    if qblob.device.type != "cuda":
        raise ValueError(f"extd2_fill: unsupported device {qblob.device}")
    lib = kernels.library()
    dev = qblob.device
    n = qlen.shape[0]
    score = torch.full((n,), KSW_NEG_INF, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total, dtype=torch.uint8, device=dev)
    if n == 0:
        return score, p
    sh = fill_shape(qlen.cpu().numpy(), tlen.cpu().numpy())
    scr_off, work, scratch = shape_operands(sh, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _record(events, 0)
    rc = lib.mm2_extd2_fill(
        qblob.data_ptr(), tblob.data_ptr(), qoff.data_ptr(), toff.data_ptr(),
        qlen.data_ptr(), tlen.data_ptr(), w.data_ptr(), p_off.data_ptr(),
        scr_off.data_ptr(), work.data_ptr(), sh.n_block, sh.n_warp,
        scratch.data_ptr(), p.data_ptr(), score.data_ptr(), prm.qq, prm.ee,
        prm.qq2, prm.ee2, prm.mat0, prm.mat1, prm.sc_n, prm.long_thres,
        prm.long_diff, int(bool(right)), sh.warp_stride, sh.smem, stream)
    _record(events, 1)
    kernels.check(rc, "extd2_fill")
    fill_launches += 1
    return score, p


def extd2_ext(qblob, tblob, qoff, toff, qlen, tlen, w, zdrop, p_off,
              p_total: int, prm: FillParams, right: bool, end_bonus: int,
              events=None):
    """The extd2 extension DP (KSW_EZ_EXTZ_ONLY) of n fills: operands as
    extd2_fill's, with zdrop int32 [n] (< 0: no Z-drop) and the end
    bonus of every fill.  Every fill must be non-empty and its band must
    not collapse, and `prm.mat_gate` must be False.

    Returns (ext int32 [n, 12]: score, max, max_t, max_q, mqe, mqe_t,
    mte, mte_q, zdropped, reach_end, and the backtrack start i0, j0 (-1:
    none) for ksw2_backtrack's `starts`; p uint8 [p_total], rows after a
    Z-drop left 0).  CPU tensors take the plain twin; CUDA tensors launch
    the kernel (built on first use); a build or launch failure raises.
    events: a (start, end) pair of CUDA events recorded right around the
    launch, or None."""
    global ext_launches
    _check_fill_operands(qblob, tblob, qoff, toff, qlen, tlen, w, p_off)
    if (zdrop.dtype != torch.int32 or zdrop.shape != qlen.shape
            or not zdrop.is_contiguous() or zdrop.device != qblob.device):
        raise ValueError("extd2_ext: zdrop must be a contiguous int32 "
                         f"tensor of {qlen.shape[0]} on {qblob.device}")
    if prm.mat_gate:
        raise ValueError("extd2_ext: this scoring matrix takes the host "
                         "route (-mat.min() > 2*(q+e))")
    if qblob.device.type == "cpu":
        return extd2_ext_torch(qblob, tblob, qoff, toff, qlen, tlen, w,
                               zdrop, p_off, p_total, prm, right, end_bonus)
    if qblob.device.type != "cuda":
        raise ValueError(f"extd2_ext: unsupported device {qblob.device}")
    lib = kernels.library()
    dev = qblob.device
    n = qlen.shape[0]
    ext = torch.full((n, 12), -1, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total, dtype=torch.uint8, device=dev)
    if n == 0:
        return ext, p
    sh = ext_shape(qlen.cpu().numpy(), tlen.cpu().numpy())
    scr_off, work, scratch = shape_operands(sh, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _record(events, 0)
    rc = lib.mm2_extd2_ext(
        qblob.data_ptr(), tblob.data_ptr(), qoff.data_ptr(), toff.data_ptr(),
        qlen.data_ptr(), tlen.data_ptr(), w.data_ptr(), zdrop.data_ptr(),
        p_off.data_ptr(), scr_off.data_ptr(), work.data_ptr(), sh.n_block,
        sh.n_warp, scratch.data_ptr(), p.data_ptr(), ext.data_ptr(), prm.qq,
        prm.ee, prm.qq2, prm.ee2, prm.mat0, prm.mat1, prm.sc_n,
        prm.long_thres, prm.long_diff, int(bool(right)), int(end_bonus),
        sh.warp_stride, sh.smem, stream)
    _record(events, 1)
    kernels.check(rc, "extd2_ext")
    ext_launches += 1
    return ext, p


# --------------------------------------------------------------------------
# the backtrack: plain twin and kernel wrapper
# --------------------------------------------------------------------------

def _row_widths(qlen, tlen, w, n_rows_max: int) -> torch.Tensor:
    """[n, n_rows_max] int64 width en - st + 1 of each row (0 past the
    fill's last row)."""
    r = torch.arange(n_rows_max, device=qlen.device)[None, :]
    st0, en0 = _windows(r, qlen[:, None], tlen[:, None], w[:, None])
    wid = (en0 | 15) - (st0 & -16) + 1
    return torch.where(r < (qlen + tlen - 1)[:, None], wid, 0)


def ksw2_backtrack_torch(p, p_off, qlen, tlen, w, cig_off, rev_cigar,
                         min_intron_len: int = 0, starts=None):
    """Plain PyTorch backtrack (the twin of the ksw2_backtrack kernel):
    every fill's walk from (tlen-1, qlen-1), or from starts[k] = (i0, j0)
    when given (a start of -1 writes no word), advances in lockstep, one
    unit op per step, run-length encoded as it goes.  Returns (cig int32
    [cig_off[-1]] of uint32 words, n_cig int32 [n]): fill k's words are
    cig[cig_off[k]:cig_off[k] + n_cig[k]].  rev_cigar: a bool, or one
    per fill (a tensor); min_intron_len > 0: intron mode (state 3 is N,
    a tail deletion of i + 1 >= min_intron_len + 1 bases is N)."""
    dev = p.device
    n = qlen.shape[0]
    i64 = torch.int64
    rev = (rev_cigar.to(dev, torch.bool) if isinstance(rev_cigar, torch.Tensor)
           else torch.full((n,), bool(rev_cigar), dtype=torch.bool,
                           device=dev))
    total = int(cig_off[-1]) if n else 0
    cig = torch.zeros(total + 1, dtype=i64, device=dev)  # + a trash word
    n_cig = torch.zeros(n, dtype=i64, device=dev)
    if n == 0:
        return cig[:0].to(torch.int32), n_cig.to(torch.int32)
    ql, tl = qlen.to(i64), tlen.to(i64)
    wv = w.to(i64)
    wv = torch.where(wv < 0, torch.maximum(ql, tl), wv)
    rows_max = int((ql + tl - 1).max())
    row_start = torch.cumsum(_row_widths(ql, tl, wv, rows_max), 1)
    row_start = torch.cat([torch.zeros((n, 1), dtype=i64, device=dev),
                           row_start[:, :-1]], 1)
    base = p_off.to(i64)
    co = cig_off[:-1].to(i64)
    i, j = tl - 1, ql - 1
    if starts is not None:
        i, j = starts[:, 0].to(i64), starts[:, 1].to(i64)
        none = (i < 0) | (j < 0)
        i, j = torch.where(none, -1, i), torch.where(none, -1, j)
    state = torch.zeros(n, dtype=i64, device=dev)
    run_op = torch.full((n,), -1, dtype=i64, device=dev)
    run_len = torch.zeros(n, dtype=i64, device=dev)
    in_tail = torch.zeros(n, dtype=torch.bool, device=dev)
    tail_n = torch.zeros(n, dtype=torch.bool, device=dev)

    def flush(mask):
        word = (run_len << 4) | run_op
        cig.scatter_(0, torch.where(mask, co + n_cig, total), word)
        n_cig.add_(mask.to(i64))

    for step in range(rows_max + 2):   # a walk takes <= qlen + tlen steps
        alive = (i >= 0) | (j >= 0)
        if step % 64 == 0 and not bool(alive.any()):   # a rare device wait
            break
        both = (i >= 0) & (j >= 0)
        r = torch.clamp(i + j, min=0)
        st0, en0 = _windows(r, ql, tl, wv)
        st, en = st0 & -16, en0 | 15
        inband = both & (i >= st) & (i <= en)
        rs = row_start.gather(1, torch.clamp(r, max=rows_max - 1)[:, None])
        at = torch.where(inband, base + rs[:, 0] + i - st, 0)
        tmp = torch.where(inband, p[at].to(i64), 0)
        s1 = torch.where(state == 0, tmp & 7,
                         torch.where(((tmp >> (state + 2)) & 1) == 1, state, 0))
        s1 = torch.where(s1 == 0, tmp & 7, s1)
        s1 = torch.where(both & (i < st), 2, s1)
        s1 = torch.where(both & (i > en), 1, s1)
        d_tail = (j < 0) & (i >= 0)
        s1 = torch.where(d_tail, 1, s1)               # tail: D run
        s1 = torch.where((i < 0) & (j >= 0), 2, s1)   # tail: I run
        is_ins = (s1 == 2) | (s1 == 4)
        op = torch.where(s1 == 0, 0, torch.where(is_ins, 1, 2))
        if min_intron_len > 0:
            # the tail's length is known where it starts: i + 1 bases
            tail_n = torch.where(d_tail & ~in_tail, i >= min_intron_len,
                                 tail_n)
            in_tail |= d_tail
            op = torch.where((both & (s1 == 3)) | (d_tail & tail_n), 3, op)
        new_run = alive & (op != run_op)
        flush(new_run & (run_len > 0))
        run_op = torch.where(new_run, op, run_op)
        run_len = torch.where(new_run, 1, run_len + alive.to(i64))
        di = ((s1 == 0) | (s1 == 1) | (s1 == 3)).to(i64)
        dj = ((s1 == 0) | is_ins).to(i64)
        i = torch.where(alive, i - di, i)
        j = torch.where(alive, j - dj, j)
        state = torch.where(alive & both, s1, state)
    flush(run_len > 0)
    cig = cig[:total]
    if not bool(rev.all()):   # words were emitted back to front
        k = torch.arange(total, device=dev)
        owner = torch.repeat_interleave(torch.arange(n, device=dev),
                                        cig_off[1:].to(i64) - co)
        pos = k - co[owner]
        src = torch.where((pos < n_cig[owner]) & ~rev[owner],
                          co[owner] + n_cig[owner] - 1 - pos, k)
        cig = cig[src]
    return cig.to(torch.int32), n_cig.to(torch.int32)


def ksw2_backtrack(p, p_off, qlen, tlen, w, cig_off, rev_cigar,
                   min_intron_len: int = 0, starts=None, events=None):
    """Backtrack n filled fills (the p, p_off of extd2_fill or extd2_ext,
    or of ksw2s_gpu.exts2_fill with w = qlen + tlen; cig_off int64
    [n + 1] with at least qlen[k] + tlen[k] words per fill), from
    (tlen-1, qlen-1), or from starts[k] = (i0, j0) when given (int32
    [n, 2] with unit column stride, such as extd2_ext's ext[:, 10:]; a
    start of -1 writes no word).

    Returns (cig int32 [cig_off[-1]] holding uint32 CIGAR words, n_cig
    int32 [n]); reversed (KSW_EZ_REV_CIGAR order) where rev_cigar, a
    bool or a bool tensor [n].  min_intron_len > 0 is the splice fills'
    intron mode (N ops).  CPU tensors take the plain twin; CUDA tensors
    launch the kernel; a build or launch failure raises.  events: a
    (start, end) pair of CUDA events recorded right around the launch,
    or None."""
    global backtrack_launches, start_backtrack_launches
    for name, t, dt in (("p", p, torch.uint8), ("p_off", p_off, torch.int64),
                        ("qlen", qlen, torch.int32),
                        ("tlen", tlen, torch.int32), ("w", w, torch.int32),
                        ("cig_off", cig_off, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"ksw2_backtrack: {name} must be a contiguous "
                             f"1-D {dt} tensor")
        if t.device != p.device:
            raise ValueError(f"ksw2_backtrack: {name} is on {t.device}, p "
                             f"on {p.device}")
    n = qlen.shape[0]
    for name, t in (("p_off", p_off), ("tlen", tlen), ("w", w)):
        if t.shape[0] != n:
            raise ValueError(f"ksw2_backtrack: {name} has {t.shape[0]} "
                             f"elements, expected {n}")
    if cig_off.shape[0] != n + 1:
        raise ValueError("ksw2_backtrack: cig_off must have n + 1 entries")
    rev_fill = None
    if isinstance(rev_cigar, torch.Tensor):
        if (rev_cigar.dtype != torch.bool or rev_cigar.shape != (n,)
                or rev_cigar.device != p.device):
            raise ValueError("ksw2_backtrack: a per-fill rev_cigar must be "
                             f"a bool tensor of {n} on {p.device}")
        rev_fill = rev_cigar.to(torch.uint8)
    if starts is not None and (
            starts.dtype != torch.int32 or starts.shape != (n, 2)
            or starts.stride(1) != 1 or starts.device != p.device):
        raise ValueError("ksw2_backtrack: starts must be an int32 [n, 2] "
                         f"tensor with unit column stride on {p.device}")
    if p.device.type == "cpu":
        return ksw2_backtrack_torch(p, p_off, qlen, tlen, w, cig_off,
                                    rev_cigar, min_intron_len, starts)
    if p.device.type != "cuda":
        raise ValueError(f"ksw2_backtrack: unsupported device {p.device}")
    lib = kernels.library()
    cig = torch.zeros(int(cig_off[-1]) if n else 0, dtype=torch.int32,
                      device=p.device)
    n_cig = torch.zeros(n, dtype=torch.int32, device=p.device)
    if n == 0:
        return cig, n_cig
    _record(events, 0)
    rc = lib.mm2_ksw2_backtrack(
        p.data_ptr(), p_off.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
        w.data_ptr(), cig_off.data_ptr(),
        None if rev_fill is None else rev_fill.data_ptr(),
        None if starts is None else starts.data_ptr(),
        0 if starts is None else starts.stride(0), n,
        int(bool(rev_cigar)) if rev_fill is None else 0,
        int(min_intron_len), cig.data_ptr(), n_cig.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    _record(events, 1)
    kernels.check(rc, "ksw2_backtrack")
    backtrack_launches += 1
    start_backtrack_launches += starts is not None
    return cig, n_cig


# --------------------------------------------------------------------------
# a batch of recorded fills (the native collect pass's output)
# --------------------------------------------------------------------------

def _chunks(nbytes: np.ndarray, budget: int) -> list[tuple[int, int]]:
    """[start, end) runs of consecutive fills whose bytes stay under the
    budget (a fill larger than the budget gets a chunk of its own)."""
    out, s, acc = [], 0, 0
    for k, b in enumerate(nbytes.tolist()):
        if k > s and acc + b > budget:
            out.append((s, k))
            s, acc = k, 0
        acc += b
    if s < len(nbytes):
        out.append((s, len(nbytes)))
    return out


def chunk_words(cig, n_cig, cig_off) -> np.ndarray:
    """A chunk's CIGAR words (the backtrack's slots cig_off, n_cig words
    used in each), compacted on the device and brought back as uint32."""
    m = n_cig.shape[0]
    slot = torch.repeat_interleave(torch.arange(m, device=cig.device),
                                   cig_off[1:] - cig_off[:-1])
    keep = (torch.arange(cig.shape[0], device=cig.device)
            - cig_off[:-1][slot] < n_cig[slot])
    return cig[keep].cpu().numpy().view(np.uint32)


def assemble_cigars(n: int, n_cig: np.ndarray, dev_idx: np.ndarray,
                    pieces: list, host_cig: dict
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(cig_off int64 [n + 1], cig_blob uint32) of a batch: the device
    fills dev_idx (their words in `pieces`, in dev_idx order) and the
    host-routed ones (host_cig: fill -> words)."""
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum(n_cig, out=cig_off[1:])
    cig_blob = np.empty(int(cig_off[-1]), np.uint32)
    if pieces:
        words = np.concatenate(pieces)
        cnt = n_cig[dev_idx]
        start = np.cumsum(cnt) - cnt
        within = np.arange(words.shape[0]) - np.repeat(start, cnt)
        cig_blob[np.repeat(cig_off[dev_idx], cnt) + within] = words
    for k, c in host_cig.items():
        cig_blob[cig_off[k]:cig_off[k + 1]] = c
    return cig_off, cig_blob


def upload(blob: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8 blob on the device, as it is."""
    return torch.from_numpy(np.ascontiguousarray(blob, np.uint8)).to(device)


def solve_chunks(dev_idx: np.ndarray, pb: np.ndarray, cap: np.ndarray,
                 extra, cols64: list, cols32: list, device: torch.device,
                 launch, backtrack):
    """The chunk loop of the fill batches.

    dev_idx: the device fills, longest first; pb: each one's direction
    bytes (p_bound); cap: its CIGAR slot in words; extra: the scratch
    bytes it takes beside them, or 0 (all in dev_idx order).  The fills
    run in chunks whose bytes stay under `gpucfg.fill_chunk_bytes`; per
    chunk the fills' cols64
    and cols32 (per-fill columns over the whole batch) go to the device
    as int64 and int32 in one copy each, then

        launch(c64, c32, p_off, p_total, events) -> (res, p)
        backtrack(p, p_off, c_off, c32, res, events) -> (cig, n_cig)

    run the fill kernel and the backtrack (c64, c32: the chunk's
    columns; events: a (start, end) pair of CUDA events the wrapper
    records right around its launch, None off the card), and the CIGAR
    words are compacted on the device before they come back.

    Returns (res rows in dev_idx order, n_cig in dev_idx order, the word
    pieces for assemble_cigars, kernel ms, backtrack ms, chunks)."""
    from mm2_gb_tpu_torch.utils.gpucfg import fill_chunk_bytes
    cuda = device.type == "cuda"
    rows, n_cig, pieces = [], [], []
    kms = bms = 0.0
    spans = _chunks(pb + 4 * cap + extra, fill_chunk_bytes(device))
    for c0, c1 in spans:
        idx = dev_idx[c0:c1]
        m = idx.shape[0]
        p_off = np.zeros(m + 1, np.int64)
        np.cumsum(pb[c0:c1], out=p_off[1:])
        c_off = np.zeros(m + 1, np.int64)
        np.cumsum(cap[c0:c1], out=c_off[1:])
        i64 = torch.from_numpy(np.concatenate(
            [c[idx] for c in cols64] + [p_off[:-1], c_off])).to(device)
        i32 = torch.from_numpy(np.concatenate(
            [c[idx] for c in cols32]).astype(np.int32)).to(device)
        k = len(cols64)
        c64 = [i64[j * m:(j + 1) * m] for j in range(k)]
        po, co = i64[k * m:(k + 1) * m], i64[(k + 1) * m:]
        c32 = [i32[j * m:(j + 1) * m] for j in range(len(cols32))]
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
              if cuda else [None] * 4)
        res, p = launch(c64, c32, po, int(p_off[-1]),
                        ev[:2] if cuda else None)
        cig, nc = backtrack(p, po, co, c32, res, ev[2:] if cuda else None)
        del p
        pieces.append(chunk_words(cig, nc, co))
        rows.append(res.cpu().numpy())
        n_cig.append(nc.cpu().numpy())
        if cuda:
            kms += ev[0].elapsed_time(ev[1])
            bms += ev[2].elapsed_time(ev[3])
    return (np.concatenate(rows), np.concatenate(n_cig), pieces, kms, bms,
            len(spans))


def _extd2_batch(meta, qblob, tblob, prm: FillParams, flag: int,
                 end_bonus: int, device, stats: FillStats, ext: bool):
    """extd2_fill_batch (ext False: meta [qlen, tlen, w, zdrop], zdrop
    unused) and extd2_ext_batch (meta [qlen, tlen, w, zdrop]): (scores
    [n] or EXT_FIELDS [n, 10], cig_off, cig_blob); the counts go to the
    gap-fill or the extension fields of stats."""
    t_start = time.perf_counter()
    device = torch.device(device)
    n = meta.shape[0]
    qlen, tlen, w, zdrop = meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3]
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    np.cumsum(qlen, out=qoff[1:])
    np.cumsum(tlen, out=toff[1:])
    wv = np.where(w < 0, np.maximum(qlen, tlen), w)
    right = bool(flag & ksw2.KSW_EZ_RIGHT)
    rev = bool(flag & ksw2.KSW_EZ_REV_CIGAR)
    host = (qlen <= 0) | (tlen <= 0) | band_collapses(qlen, tlen, wv)
    if prm.mat_gate:
        host[:] = True
    res = (np.empty((n, len(EXT_FIELDS)), np.int32) if ext
           else np.full(n, KSW_NEG_INF, np.int32))
    n_cig = np.zeros(n, np.int64)
    host_cig = {}
    for k in np.nonzero(host)[0].tolist():
        ez = ksw2.extd2(qblob[qoff[k]:qoff[k + 1]], tblob[toff[k]:toff[k + 1]],
                        prm.mat, prm.q, prm.e, prm.q2, prm.e2, int(w[k]),
                        int(zdrop[k]) if ext else -1,
                        end_bonus if ext else 0, flag)
        res[k] = ([int(getattr(ez, f)) for f in EXT_FIELDS] if ext
                  else ez.score)
        n_cig[k] = ez.cigar.shape[0]
        host_cig[k] = ez.cigar

    dev_idx = np.nonzero(~host)[0]
    dev_idx = dev_idx[np.argsort(-(qlen + tlen)[dev_idx], kind="stable")]
    pieces, kms, bms, chunks = [], 0.0, 0.0, 0
    if dev_idx.shape[0]:
        qb_d, tb_d = upload(qblob, device), upload(tblob, device)
        n_scr = 0

        def launch(c64, c32, po, p_total, events):
            nonlocal n_scr
            (qo, to), (ql, tl, wd, zd) = c64, c32
            shape = (ext_shape if ext else fill_shape)(ql.cpu().numpy(),
                                                      tl.cpu().numpy())
            n_scr += int((shape.scr_off >= 0).sum())
            if ext:
                return extd2_ext(qb_d, tb_d, qo, to, ql, tl, wd, zd, po,
                                 p_total, prm, right, end_bonus,
                                 events=events)
            return extd2_fill(qb_d, tb_d, qo, to, ql, tl, wd, po, p_total,
                              prm, right, events=events)

        def backtrack(p, po, co, c32, out, events):
            return ksw2_backtrack(p, po, *c32[:3], co, rev,
                                  starts=out[:, 10:] if ext else None,
                                  events=events)
        ql, tl = qlen[dev_idx], tlen[dev_idx]
        scr = scratch_bytes((ext_bytes if ext else fill_bytes)(ql, tl),
                            EXT_SMEM_MAX if ext else FILL_SMEM_MAX)
        # regions 16-aligned: the fill kernel stores 4 direction bytes at
        # once where its region allows
        out, n_cig[dev_idx], pieces, kms, bms, chunks = solve_chunks(
            dev_idx, (p_bound(ql, tl, wv[dev_idx]) + 15) // 16 * 16, ql + tl,
            scr, [qoff, toff], [qlen, tlen, w, zdrop], device, launch,
            backtrack)
        res[dev_idx] = out[:, :len(EXT_FIELDS)] if ext else out
        stats.scratch_fills += n_scr
    cells = int((qlen * tlen)[dev_idx].sum())
    cig_off, cig_blob = assemble_cigars(n, n_cig, dev_idx, pieces, host_cig)
    if ext:
        stats.ext_fills += n
        stats.ext_host_fills += len(host_cig)
        stats.ext_chunks += chunks
        stats.ext_cells += cells
        stats.ext_ms += kms
        stats.ext_backtrack_ms += bms
    else:
        stats.fills += n
        stats.device_fills += int(dev_idx.shape[0])
        stats.host_fills += len(host_cig)
        stats.chunks += chunks
        stats.cells += cells
        stats.fill_ms += kms
        stats.backtrack_ms += bms
    stats.batch_s += time.perf_counter() - t_start
    return res, cig_off, cig_blob


def extd2_fill_batch(meta: np.ndarray, qblob: np.ndarray,
                     tblob: np.ndarray, prm: FillParams,
                     device: torch.device | str,
                     flag: int = APPROX_MAX,
                     stats: FillStats | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve the gap fills `native.fill_fetch` returns.

    meta: (n, 4) int64 [qlen, tlen, w, zdrop] (zdrop does not act under
    APPROX_MAX); the sequences lie back to back in qblob/tblob in meta
    order.  flag: KSW_EZ_APPROX_MAX, optionally with KSW_EZ_RIGHT and
    KSW_EZ_REV_CIGAR.  Returns (scores int32 [n], cig_off int64 [n + 1],
    cig_blob uint32), the layout `native.fill_table_bulk` loads.

    The blobs go to the device once, as they are; the fills run longest
    first in chunks (solve_chunks), each one extd2_fill launch and one
    ksw2_backtrack launch.  Fills whose band collapses, fills with an
    empty side and every fill under a matrix that fails the mat gate
    take ksw2.extd2 on the host and are counted in stats.host_fills."""
    if not flag & APPROX_MAX or flag & ~(APPROX_MAX | ksw2.KSW_EZ_RIGHT
                                         | ksw2.KSW_EZ_REV_CIGAR):
        raise ValueError(f"extd2_fill_batch: unsupported flag {flag:#x}")
    return _extd2_batch(np.asarray(meta, np.int64).reshape(-1, 4), qblob,
                        tblob, prm, flag, 0, device,
                        stats if stats is not None else FillStats(), False)


def extd2_ext_batch(meta: np.ndarray, qblob: np.ndarray, tblob: np.ndarray,
                    zdrop: np.ndarray, prm: FillParams, flag: int,
                    end_bonus: int, device: torch.device | str,
                    stats: FillStats | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve a batch of extensions (ext_batch_device's work,
    ksw2_tpu.py:1672-1785).

    meta: (n, 3) int64 [qlen, tlen, w]; the sequences lie back to back
    in qblob/tblob in meta order; zdrop (n,) per fill.  flag:
    KSW_EZ_EXTZ_ONLY, optionally with KSW_EZ_RIGHT and KSW_EZ_REV_CIGAR;
    end_bonus for every fill.  Returns (fields int32 [n, 10], the
    EXT_FIELDS of each fill; cig_off int64 [n + 1], cig_blob uint32).

    As extd2_fill_batch, with one extd2_ext launch and one ksw2_backtrack
    launch from the starts the kernel picked per chunk.  Fills whose
    band collapses, fills with an empty side and every fill under a
    matrix that fails the mat gate take ksw2.extd2 on the host and are
    counted in stats.ext_host_fills."""
    ext_only = ksw2.KSW_EZ_EXTZ_ONLY
    if not flag & ext_only or flag & ~(ext_only | ksw2.KSW_EZ_RIGHT
                                       | ksw2.KSW_EZ_REV_CIGAR):
        raise ValueError(f"extd2_ext_batch: unsupported flag {flag:#x}")
    meta = np.asarray(meta, np.int64).reshape(-1, 3)
    zdrop = np.asarray(zdrop, np.int64).reshape(-1, 1)
    return _extd2_batch(np.concatenate([meta, zdrop], 1), qblob, tblob, prm,
                        flag, end_bonus, device,
                        stats if stats is not None else FillStats(), True)
