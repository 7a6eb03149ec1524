"""Gap fills on the GPU: the extd2 fill DP and its backtrack.

Port of the host half of mm2_gb_tpu/ops/ksw2_tpu.py for the gap fills
of `--gpu-align` (cigar + KSW_EZ_APPROX_MAX, optional KSW_EZ_RIGHT and
KSW_EZ_REV_CIGAR, no in-DP Z-drop): every fill the C++ aligner
records in its collect pass.  Two hand-written CUDA kernels do the work
(csrc/extd2_kernel.cu):

- `extd2_fill`: the dual affine-gap anti-diagonal DP of
  ops/ksw2.py::extd2 (ksw2_extd2_sse.c semantics: 16-aligned stale
  windows, the unaligned score-row store span, the boundary fallbacks,
  the approx-max H0 walk), one thread block per fill.  It writes each
  row's direction bytes over [st, en] into the fill's own region of `p`
  (rows packed at a running sum of their widths) and the score.
- `ksw2_backtrack`: ksw_backtrack with is_rot (ksw2.h:126-158), one
  thread per fill, run-length CIGAR words into a slot of qlen + tlen
  words per fill; with min_intron_len > 0 the intron mode of the splice
  fills (ops/ksw2s_gpu.py).

`extd2_fill_torch` and `ksw2_backtrack_torch` are their plain PyTorch
twins, same inputs and outputs; the wrappers take them only for tensors
on the CPU.  `extd2_fill_batch` takes what the native collect pass
returns (`native.fill_fetch`) and gives back what `native.fill_table_bulk`
loads.  Host route (ksw2.extd2, counted): band collapse, the
`-mat.min() > 2*(q+e)` gate and empty sides.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mm2_gb_tpu.ops import ksw2
from mm2_gb_tpu_torch.utils import kernels

KSW_NEG_INF = ksw2.KSW_NEG_INF
APPROX_MAX = ksw2.KSW_EZ_APPROX_MAX

fill_launches = 0       # extd2_fill kernel launches (CUDA tensors)
backtrack_launches = 0  # ksw2_backtrack kernel launches (CUDA tensors)

# fills whose state (10 rows of nbytes int8) exceeds this run with their
# state in a global scratch region instead of shared memory (the default
# 48 KiB of a block, less the kernel's static slots)
SMEM_STATE_MAX = 44 * 1024
# the kernel's state rows: u, y, y2, the score row, and x, v, x2 twice
# (double-buffered by row parity)
STATE_ROWS = 10


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
    """Counters of extd2_fill_batch (and ksw2s_gpu.exts2_fill_batch),
    summed over calls."""
    fills: int = 0          # fills asked for
    device_fills: int = 0   # solved by the fill + backtrack kernels
    host_fills: int = 0     # host route: collapse, mat gate, empty side
    scratch_fills: int = 0  # device fills whose state is in global scratch
    chunks: int = 0         # kernel launch pairs
    cells: int = 0          # sum of qlen * tlen over device fills
    fill_ms: float = 0.0    # extd2_fill kernel time (CUDA events)
    backtrack_ms: float = 0.0
    batch_s: float = 0.0    # wall time of extd2_fill_batch


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
    windows, in int32 holding the kernel's int8 values.  Returns
    (score int32 [n], p uint8 [p_total]): fill k's row r lies at
    p_off[k] + (sum of its earlier rows' widths), over [st, en]."""
    dev = qblob.device
    n = qlen.shape[0]
    score = torch.full((n,), KSW_NEG_INF, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total, dtype=torch.uint8, device=dev)
    if n == 0:
        return score, p
    i64, i32 = torch.int64, torch.int32
    ql0, tl0 = qlen.to(i64), tlen.to(i64)
    order = torch.argsort(ql0 + tl0, descending=True, stable=True)
    ql, tl, wv = ql0[order], tl0[order], w.to(i64)[order]
    wv = torch.where(wv < 0, torch.maximum(ql, tl), wv)
    qo, to, po = qoff.to(i64)[order], toff.to(i64)[order], \
        p_off.to(i64)[order]
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
    mat0, mat1, sc_n = prm.mat0, prm.mat1, prm.sc_n
    # state channels per (fill, column): the six DP rows, the score row
    # and (fixed) the target byte, zero past tlen
    U, V, X, Y, X2, Y2, S, TB = range(8)
    st8 = torch.tensor([nqe, nqe, nqe, nqe, nqe2, nqe2, 0, 0], dtype=i32,
                       device=dev)
    Z = st8.repeat(n, width, 1)
    cols = torch.arange(width - 2, device=dev)
    tsrc = to[:, None] + torch.minimum(cols, tl[:, None] - 1)
    Z[:, 1:-1, TB] = torch.where(cols < tl[:, None],
                                 tblob.to(i32)[tsrc], 0)
    # the query, one leading zero for r - t < 0
    qw = int(ql.max()) + 1
    qcols = torch.arange(qw - 1, device=dev)
    qsrc = qo[:, None] + torch.minimum(qcols, ql[:, None] - 1)
    QP = torch.zeros((n, qw), dtype=i32, device=dev)
    QP[:, 1:] = torch.where(qcols < ql[:, None], qblob.to(i32)[qsrc], 0)
    H0 = torch.zeros(n, dtype=i64, device=dev)
    lh = torch.zeros(n, dtype=i64, device=dev)
    last_st = torch.full((n,), -1, dtype=i64, device=dev)
    last_en = torch.full((n,), -1, dtype=i64, device=dev)
    row_off = torch.zeros(n, dtype=i64, device=dev)
    sc_out = torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev)

    def w8(x):   # the kernels' int8 casts
        return x.to(torch.int8).to(i32)

    def bound_v(r):
        if r == 0:
            return nqe
        if r < prm.long_thres:
            return _c8(-e)
        if r == prm.long_thres:
            return _c8(prm.long_diff)
        return _c8(-e2)

    for r in range(int(rows_h[0])):
        a = int(np.searchsorted(-rows_h, -r, side="left"))  # n_rows > r
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
        sc = torch.where(tbyte == qbyte, mat0, mat1).to(i32)
        sc = torch.where((tbyte == 4) | (qbyte == 4), sc_n, sc)
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
        # the cell update (csrc/ksw2kit.cpp extd2_row)
        av = w8(xt1 + vt1)
        bv = w8(yt + ut)
        a2 = w8(x2t1 + vt1)
        b2 = w8(y2t + ut)
        if right:
            d = torch.where(z > av, 0, 1)
            z = torch.maximum(z, av)
            d = torch.where(z > bv, d, 2)
            z = torch.maximum(z, bv)
            d = torch.where(z > a2, d, 3)
            z = torch.maximum(z, a2)
            d = torch.where(z > b2, d, 4)
            z = torch.maximum(z, b2)
        else:
            d = torch.where(av > z, 1, 0)
            z = torch.maximum(z, av)
            d = torch.where(bv > z, 2, d)
            z = torch.maximum(z, bv)
            d = torch.where(a2 > z, 3, d)
            z = torch.maximum(z, a2)
            d = torch.where(b2 > z, 4, d)
            z = torch.maximum(z, b2)
        z = torch.clamp(z, max=mat0)
        tq, tq2 = w8(z - q8), w8(z - q28)
        av, bv = w8(av - tq), w8(bv - tq)
        a2, b2 = w8(a2 - tq2), w8(b2 - tq2)
        if right:
            ta, tb, ta2, tb2 = av >= 0, bv >= 0, a2 >= 0, b2 >= 0
        else:
            ta, tb, ta2, tb2 = av > 0, bv > 0, a2 > 0, b2 > 0
        new = torch.stack([
            w8(z - vt1), w8(z - ut), w8(torch.where(ta, av, 0) - qe8),
            w8(torch.where(tb, bv, 0) - qe8),
            w8(torch.where(ta2, a2, 0) - qe28),
            w8(torch.where(tb2, b2, 0) - qe28)], -1)
        cur[:, :, :6] = torch.where(dp[:, :, None], new, cur[:, :, :6])
        cur[:, :, S] = torch.where(fresh, sc, cur[:, :, S])
        keep = dp | fresh
        Za.scatter_(1, torch.where(keep, col, trash)[:, :, None]
                    .expand(a, J, 8), cur)
        d = d | ta * 0x08 | tb * 0x10 | ta2 * 0x20 | tb2 * 0x40
        dst = po[:a, None] + row_off[:a, None] + (t - st[:, None])
        p[dst[dp]] = d[dp].to(torch.uint8)
        row_off[:a] += en - st + 1
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
        last_st[:a], last_en[:a] = st, en
    score[order] = sc_out.to(torch.int32)
    return score, p


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


def extd2_fill(qblob, tblob, qoff, toff, qlen, tlen, w, p_off,
               p_total: int, prm: FillParams, right: bool):
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
    build or launch failure raises."""
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
    # shared memory per block: the largest state that fits; larger fills
    # keep theirs in a global scratch region of their own
    tl = tlen.to(torch.int64)
    need = STATE_ROWS * ((tl + 15) // 16 * 16)
    big = need > SMEM_STATE_MAX
    scr_off = torch.where(big, torch.cumsum(torch.where(big, need, 0), 0)
                          - need, -1)
    n_big = int(big.sum())
    scratch = torch.empty(int(need[big].sum()) if n_big else 1,
                          dtype=torch.int8, device=dev)
    smem = int(need[~big].max()) if n_big < n else 16
    wv = torch.where(w < 0, torch.maximum(qlen, tlen), w).to(torch.int64)
    m = torch.minimum(torch.minimum(qlen.to(torch.int64), tl), wv + 1)
    threads = min(256, max(32, (int(m.max()) + 47) // 32 * 32))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mm2_extd2_fill(
        qblob.data_ptr(), tblob.data_ptr(), qoff.data_ptr(), toff.data_ptr(),
        qlen.data_ptr(), tlen.data_ptr(), w.data_ptr(), p_off.data_ptr(),
        scr_off.data_ptr(), n, scratch.data_ptr(), p.data_ptr(),
        score.data_ptr(), prm.qq, prm.ee, prm.qq2, prm.ee2, prm.mat0,
        prm.mat1, prm.sc_n, prm.long_thres, prm.long_diff, int(bool(right)),
        threads, smem, stream)
    kernels.check(rc, "extd2_fill")
    fill_launches += 1
    return score, p


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
                         min_intron_len: int = 0):
    """Plain PyTorch backtrack (the twin of the ksw2_backtrack kernel):
    every fill's walk from (tlen-1, qlen-1) advances in lockstep, one
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
                   min_intron_len: int = 0):
    """Backtrack n filled fills (the p, p_off of extd2_fill, or of
    ksw2s_gpu.exts2_fill with w = qlen + tlen; cig_off int64 [n + 1]
    with at least qlen[k] + tlen[k] words per fill).

    Returns (cig int32 [cig_off[-1]] holding uint32 CIGAR words, n_cig
    int32 [n]); reversed (KSW_EZ_REV_CIGAR order) where rev_cigar, a
    bool or a bool tensor [n].  min_intron_len > 0 is the splice fills'
    intron mode (N ops).  CPU tensors take the plain twin; CUDA tensors
    launch the kernel; a build or launch failure raises."""
    global backtrack_launches
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
    if p.device.type == "cpu":
        return ksw2_backtrack_torch(p, p_off, qlen, tlen, w, cig_off,
                                    rev_cigar, min_intron_len)
    if p.device.type != "cuda":
        raise ValueError(f"ksw2_backtrack: unsupported device {p.device}")
    lib = kernels.library()
    cig = torch.zeros(int(cig_off[-1]) if n else 0, dtype=torch.int32,
                      device=p.device)
    n_cig = torch.zeros(n, dtype=torch.int32, device=p.device)
    if n == 0:
        return cig, n_cig
    rc = lib.mm2_ksw2_backtrack(
        p.data_ptr(), p_off.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
        w.data_ptr(), cig_off.data_ptr(),
        None if rev_fill is None else rev_fill.data_ptr(), n,
        int(bool(rev_cigar)) if rev_fill is None else 0,
        int(min_intron_len), cig.data_ptr(), n_cig.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    kernels.check(rc, "ksw2_backtrack")
    backtrack_launches += 1
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
    first in chunks under `gpucfg.fill_chunk_bytes`, each one extd2_fill
    launch and one ksw2_backtrack launch, and the CIGAR words are
    compacted on the device before they come back.  Fills whose band
    collapses, fills with an empty side and every fill under a matrix
    that fails the mat gate take ksw2.extd2 on the host and are counted
    in stats.host_fills."""
    from mm2_gb_tpu_torch.utils.gpucfg import fill_chunk_bytes
    if not flag & APPROX_MAX or flag & ~(APPROX_MAX | ksw2.KSW_EZ_RIGHT
                                         | ksw2.KSW_EZ_REV_CIGAR):
        raise ValueError(f"extd2_fill_batch: unsupported flag {flag:#x}")
    t_start = time.perf_counter()
    device = torch.device(device)
    stats = stats if stats is not None else FillStats()
    meta = np.asarray(meta, np.int64).reshape(-1, 4)
    n = meta.shape[0]
    qlen, tlen, w = meta[:, 0], meta[:, 1], meta[:, 2]
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
    scores = np.full(n, KSW_NEG_INF, np.int32)
    n_cig = np.zeros(n, np.int64)
    host_cig = {}
    for k in np.nonzero(host)[0].tolist():
        ez = ksw2.extd2(qblob[qoff[k]:qoff[k + 1]], tblob[toff[k]:toff[k + 1]],
                        prm.mat, prm.q, prm.e, prm.q2, prm.e2, int(w[k]), -1,
                        0, flag)
        scores[k] = ez.score
        n_cig[k] = ez.cigar.shape[0]
        host_cig[k] = ez.cigar

    dev_idx = np.nonzero(~host)[0]
    dev_idx = dev_idx[np.argsort(-(qlen + tlen)[dev_idx], kind="stable")]
    pieces = []
    if dev_idx.shape[0]:
        pb = p_bound(qlen, tlen, wv)[dev_idx]
        cap = (qlen + tlen)[dev_idx]
        qb_d = torch.from_numpy(np.ascontiguousarray(qblob, np.uint8)).to(
            device)
        tb_d = torch.from_numpy(np.ascontiguousarray(tblob, np.uint8)).to(
            device)
        cuda = device.type == "cuda"
        for c0, c1 in _chunks(pb + 4 * cap, fill_chunk_bytes(device)):
            idx = dev_idx[c0:c1]
            m = idx.shape[0]
            p_off = np.zeros(m + 1, np.int64)
            np.cumsum(pb[c0:c1], out=p_off[1:])
            c_off = np.zeros(m + 1, np.int64)
            np.cumsum(cap[c0:c1], out=c_off[1:])
            i64 = torch.from_numpy(np.concatenate(
                [qoff[idx], toff[idx], p_off[:-1], c_off])).to(device)
            i32 = torch.from_numpy(np.concatenate(
                [qlen[idx], tlen[idx], w[idx]]).astype(np.int32)).to(device)
            qo, to, po, co = (i64[:m], i64[m:2 * m], i64[2 * m:3 * m],
                              i64[3 * m:])
            ql, tl, wd = i32[:m], i32[m:2 * m], i32[2 * m:]
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            sc, p = extd2_fill(qb_d, tb_d, qo, to, ql, tl, wd, po,
                               int(p_off[-1]), prm, right)
            if cuda:
                ev[1].record()
            cig, nc = ksw2_backtrack(p, po, ql, tl, wd, co, rev)
            if cuda:
                ev[2].record()
            del p
            pieces.append(chunk_words(cig, nc, co))
            scores[idx] = sc.cpu().numpy()
            n_cig[idx] = nc.cpu().numpy()
            if cuda:
                stats.fill_ms += ev[0].elapsed_time(ev[1])
                stats.backtrack_ms += ev[1].elapsed_time(ev[2])
            stats.chunks += 1
        stats.cells += int((qlen * tlen)[dev_idx].sum())
        nb = (tlen[dev_idx] + 15) // 16 * 16
        stats.scratch_fills += int((STATE_ROWS * nb > SMEM_STATE_MAX).sum())

    cig_off, cig_blob = assemble_cigars(n, n_cig, dev_idx, pieces, host_cig)
    stats.fills += n
    stats.device_fills += int(dev_idx.shape[0])
    stats.host_fills += len(host_cig)
    stats.batch_s += time.perf_counter() - t_start
    return scores, cig_off, cig_blob
