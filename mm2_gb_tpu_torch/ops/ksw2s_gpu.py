"""Splice gap fills and splice extensions on the GPU: the exts2 DP and its
intron backtrack.

Port of the host half of mm2_gb_tpu/ops/ksw2_tpu.py::exts2_batch_device
for the gap fills of `-x splice --gpu-align` (cigar + KSW_EZ_APPROX_MAX
with any of KSW_EZ_SPLICE_FOR/REV/FLANK, KSW_EZ_RIGHT and
KSW_EZ_REV_CIGAR, per fill): every fill the Python align driver records
in its collect pass (models/pipeline.py::_prefill_device).  Two
hand-written CUDA kernels do the work:

- `exts2_fill` (csrc/exts2_kernel.cu): the splice DP of
  ops/ksw2_splice.py::exts2 (ksw2_exts2_sse.c semantics), a warp per
  narrow fill and a block per wide one (`fill_shape` picks each fill's
  class; one launch holds both), state in rings of lanes that slide
  along the target, the target, junction and query bytes staged a batch
  of rows ahead, donor and acceptor scores made on the device from them.
  Direction rows are packed as extd2_fill's.
- `ksw2_backtrack` (ops/ksw2_gpu.py, csrc/extd2_kernel.cu) in intron
  mode: min_intron_len = long_thres, and w = qlen + tlen, under which its
  row windows are the unbanded ones.

The same file's extension kernel, `exts2_ext` (the JAX package's
`exts2_fwd_tpu(track_h=True)`; the fill kernel's classes and rings,
`ext_ring_shape`), runs the splice DP
without KSW_EZ_APPROX_MAX: the H row, the ranked row maximum, mqe, mte,
Z-drop with gap extension 0, and the backtrack start picked on the card;
`exts2_ext_batch` solves a batch of such calls (splice extensions, with
or without KSW_EZ_EXTZ_ONLY) with the backtrack from per-fill starts in
intron mode.  No JAX path calls that branch, and neither does the CLI:
the align driver runs splice extensions on the host.

`splice_sites_torch`, `exts2_fill_torch` and `exts2_ext_torch` are the
plain PyTorch versions; the wrappers take the twins only for CPU
tensors.  There is no size cap: the TPU sent every fill longer than 4096
to the host.  Host route (ksw2_splice.exts2, counted): an empty side,
q2 <= q + e, and the `-mat.min() > 2*(q+e)` gate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mm2_gb_tpu_torch.ops import ksw2, ksw2_splice
from mm2_gb_tpu_torch.ops.ksw2_gpu import (EXT_FIELDS, FILL_WARPS,
                                           KSW_NEG_INF, LONG_FILLS,
                                           FillShape, FillStats, _c8,
                                           _record, _track_h_row,
                                           assemble_cigars, class_shape,
                                           ksw2_backtrack, p_bound,
                                           scratch_bytes, shape_operands,
                                           solve_chunks, upload)
from mm2_gb_tpu_torch.utils import kernels

APPROX_MAX = ksw2.KSW_EZ_APPROX_MAX
RIGHT = ksw2.KSW_EZ_RIGHT
REV_CIGAR = ksw2.KSW_EZ_REV_CIGAR
S_FOR, S_REV = ksw2.KSW_EZ_SPLICE_FOR, ksw2.KSW_EZ_SPLICE_REV
S_FLANK = ksw2.KSW_EZ_SPLICE_FLANK
EXTZ_ONLY = ksw2.KSW_EZ_EXTZ_ONLY
FLAG_BITS = S_FOR | S_REV | S_FLANK | RIGHT | REV_CIGAR   # beside APPROX_MAX

fill_launches = 0   # exts2_fill kernel launches (CUDA tensors)
ext_launches = 0    # exts2_ext kernel launches (CUDA tensors)

# fill mode (exts2_fill): thirteen byte rings of fill_ring_lanes lanes
# (u, y, the score row, x, v and x2 twice by row parity, donor, acceptor,
# the target bases with their junction bits, the query) and the H0 walk's
# four int32 slots.  A fill whose ring has at most WARP_RING lanes takes
# a warp (FILL_WARPS to a block), a wider one a block of 256 threads, as
# do the LONG_FILLS longest of a launch (ksw2_gpu.class_shape); a
# block-class fill whose rings exceed FILL_SMEM_MAX bytes keeps them in a
# global scratch region of its own.
FILL_LANE_BYTES = 13
FILL_RING_PAD = 80     # the kernel's kRingPad: kBatch (32) + 34 and more
WARP_RING = 256
FILL_SMEM_MAX = FILL_LANE_BYTES * 2048 + 16   # rings of 2048 lanes
# extension mode (exts2_ext): the fill kernel's classes and rings with
# the int32 H ring beside them (ext_ring_bytes); a block-class ring past
# EXT_SMEM_MAX (1024 lanes) stays in a global scratch region of its own.
# No LONG_FILLS rule, as for ksw2_gpu.ext_shape.
EXT_SMEM_MAX = 24 * 1024


@dataclass
class SpliceParams:
    """Kernel constants of one option set (exts2_batch_device's
    derivation, ksw2_tpu.py:816-825; no q/e swap)."""
    mat: np.ndarray
    q: int
    e: int
    q2: int           # the intron open cost
    noncan: int
    junc_bonus: int
    mat0: int
    mat1: int
    sc_n: int
    long_thres: int   # also the backtrack's min_intron_len
    long_diff: int
    host_only: bool   # q2 <= q + e, or -mat.min() > 2*(q+e): every fill
                      # on the host


def splice_params_from(mat: np.ndarray, q: int, e: int, q2: int,
                       noncan: int, junc_bonus: int) -> SpliceParams:
    mat = np.asarray(mat, np.int8)
    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    return SpliceParams(
        mat, q, e, q2, noncan, junc_bonus, int(mat[0]), int(mat[1]),
        -e if int(mat[24]) == 0 else int(mat[24]), long_thres,
        long_thres * e - (q2 - q),
        q2 <= q + e or -int(mat.min()) > 2 * (q + e))


def splice_params(opt) -> SpliceParams:
    """SpliceParams of a MapOptions (scoring matrix, gap and intron
    costs, non-canonical site cost, BED junction bonus)."""
    return splice_params_from(
        ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi), opt.q, opt.e,
        opt.q2, opt.noncan, opt.junc_bonus)


def ring_lanes(qlen, tlen, pad: int = 32, least: int = 32):
    """Lanes of a state ring: the least power of two, at least `least`,
    not below min(qlen, tlen) + pad (numpy arrays or tensors)."""
    if isinstance(qlen, torch.Tensor):
        m = torch.minimum(qlen, tlen).to(torch.int64) + pad
        return torch.clamp(2 ** torch.ceil(torch.log2(m.double())).long(),
                           min=least)
    m = np.minimum(np.asarray(qlen, np.int64), np.asarray(tlen, np.int64))
    return np.maximum(least, 2 ** np.ceil(np.log2(m + pad)).astype(np.int64))


def fill_ring_lanes(qlen, tlen):
    """Lanes of a fill's rings in the fill kernel (its fill_ring): the
    least power of two, at least 64, not below min(qlen, tlen) +
    FILL_RING_PAD."""
    return ring_lanes(qlen, tlen, FILL_RING_PAD, 64)


def fill_bytes(qlen, tlen):
    """Bytes of a fill's rings and slots in the fill kernel, a multiple
    of 16."""
    return FILL_LANE_BYTES * fill_ring_lanes(qlen, tlen) + 16


def ext_ring_bytes(qlen, tlen):
    """Bytes of an extension's rings in the extension kernel: the fill
    kernel's and the int32 H ring."""
    return fill_bytes(qlen, tlen) + 4 * fill_ring_lanes(qlen, tlen)


def ext_ring_shape(qlen, tlen) -> FillShape:
    """exts2_ext's launch over n extensions (numpy arrays, in launch
    order, longest first): a warp for an extension whose rings have at
    most WARP_RING lanes, else a block (ksw2_gpu.class_shape, with
    EXT_SMEM_MAX and no LONG_FILLS rule)."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    return class_shape(ext_ring_bytes(qlen, tlen), qlen + tlen - 1,
                       fill_ring_lanes(qlen, tlen) <= WARP_RING,
                       EXT_SMEM_MAX, 0)


def fill_shape(qlen, tlen) -> FillShape:
    """exts2_fill's launch over n fills (numpy arrays, in launch order,
    longest first): a warp for a fill whose rings have at most WARP_RING
    lanes, else a block (ksw2_gpu.class_shape, with FILL_SMEM_MAX)."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    return class_shape(fill_bytes(qlen, tlen), qlen + tlen - 1,
                       fill_ring_lanes(qlen, tlen) <= WARP_RING,
                       FILL_SMEM_MAX)


# --------------------------------------------------------------------------
# donor / acceptor scores (ksw2kit.cpp:701-753, ksw2_splice._splice_sites)
# --------------------------------------------------------------------------

def _site_scores(tblob, jblob, toff, joff, tlen, flag, t, noncan: int,
                 junc_bonus: int):
    """Donor and acceptor scores (int32 holding int8 values) at lanes t
    (int64 [a, J]) of a fills; toff, joff (< 0: no junction bytes), tlen
    and flag are int64 [a, 1].  Lanes outside [0, tlen) get the -noncan
    pad."""
    i32 = torch.int32

    def at(blob, off, k, ok):
        if blob.numel() == 0:
            return torch.zeros_like(k, dtype=i32)
        ok = ok & (k >= 0) & (k < tlen)
        idx = torch.clamp(off + torch.clamp(k, min=0), 0, blob.numel() - 1)
        return torch.where(ok, blob[idx].to(i32), -1)

    t = t + torch.zeros_like(toff)    # [a, J]
    yes = torch.ones_like(t, dtype=torch.bool)
    has_j = (joff >= 0).expand_as(t)
    sfor, srev = (flag & S_FOR) != 0, (flag & S_REV) != 0
    rc = (flag & REV_CIGAR) != 0
    semi = torch.where((flag & S_FLANK) != 0, -int(noncan / 2), 0)
    pad = torch.full_like(t, _c8(-noncan), dtype=i32)
    # donors: GTr... (CTr... on the reverse strand); GAy.../CAy... when
    # the fill is reversed (REV_CIGAR)
    a, b, d = (at(tblob, toff, t + k, yes) for k in (1, 2, 3))
    can = torch.where(rc, (sfor & (a == 2) & (b == 0))
                      | (srev & (a == 1) & (b == 0)),
                      (sfor & (a == 2) & (b == 3))
                      | (srev & (a == 1) & (b == 3)))
    full = can & torch.where(rc, (d == 1) | (d == 3), (d == 0) | (d == 2))
    dn = torch.where(can & (t < tlen - 4), torch.where(full, 0, semi), pad)
    j = at(jblob, joff, t + 1, has_j & (t < tlen - 1))
    bonus = torch.where(rc, (sfor & (j & 2 > 0)) | (srev & (j & 4 > 0)),
                        (sfor & (j & 1 > 0)) | (srev & (j & 8 > 0)))
    dn = torch.where(bonus & (j >= 0), _w8(dn + junc_bonus), dn)
    # acceptors: ...yAG (...yAC); ...rTG/...rTC when reversed
    a, b, d = (at(tblob, toff, t + k, yes) for k in (-1, 0, -2))
    can = torch.where(rc, (sfor & (a == 3) & (b == 2))
                      | (srev & (a == 3) & (b == 1)),
                      (sfor & (a == 0) & (b == 2))
                      | (srev & (a == 0) & (b == 1)))
    full = can & torch.where(rc, (d == 0) | (d == 2), (d == 1) | (d == 3))
    ac = torch.where(can & (t >= 2), torch.where(full, 0, semi), pad)
    j = at(jblob, joff, t, has_j)
    bonus = torch.where(rc, (sfor & (j & 1 > 0)) | (srev & (j & 8 > 0)),
                        (sfor & (j & 2 > 0)) | (srev & (j & 4 > 0)))
    ac = torch.where(bonus & (j >= 0), _w8(ac + junc_bonus), ac)
    spliced = (sfor | srev).expand_as(t)
    return torch.where(spliced, dn, pad), torch.where(spliced, ac, pad)


def _w8(x):
    """The int8 value each element truncates to (the kernels' casts)."""
    return x.to(torch.int8).to(torch.int32)


def splice_sites_torch(tseq, tlen: int, nbytes: int, noncan: int,
                       junc_bonus: int, flag: int, junc=None):
    """ksw2_splice._splice_sites in PyTorch: (donor, acceptor) int8
    tensors of nbytes lanes, the -noncan pad past tlen."""
    tb = torch.as_tensor(np.ascontiguousarray(tseq, np.uint8))
    jb = (torch.empty(0, dtype=torch.uint8) if junc is None
          else torch.as_tensor(np.ascontiguousarray(junc, np.uint8)))
    col = torch.tensor([[0]])
    dn, ac = _site_scores(tb, jb, col, col - int(junc is None), col + tlen,
                          col + flag, torch.arange(nbytes)[None, :], noncan,
                          junc_bonus)
    return dn[0].to(torch.int8), ac[0].to(torch.int8)


# --------------------------------------------------------------------------
# the fill: plain twin and kernel wrapper
# --------------------------------------------------------------------------

def exts2_fill_torch(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                     flags, p_off, p_total: int, prm: SpliceParams):
    """Plain PyTorch exts2 fill (the twin of the exts2_fill kernel).

    Anti-diagonals r = 0, 1, ... are stepped in Python; each step is
    vectorized over the fills still that long x the columns of their
    windows.  The state is int8 and its arithmetic wraps as the kernel's
    int8 casts do; it is kept in absolute lane coordinates (column c
    holds lane c - 1), not the kernel's ring.  Returns (score int32 [n],
    p uint8 [p_total]): fill k's row r lies at p_off[k] + (sum of its
    earlier rows' widths), over [st, en]."""
    return _exts2_rows(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                       flags, p_off, p_total, prm)


def exts2_ext_torch(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                    flags, zdrop, p_off, p_total: int, prm: SpliceParams):
    """Plain PyTorch exts2 extension (the twin of the exts2_ext kernel):
    the fill twin's row loop with the H row, the ranked row maximum, mqe,
    mte and Z-drop with gap extension 0 (ksw2_splice.py:239-258), and
    the backtrack start of ksw2_splice.py:284-291.  Returns (ext int32
    [n, 12]: the EXT_FIELDS (reach_end 0), then the backtrack start i0,
    j0 (-1: none); p uint8 [p_total], rows after a Z-drop left 0)."""
    return _exts2_rows(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                       flags, p_off, p_total, prm, zdrop)


def _exts2_rows(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen, flags,
                p_off, p_total: int, prm: SpliceParams, zdrop=None):
    """The row loop of both twins; extension mode when zdrop is given."""
    dev = qblob.device
    n = qlen.shape[0]
    track_h = zdrop is not None
    if track_h:
        out = torch.full((n, 12), -1, dtype=torch.int32, device=dev)
    else:
        out = torch.full((n,), KSW_NEG_INF, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total + 1, dtype=torch.uint8, device=dev)  # + trash
    if n == 0:
        return out, p[:p_total]
    i64, i8 = torch.int64, torch.int8
    ql0, tl0 = qlen.to(i64), tlen.to(i64)
    order = torch.argsort(ql0 + tl0, descending=True, stable=True)
    ql, tl = ql0[order], tl0[order]
    qo, to, jo, po, fl = (x.to(i64)[order]
                          for x in (qoff, toff, joff, p_off, flags))
    n_rows = ql + tl - 1
    rows_h = n_rows.cpu().numpy()
    # the row windows' widths come from host copies, so that the loop
    # never waits for the device
    ql_h, tl_h = ql.cpu().numpy(), tl.cpu().numpy()
    nb_h = (tl_h + 15) // 16 * 16
    nbytes = (tl + 15) // 16 * 16
    width = int(nbytes.max()) + 2        # column c holds lane c - 1
    trash = width - 1                    # masked-off scatters land here
    q, e, q2 = prm.q, prm.e, prm.q2
    nqe, nq2 = _c8(-q - e), _c8(-q2)
    qe8, q8, q28 = _c8(q + e), _c8(q), _c8(q2)
    mat0, mat1, sc_n = _c8(prm.mat0), _c8(prm.mat1), _c8(prm.sc_n)
    # channels per (fill, column): the five DP rows, the score row, and
    # (fixed) the donor and acceptor scores
    U, V, X, Y, X2, S, DN, AC = range(8)
    Z = torch.tensor([nqe, nqe, nqe, nqe, nq2, 0, 0, 0], dtype=i8,
                     device=dev).repeat(n, width, 1)
    lanes = torch.arange(width - 2, device=dev)[None, :]
    step = max(1, (1 << 22) // width)    # fills per block of site scores
    for b in range(0, n, step):
        s_ = slice(b, b + step)
        dn, ac = _site_scores(tblob, jblob, to[s_, None], jo[s_, None],
                              tl[s_, None], fl[s_, None], lanes, prm.noncan,
                              prm.junc_bonus)
        Z[s_, 1:-1, DN], Z[s_, 1:-1, AC] = dn.to(i8), ac.to(i8)
    # the query, one leading zero for r - t < 0
    qw = int(ql.max()) + 1
    qcols = torch.arange(qw - 1, device=dev)
    qsrc = qo[:, None] + torch.minimum(qcols, ql[:, None] - 1)
    QP = torch.zeros((n, qw), dtype=torch.uint8, device=dev)
    QP[:, 1:] = torch.where(qcols < ql[:, None], qblob[qsrc], 0)
    right = ((fl & RIGHT) != 0)[:, None]
    H0 = torch.zeros(n, dtype=i64, device=dev)
    lh = torch.zeros(n, dtype=i64, device=dev)
    last_st = torch.full((n,), -1, dtype=i64, device=dev)
    last_en = torch.full((n,), -1, dtype=i64, device=dev)
    row_off = torch.zeros(n, dtype=i64, device=dev)
    sc_out = torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev)
    zero = torch.zeros((), dtype=i8, device=dev)
    if track_h:   # the H row and the oracle's Extz fields
        Hs = torch.full((n, width), KSW_NEG_INF, dtype=i64, device=dev)
        ez = dict(ql=ql, tl=tl, n_rows=n_rows, sc_out=sc_out,
                  zd=zdrop.to(dev, i64)[order],
                  mx=torch.zeros(n, dtype=i64, device=dev),
                  mqe=torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev),
                  mte=torch.full((n,), KSW_NEG_INF, dtype=i64, device=dev),
                  dropped=torch.zeros(n, dtype=torch.bool, device=dev),
                  **{k: torch.full((n,), -1, dtype=i64, device=dev)
                     for k in ("max_t", "max_q", "mqe_t", "mte_q")})

    def bound_v(r):
        if r == 0:
            return nqe
        if r < prm.long_thres:
            return _c8(-e)
        if r == prm.long_thres:
            return _c8(prm.long_diff)
        return 0

    for r in range(int(rows_h[0])):
        a = int(np.searchsorted(-rows_h, -r, side="left"))  # n_rows > r
        if track_h and r % 64 == 63 and bool(ez["dropped"][:a].all()):
            break   # every fill still this long has dropped
        qla, tla = ql[:a], tl[:a]
        st0 = torch.clamp(r - qla + 1, min=0)
        en0 = torch.clamp(tla - 1, max=r)
        st, en = st0 & -16, en0 | 15
        hi = torch.minimum(st0 + 16 * ((en0 - st0) // 16 + 1), nbytes[:a])
        s0 = np.maximum(r - ql_h[:a] + 1, 0)
        e0 = np.minimum(tl_h[:a] - 1, r)
        h0 = np.minimum(s0 + 16 * ((e0 - s0) // 16 + 1), nb_h[:a])
        J = int((np.maximum(e0 | 15, h0 - 1) - (s0 & -16)).max()) + 1
        t = st[:, None] + torch.arange(J, device=dev)
        col = torch.clamp(t + 1, max=trash)
        dp = t <= en[:, None]
        fresh = (t >= st0[:, None]) & (t < hi[:, None])
        Za = Z[:a]
        cur = Za.gather(1, col[:, :, None].expand(a, J, 8))
        prev = Za.gather(1, (col - 1)[:, :, None].expand(a, J, 8))
        # the score row (ksw2._row_scores over [st0, hi))
        qbyte = QP[:a].gather(1, torch.clamp(r - t + 1, 0, qw - 1))
        tsrc = to[:a, None] + torch.minimum(t, tla[:, None] - 1)
        tbyte = torch.where(t < tla[:, None], tblob[tsrc], 0)
        sc = torch.where((tbyte == 4) | (qbyte == 4), sc_n,
                         torch.where(tbyte == qbyte, mat0, mat1)).to(i8)
        z = torch.where(fresh, sc, cur[:, :, S])
        # x, v, x2 of the previous row at t - 1, and the boundary values
        xt1, vt1, x2t1 = prev[:, :, X], prev[:, :, V], prev[:, :, X2]
        inb = (st > 0) & (last_st[:a] <= st - 1) & (st - 1 <= last_en[:a])
        xt1[:, 0] = torch.where(inb, xt1[:, 0], nqe)
        x2t1[:, 0] = torch.where(inb, x2t1[:, 0], nq2)
        vt1[:, 0] = torch.where(st > 0, torch.where(inb, vt1[:, 0], nqe),
                                bound_v(r))
        reset = (t == r) & (en >= r)[:, None]
        ut = torch.where(reset, bound_v(r), cur[:, :, U])
        yt = torch.where(reset, nqe, cur[:, :, Y])
        dnv = cur[:, :, DN]
        # the cell update (csrc/ksw2kit.cpp exts2_row), int8 wrapping
        av = xt1 + vt1
        bv = yt + ut
        a2 = x2t1 + vt1
        a2a = a2 + cur[:, :, AC]
        ra = right[:a]
        z1 = torch.maximum(z, av)
        z2 = torch.maximum(z1, bv)
        zf = torch.maximum(z2, a2a)
        d_left = torch.where(a2a > z2, 3, torch.where(
            bv > z1, 2, (av > z).to(i8)))
        d_right = torch.where(z2 > a2a, torch.where(
            z1 > bv, (z <= av).to(i8), 2), 3)
        d = torch.where(ra, d_right, d_left).to(torch.uint8)
        tq = zf - q8
        av, bv = av - tq, bv - tq
        a2 = a2 - (zf - q28)
        ta = torch.where(ra, av >= 0, av > 0)
        tb = torch.where(ra, bv >= 0, bv > 0)
        ta2 = torch.where(ra, a2 >= dnv, a2 > dnv)
        new = torch.stack([
            zf - vt1, zf - ut, torch.where(ta, av, zero) - qe8,
            torch.where(tb, bv, zero) - qe8,
            torch.where(ta2, a2, dnv) - q28], -1)
        cur[:, :, :5] = torch.where(dp[:, :, None], new, cur[:, :, :5])
        cur[:, :, S] = torch.where(fresh, sc, cur[:, :, S])
        Za.scatter_(1, torch.where(dp | fresh, col, trash)[:, :, None]
                    .expand(a, J, 8), cur)
        d = (d | ta * 0x08 | tb * 0x10 | ta2 * 0x20).to(torch.uint8)
        dst = po[:a, None] + row_off[:a, None] + (t - st[:, None])
        wr = dp & ~ez["dropped"][:a, None] if track_h else dp
        p.scatter_(0, torch.where(wr, dst, p_total).reshape(-1),
                   d.reshape(-1))
        row_off[:a] += en - st + 1
        if track_h:
            _track_h_row(r, a, t, col, st, st0, en, en0, new, Hs, trash, ez,
                         q + e, 0)
            last_st[:a], last_en[:a] = st, en
            continue
        # the approx-max H0 walk (ksw2_splice.py:259-281)
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
    if not track_h:
        out[order] = sc_out.to(torch.int32)
        return out, p[:p_total]
    # the backtrack start (ksw2_splice.py:284-291)
    mx, max_t, max_q = ez["mx"], ez["max_t"], ez["max_q"]
    dropped = ez["dropped"]
    whole = ~dropped & ((fl & EXTZ_ONLY) == 0)
    has_max = (max_t >= 0) & (max_q >= 0)
    i0 = torch.where(whole, tl - 1, torch.where(has_max, max_t, -1))
    j0 = torch.where(whole, ql - 1, torch.where(has_max, max_q, -1))
    out[order] = torch.stack([sc_out, mx, max_t, max_q, ez["mqe"],
                              ez["mqe_t"], ez["mte"], ez["mte_q"],
                              dropped.to(i64), torch.zeros_like(sc_out), i0,
                              j0], 1).to(torch.int32)
    return out, p[:p_total]


def exts2_fill(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen, flags,
               p_off, p_total: int, prm: SpliceParams, events=None):
    """The exts2 splice fill DP of n fills (APPROX_MAX, no Z-drop).

    qblob/tblob: uint8 base codes (0..4) of all queries and targets;
    fill k is qblob[qoff[k]:qoff[k] + qlen[k]] against
    tblob[toff[k]:toff[k] + tlen[k]] under the KSW_EZ_* flag flags[k],
    with the BED junction bytes jblob[joff[k]:joff[k] + tlen[k]]
    (joff[k] < 0: none).  Every fill must be non-empty and
    `prm.host_only` False: those fills belong to the host route.
    Region k of p starts at p_off[k] and holds p_bound(qlen[k], tlen[k],
    qlen[k] + tlen[k]) bytes.

    Returns (score int32 [n], p uint8 [p_total]).  CPU tensors take the
    plain twin; CUDA tensors launch the kernel (built on first use); a
    build or launch failure raises.  events: a (start, end) pair of CUDA
    events recorded right around the launch, or None."""
    return _exts2_launch("exts2_fill", qblob, tblob, jblob, qoff, toff, joff,
                         qlen, tlen, flags, None, p_off, p_total, prm, events)


def exts2_ext(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen, flags,
              zdrop, p_off, p_total: int, prm: SpliceParams, events=None):
    """The exts2 splice DP of n fills in extension mode (no
    KSW_EZ_APPROX_MAX; KSW_EZ_EXTZ_ONLY, RIGHT, REV_CIGAR and the splice
    bits per fill in flags): operands as exts2_fill's, with zdrop int32
    [n] (< 0: no Z-drop).  Every fill must be non-empty and
    `prm.host_only` False.

    Returns (ext int32 [n, 12]: score, max, max_t, max_q, mqe, mqe_t,
    mte, mte_q, zdropped, reach_end (0), and the backtrack start i0, j0
    (-1: none) for ksw2_backtrack's `starts`; p uint8 [p_total], rows
    after a Z-drop left 0).  CPU tensors take the plain twin; CUDA
    tensors launch the kernel (built on first use); a build or launch
    failure raises.  events: a (start, end) pair of CUDA events recorded
    right around the launch, or None."""
    return _exts2_launch("exts2_ext", qblob, tblob, jblob, qoff, toff, joff,
                         qlen, tlen, flags, zdrop, p_off, p_total, prm, events)


def _exts2_launch(what, qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                  flags, zdrop, p_off, p_total: int, prm: SpliceParams,
                  events):
    """exts2_fill (zdrop None) and exts2_ext: the operand checks, the twin
    for CPU tensors, else one launch of the kernel in its mode."""
    global fill_launches, ext_launches
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    ext = zdrop is not None
    named = [("qblob", qblob, u8), ("tblob", tblob, u8), ("jblob", jblob, u8),
             ("qoff", qoff, i64), ("toff", toff, i64), ("joff", joff, i64),
             ("qlen", qlen, i32), ("tlen", tlen, i32), ("flags", flags, i32),
             ("p_off", p_off, i64)] + ([("zdrop", zdrop, i32)] if ext else [])
    n = qlen.shape[0]
    for name, t, dt in named:
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D "
                             f"{dt} tensor")
        if t.device != qblob.device:
            raise ValueError(f"{what}: {name} is on {t.device}, qblob "
                             f"on {qblob.device}")
        if name not in ("qblob", "tblob", "jblob") and t.shape[0] != n:
            raise ValueError(f"{what}: {name} has {t.shape[0]} "
                             f"elements, expected {n}")
    if prm.host_only:
        raise ValueError(f"{what}: these options take the host route "
                         "(q2 <= q+e or -mat.min() > 2*(q+e))")
    if qblob.device.type == "cpu":
        return _exts2_rows(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen,
                           flags, p_off, p_total, prm, zdrop)
    if qblob.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qblob.device}")
    lib = kernels.library()
    dev = qblob.device
    out = (torch.full((n, 12), -1, dtype=i32, device=dev) if ext
           else torch.full((n,), KSW_NEG_INF, dtype=i32, device=dev))
    p = torch.zeros(p_total, dtype=u8, device=dev)
    if n == 0:
        return out, p
    stream = torch.cuda.current_stream(dev).cuda_stream
    sh = (ext_ring_shape if ext else fill_shape)(qlen.cpu().numpy(),
                                                 tlen.cpu().numpy())
    scr_off, work, scratch = shape_operands(sh, dev)
    _record(events, 0)
    if ext:
        rc = lib.mm2_exts2_ext(
            qblob.data_ptr(), tblob.data_ptr(), jblob.data_ptr(),
            qoff.data_ptr(), toff.data_ptr(), joff.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), flags.data_ptr(),
            zdrop.data_ptr(), p_off.data_ptr(), scr_off.data_ptr(),
            work.data_ptr(), sh.n_block, sh.n_warp, scratch.data_ptr(),
            p.data_ptr(), out.data_ptr(), prm.q, prm.e, prm.q2, prm.noncan,
            prm.junc_bonus, prm.mat0, prm.mat1, prm.sc_n, prm.long_thres,
            prm.long_diff, sh.warp_stride, sh.smem, stream)
    else:
        rc = lib.mm2_exts2_fill(
            qblob.data_ptr(), tblob.data_ptr(), jblob.data_ptr(),
            qoff.data_ptr(), toff.data_ptr(), joff.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), flags.data_ptr(),
            p_off.data_ptr(), scr_off.data_ptr(), work.data_ptr(),
            sh.n_block, sh.n_warp, scratch.data_ptr(), p.data_ptr(),
            out.data_ptr(), prm.q, prm.e, prm.q2, prm.noncan,
            prm.junc_bonus, prm.mat0, prm.mat1, prm.sc_n, prm.long_thres,
            prm.long_diff, sh.warp_stride, sh.smem, stream)
    _record(events, 1)
    kernels.check(rc, what)
    if ext:
        ext_launches += 1
    else:
        fill_launches += 1
    return out, p


# --------------------------------------------------------------------------
# a batch of recorded splice fills (the Python collect pass's output)
# --------------------------------------------------------------------------

def exts2_fill_batch(meta: np.ndarray, qblob: np.ndarray, tblob: np.ndarray,
                     jblob: np.ndarray, flags: np.ndarray,
                     prm: SpliceParams, device: torch.device | str,
                     stats: FillStats | None = None
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve a batch of splice gap fills.

    meta: (n, 3) int64 [qlen, tlen, jlen], jlen 0 (no junction bytes)
    or tlen; queries, targets and junction bytes lie back to back in
    qblob/tblob/jblob in meta order.  flags: (n,) KSW_EZ_APPROX_MAX with
    any of the splice, RIGHT and REV_CIGAR bits, per fill.  Returns
    (scores int32 [n], cig_off int64 [n + 1], cig_blob uint32).

    The blobs go to the device once; the fills run longest first in
    chunks whose direction bytes, CIGAR slots and scratch rings stay
    under `gpucfg.fill_chunk_bytes` (ksw2_gpu.solve_chunks), each one
    exts2_fill launch and one intron-mode ksw2_backtrack launch.  Fills
    with an empty side, and every fill under options that fail the
    host_only gate, take ksw2_splice.exts2 on the host and are counted
    in stats.host_fills."""
    return _exts2_batch(meta, qblob, tblob, jblob, flags, None, prm, device,
                        stats)


def exts2_ext_batch(meta: np.ndarray, qblob: np.ndarray, tblob: np.ndarray,
                    jblob: np.ndarray, flags: np.ndarray, zdrop: np.ndarray,
                    prm: SpliceParams, device: torch.device | str,
                    stats: FillStats | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve a batch of splice extensions (the work of
    exts2_fwd_tpu(track_h=True)): ksw2_splice.exts2 without
    KSW_EZ_APPROX_MAX.

    meta, blobs: as exts2_fill_batch; flags: (n,) any of the splice,
    RIGHT, REV_CIGAR and KSW_EZ_EXTZ_ONLY bits, per fill; zdrop (n,) per
    fill (< 0: none).  Returns (fields int32 [n, 10], the EXT_FIELDS of
    each fill as ksw2_splice.exts2 sets them (reach_end False); cig_off
    int64 [n + 1], cig_blob uint32).

    As exts2_fill_batch, with one exts2_ext launch and one intron-mode
    ksw2_backtrack launch from the starts the kernel picked per chunk.
    Fills with an empty side, and every fill under options that fail the
    host_only gate, take ksw2_splice.exts2 on the host; the counts go to
    the extension fields of stats (ext_fills, ext_host_fills, ...)."""
    return _exts2_batch(meta, qblob, tblob, jblob, flags,
                        np.asarray(zdrop, np.int64).reshape(-1), prm, device,
                        stats)


def _exts2_batch(meta, qblob, tblob, jblob, flags, zdrop, prm: SpliceParams,
                 device, stats: FillStats | None):
    """exts2_fill_batch (zdrop None) and exts2_ext_batch."""
    t_start = time.perf_counter()
    device = torch.device(device)
    stats = stats if stats is not None else FillStats()
    ext = zdrop is not None
    what = "exts2_ext_batch" if ext else "exts2_fill_batch"
    meta = np.asarray(meta, np.int64).reshape(-1, 3)
    flags = np.asarray(flags, np.int64).reshape(-1)
    n = meta.shape[0]
    qlen, tlen, jlen = meta[:, 0], meta[:, 1], meta[:, 2]
    if ext:
        bad = (flags & ~(EXTZ_ONLY | FLAG_BITS)) != 0
    else:
        bad = (((flags & APPROX_MAX) == 0)
               | ((flags & ~(APPROX_MAX | FLAG_BITS)) != 0))
    if flags.shape[0] != n or bad.any() or ext and zdrop.shape[0] != n:
        raise ValueError(f"{what}: unsupported flags "
                         f"{sorted({int(f) for f in flags[bad]})}")
    if ((jlen != 0) & (jlen != tlen)).any():
        raise ValueError(f"{what}: junction bytes must cover the target "
                         "(jlen 0 or tlen)")
    qoff, toff, joff = (np.zeros(n + 1, np.int64) for _ in range(3))
    np.cumsum(qlen, out=qoff[1:])
    np.cumsum(tlen, out=toff[1:])
    np.cumsum(jlen, out=joff[1:])
    host = (qlen <= 0) | (tlen <= 0)
    if prm.host_only:
        host[:] = True
    res = (np.empty((n, len(EXT_FIELDS)), np.int32) if ext
           else np.full(n, KSW_NEG_INF, np.int32))
    n_cig = np.zeros(n, np.int64)
    host_cig = {}
    for k in np.nonzero(host)[0].tolist():
        ez = ksw2_splice.exts2(
            qblob[qoff[k]:qoff[k + 1]], tblob[toff[k]:toff[k + 1]], prm.mat,
            prm.q, prm.e, prm.q2, prm.noncan, int(zdrop[k]) if ext else -1,
            prm.junc_bonus, int(flags[k]),
            jblob[joff[k]:joff[k + 1]] if jlen[k] else None)
        res[k] = ([int(getattr(ez, f)) for f in EXT_FIELDS] if ext
                  else ez.score)
        n_cig[k] = ez.cigar.shape[0]
        host_cig[k] = ez.cigar

    dev_idx = np.nonzero(~host)[0]
    dev_idx = dev_idx[np.argsort(-(qlen + tlen)[dev_idx], kind="stable")]
    pieces, kms, bms, chunks, n_scr = [], 0.0, 0.0, 0, 0
    if dev_idx.shape[0]:
        ql, tl = qlen[dev_idx], tlen[dev_idx]
        if ext:
            scr = scratch_bytes(ext_ring_bytes(ql, tl), EXT_SMEM_MAX)
        else:   # budgeted as if every fill's rings were in scratch
            scr = fill_bytes(ql, tl)
        qb_d, tb_d, jb_d = (upload(b, device) for b in (qblob, tblob, jblob))

        def launch(c64, c32, po, p_total, events):
            nonlocal n_scr
            (qo, to, jo), (q_, t_, f_, _w, zd) = c64, c32
            shape = (ext_ring_shape if ext else fill_shape)(
                q_.cpu().numpy(), t_.cpu().numpy())
            n_scr += int((shape.scr_off >= 0).sum())
            if ext:
                return exts2_ext(qb_d, tb_d, jb_d, qo, to, jo, q_, t_, f_, zd,
                                 po, p_total, prm, events=events)
            return exts2_fill(qb_d, tb_d, jb_d, qo, to, jo, q_, t_, f_, po,
                              p_total, prm, events=events)

        def backtrack(p, po, co, c32, out, events):
            q_, t_, f_, w_, _zd = c32
            return ksw2_backtrack(p, po, q_, t_, w_, co,
                                  (f_ & REV_CIGAR) != 0, prm.long_thres,
                                  starts=out[:, 10:] if ext else None,
                                  events=events)
        # regions 16-aligned: the fill kernel stores 4 direction bytes at
        # once where its region allows
        out, n_cig[dev_idx], pieces, kms, bms, chunks = solve_chunks(
            dev_idx, (p_bound(ql, tl, ql + tl) + 15) // 16 * 16, ql + tl, scr,
            [qoff, toff, np.where(jlen > 0, joff[:-1], -1)],
            [qlen, tlen, flags, qlen + tlen,
             zdrop if ext else np.zeros(n, np.int64)],
            device, launch, backtrack)
        res[dev_idx] = out[:, :len(EXT_FIELDS)] if ext else out
    cells = int((qlen * tlen)[dev_idx].sum())
    cig_off, cig_blob = assemble_cigars(n, n_cig, dev_idx, pieces, host_cig)
    stats.scratch_fills += n_scr
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
