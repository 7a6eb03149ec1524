"""Splice gap fills on the GPU: the exts2 fill DP and its intron backtrack.

Port of the host half of mm2_gb_tpu/ops/ksw2_tpu.py::exts2_batch_device
for the gap fills of `-x splice --gpu-align` (cigar + KSW_EZ_APPROX_MAX
with any of KSW_EZ_SPLICE_FOR/REV/FLANK, KSW_EZ_RIGHT and
KSW_EZ_REV_CIGAR, per fill): every fill the Python align driver records
in its collect pass (models/pipeline.py::_prefill_device).  Two
hand-written CUDA kernels do the work:

- `exts2_fill` (csrc/exts2_kernel.cu): the splice DP of
  ops/ksw2_splice.py::exts2 (ksw2_exts2_sse.c semantics), one thread
  block per fill, state in a ring of lanes that slides along the target,
  donor and acceptor scores made on the device from the target and the
  fill's BED junction bytes.  Direction rows are packed as extd2_fill's.
- `ksw2_backtrack` (ops/ksw2_gpu.py, csrc/extd2_kernel.cu) in intron
  mode: min_intron_len = long_thres, and w = qlen + tlen, under which its
  row windows are the unbanded ones.

`splice_sites_torch` and `exts2_fill_torch` are the plain PyTorch
versions; the wrapper takes the twin only for CPU tensors.  There is no
size cap: the TPU sent every fill longer than 4096 to the host.  Host
route (ksw2_splice.exts2, counted): an empty side, q2 <= q + e, and the
`-mat.min() > 2*(q+e)` gate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from mm2_gb_tpu.ops import ksw2, ksw2_splice
from mm2_gb_tpu_torch.ops.ksw2_gpu import (KSW_NEG_INF, FillStats, _c8,
                                           _chunks, assemble_cigars,
                                           chunk_words, ksw2_backtrack,
                                           p_bound)
from mm2_gb_tpu_torch.utils import kernels

APPROX_MAX = ksw2.KSW_EZ_APPROX_MAX
RIGHT = ksw2.KSW_EZ_RIGHT
REV_CIGAR = ksw2.KSW_EZ_REV_CIGAR
S_FOR, S_REV = ksw2.KSW_EZ_SPLICE_FOR, ksw2.KSW_EZ_SPLICE_REV
S_FLANK = ksw2.KSW_EZ_SPLICE_FLANK
FLAG_BITS = S_FOR | S_REV | S_FLANK | RIGHT | REV_CIGAR   # beside APPROX_MAX

fill_launches = 0   # exts2_fill kernel launches (CUDA tensors)

# the kernel's ring rows: u, y, the score row, x, v, x2 twice (by row
# parity), donor and acceptor; a fill whose ring (RING_ROWS x ring_lanes
# bytes) exceeds this keeps it in a global scratch region of its own
# (it stays under the 48 KB a block gets without an opt-in)
RING_ROWS = 11
SMEM_RING_MAX = 24 * 1024


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


def ring_lanes(qlen, tlen):
    """Lanes of a fill's state ring in the kernel: the least power of two,
    at least 32, not below min(qlen, tlen) + 32 (numpy arrays or
    tensors)."""
    if isinstance(qlen, torch.Tensor):
        m = torch.minimum(qlen, tlen).to(torch.int64) + 32
        return torch.clamp(2 ** torch.ceil(torch.log2(m.double())).long(),
                           min=32)
    m = np.minimum(np.asarray(qlen, np.int64), np.asarray(tlen, np.int64))
    return np.maximum(32, 2 ** np.ceil(np.log2(m + 32)).astype(np.int64))


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
    dev = qblob.device
    n = qlen.shape[0]
    score = torch.full((n,), KSW_NEG_INF, dtype=torch.int32, device=dev)
    p = torch.zeros(p_total + 1, dtype=torch.uint8, device=dev)  # + trash
    if n == 0:
        return score, p[:p_total]
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
        p.scatter_(0, torch.where(dp, dst, p_total).reshape(-1),
                   d.reshape(-1))
        row_off[:a] += en - st + 1
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
    score[order] = sc_out.to(torch.int32)
    return score, p[:p_total]


def _check_operands(named, ref):
    n = named[6][1].shape[0]   # qlen
    for name, t, dt in named:
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"exts2_fill: {name} must be a contiguous 1-D "
                             f"{dt} tensor")
        if t.device != ref.device:
            raise ValueError(f"exts2_fill: {name} is on {t.device}, qblob "
                             f"on {ref.device}")
        if name not in ("qblob", "tblob", "jblob") and t.shape[0] != n:
            raise ValueError(f"exts2_fill: {name} has {t.shape[0]} "
                             f"elements, expected {n}")


def exts2_fill(qblob, tblob, jblob, qoff, toff, joff, qlen, tlen, flags,
               p_off, p_total: int, prm: SpliceParams):
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
    build or launch failure raises."""
    global fill_launches
    i64, i32, u8 = torch.int64, torch.int32, torch.uint8
    _check_operands((("qblob", qblob, u8), ("tblob", tblob, u8),
                     ("jblob", jblob, u8), ("qoff", qoff, i64),
                     ("toff", toff, i64), ("joff", joff, i64),
                     ("qlen", qlen, i32), ("tlen", tlen, i32),
                     ("flags", flags, i32), ("p_off", p_off, i64)), qblob)
    if prm.host_only:
        raise ValueError("exts2_fill: these options take the host route "
                         "(q2 <= q+e or -mat.min() > 2*(q+e))")
    if qblob.device.type == "cpu":
        return exts2_fill_torch(qblob, tblob, jblob, qoff, toff, joff, qlen,
                                tlen, flags, p_off, p_total, prm)
    if qblob.device.type != "cuda":
        raise ValueError(f"exts2_fill: unsupported device {qblob.device}")
    lib = kernels.library()
    dev = qblob.device
    n = qlen.shape[0]
    score = torch.full((n,), KSW_NEG_INF, dtype=i32, device=dev)
    p = torch.zeros(p_total, dtype=u8, device=dev)
    if n == 0:
        return score, p
    # shared memory per block: the largest ring that fits; larger rings
    # live in a global scratch region of their own
    need = RING_ROWS * ring_lanes(qlen.to(i64), tlen.to(i64))
    big = need > SMEM_RING_MAX
    scr_off = torch.where(big, torch.cumsum(torch.where(big, need, 0), 0)
                          - need, -1)
    n_big = int(big.sum())
    scratch = torch.empty(int(need[big].sum()) if n_big else 1,
                          dtype=torch.int8, device=dev)
    smem = int(need[~big].max()) if n_big < n else 16
    m = torch.minimum(qlen, tlen)
    threads = min(256, max(32, (int(m.max()) + 47) // 32 * 32))
    rc = lib.mm2_exts2_fill(
        qblob.data_ptr(), tblob.data_ptr(), jblob.data_ptr(),
        qoff.data_ptr(), toff.data_ptr(), joff.data_ptr(), qlen.data_ptr(),
        tlen.data_ptr(), flags.data_ptr(), p_off.data_ptr(),
        scr_off.data_ptr(), n, scratch.data_ptr(), p.data_ptr(),
        score.data_ptr(), prm.q, prm.e, prm.q2, prm.noncan, prm.junc_bonus,
        prm.mat0, prm.mat1, prm.sc_n, prm.long_thres, prm.long_diff,
        threads, smem, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "exts2_fill")
    fill_launches += 1
    return score, p


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
    under `gpucfg.fill_chunk_bytes`, each one exts2_fill launch and one
    intron-mode ksw2_backtrack launch, and the CIGAR words are compacted
    on the device before they come back.  Fills with an empty side, and
    every fill under options that fail the host_only gate, take
    ksw2_splice.exts2 on the host and are counted in stats.host_fills."""
    from mm2_gb_tpu_torch.utils.gpucfg import fill_chunk_bytes
    t_start = time.perf_counter()
    device = torch.device(device)
    stats = stats if stats is not None else FillStats()
    meta = np.asarray(meta, np.int64).reshape(-1, 3)
    flags = np.asarray(flags, np.int64).reshape(-1)
    n = meta.shape[0]
    qlen, tlen, jlen = meta[:, 0], meta[:, 1], meta[:, 2]
    bad = ((flags & APPROX_MAX) == 0) | ((flags & ~(APPROX_MAX | FLAG_BITS))
                                         != 0)
    if flags.shape[0] != n or bad.any():
        raise ValueError("exts2_fill_batch: unsupported flags "
                         f"{sorted({int(f) for f in flags[bad]})}")
    if ((jlen != 0) & (jlen != tlen)).any():
        raise ValueError("exts2_fill_batch: junction bytes must cover the "
                         "target (jlen 0 or tlen)")
    qoff, toff, joff = (np.zeros(n + 1, np.int64) for _ in range(3))
    np.cumsum(qlen, out=qoff[1:])
    np.cumsum(tlen, out=toff[1:])
    np.cumsum(jlen, out=joff[1:])
    host = (qlen <= 0) | (tlen <= 0)
    if prm.host_only:
        host[:] = True
    scores = np.full(n, KSW_NEG_INF, np.int32)
    n_cig = np.zeros(n, np.int64)
    host_cig = {}
    for k in np.nonzero(host)[0].tolist():
        ez = ksw2_splice.exts2(
            qblob[qoff[k]:qoff[k + 1]], tblob[toff[k]:toff[k + 1]], prm.mat,
            prm.q, prm.e, prm.q2, prm.noncan, -1, prm.junc_bonus,
            int(flags[k]), jblob[joff[k]:joff[k + 1]] if jlen[k] else None)
        scores[k] = ez.score
        n_cig[k] = ez.cigar.shape[0]
        host_cig[k] = ez.cigar

    dev_idx = np.nonzero(~host)[0]
    dev_idx = dev_idx[np.argsort(-(qlen + tlen)[dev_idx], kind="stable")]
    pieces = []
    if dev_idx.shape[0]:
        ql, tl = qlen[dev_idx], tlen[dev_idx]
        pb = p_bound(ql, tl, ql + tl)
        cap = ql + tl
        ring = RING_ROWS * ring_lanes(ql, tl)
        scr = np.where(ring > SMEM_RING_MAX, ring, 0)
        up = (lambda a: torch.from_numpy(np.ascontiguousarray(a, np.uint8))
              .to(device))
        qb_d, tb_d, jb_d = up(qblob), up(tblob), up(jblob)
        cuda = device.type == "cuda"
        for c0, c1 in _chunks(pb + 4 * cap + scr, fill_chunk_bytes(device)):
            idx = dev_idx[c0:c1]
            m = idx.shape[0]
            p_off = np.zeros(m + 1, np.int64)
            np.cumsum(pb[c0:c1], out=p_off[1:])
            c_off = np.zeros(m + 1, np.int64)
            np.cumsum(cap[c0:c1], out=c_off[1:])
            i64 = torch.from_numpy(np.concatenate(
                [qoff[idx], toff[idx], np.where(jlen[idx] > 0, joff[idx], -1),
                 p_off[:-1], c_off])).to(device)
            i32 = torch.from_numpy(np.concatenate(
                [qlen[idx], tlen[idx], flags[idx], (qlen + tlen)[idx]])
                .astype(np.int32)).to(device)
            qo, to, jo, po, co = (i64[:m], i64[m:2 * m], i64[2 * m:3 * m],
                                  i64[3 * m:4 * m], i64[4 * m:])
            q_, t_, f_, w_ = (i32[:m], i32[m:2 * m], i32[2 * m:3 * m],
                              i32[3 * m:])
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
            sc, p = exts2_fill(qb_d, tb_d, jb_d, qo, to, jo, q_, t_, f_, po,
                               int(p_off[-1]), prm)
            if cuda:
                ev[1].record()
            cig, nc = ksw2_backtrack(p, po, q_, t_, w_, co,
                                     (f_ & REV_CIGAR) != 0, prm.long_thres)
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
        stats.cells += int((ql * tl).sum())
        stats.scratch_fills += int((scr > 0).sum())

    cig_off, cig_blob = assemble_cigars(n, n_cig, dev_idx, pieces, host_cig)
    stats.fills += n
    stats.device_fills += int(dev_idx.shape[0])
    stats.host_fills += len(host_cig)
    stats.batch_s += time.perf_counter() - t_start
    return scores, cig_off, cig_blob
