# Frozen copy of mm2_gb_tpu_torch/ops/align.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Base-level alignment driver (align.c analog).

Turns chained regions into CIGAR alignments: end trimming, bad-seed
filtering, left/right extension, per-gap filling with Z-drop and inversion
detection, CIGAR normalization and identity statistics.  The DP itself is
the ksw2 module (NumPy oracle or the C++ fast path); this module is the
sequential orchestration around it, byte-exact with mm_align_skeleton /
mm_align1 (align.c:960-1020, 573-826).
"""

from __future__ import annotations

import math

import numpy as np

from . import hit as hitmod
from .hit import AlnExtra, Region, MM_PARENT_TMP_PRI, \
    MM_PARENT_UNSET
from . import ksw2
from .seed import (MM_SEED_IGNORE, MM_SEED_LONG_JOIN,
                                 MM_SEED_SELF, MM_SEED_TANDEM)
from .sketch import _NT4
from .opts import (MapOptions, MM_F_EQX, MM_F_FOR_ONLY,
                                   MM_F_NO_END_FLT, MM_F_NO_INV,
                                   MM_F_QSTRAND, MM_F_REV_ONLY, MM_F_SPLICE,
                                   MM_F_SPLICE_FLANK, MM_F_SPLICE_FOR,
                                   MM_F_SPLICE_REV, MM_F_SR, MM_I_HPC)

U64 = np.uint64
INT32_MIN = -2**31

MM_CIGAR_MATCH, MM_CIGAR_INS, MM_CIGAR_DEL, MM_CIGAR_N_SKIP = 0, 1, 2, 3
MM_CIGAR_EQ_MATCH, MM_CIGAR_X_MISMATCH = 7, 8


def _lo32(x) -> int:
    return int(np.int32(np.uint32(int(x) & 0xFFFFFFFF)))


def _q_span(ayi) -> int:
    return int((int(ayi) >> 32) & 0xFF)


def _mg_log2(x: float) -> float:
    """mg_log2 (mmpriv.h:118-126) — fast float log2 approximation."""
    z = np.float32(x).view(np.uint32)
    log_2 = float(int((z >> np.uint32(23)) & np.uint32(255)) - 128)
    z = (z & ~np.uint32(255 << 23)) + np.uint32(127 << 23)
    f = float(z.view(np.float32))
    log_2 += (float(np.float32(np.float32(-0.34484843) * np.float32(f))
                    + np.float32(2.02466578)) * f - 0.67487759)
    return float(np.float32(log_2))


# ------------------------------------------------------------------ ksw glue

# ---- speculative device-fill service -----------------------------------
# The TPU batch pipeline runs alignment twice per read batch: a collect
# pass with fake DP results records every gap-fill subproblem (they are
# pure functions of the anchors -- results only steer cigar/score/Z-drop
# splits), one Pallas dispatch solves them (ops/ksw2_tpu.py), and the real
# pass consumes the cache.  The same split as mm2-gb's GPU chaining
# (scores on device, control flow on host, plchain.cu:292-464).
_fill_collect: list | None = None
_fill_cache: dict | None = None
# device extensions are profitable only on wide device links: the
# EXTZ_ONLY problems are small and numerous, so dispatch latency dominates
# on tunneled hosts.  Off by default; the pipeline enables it per config.
collect_ext = False


def _fill_key(qseq: np.ndarray, tseq: np.ndarray, w: int, flag: int,
              zdrop: int, end_bonus: int, junc=None):
    return (qseq.tobytes(), tseq.tobytes(), int(w), int(flag), int(zdrop),
            int(end_bonus),
            None if junc is None else junc.tobytes())


def begin_fill_collect() -> None:
    global _fill_collect
    _fill_collect = []


def end_fill_collect() -> list:
    global _fill_collect
    out, _fill_collect = _fill_collect, None
    return out or []


def set_fill_cache(cache: dict | None) -> None:
    global _fill_cache
    _fill_cache = cache


def _fake_ez(qlen: int, tlen: int) -> ksw2.Extz:
    ez = ksw2.Extz()
    ez.score = 0
    ez.max = 0
    ez.max_q, ez.max_t = qlen - 1, tlen - 1
    ez.cigar = np.array([min(qlen, tlen) << 4 | 0], np.uint32)
    return ez


_BASES = "ACGTN"
_CIGAR_STR = "MIDNSHP=XB"


def _dump_aln_seq_pre(opt, qseq, tseq, w: int, flag: int) -> None:
    """MM_DBG_PRINT_ALN_SEQ pre-kernel dump (align.c:318-325)."""
    import sys
    sys.stderr.write("===> q=(%d,%d), e=(%d,%d), bw=%d, flag=%d, "
                     "zdrop=%d <===\n" % (opt.q, opt.q2, opt.e, opt.e2,
                                          w, flag, opt.zdrop))
    sys.stderr.write("".join(_BASES[c] for c in tseq) + "\n")
    sys.stderr.write("".join(_BASES[c] for c in qseq) + "\n")


def _dump_aln_seq_post(ez: ksw2.Extz) -> None:
    """Post-kernel score/cigar dump (align.c:335-341)."""
    import sys
    cig = "" if ez.cigar is None else "".join(
        "%d%c" % (int(c) >> 4, _CIGAR_STR[int(c) & 0xF]) for c in ez.cigar)
    sys.stderr.write("score=%d, cigar=%s\n" % (ez.score, cig))


def align_pair(opt: MapOptions, qseq: np.ndarray, tseq: np.ndarray,
               junc, mat: np.ndarray, w: int, end_bonus: int, zdrop: int,
               flag: int) -> ksw2.Extz:
    """Kernel dispatch (mm_align_pair, align.c:316-342)."""
    if opt.dbg_print_aln_seq and _fill_collect is None:
        _dump_aln_seq_pre(opt, qseq, tseq, w, flag)
        ez = _align_pair(opt, qseq, tseq, junc, mat, w, end_bonus, zdrop,
                         flag)
        _dump_aln_seq_post(ez)
        return ez
    return _align_pair(opt, qseq, tseq, junc, mat, w, end_bonus, zdrop,
                       flag)


def _align_pair(opt: MapOptions, qseq: np.ndarray, tseq: np.ndarray,
                junc, mat: np.ndarray, w: int, end_bonus: int, zdrop: int,
                flag: int) -> ksw2.Extz:
    qlen, tlen = len(qseq), len(tseq)
    if opt.max_sw_mat > 0 and tlen * qlen > opt.max_sw_mat:
        ez = ksw2.Extz()
        ez.zdropped = True
        return ez
    if opt.flag & MM_F_SPLICE:
        from .ksw2_splice import exts2
        # device-batched splice fills: the APPROX_MAX gap fills between
        # anchors (align.c:744-758) run in exts2_batch_device; extensions
        # and everything else stay on the host oracle
        _SPLICE_BITS = (ksw2.KSW_EZ_SPLICE_FOR | ksw2.KSW_EZ_SPLICE_REV
                        | ksw2.KSW_EZ_SPLICE_FLANK | ksw2.KSW_EZ_RIGHT
                        | ksw2.KSW_EZ_REV_CIGAR)
        dev_ok = (qlen > 0 and tlen > 0 and opt.q2 > opt.q + opt.e
                  and (flag & ~_SPLICE_BITS) == ksw2.KSW_EZ_APPROX_MAX)
        if _fill_collect is not None:
            if dev_ok:
                _fill_collect.append(
                    ("splice", qseq.copy(), tseq.copy(), int(w), flag,
                     int(zdrop), 0,
                     None if junc is None else np.asarray(junc).copy()))
            return _fake_ez(qlen, tlen)
        if dev_ok and _fill_cache is not None:
            hit = _fill_cache.get(_fill_key(qseq, tseq, w, flag, zdrop,
                                            0, junc))
            if hit is not None:
                return hit
        return exts2(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.noncan,
                     zdrop, opt.junc_bonus, flag, junc)
    _EXT_FLAGS = (ksw2.KSW_EZ_EXTZ_ONLY,
                  ksw2.KSW_EZ_EXTZ_ONLY | ksw2.KSW_EZ_RIGHT
                  | ksw2.KSW_EZ_REV_CIGAR)
    # junc does not gate the non-splice kinds: extd2/extz2 ignore the
    # junction flags entirely, and bed_junc returns an (all-zero) array
    # even when no BED is loaded — requiring `junc is None` here silently
    # disabled every device fill on the genomic path
    dev_kind = None
    if qlen > 0 and tlen > 0 \
            and not (opt.q == opt.q2 and opt.e == opt.e2):
        if flag == ksw2.KSW_EZ_APPROX_MAX:
            dev_kind = "fill"
        elif flag in _EXT_FLAGS and (collect_ext or _fill_cache is not None):
            dev_kind = "ext"
    if _fill_collect is not None:
        if dev_kind is not None:
            _fill_collect.append((dev_kind, qseq.copy(), tseq.copy(),
                                  int(w), flag, int(zdrop),
                                  int(end_bonus), None))
        return _fake_ez(qlen, tlen)
    if dev_kind is not None and _fill_cache is not None:
        hit = _fill_cache.get(_fill_key(qseq, tseq, w, flag, zdrop,
                                        end_bonus))
        if hit is not None:
            return hit
    if opt.q == opt.q2 and opt.e == opt.e2:
        return ksw2.extz2(qseq, tseq, mat, opt.q, opt.e, w, zdrop,
                          end_bonus, flag)
    return ksw2.extd2(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.e2, w,
                      zdrop, end_bonus, flag)


def _append_cigar(r: Region, cigar) -> None:
    """mm_append_cigar (align.c:291-314)."""
    if len(cigar) == 0:
        return
    if r.p is None:
        r.p = AlnExtra(cigar=[])
    c = r.p.cigar
    cigar = [int(x) for x in cigar]
    if c and (c[-1] & 0xF) == (cigar[0] & 0xF):
        c[-1] += cigar[0] >> 4 << 4
        c.extend(cigar[1:])
    else:
        c.extend(cigar)


# -------------------------------------------------------- seed-level filters

def _collect_long_gaps(as1: int, cnt1: int, x32, y32, min_gap: int):
    """Positions of |gap|>min_gap between consecutive anchors
    (collect_long_gaps, align.c:370-387)."""
    if cnt1 < 2:
        return None
    sl = slice(as1, as1 + cnt1)
    gaps = np.diff(y32[sl]) - np.diff(x32[sl])
    idx = (np.nonzero(np.abs(gaps) > min_gap)[0] + 1).tolist()
    return idx if len(idx) > 1 else None


def _filter_bad_seeds(as1: int, cnt1: int, x32, y32, ay, min_gap: int,
                      diff_thres: int, max_ext_len: int,
                      max_ext_cnt: int) -> None:
    """Mark anchors inside indel-dense windows IGNORE (align.c:389-424)."""
    K = _collect_long_gaps(as1, cnt1, x32, y32, min_gap)
    if K is None:
        return
    n = len(K)
    mx, max_st, max_en = 0, -1, -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(K[max_st], K[max_en]):
                    ay[as1 + i] |= MM_SEED_IGNORE
            mx, max_st, max_en = 0, -1, -1
            if k == n:
                break
        i = K[k]
        gap = (int(y32[as1 + i]) - int(y32[as1 + i - 1])) - \
              (int(x32[as1 + i]) - int(x32[as1 + i - 1]))
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = int(y32[as1 + i - 1])
        rs = int(x32[as1 + i - 1])
        max_diff, max_diff_l = 0, -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = K[l]
            if (int(y32[as1 + j]) - qs > max_ext_len
                    or int(x32[as1 + j]) - rs > max_ext_len):
                break
            gap = (int(y32[as1 + j]) - int(y32[as1 + j - 1])) - \
                  (int(x32[as1 + j]) - int(x32[as1 + j - 1]))
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff, max_diff_l = diff, l
            l += 1
        if max_diff > diff_thres and max_diff > mx:
            mx, max_st, max_en = max_diff, k, max_diff_l
        k += 1


def _filter_bad_seeds_alt(as1: int, cnt1: int, x32, y32, spans, ay,
                          min_gap: int, max_ext: int) -> None:
    """Join runs of alternating-gap seeds into LONG_JOINs (align.c:426-460)."""
    K = _collect_long_gaps(as1, cnt1, x32, y32, min_gap)
    if K is None:
        return
    n = len(K)
    k = 0
    while k < n:
        i = K[k]
        gap1 = (int(y32[as1 + i]) - int(y32[as1 + i - 1])) - \
               (int(x32[as1 + i]) - int(x32[as1 + i - 1]))
        re1 = int(x32[as1 + i])
        qe1 = int(y32[as1 + i])
        gap1 = abs(gap1)
        l = k + 1
        while l < n:
            j = K[l]
            if (int(y32[as1 + j]) - qe1 > max_ext
                    or int(x32[as1 + j]) - re1 > max_ext):
                break
            gap2 = (int(y32[as1 + j]) - int(y32[as1 + j - 1])) - \
                   (int(x32[as1 + j]) - int(x32[as1 + j - 1]))
            q_span_pre = int(spans[as1 + j - 1])
            rs2 = int(x32[as1 + j - 1]) + q_span_pre
            qs2 = int(y32[as1 + j - 1]) + q_span_pre
            m = min(rs2 - re1, qs2 - qe1)
            gap2 = abs(gap2)
            if m > gap1 + gap2:
                break
            re1 = int(x32[as1 + j])
            qe1 = int(y32[as1 + j])
            gap1 = gap2
            l += 1
        if l > k + 1:
            end = K[l - 1]
            for j in range(K[k], end):
                ay[as1 + j] |= MM_SEED_IGNORE
            ay[as1 + end] |= MM_SEED_LONG_JOIN
        k = l


def _fix_bad_ends(r: Region, x32, y32, spans, ay, bw: int, min_match: int):
    """Trim chain ends dominated by gaps (mm_fix_bad_ends, align.c:462-496)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    m = l = int(spans[r.as_])
    for i in range(r.as_ + 1, r.as_ + r.cnt - 1):
        q_span = int(spans[i])
        if int(ay[i]) & int(MM_SEED_LONG_JOIN):
            break
        lr = int(x32[i]) - int(x32[i - 1])
        lq = int(y32[i]) - int(y32[i - 1])
        mn, mx = min(lr, lq), max(lr, lq)
        if mx - mn > l >> 1:
            as_ = i
        l += mn
        m += min(mn, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    cnt = r.as_ + r.cnt - as_
    m = l = int(spans[r.as_ + r.cnt - 1])
    for i in range(r.as_ + r.cnt - 2, as_, -1):
        q_span = int(spans[i + 1])
        if int(ay[i + 1]) & int(MM_SEED_LONG_JOIN):
            break
        lr = int(x32[i + 1]) - int(x32[i])
        lq = int(y32[i + 1]) - int(y32[i])
        mn, mx = min(lr, lq), max(lr, lq)
        if mx - mn > l >> 1:
            cnt = i + 1 - as_
        l += mn
        m += min(mn, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    return as_, cnt


def _max_stretch(r: Region, x32, y32, spans):
    """Longest exactly-colinear anchor run (mm_max_stretch, align.c:498-524)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 2:
        return as_, cnt
    max_score, max_i, max_len = -1, -1, 0
    score, length = int(spans[r.as_]), 1
    i = r.as_ + 1
    for i in range(r.as_ + 1, r.as_ + r.cnt):
        q_span = int(spans[i])
        lr = int(x32[i]) - int(x32[i - 1])
        lq = int(y32[i]) - int(y32[i - 1])
        if lq == lr:
            score += min(lq, q_span)
            length += 1
        else:
            if score > max_score:
                max_score, max_len, max_i = score, length, i - length
            score, length = q_span, 1
    i = r.as_ + r.cnt
    if score > max_score:
        max_score, max_len, max_i = score, length, i - length
    return max_i, max_len


# -------------------------------------------------------------- coordinates

def _get_hplen_back(index, rid: int, x: int) -> int:
    """Homopolymer run length ending at x (align.c:344-351)."""
    off0 = int(index.offsets[rid])
    off = off0 + x
    c = int(index.seq_codes[off])
    i = off - 1
    while i >= off0 and int(index.seq_codes[i]) == c:
        i -= 1
    return off - i


def _adjust_minier(index, qseq0, axi, ayi):
    """Left end of a minimizer in r/q coords (mm_adjust_minier, align.c:353-368)."""
    if index.flag & MM_I_HPC:
        qseq = qseq0[int(axi) >> 63]
        q = _lo32(ayi)
        c = int(qseq[q])
        i = q - 1
        while i > 0 and int(qseq[i]) == c:
            i -= 1
        q = i + 1
        rid = (int(axi) << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
        c = _get_hplen_back(index, rid, _lo32(axi))
        r = _lo32(axi) + 1 - c
    else:
        r = _lo32(axi) - (index.k >> 1)
        q = _lo32(ayi) - (index.k >> 1)
    return r, q


def _seed_ext_score(opt: MapOptions, index, mat, qlen: int, qseq0,
                    axi, ayi) -> int:
    """SW score of one extended anchor (mm_seed_ext_score, align.c:526-551)."""
    q_span = _q_span(ayi)
    rid = (int(axi) << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    ext = opt.anchor_ext_len
    re = _lo32(axi) + 1
    rs = re - q_span
    qe = _lo32(ayi) + 1
    qs = qe - q_span
    rs = max(rs - ext, 0)
    qs = max(qs - ext, 0)
    re = min(re + ext, int(index.lens[rid]))
    qe = min(qe + ext, qlen)
    if opt.flag & MM_F_QSTRAND:
        qseq = qseq0[0][qs:qe]
        tseq = index.get_seq(rid, rs, re, rev=bool(int(axi) >> 63))
    else:
        qseq = qseq0[int(axi) >> 63][qs:qe]
        tseq = index.get_seq(rid, rs, re)
    score, _, _ = ksw2.sw_ll(qseq, tseq, mat, opt.q, opt.e)
    return score


def _fix_bad_ends_splice(opt: MapOptions, index, r: Region, mat, qlen: int,
                         qseq0, ax, ay):
    """Boundary-exon filter for splice mode (align.c:553-571)."""
    as1, cnt1 = r.as_, r.cnt
    if r.cnt < 3:
        return as1, cnt1
    log_gap = math.log(_lo32(ax[r.as_ + 1]) - _lo32(ax[r.as_]))
    if _q_span(ay[r.as_]) < log_gap + opt.anchor_ext_shift:
        score = _seed_ext_score(opt, index, mat, qlen, qseq0,
                                ax[r.as_], ay[r.as_])
        if score / int(mat[0]) < log_gap + opt.anchor_ext_shift:
            as1 += 1
            cnt1 -= 1
    log_gap = math.log(_lo32(ax[r.as_ + r.cnt - 1])
                       - _lo32(ax[r.as_ + r.cnt - 2]))
    if _q_span(ay[r.as_ + r.cnt - 1]) < log_gap + opt.anchor_ext_shift:
        score = _seed_ext_score(opt, index, mat, qlen, qseq0,
                                ax[r.as_ + r.cnt - 1], ay[r.as_ + r.cnt - 1])
        if score / int(mat[0]) < log_gap + opt.anchor_ext_shift:
            cnt1 -= 1
    return as1, cnt1


# ------------------------------------------------------------ zdrop test

def _update_max_zdrop(score, i, j, state, e):
    mx, max_i, max_j, max_zdrop, pos = state
    if score < mx:
        li, lj = i - max_i, j - max_j
        diff = abs(li - lj)
        z = mx - score - diff * e
        if z > max_zdrop:
            max_zdrop = z
            pos = ((max_i, i), (max_j, j))
    else:
        mx, max_i, max_j = score, i, j
    return mx, max_i, max_j, max_zdrop, pos


def test_zdrop(opt: MapOptions, qseq, tseq, cigar, mat) -> int:
    if _fill_collect is not None:  # collect pass runs on fake cigars
        return 0
    from . import native
    if native.available() and len(cigar):
        try_inv = not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY
                                   | MM_F_REV_ONLY))
        return native.test_zdrop(
            qseq, tseq, cigar, mat, opt.q, opt.e, opt.zdrop, opt.zdrop_inv,
            opt.max_gap, try_inv, opt.min_chain_score * opt.a,
            opt.min_dp_max)
    """0 = pass, 1 = Z-dropped, 2 = potential inversion
    (mm_test_zdrop, align.c:47-89)."""
    mat = np.asarray(mat, np.int64)
    state = (INT32_MIN, -1, -1, 0, ((-1, -1), (-1, -1)))
    score = 0
    i = j = 0
    for c in cigar:
        op, ln = int(c) & 0xF, int(c) >> 4
        if op == MM_CIGAR_MATCH:
            sub = mat[tseq[i:i + ln].astype(np.int64) * 5
                      + qseq[j:j + ln].astype(np.int64)]
            cum = score + np.cumsum(sub)
            # vectorized diagonal walk split at the first running-max
            # update: before it the reference max may sit on a different
            # diagonal (diff*e term constant); after it diff is zero
            mx, max_i, max_j, max_zdrop, pos = state
            ge = np.nonzero(cum >= mx)[0]
            u0 = int(ge[0]) if ge.shape[0] else ln
            if u0 > 0:
                d0 = abs((i - max_i) - (j - max_j))
                zA = mx - cum[:u0] - d0 * opt.e
                for l in np.nonzero(zA > max_zdrop)[0]:
                    zz = int(zA[l])
                    if zz > max_zdrop:
                        max_zdrop = zz
                        pos = ((max_i, i + int(l)), (max_j, j + int(l)))
            if u0 < ln:
                sub2 = cum[u0:]
                pmB = np.maximum.accumulate(sub2)
                zB = pmB - sub2
                upd = np.nonzero(sub2 >= pmB)[0]
                for l in np.nonzero(zB > max_zdrop)[0]:
                    zz = int(zB[l])
                    if zz > max_zdrop:
                        arg = int(upd[upd < l][-1])
                        max_zdrop = zz
                        pos = ((i + u0 + arg, i + u0 + int(l)),
                               (j + u0 + arg, j + u0 + int(l)))
                M = int(pmB[-1])
                last = int(np.nonzero(sub2 == M)[0][-1])
                mx = M
                max_i, max_j = i + u0 + last, j + u0 + last
            state = (mx, max_i, max_j, max_zdrop, pos)
            score = int(cum[-1])
            i += ln
            j += ln
        elif op in (MM_CIGAR_INS, MM_CIGAR_DEL, MM_CIGAR_N_SKIP):
            score -= opt.q + opt.e * ln
            if op == MM_CIGAR_INS:
                j += ln
            else:
                i += ln
            state = _update_max_zdrop(score, i, j, state, opt.e)
    _, _, _, max_zdrop, pos = state
    q_len = pos[1][1] - pos[1][0]
    t_len = pos[0][1] - pos[0][0]
    if (not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY | MM_F_REV_ONLY))
            and max_zdrop > opt.zdrop_inv
            and q_len < opt.max_gap and t_len < opt.max_gap):
        qseq2 = qseq[pos[1][1] - q_len:pos[1][1]][::-1]
        qseq2 = np.where(qseq2 >= 4, np.uint8(4), 3 - qseq2).astype(np.uint8)
        score, _, _ = ksw2.sw_ll(qseq2, tseq[pos[0][0]:pos[0][1]],
                                 mat.astype(np.int8), opt.q, opt.e)
        if score >= opt.min_chain_score * opt.a and score >= opt.min_dp_max:
            return 2
    return 1 if max_zdrop > opt.zdrop else 0


# --------------------------------------------------------- CIGAR fixing

def _fix_cigar(r: Region, qseq, tseq):
    """Indel left-shift + I/D-run merging (mm_fix_cigar, align.c:91-167)."""
    p = r.p
    qshift = tshift = 0
    if len(p.cigar) <= 1:
        return qshift, tshift
    cig = p.cigar
    toff = qoff = 0
    to_shrink = False
    for k in range(len(cig)):
        op, ln = cig[k] & 0xF, cig[k] >> 4
        if ln == 0:
            to_shrink = True
        if op == MM_CIGAR_MATCH:
            toff += ln
            qoff += ln
        elif op in (MM_CIGAR_INS, MM_CIGAR_DEL):
            if (0 < k < len(cig) - 1 and (cig[k - 1] & 0xF) == 0
                    and (cig[k + 1] & 0xF) == 0):
                prev_len = cig[k - 1] >> 4
                l = 0
                if op == MM_CIGAR_INS:
                    while l < prev_len and \
                            qseq[qoff - 1 - l] == qseq[qoff + ln - 1 - l]:
                        l += 1
                else:
                    while l < prev_len and \
                            tseq[toff - 1 - l] == tseq[toff + ln - 1 - l]:
                        l += 1
                if l > 0:
                    cig[k - 1] -= l << 4
                    cig[k + 1] += l << 4
                    qoff -= l
                    toff -= l
                if l == prev_len:
                    to_shrink = True
            if op == MM_CIGAR_INS:
                qoff += ln
            else:
                toff += ln
        elif op == MM_CIGAR_N_SKIP:
            toff += ln
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    k = 0
    while k < len(cig) - 2:  # collapse I/D/I (or D/I/D) runs (align.c:126-144)
        if (cig[k] & 0xF) > 0 and (cig[k] & 0xF) + (cig[k + 1] & 0xF) == 3:
            s = [0, 0, 0]
            l = k
            while l < len(cig):
                op = cig[l] & 0xF
                if op in (MM_CIGAR_INS, MM_CIGAR_DEL) or cig[l] >> 4 == 0:
                    s[op] += cig[l] >> 4
                else:
                    break
                l += 1
            if s[1] > 0 and s[2] > 0 and l - k > 2:
                cig[k] = s[1] << 4 | MM_CIGAR_INS
                cig[k + 1] = s[2] << 4 | MM_CIGAR_DEL
                for kk in range(k + 2, l):
                    cig[kk] &= 0xF
                to_shrink = True
            k = l + 1  # C's for-loop increments after k = l
        else:
            k += 1
    if to_shrink:
        cig2 = [c for c in cig if c >> 4 != 0]
        out = []
        for k in range(len(cig2)):
            if k == len(cig2) - 1 or (cig2[k] & 0xF) != (cig2[k + 1] & 0xF):
                out.append(cig2[k])
            else:
                cig2[k + 1] += cig2[k] >> 4 << 4
        cig[:] = out
    if cig and (cig[0] & 0xF) in (MM_CIGAR_INS, MM_CIGAR_DEL):
        l = cig[0] >> 4
        if (cig[0] & 0xF) == MM_CIGAR_INS:
            if r.rev:
                r.qe -= l
            else:
                r.qs += l
            qshift = l
        else:
            r.rs += l
            tshift = l
        del cig[0]
    return qshift, tshift


def _update_cigar_eqx(r: Region, qseq, tseq) -> None:
    """Replace M ops with =/X runs (mm_update_cigar_eqx, align.c:169-238)."""
    if r.p is None:
        return
    out = []
    toff = qoff = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op == MM_CIGAR_MATCH:
            while ln > 0:
                l = 0
                while l < ln and qseq[qoff + l] == tseq[toff + l]:
                    l += 1
                if l > 0:
                    out.append(l << 4 | MM_CIGAR_EQ_MATCH)
                    ln -= l
                    toff += l
                    qoff += l
                l = 0
                while l < ln and qseq[qoff + l] != tseq[toff + l]:
                    l += 1
                if l > 0:
                    out.append(l << 4 | MM_CIGAR_X_MISMATCH)
                    ln -= l
                    toff += l
                    qoff += l
            continue
        if op == MM_CIGAR_INS:
            qoff += ln
        elif op in (MM_CIGAR_DEL, MM_CIGAR_N_SKIP):
            toff += ln
        out.append(c)
    r.p.cigar[:] = out


def _update_extra(r, *a, **k):
    if _fill_collect is not None:  # collect pass: stats of fake cigars
        return                     # are never read; skip the consistency
    return _update_extra_real(r, *a, **k)


def _update_extra_real(r: Region, qseq, tseq, mat, q: int, e: int, is_eqx: bool,
                  log_gap: bool) -> None:
    """blen/mlen/n_ambi/dp_max recomputation (mm_update_extra, align.c:240-289)."""
    p = r.p
    if p is None:
        return
    qshift, tshift = _fix_cigar(r, qseq, tseq)
    qseq = qseq[qshift:]
    tseq = tseq[tshift:]
    r.blen = r.mlen = 0
    mat = np.asarray(mat, np.int64)
    toff = qoff = 0
    s = 0.0
    mx = 0.0
    for c in p.cigar:
        op, ln = c & 0xF, c >> 4
        if op == MM_CIGAR_MATCH:
            cq = qseq[qoff:qoff + ln].astype(np.int64)
            ct = tseq[toff:toff + ln].astype(np.int64)
            ambi = (ct > 3) | (cq > 3)
            n_ambi = int(ambi.sum())
            n_diff = int(((ct != cq) & ~ambi).sum())
            sub = mat[ct * 5 + cq].astype(np.float64)
            # running score with reset-at-zero and running max (align.c:254-261)
            for v in sub:
                s += float(v)
                if s < 0.0:
                    s = 0.0
                elif s > mx:
                    mx = s
            r.blen += ln - n_ambi
            r.mlen += ln - (n_ambi + n_diff)
            p.n_ambi += n_ambi
            toff += ln
            qoff += ln
        elif op == MM_CIGAR_INS:
            n_ambi = int((qseq[qoff:qoff + ln] > 3).sum())
            r.blen += ln - n_ambi
            p.n_ambi += n_ambi
            s -= q + (e * _mg_log2(1.0 + ln) if log_gap else e)
            if s < 0.0:
                s = 0.0
            qoff += ln
        elif op == MM_CIGAR_DEL:
            n_ambi = int((tseq[toff:toff + ln] > 3).sum())
            r.blen += ln - n_ambi
            p.n_ambi += n_ambi
            s -= q + (e * _mg_log2(1.0 + ln) if log_gap else e)
            if s < 0.0:
                s = 0.0
            toff += ln
        elif op == MM_CIGAR_N_SKIP:
            toff += ln
    p.dp_max = int(mx + 0.499)
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    if is_eqx:
        _update_cigar_eqx(r, qseq, tseq)


# ------------------------------------------------------------ rank filtering

def _count_gaps(r: Region):
    n_gap = n_gapo = 0
    if r.p is None:
        return -1, -1
    for c in r.p.cigar:
        op = c & 0xF
        if op in (MM_CIGAR_INS, MM_CIGAR_DEL):
            n_gapo += 1
            n_gap += c >> 4
    return n_gap, n_gapo


def event_identity(r: Region) -> float:
    """mm_event_identity (align.c:909-915)."""
    if r.p is None:
        return -1.0
    n_gap, n_gapo = _count_gaps(r)
    return r.mlen / (r.blen + r.p.n_ambi - n_gap + n_gapo)


def _recal_max_dp(r: Region, b2: float, match_sc: int) -> int:
    if r.p is None:
        return -1
    n_gap = n_gapo = 0
    gap_cost = 0.0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (MM_CIGAR_INS, MM_CIGAR_DEL):
            gap_cost += b2 + float(_mg_log2(1.0 + ln))
            n_gapo += 1
            n_gap += ln
    n_mis = r.blen + r.p.n_ambi - r.mlen - n_gap
    return int(match_sc * (r.mlen - b2 * n_mis - gap_cost) + 0.499)


def update_dp_max(qlen: int, regs: list[Region], frac: float, a: int,
                  b: int) -> None:
    """Divergence-aware re-ranking (mm_update_dp_max, align.c:934-958)."""
    if len(regs) < 2:
        return
    mx, mx2, max_i = -1, -1, -1
    for i, r in enumerate(regs):
        if r.p is None:
            continue
        if r.p.dp_max > mx:
            mx2, mx, max_i = mx, r.p.dp_max, i
        elif r.p.dp_max > mx2:
            mx2 = r.p.dp_max
    if max_i < 0 or mx < 0 or mx2 < 0:
        return
    if regs[max_i].qe - regs[max_i].qs < qlen * frac:
        return
    if mx2 < mx * frac:
        return
    div = 1.0 - event_identity(regs[max_i])
    if div < 0.02:
        div = 0.02
    b2 = 0.5 / div
    if b2 * a < b:
        b2 = a / b
    for r in regs:
        if r.p is None:
            continue
        r.p.dp_max = max(_recal_max_dp(r, b2, a), 0)


# ------------------------------------------------------------------ align1

def _native_align1_ok(index, opt: MapOptions) -> bool:
    """The C++ driver covers the plain host path: no splice/qstrand, no
    debug dumps, no TPU fill collect/cache redirection."""
    from . import native
    return (native.available() and _fill_collect is None
            and _fill_cache is None
            and not opt.dbg_print_aln_seq
            and not (opt.flag & (MM_F_SPLICE | MM_F_QSTRAND)))


def _align1_native(index, opt: MapOptions, qlen: int, qseq0, r: Region,
                   n_a: int, ax, ay):
    """Drive one region through mmt_align1 (csrc/alignkit.cpp).

    Returns (handled, r2).  handled=False means the C++ side declined
    (semantic guard) and the Python oracle must run instead.  Z-drop
    splits are applied here with split_reg's exact float32 staging
    (mm_split_reg, hit.c:106-123) using the region's entry snapshot,
    because in the C flow the split happens mid-loop, before the tail
    coordinate assignment."""
    import copy

    from . import native
    if r.cnt == 0:
        return True, None
    fwd, rc = qseq0
    mat = ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi)
    bw = int(opt.bw * 1.5 + 1.0)
    bw_long = max(int(opt.bw_long * 1.5 + 1.0), bw)
    try_inv = not (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY
                               | MM_F_REV_ONLY))
    params = np.array([
        opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2, opt.zdrop,
        opt.zdrop_inv, opt.end_bonus, opt.max_gap, opt.min_cnt,
        opt.min_ksw_len, opt.min_chain_score, opt.min_dp_max, bw, bw_long,
        opt.bw, opt.max_sw_mat,
        1 if opt.flag & MM_F_SR else 0,
        1 if opt.flag & MM_F_NO_END_FLT else 0,
        1 if opt.flag & MM_F_EQX else 0,
        1 if try_inv else 0,
        index.k,
        1 if index.flag & MM_I_HPC else 0,
        0 if opt.flag & MM_F_SR else 1,           # log_gap
        r.as_, r.cnt, r.mlen,
        1 if r.split_inv else 0,
        r.rs, r.re, r.qs, r.qe, qlen], np.int64)
    lens64 = (index.lens if index.lens.dtype == np.int64
              else index.lens.astype(np.int64))
    res = native.align1(ax, ay, n_a, index.seq_codes, index.offsets,
                        lens64, fwd, rc, mat, params)
    if res is None:
        return False, None
    out, cig = res
    snap = copy.copy(r)  # entry state: basis for the split region
    r.rs, r.re = int(out[6]), int(out[7])
    r.qs, r.qe = int(out[8]), int(out[9])
    if out[0]:
        p = AlnExtra(cigar=cig.tolist())
        p.dp_score = int(out[1])
        p.dp_max = int(out[2])
        p.n_ambi = int(out[3])
        r.p = p
        r.blen, r.mlen = int(out[4]), int(out[5])
    r2 = None
    n = int(out[10])
    if 0 < n < snap.cnt:  # split_reg semantics on the entry snapshot
        r2 = copy.copy(snap)
        r2.id = -1
        r2.sam_pri = False
        r2.p = None
        r2.split_inv = False
        r2.cnt = snap.cnt - n
        ratio = np.float32(np.float32(r2.cnt) / np.float32(snap.cnt))
        r2.score = int(float(np.float32(np.float32(snap.score) * ratio))
                       + 0.499)
        r2.as_ = snap.as_ + n
        if snap.parent == snap.id:
            r2.parent = MM_PARENT_TMP_PRI
        hitmod._set_coor(r2, qlen, ax, ay, False)
        r.cnt = snap.cnt - r2.cnt
        r.score = snap.score - r2.score
        r.split = snap.split | 1
        r2.split = snap.split | 2
        if int(out[11]) == 2:
            r2.split_inv = True
    return True, r2


def _align1(index, opt: MapOptions, qlen: int, qseq0, r: Region,
            n_a: int, ax, ay, splice_flag: int) -> Region | None:
    """Align one region; returns the Z-drop split remainder (align.c:573-826)."""
    if _native_align1_ok(index, opt):
        handled, r2 = _align1_native(index, opt, qlen, qseq0, r, n_a,
                                     ax, ay)
        if handled:
            return r2
    is_sr = bool(opt.flag & MM_F_SR)
    is_splice = bool(opt.flag & MM_F_SPLICE)
    rid = (int(ax[r.as_]) << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    rev = int(ax[r.as_]) >> 63
    rlen = int(index.lens[rid])
    r2: Region | None = None
    dropped = False
    if r.cnt == 0:
        return None
    # int coordinate views: the per-anchor Python bit-twiddling dominated
    # the align driver profile (2M+ _lo32 calls per 200 reads)
    M32 = np.uint64(0xFFFFFFFF)
    x32 = (ax & M32).astype(np.int64)
    y32 = (ay & M32).astype(np.int64)
    spans = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    mat = ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi)
    bw = int(opt.bw * 1.5 + 1.0)
    bw_long = max(int(opt.bw_long * 1.5 + 1.0), bw)

    if is_sr and not (index.flag & MM_I_HPC):
        as1, cnt1 = _max_stretch(r, x32, y32, spans)
        rs = _lo32(ax[as1]) + 1 - _q_span(ay[as1])
        qs = _lo32(ay[as1]) + 1 - _q_span(ay[as1])
        re = _lo32(ax[as1 + cnt1 - 1]) + 1
        qe = _lo32(ay[as1 + cnt1 - 1]) + 1
    else:
        if not (opt.flag & MM_F_NO_END_FLT):
            if is_splice:
                as1, cnt1 = _fix_bad_ends_splice(opt, index, r, mat, qlen,
                                                 qseq0, ax, ay)
            else:
                as1, cnt1 = _fix_bad_ends(r, x32, y32, spans, ay, opt.bw,
                                          opt.min_chain_score * 2)
        else:
            as1, cnt1 = r.as_, r.cnt
        _filter_bad_seeds(as1, cnt1, x32, y32, ay, 10, 40,
                          opt.max_gap >> 1, 10)
        _filter_bad_seeds_alt(as1, cnt1, x32, y32, spans, ay, 30,
                              opt.max_gap >> 1)
        rs, qs = _adjust_minier(index, qseq0, ax[as1], ay[as1])
        re, qe = _adjust_minier(index, qseq0, ax[as1 + cnt1 - 1],
                                ay[as1 + cnt1 - 1])
    assert cnt1 > 0

    extra_flag = 0
    if is_splice:
        if splice_flag & MM_F_SPLICE_FOR:
            extra_flag |= (ksw2.KSW_EZ_SPLICE_REV if rev
                           else ksw2.KSW_EZ_SPLICE_FOR)
        if splice_flag & MM_F_SPLICE_REV:
            extra_flag |= (ksw2.KSW_EZ_SPLICE_FOR if rev
                           else ksw2.KSW_EZ_SPLICE_REV)
        if opt.flag & MM_F_SPLICE_FLANK:
            extra_flag |= ksw2.KSW_EZ_SPLICE_FLANK

    # DP region bounds (align.c:618-694)
    if is_sr:
        qs0, qe0 = 0, qlen
        l = qs
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e \
            if l * opt.a + opt.end_bonus > opt.q else 0
        rs0 = max(rs - l, 0)
        l = qlen - qe
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e \
            if l * opt.a + opt.end_bonus > opt.q else 0
        re0 = min(re + l, rlen)
    else:
        rs0 = int(x32[r.as_]) + 1 - int(spans[r.as_])
        qs0 = int(y32[r.as_]) + 1 - int(spans[r.as_])
        if rs0 < 0:
            rs0 = 0
        assert qs0 >= 0
        rs1 = qs1 = 0
        l = 0
        i = r.as_ - 1
        while i >= 0 and int(ax[i]) >> 32 == int(ax[r.as_]) >> 32:
            x = int(x32[i]) + 1 - int(spans[i])
            y = int(y32[i]) + 1 - int(spans[i])
            if x < rs0 and y < qs0:
                l += 1
                if l > opt.min_cnt:
                    l = max(rs0 - x, qs0 - y)
                    rs1, qs1 = rs0 - l, qs0 - l
                    if rs1 < 0:
                        rs1 = 0
                    break
            i -= 1
        if qs > 0 and rs > 0:
            l = min(qs, opt.max_gap)
            qs1 = max(qs1, qs - l)
            qs0 = min(qs0, qs1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rs)
            rs1 = max(rs1, rs - l)
            rs0 = min(rs0, rs1)
            rs0 = min(rs0, rs)
        else:
            rs0, qs0 = rs, qs
        re0 = int(x32[r.as_ + r.cnt - 1]) + 1
        qe0 = int(y32[r.as_ + r.cnt - 1]) + 1
        re1, qe1 = rlen, qlen
        l = 0
        i = r.as_ + r.cnt
        while i < n_a and int(ax[i]) >> 32 == int(ax[r.as_]) >> 32:
            x = int(x32[i]) + 1
            y = int(y32[i]) + 1
            if x > re0 and y > qe0:
                l += 1
                if l > opt.min_cnt:
                    l = max(x - re0, y - qe0)
                    re1, qe1 = re0 + l, qe0 + l
                    break
            i += 1
        if qe < qlen and re < rlen:
            l = min(qlen - qe, opt.max_gap)
            qe1 = min(qe1, qe + l)
            qe0 = max(qe0, qe1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rlen - re)
            re1 = min(re1, re + l)
            re0 = max(re0, re1)
        else:
            re0, qe0 = re, qe
    if int(ay[r.as_]) & int(MM_SEED_SELF):
        max_ext = abs(r.qs - r.rs)
        if r.rs - rs0 > max_ext:
            rs0 = r.rs - max_ext
        if r.qs - qs0 > max_ext:
            qs0 = r.qs - max_ext
        max_ext = abs(r.qe - r.re)
        if re0 - r.re > max_ext:
            re0 = r.re + max_ext
        if qe0 - r.qe > max_ext:
            qe0 = r.qe + max_ext

    assert re0 > rs0

    def getseq(rs_, re_):
        if opt.flag & MM_F_QSTRAND:
            return index.get_seq(rid, rs_, re_, rev=bool(rev))
        return index.get_seq(rid, rs_, re_)

    def getjunc(rs_, re_):
        from .index import bed_junc
        return bed_junc(index, rid, rs_, re_)

    qstrand_qseq = qseq0[0] if (opt.flag & MM_F_QSTRAND) else qseq0[rev]

    if qs > 0 and rs > 0:  # left extension (align.c:700-720)
        qseq = qstrand_qseq[qs0:qs][::-1]
        tseq = getseq(rs0, rs)[::-1]
        junc = getjunc(rs0, rs)[::-1]
        ez = align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus,
                        opt.zdrop_inv if r.split_inv else opt.zdrop,
                        extra_flag | ksw2.KSW_EZ_EXTZ_ONLY | ksw2.KSW_EZ_RIGHT
                        | ksw2.KSW_EZ_REV_CIGAR)
        if ez.n_cigar > 0:
            _append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        rs1 = rs - (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qs1 = qs - (qs - qs0 if ez.reach_end else ez.max_q + 1)
    else:
        rs1, qs1 = rs, qs
    re1, qe1 = rs, qs
    assert qs1 >= 0 and rs1 >= 0

    i = cnt1 - 1 if is_sr else 1
    while i < cnt1:  # gap filling (align.c:724-785)
        if (int(ay[as1 + i]) & int(MM_SEED_IGNORE | MM_SEED_TANDEM)) \
                and i != cnt1 - 1:
            i += 1
            continue
        if is_sr and not (index.flag & MM_I_HPC):
            re = int(x32[as1 + i]) + 1
            qe = int(y32[as1 + i]) + 1
        elif not (index.flag & MM_I_HPC):
            re = int(x32[as1 + i]) - (index.k >> 1)
            qe = int(y32[as1 + i]) - (index.k >> 1)
        else:
            re, qe = _adjust_minier(index, qseq0, ax[as1 + i], ay[as1 + i])
        re1, qe1 = re, qe
        if (i == cnt1 - 1 or (int(ay[as1 + i]) & int(MM_SEED_LONG_JOIN))
                or (qe - qs >= opt.min_ksw_len
                    and re - rs >= opt.min_ksw_len)):
            bw1 = bw_long
            if int(ay[as1 + i]) & int(MM_SEED_LONG_JOIN):
                bw1 = max(qe - qs, re - rs)
            qseq = qstrand_qseq[qs:qe]
            tseq = getseq(rs, re)
            junc = getjunc(rs, re)
            if is_sr:  # ungapped (align.c:744-751)
                assert qe - qs == re - rs
                ez = ksw2.Extz()
                sc = np.where((qseq >= 4) | (tseq >= 4), opt.e2,
                              np.where(qseq == tseq, opt.a, -opt.b))
                ez.score = int(sc.sum())
                ez.cigar = np.array([(qe - qs) << 4 | MM_CIGAR_MATCH],
                                    np.uint32)
            else:
                ez = align_pair(opt, qseq, tseq, junc, mat, bw1, -1,
                                opt.zdrop,
                                extra_flag | ksw2.KSW_EZ_APPROX_MAX)
            # collect pass: ez is the fake giant-M cigar, on which the
            # zdrop test fires for every divergent gap and the re-align
            # below would run the full local kernel — defer the zdrop
            # decision to the real pass (same rationale as the C++
            # driver, csrc/alignkit.cpp align1_c)
            zdrop_code = (0 if _fill_collect is not None
                          else test_zdrop(opt, qseq, tseq, ez.cigar, mat))
            if zdrop_code != 0:  # lift approximate Z-drop (align.c:756-757)
                ez = align_pair(
                    opt, qseq, tseq, junc, mat, bw1, -1,
                    opt.zdrop_inv if zdrop_code == 2 else opt.zdrop,
                    extra_flag)
            if ez.n_cigar > 0:
                _append_cigar(r, ez.cigar)
            if ez.zdropped:  # truncated by Z-drop (align.c:761-781)
                if r.p is None:
                    assert ez.n_cigar == 0
                    r.p = AlnExtra(cigar=[])
                j = i - 1
                while j >= 0:
                    if int(x32[as1 + j]) <= rs + ez.max_t:
                        break
                    j -= 1
                dropped = True
                if j < 0:
                    j = 0
                r.p.dp_score += ez.max
                re1 = rs + ez.max_t + 1
                qe1 = qs + ez.max_q + 1
                if cnt1 - (j + 1) >= opt.min_cnt:
                    r2 = hitmod.split_reg(r, as1 + j + 1 - r.as_, qlen, ax,
                                          ay, bool(opt.flag & MM_F_QSTRAND))
                    if r2 is not None and zdrop_code == 2:
                        r2.split_inv = True
                break
            else:
                r.p.dp_score += ez.score
            rs, qs = re, qe
        i += 1

    if not dropped and qe < qe0 and re < re0:  # right ext (align.c:787-803)
        qseq = qstrand_qseq[qe:qe0]
        tseq = getseq(re, re0)
        junc = getjunc(re, re0)
        ez = align_pair(opt, qseq, tseq, junc, mat, bw, opt.end_bonus,
                        opt.zdrop, extra_flag | ksw2.KSW_EZ_EXTZ_ONLY)
        if ez.n_cigar > 0:
            _append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        re1 = re + (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qe1 = qe + (qe0 - qe if ez.reach_end else ez.max_q + 1)
    assert qe1 <= qlen

    r.rs, r.re = rs1, re1
    if not rev or (opt.flag & MM_F_QSTRAND):
        r.qs, r.qe = qs1, qe1
    else:
        r.qs, r.qe = qlen - qe1, qlen - qs1

    assert re1 - rs1 <= re0 - rs0
    if r.p is not None:
        if opt.flag & MM_F_QSTRAND:
            tseq = index.get_seq(rid, rs1, re1, rev=bool(r.rev))
            qseq = qseq0[0][qs1:]
        else:
            tseq = index.get_seq(rid, rs1, re1)
            qseq = qseq0[1 if r.rev else 0][qs1:]
        _update_extra(r, qseq, tseq, mat, opt.q, opt.e,
                      bool(opt.flag & MM_F_EQX), not (opt.flag & MM_F_SR))
        if rev and r.p.trans_strand:
            r.p.trans_strand ^= 3
    return r2


def _align1_inv(index, opt: MapOptions, qlen: int, qseq0, r1: Region,
                r2: Region) -> Region | None:
    """Inversion alignment between two split regions (align.c:828-883)."""
    if not (r1.split & 1) or not (r2.split & 2):
        return None
    if r1.id != r1.parent and r1.parent != MM_PARENT_TMP_PRI:
        return None
    if r2.id != r2.parent and r2.parent != MM_PARENT_TMP_PRI:
        return None
    if r1.rid != r2.rid or r1.rev != r2.rev:
        return None
    ql = r1.qs - r2.qe if r1.rev else r2.qs - r1.qe
    tl = r2.rs - r1.re
    if ql < opt.min_chain_score or ql > opt.max_gap:
        return None
    if tl < opt.min_chain_score or tl > opt.max_gap:
        return None
    mat = ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi)
    tseq = index.get_seq(r1.rid, r1.re, r2.rs)
    buf = qseq0[0] if r1.rev else qseq0[1]
    base = r2.qe if r1.rev else qlen - r2.qs
    qseq = buf[base:base + ql]
    q_r = qseq[::-1]
    t_r = tseq[::-1]
    score, q_off, t_off = ksw2.sw_ll(q_r, t_r, mat, opt.q, opt.e)
    if score < opt.min_dp_max:
        return None
    # ksw_ll_i16's qe may land on a striped padding lane (>= ql), making
    # q_off negative; C then calls mm_align_pair with qseq + q_off, which
    # reaches into the bytes PRECEDING the gap slice of the full query
    # buffer (align.c:859-860).  Reproduce that pointer arithmetic.
    q_off = ql - (q_off + 1)
    t_off = tl - (t_off + 1)
    qsub = buf[max(base + q_off, 0):base + ql]
    tsub = tseq[t_off:]
    ez = align_pair(opt, qsub, tsub, None, mat,
                    int(opt.bw * 1.5), -1, opt.zdrop, ksw2.KSW_EZ_EXTZ_ONLY)
    if ez.n_cigar == 0:
        return None
    r_inv = Region()
    _append_cigar(r_inv, ez.cigar)
    r_inv.p.dp_score = ez.max
    r_inv.id = -1
    r_inv.parent = MM_PARENT_UNSET
    r_inv.inv = True
    r_inv.rev = not r1.rev
    r_inv.rid = r1.rid
    r_inv.div = -1.0
    if not r_inv.rev:
        r_inv.qs = r2.qe + q_off
        r_inv.qe = r_inv.qs + ez.max_q + 1
    else:
        r_inv.qe = r2.qs - q_off
        r_inv.qs = r_inv.qe - (ez.max_q + 1)
    r_inv.rs = r1.re + t_off
    r_inv.re = r_inv.rs + ez.max_t + 1
    _update_extra(r_inv, qsub, tsub, mat, opt.q, opt.e,
                  bool(opt.flag & MM_F_EQX), not (opt.flag & MM_F_SR))
    return r_inv


def align_regs(index, opt: MapOptions, qlen: int, qstr,
               regs: list[Region], ax: np.ndarray, ay: np.ndarray
               ) -> list[Region]:
    """mm_align_skeleton (align.c:960-1020)."""
    if isinstance(qstr, str):
        qarr = _NT4[np.frombuffer(qstr.encode(), np.uint8)]
    else:
        qarr = np.asarray(qstr, np.uint8)
    fwd = qarr.copy()
    rc = np.where(fwd < 4, 3 - fwd, np.uint8(4))[::-1].copy()
    qseq0 = (fwd, rc)

    n_a = hitmod.squeeze_a(regs, ax, ay)
    two_rounds = ((opt.flag & MM_F_SPLICE) and (opt.flag & MM_F_SPLICE_FOR)
                  and (opt.flag & MM_F_SPLICE_REV))
    i = 0
    while i < len(regs):
        if two_rounds:  # splice: align both transcript strands (align.c:980-996)
            import copy
            s0, s1 = copy.deepcopy(regs[i]), copy.deepcopy(regs[i])
            s20 = _align1(index, opt, qlen, qseq0, s0, n_a, ax, ay,
                          MM_F_SPLICE_FOR)
            s21 = _align1(index, opt, qlen, qseq0, s1, n_a, ax, ay,
                          MM_F_SPLICE_REV)
            if s0.p.dp_score > s1.p.dp_score:
                which, trans_strand = 0, 1
            elif s0.p.dp_score < s1.p.dp_score:
                which, trans_strand = 1, 2
            else:
                trans_strand = 3
                which = (qlen + s0.p.dp_score) & 1
            regs[i], r2 = (s0, s20) if which == 0 else (s1, s21)
            regs[i].p.trans_strand = trans_strand
        else:
            r2 = _align1(index, opt, qlen, qseq0, regs[i], n_a, ax, ay,
                         opt.flag)
            if (opt.flag & MM_F_SPLICE) and regs[i].p is not None:
                regs[i].p.trans_strand = \
                    1 if opt.flag & MM_F_SPLICE_FOR else 2
        if r2 is not None and r2.cnt > 0:
            regs.insert(i + 1, r2)
        if i > 0 and regs[i].split_inv and not (opt.flag & MM_F_NO_INV):
            r_inv = _align1_inv(index, opt, qlen, qseq0, regs[i - 1], regs[i])
            if r_inv is not None:
                regs.insert(i + 1, r_inv)
                i += 1
        i += 1

    regs = hitmod.filter_regs(opt, qlen, regs)
    if (not (opt.flag & MM_F_SR) and not opt.split_prefix
            and qlen >= opt.rank_min_len):
        update_dp_max(qlen, regs, opt.rank_frac, opt.a, opt.b)
        regs = hitmod.filter_regs(opt, qlen, regs)
    regs = hitmod.hit_sort(regs, opt.alt_drop)
    return regs
