"""Splice-aware extension DP (ksw_exts2_sse analog, ksw2_exts2_sse.c).

Like ops/ksw2.py's extd2 but the second "gap" state is an intron: opened
at donor sites, closed at acceptor sites, with canonical GT..AG scoring
(PMID:18688272 flank model) and optional BED junction bonuses.  Unbanded.
Emits N (intron) CIGAR ops for long state-3 runs via the backtracker's
min_intron_len = long_thres.
"""

from __future__ import annotations

import numpy as np

from mm2_gb_tpu_torch.ops.ksw2 import (Extz, KSW_NEG_INF, KSW_EZ_APPROX_DROP,
                                 KSW_EZ_APPROX_MAX, KSW_EZ_EXTZ_ONLY,
                                 KSW_EZ_GENERIC_SC, KSW_EZ_REV_CIGAR,
                                 KSW_EZ_RIGHT, KSW_EZ_SCORE_ONLY,
                                 KSW_EZ_SPLICE_FLANK, KSW_EZ_SPLICE_FOR,
                                 KSW_EZ_SPLICE_REV, _apply_zdrop, _backtrack,
                                 _row_max, _row_scores, _shift1)


def _splice_sites(tseq: np.ndarray, tlen: int, nbytes: int, noncan: int,
                  junc_bonus: int, flag: int, junc) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """Donor/acceptor score arrays (ksw2_exts2_sse.c:119-171)."""
    donor = np.full(nbytes, np.int8(-noncan), np.int8)
    acceptor = np.full(nbytes, np.int8(-noncan), np.int8)
    if not (flag & (KSW_EZ_SPLICE_FOR | KSW_EZ_SPLICE_REV)):
        return donor, acceptor
    # C's -noncan/2 truncates toward zero (GTr/yAG worth 0.5 bit)
    semi = -(noncan // 2) if flag & KSW_EZ_SPLICE_FLANK else 0
    sfor = bool(flag & KSW_EZ_SPLICE_FOR)
    srev = bool(flag & KSW_EZ_SPLICE_REV)
    t = tseq
    if not (flag & KSW_EZ_REV_CIGAR):
        for i in range(tlen - 4):
            can = 0
            if sfor and t[i + 1] == 2 and t[i + 2] == 3:
                can = 1  # GTr...
            if srev and t[i + 1] == 1 and t[i + 2] == 3:
                can = 1  # CTr...
            if can and (t[i + 3] == 0 or t[i + 3] == 2):
                can = 2
            if can:
                donor[i] = 0 if can == 2 else semi
        if junc is not None:
            for i in range(tlen - 1):
                if (sfor and (junc[i + 1] & 1)) or (srev and (junc[i + 1] & 8)):
                    donor[i] += junc_bonus
        for i in range(2, tlen):
            can = 0
            if sfor and t[i - 1] == 0 and t[i] == 2:
                can = 1  # ...yAG
            if srev and t[i - 1] == 0 and t[i] == 1:
                can = 1  # ...yAC
            if can and (t[i - 2] == 1 or t[i - 2] == 3):
                can = 2
            if can:
                acceptor[i] = 0 if can == 2 else semi
        if junc is not None:
            for i in range(tlen):
                if (sfor and (junc[i] & 2)) or (srev and (junc[i] & 4)):
                    acceptor[i] += junc_bonus
    else:
        for i in range(tlen - 4):
            can = 0
            if sfor and t[i + 1] == 2 and t[i + 2] == 0:
                can = 1  # GAy...
            if srev and t[i + 1] == 1 and t[i + 2] == 0:
                can = 1  # CAy...
            if can and (t[i + 3] == 1 or t[i + 3] == 3):
                can = 2
            if can:
                donor[i] = 0 if can == 2 else semi
        if junc is not None:
            for i in range(tlen - 1):
                if (sfor and (junc[i + 1] & 2)) or (srev and (junc[i + 1] & 4)):
                    donor[i] += junc_bonus
        for i in range(2, tlen):
            can = 0
            if sfor and t[i - 1] == 3 and t[i] == 2:
                can = 1  # ...rTG
            if srev and t[i - 1] == 3 and t[i] == 1:
                can = 1  # ...rTC
            if can and (t[i - 2] == 0 or t[i - 2] == 2):
                can = 2
            if can:
                acceptor[i] = 0 if can == 2 else semi
        if junc is not None:
            for i in range(tlen):
                if (sfor and (junc[i] & 1)) or (srev and (junc[i] & 8)):
                    acceptor[i] += junc_bonus
    return donor, acceptor


def exts2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, q: int,
          e: int, q2: int, noncan: int, zdrop: int, junc_bonus: int,
          flag: int, junc=None, m: int = 5) -> Extz:
    """Splice-aware extension (ksw_exts2_sse semantics)."""
    from mm2_gb_tpu_torch.ops.ksw2 import _ez_from_native, _use_native
    from mm2_gb_tpu_torch.utils import native
    if _use_native() and not (flag & KSW_EZ_GENERIC_SC) \
            and len(qseq) and len(tseq):
        return _ez_from_native(*native.ksw_exts2(
            np.ascontiguousarray(qseq, np.uint8),
            np.ascontiguousarray(tseq, np.uint8), mat, q, e, q2, noncan,
            zdrop, junc_bonus, flag, junc))
    ez = Extz()
    qlen, tlen = len(qseq), len(tseq)
    if m <= 1 or qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez
    assert not (flag & KSW_EZ_GENERIC_SC)
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    mat = np.asarray(mat, np.int8)
    mat0, mat1 = int(mat[0]), int(mat[1])
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    if -int(mat.min()) > 2 * (q + e):
        return ez

    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col = (min(qlen, tlen) + 15) // 16 * 16 + 16
    nbytes = tlen_ * 16

    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * e - (q2 - q)

    neg_qe = np.int8(-q - e)
    u = np.full(nbytes, neg_qe, np.int8)
    v = np.full(nbytes, neg_qe, np.int8)
    x = np.full(nbytes, neg_qe, np.int8)
    y = np.full(nbytes, neg_qe, np.int8)
    x2 = np.full(nbytes, np.int8(-q2), np.int8)
    smem = np.zeros(nbytes * 2 + qlen_ * 16 + 16, np.int8)
    sf_off, qr_off = nbytes, nbytes * 2
    smem[sf_off:sf_off + tlen] = tseq
    smem[qr_off:qr_off + qlen] = qseq[::-1]

    tarr = np.asarray(tseq, np.uint8)
    donor, acceptor = _splice_sites(tarr, tlen, nbytes, noncan, junc_bonus,
                                    flag, junc)

    H = None
    if not approx_max:
        H = np.full(nbytes, KSW_NEG_INF, np.int64)
    p_rows: list = [None] * (qlen + tlen - 1)
    off = np.zeros(qlen + tlen - 1, np.int64)
    off_end = np.zeros(qlen + tlen - 1, np.int64)

    def bound_v(r: int) -> int:
        if r == 0:
            return -q - e
        if r < long_thres:
            return -e
        if r == long_thres:
            return long_diff
        return 0

    qe = q + e
    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1

    with np.errstate(over="ignore"):
        for r in range(qlen + tlen - 1):
            st, en = max(0, r - qlen + 1), min(tlen - 1, r)
            st0, en0 = st, en
            st = st // 16 * 16
            en = (en + 16) // 16 * 16 - 1
            if st > 0:
                if last_st <= st - 1 <= last_en:
                    x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
                else:
                    x1, x21, v1 = -q - e, -q2, -q - e
            else:
                x1, x21 = -q - e, -q2
                v1 = bound_v(r)
            if en >= r:
                y[r] = neg_qe
                u[r] = bound_v(r)
            _row_scores(smem, sf_off, qr_off, r, qlen, st0, en0, mat0, mat1,
                        sc_N)

            sl = slice(st, en + 1)
            z = smem[sl].copy()
            xt1 = _shift1(x[sl], np.int8(x1))
            vt1 = _shift1(v[sl], np.int8(v1))
            a = xt1 + vt1
            ut = u[sl].copy()
            b = y[sl] + ut
            x2t1 = _shift1(x2[sl], np.int8(x21))
            a2 = x2t1 + vt1
            a2a = a2 + acceptor[sl]
            if with_cigar and (flag & KSW_EZ_RIGHT):
                d = np.where(z > a, np.uint8(0), np.uint8(1))
                z = np.maximum(z, a)
                d = np.where(z > b, d, np.uint8(2))
                z = np.maximum(z, b)
                d = np.where(z > a2a, d, np.uint8(3))
                z = np.maximum(z, a2a)
            else:
                if with_cigar:
                    d = (a > z).astype(np.uint8)
                z = np.maximum(z, a)
                if with_cigar:
                    d = np.where(b > z, np.uint8(2), d)
                z = np.maximum(z, b)
                if with_cigar:
                    d = np.where(a2a > z, np.uint8(3), d)
                z = np.maximum(z, a2a)
            u[sl] = z - vt1
            v[sl] = z - ut
            tq = z - np.int8(q)
            a = a - tq
            b = b - tq
            a2 = a2 - (z - np.int8(q2))
            if flag & KSW_EZ_RIGHT:
                ta, tb = a >= 0, b >= 0
                ta2 = a2 >= donor[sl]
            else:
                ta, tb = a > 0, b > 0
                ta2 = a2 > donor[sl]
            x[sl] = np.where(ta, a, np.int8(0)) - np.int8(qe)
            y[sl] = np.where(tb, b, np.int8(0)) - np.int8(qe)
            x2[sl] = np.where(ta2, a2, donor[sl]) - np.int8(q2)
            if with_cigar:
                d |= np.where(ta, np.uint8(0x08), np.uint8(0))
                d |= np.where(tb, np.uint8(0x10), np.uint8(0))
                d |= np.where(ta2, np.uint8(0x20), np.uint8(0))
                row = np.zeros(n_col, np.uint8)
                row[:en - st + 1] = d
                p_rows[r] = row
                off[r], off_end[r] = st, en

            if not approx_max:
                if r > 0:
                    if en0 > 0:
                        h_en0 = int(H[en0 - 1]) + int(u[en0])
                    else:
                        h_en0 = int(H[en0]) + int(v[en0])
                    H[en0] = h_en0
                    H[st0:en0] += v[st0:en0].astype(np.int64)
                    max_H, max_t = _row_max(H, st0, en0, None, h_en0)
                else:
                    H[0] = int(v[0]) - qe
                    max_H, max_t = int(H[0]), 0
                if en0 == tlen - 1 and int(H[en0]) > ez.mte:
                    ez.mte, ez.mte_q = int(H[en0]), r - en
                if r - st0 == qlen - 1 and int(H[st0]) > ez.mqe:
                    ez.mqe, ez.mqe_t = int(H[st0]), st0
                if _apply_zdrop(ez, max_H, r, max_t, zdrop, 0):
                    break
                if r == qlen + tlen - 2 and en0 == tlen - 1:
                    ez.score = int(H[tlen - 1])
            else:
                if r > 0:
                    if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                        d0 = int(v[last_H0_t])
                        d1 = int(u[last_H0_t + 1])
                        if d0 > d1:
                            H0 += d0
                        else:
                            H0 += d1
                            last_H0_t += 1
                    elif st0 <= last_H0_t <= en0:
                        H0 += int(v[last_H0_t])
                    else:
                        last_H0_t += 1
                        H0 += int(u[last_H0_t])
                    if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(
                            ez, H0, r, last_H0_t, zdrop, 0):
                        break
                else:
                    H0 = int(v[0]) - qe
                    last_H0_t = 0
                if r == qlen + tlen - 2 and en0 == tlen - 1:
                    ez.score = H0
            last_st, last_en = st, en

    if with_cigar:
        rev = bool(flag & KSW_EZ_REV_CIGAR)
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1,
                                  rev, long_thres)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q,
                                  rev, long_thres)
    return ez
