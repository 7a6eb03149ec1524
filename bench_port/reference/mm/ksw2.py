# Frozen copy of mm2_gb_tpu_torch/ops/ksw2.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""ksw2-family extension DP, host reference implementation (NumPy).

Byte-exact with the reference's SSE4.1 kernels:
- `extz2` — single gap cost (ksw2_extz2_sse.c, SSE4.1 build)
- `extd2` — dual affine gap cost (ksw2_extd2_sse.c)
- `sw_ll` — small Smith-Waterman used for inversion rescue and seed
  extension scoring (ksw2_ll_sse.c `ksw_ll_qinit`/`ksw_ll_i16`)

The SSE kernels implement the Suzuki-Kasahara anti-diagonal difference
recurrence in 8-bit lanes.  Byte-exactness (same scores, same CIGAR, same
zdrop points) requires reproducing not just the math but the kernels'
exact memory behavior: 16-lane rounding of the band per row, stale lane
values persisting across rows, unsigned/signed reinterpretation of the
difference arrays, and the blocked argmax tie-breaking of the row maximum.
This module emulates all of that with vectorized int8 NumPy; it is the
oracle for the fast C++ port (csrc) and the Pallas device kernels.

Semantics cited against ksw2.h:110-183 (backtrack/zdrop helpers),
ksw2_extz2_sse.c:31-312 and ksw2_extd2_sse.c:34-401.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import native


def _use_native() -> bool:
    return native.available() and not os.environ.get("MM2TPU_NO_NATIVE")


def _ez_from_native(scal: np.ndarray, cig: np.ndarray) -> "Extz":
    ez = Extz()
    (ez.score, ez.max, ez.max_q, ez.max_t, ez.mqe, ez.mqe_t, ez.mte,
     ez.mte_q) = (int(scal[0]), int(scal[1]), int(scal[2]), int(scal[3]),
                  int(scal[4]), int(scal[5]), int(scal[6]), int(scal[7]))
    ez.zdropped = bool(scal[8])
    ez.reach_end = bool(scal[9])
    ez.cigar = cig
    return ez

KSW_NEG_INF = -0x40000000

KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_RIGHT = 0x02
KSW_EZ_GENERIC_SC = 0x04
KSW_EZ_APPROX_MAX = 0x08
KSW_EZ_APPROX_DROP = 0x10
KSW_EZ_EXTZ_ONLY = 0x40
KSW_EZ_REV_CIGAR = 0x80
KSW_EZ_SPLICE_FOR = 0x100
KSW_EZ_SPLICE_REV = 0x200
KSW_EZ_SPLICE_FLANK = 0x400

CIGAR_MATCH, CIGAR_INS, CIGAR_DEL, CIGAR_N_SKIP = 0, 1, 2, 3


@dataclass
class Extz:
    """Result record (ksw_extz_t, ksw2.h:30-39)."""
    max: int = 0
    zdropped: bool = False
    max_q: int = -1
    max_t: int = -1
    mqe: int = KSW_NEG_INF
    mqe_t: int = -1
    mte: int = KSW_NEG_INF
    mte_q: int = -1
    score: int = KSW_NEG_INF
    reach_end: bool = False
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))

    @property
    def n_cigar(self) -> int:
        return int(self.cigar.shape[0])


def gen_simple_mat(m: int, a: int, b: int, sc_ambi: int) -> np.ndarray:
    """Match/mismatch matrix with ambiguous-base row/col (align.c:9-22)."""
    a, b = abs(a), -abs(b)
    sc_ambi = -abs(sc_ambi)
    mat = np.full((m, m), b, dtype=np.int8)
    np.fill_diagonal(mat, a)
    mat[m - 1, :] = sc_ambi
    mat[:, m - 1] = sc_ambi
    return mat.reshape(-1)


def _push(cig: list[int], op: int, length: int) -> None:
    if cig and (cig[-1] & 0xF) == op:
        cig[-1] += length << 4
    else:
        cig.append(length << 4 | op)


def _backtrack(p_rows, off, off_end, i0: int, j0: int, rev_cigar: bool,
               min_intron_len: int = 0) -> np.ndarray:
    """Rotated-matrix CIGAR backtrack (ksw_backtrack, ksw2.h:126-158)."""
    cig: list[int] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if off_end is not None and i > off_end[r]:
            force_state = 1
        tmp = int(p_rows[r][i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2) & 1):
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            _push(cig, CIGAR_MATCH, 1)
            i -= 1
            j -= 1
        elif state == 1 or (state == 3 and min_intron_len <= 0):
            _push(cig, CIGAR_DEL, 1)
            i -= 1
        elif state == 3:
            _push(cig, CIGAR_N_SKIP, 1)
            i -= 1
        else:
            _push(cig, CIGAR_INS, 1)
            j -= 1
    if i >= 0:
        _push(cig, CIGAR_N_SKIP if (min_intron_len > 0 and i >= min_intron_len)
              else CIGAR_DEL, i + 1)
    if j >= 0:
        _push(cig, CIGAR_INS, j + 1)
    arr = np.array(cig, dtype=np.uint32)
    return arr if rev_cigar else arr[::-1].copy()


def _apply_zdrop(ez: Extz, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """ksw_apply_zdrop with is_rot=1 (ksw2.h:167-183)."""
    q = r - t
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, q
    elif t >= ez.max_t and q >= ez.max_q:
        tl, ql = t - ez.max_t, q - ez.max_q
        l = abs(tl - ql)
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = True
            return True
    return False


def _row_window(r: int, qlen: int, tlen: int, wl: int, wr: int):
    """Band boundaries for anti-diagonal r; None signals zdrop cut."""
    st, en = 0, tlen - 1
    if st < r - qlen + 1:
        st = r - qlen + 1
    if en > r:
        en = r
    if st < (r - wr + 1) >> 1:
        st = (r - wr + 1) >> 1
    if en > (r + wl) >> 1:
        en = (r + wl) >> 1
    if st > en:
        return None
    st0, en0 = st, en
    st = st // 16 * 16
    en = (en + 16) // 16 * 16 - 1
    return st, en, st0, en0


def _row_scores(smem: np.ndarray, sf_off: int, qr_off: int, r: int,
                qlen: int, st0: int, en0: int, mat0: int, mat1: int,
                sc_N: int) -> None:
    """Vector score fill with the kernels' unaligned 16-byte store span.

    `smem` models the kernels' contiguous [s][sf][qr] region: score stores
    at the tail of `s` legitimately spill into the head of `sf`, and query
    loads near the ends dip into the adjacent buffers, exactly as the
    unchecked SSE loads/stores do.
    """
    n_stores = (en0 - st0) // 16 + 1
    lo, hi = st0, st0 + 16 * n_stores  # exclusive
    sq = smem[sf_off + lo:sf_off + hi]
    stq = smem[qr_off + (qlen - 1 - r) + lo:qr_off + (qlen - 1 - r) + hi]
    vals = np.where(sq == stq, np.int8(mat0), np.int8(mat1))
    vals = np.where((sq == 4) | (stq == 4), np.int8(sc_N), vals)
    smem[lo:hi] = vals


def _row_max(H: np.ndarray, st0: int, en0: int, add: np.ndarray,
             h_en0: int) -> tuple[int, int]:
    """Row max with the kernels' 4-lane blocked argmax tie-breaking.

    H[st0:en0] has already been updated (+= add); h_en0 is H[en0] (updated
    first, separately).  Emulates ksw2_ext?2_sse.c:327-357.
    """
    max_H, max_t = h_en0, en0
    en1 = st0 + (en0 - st0) // 4 * 4
    nb = (en1 - st0) // 4
    if nb > 0:
        block = H[st0:en1].reshape(nb, 4)
        lane_max = block.max(axis=0)
        lane_arg = block.argmax(axis=0)  # first occurrence == strict update
        for i in range(4):
            lm = int(lane_max[i])
            lt = st0 + 4 * int(lane_arg[i]) + i if lm > h_en0 else en0
            if max_H < lm:
                max_H, max_t = lm, lt
    for t in range(en1, en0):
        if int(H[t]) > max_H:
            max_H, max_t = int(H[t]), t
    return max_H, max_t


def _shift1(arr_seg: np.ndarray, first) -> np.ndarray:
    """[first, arr_seg[0], ..., arr_seg[-2]] — the cross-lane byte shift."""
    out = np.empty_like(arr_seg)
    out[0] = first
    out[1:] = arr_seg[:-1]
    return out


def extz2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, q: int,
          e: int, w: int, zdrop: int, end_bonus: int, flag: int,
          m: int = 5) -> Extz:
    """Single-gap-cost extension (ksw_extz2_sse, SSE4.1 semantics)."""
    if _use_native() and not (flag & KSW_EZ_GENERIC_SC):
        qv = np.ascontiguousarray(qseq, np.uint8)
        tv = np.ascontiguousarray(tseq, np.uint8)
        if qv.shape[0] and tv.shape[0]:
            return _ez_from_native(*native.ksw_extz2(
                qv, tv, mat, q, e, w, zdrop, end_bonus, flag))
    ez = Extz()
    qlen, tlen = len(qseq), len(tseq)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    assert not (flag & KSW_EZ_GENERIC_SC)
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    mat = np.asarray(mat, np.int8)
    mat0, mat1 = int(mat[0]), int(mat[1])
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    max_sc_clamp = mat0 + (q + e) * 2

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col = min(qlen, tlen)
    n_col = ((min(n_col, w + 1)) + 15) // 16 * 16 + 16
    if -int(mat.min()) > 2 * (q + e):
        return ez

    nbytes = tlen_ * 16
    u = np.zeros(nbytes, np.int8)
    v = np.zeros(nbytes, np.int8)
    x = np.zeros(nbytes, np.int8)
    y = np.zeros(nbytes, np.int8)
    # contiguous [s][sf][qr] block, mirroring the kernel's memory plan
    smem = np.zeros(nbytes * 2 + qlen_ * 16 + 16, np.int8)
    sf_off, qr_off = nbytes, nbytes * 2
    smem[sf_off:sf_off + tlen] = tseq
    smem[qr_off:qr_off + qlen] = qseq[::-1]
    s = smem[:nbytes]

    H = None
    if not approx_max:
        H = np.full(nbytes, KSW_NEG_INF, np.int64)
    p_rows: list = [None] * (qlen + tlen - 1)
    off = np.zeros(qlen + tlen - 1, np.int64)
    off_end = np.zeros(qlen + tlen - 1, np.int64)

    qe = q + e
    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    u8 = u.view(np.uint8)
    v8 = v.view(np.uint8)

    with np.errstate(over="ignore"):
        for r in range(qlen + tlen - 1):
            bw = _row_window(r, qlen, tlen, wl, wr)
            if bw is None:
                ez.zdropped = True
                break
            st, en, st0, en0 = bw
            # boundary conditions (ksw2_extz2_sse.c:126-131)
            if st > 0:
                if last_st <= st - 1 <= last_en:
                    x1, v1 = int(x[st - 1]), int(v[st - 1])
                else:
                    x1 = v1 = 0
            else:
                x1, v1 = 0, (q if r else 0)
            if en >= r:
                y[r] = 0
                u[r] = q if r else 0
            _row_scores(smem, sf_off, qr_off, r, qlen, st0, en0, mat0, mat1,
                        sc_N)

            sl = slice(st, en + 1)
            z = s[sl] + np.int8((q + e) * 2)
            xt1 = _shift1(x[sl], np.int8(x1))
            vt1 = _shift1(v[sl], np.int8(v1))
            a = xt1 + vt1
            ut = u[sl].copy()
            b = y[sl] + ut
            if with_cigar:
                d = (a > z).astype(np.uint8)  # 1 if E-state wins
                if flag & KSW_EZ_RIGHT:
                    d = np.where(z > a, np.uint8(0), np.uint8(1))
            z = np.maximum(z, a)
            if with_cigar:
                if flag & KSW_EZ_RIGHT:
                    d = np.where(z > b, d, np.uint8(2))
                else:
                    d = np.where(b > z, np.uint8(2), d)
            # unsigned max/min with b and the score clamp
            zu = z.view(np.uint8)
            zu[:] = np.maximum(zu, b.view(np.uint8))
            zu[:] = np.minimum(zu, np.uint8(max_sc_clamp))
            u[sl] = z - vt1
            v[sl] = z - ut
            z2 = z - np.int8(q)
            a = a - z2
            b = b - z2
            if flag & KSW_EZ_RIGHT:
                ta = a >= 0
                tb = b >= 0
            else:
                ta = a > 0
                tb = b > 0
            x[sl] = np.where(ta, a, np.int8(0))
            y[sl] = np.where(tb, b, np.int8(0))
            if with_cigar:
                d |= np.where(ta, np.uint8(0x08), np.uint8(0))
                d |= np.where(tb, np.uint8(0x10), np.uint8(0))
                row = np.zeros(n_col, np.uint8)
                row[:en - st + 1] = d
                p_rows[r] = row
                off[r], off_end[r] = st, en

            if not approx_max:
                if r > 0:
                    if en0 > 0:
                        h_en0 = int(H[en0 - 1]) + int(u8[en0]) - qe
                    else:
                        h_en0 = int(H[en0]) + int(v8[en0]) - qe
                    H[en0] = h_en0
                    H[st0:en0] += v8[st0:en0].astype(np.int64) - qe
                    max_H, max_t = _row_max(H, st0, en0, None, h_en0)
                else:
                    H[0] = int(v8[0]) - qe - qe
                    max_H, max_t = int(H[0]), 0
                if en0 == tlen - 1 and int(H[en0]) > ez.mte:
                    ez.mte, ez.mte_q = int(H[en0]), r - en
                if r - st0 == qlen - 1 and int(H[st0]) > ez.mqe:
                    ez.mqe, ez.mqe_t = int(H[st0]), st0
                if _apply_zdrop(ez, max_H, r, max_t, zdrop, e):
                    break
                if r == qlen + tlen - 2 and en0 == tlen - 1:
                    ez.score = int(H[tlen - 1])
            else:
                if r > 0:
                    if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                        d0 = int(v8[last_H0_t]) - qe
                        d1 = int(u8[last_H0_t + 1]) - qe
                        if d0 > d1:
                            H0 += d0
                        else:
                            H0 += d1
                            last_H0_t += 1
                    elif st0 <= last_H0_t <= en0:
                        H0 += int(v8[last_H0_t]) - qe
                    else:
                        last_H0_t += 1
                        H0 += int(u8[last_H0_t]) - qe
                    if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(
                            ez, H0, r, last_H0_t, zdrop, e):
                        break
                else:
                    H0 = int(v8[0]) - qe - qe
                    last_H0_t = 0
                if r == qlen + tlen - 2 and en0 == tlen - 1:
                    ez.score = H0
            last_st, last_en = st, en

    if with_cigar:
        rev = bool(flag & KSW_EZ_REV_CIGAR)
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1, rev)
        elif (not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY)
              and ez.mqe + end_bonus > ez.max):
            ez.reach_end = True
            ez.cigar = _backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1, rev)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q, rev)
    return ez


def extd2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, q: int,
          e: int, q2: int, e2: int, w: int, zdrop: int, end_bonus: int,
          flag: int, m: int = 5) -> Extz:
    """Dual-gap-cost extension (ksw_extd2_sse, SSE4.1 semantics)."""
    if _use_native() and not (flag & KSW_EZ_GENERIC_SC):
        qv = np.ascontiguousarray(qseq, np.uint8)
        tv = np.ascontiguousarray(tseq, np.uint8)
        if qv.shape[0] and tv.shape[0]:
            return _ez_from_native(*native.ksw_extd2(
                qv, tv, mat, q, e, q2, e2, w, zdrop, end_bonus, flag))
    ez = Extz()
    qlen, tlen = len(qseq), len(tseq)
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez
    assert not (flag & KSW_EZ_GENERIC_SC)
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    mat = np.asarray(mat, np.int8)
    mat0, mat1 = int(mat[0]), int(mat[1])
    sc_N = -e2 if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col = min(qlen, tlen)
    n_col = ((min(n_col, w + 1)) + 15) // 16 * 16 + 16
    if -int(mat.min()) > 2 * (q + e):
        return ez

    # transition point between the two gap cost models (extd2:102-105)
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    nbytes = tlen_ * 16
    neg_qe = np.int8(-q - e)
    neg_qe2 = np.int8(-q2 - e2)
    u = np.full(nbytes, neg_qe, np.int8)
    v = np.full(nbytes, neg_qe, np.int8)
    x = np.full(nbytes, neg_qe, np.int8)
    y = np.full(nbytes, neg_qe, np.int8)
    x2 = np.full(nbytes, neg_qe2, np.int8)
    y2 = np.full(nbytes, neg_qe2, np.int8)
    smem = np.zeros(nbytes * 2 + qlen_ * 16 + 16, np.int8)
    sf_off, qr_off = nbytes, nbytes * 2
    smem[sf_off:sf_off + tlen] = tseq
    smem[qr_off:qr_off + qlen] = qseq[::-1]
    s = smem[:nbytes]

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
        return -e2

    qe = q + e
    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1

    with np.errstate(over="ignore"):
        for r in range(qlen + tlen - 1):
            bw = _row_window(r, qlen, tlen, wl, wr)
            if bw is None:
                ez.zdropped = True
                break
            st, en, st0, en0 = bw
            if st > 0:
                if last_st <= st - 1 <= last_en:
                    x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
                else:
                    x1, x21, v1 = -q - e, -q2 - e2, -q - e
            else:
                x1, x21 = -q - e, -q2 - e2
                v1 = bound_v(r)
            if en >= r:
                y[r] = -q - e
                y2[r] = -q2 - e2
                u[r] = bound_v(r)
            _row_scores(smem, sf_off, qr_off, r, qlen, st0, en0, mat0, mat1,
                        sc_N)

            sl = slice(st, en + 1)
            z = s[sl].copy()
            xt1 = _shift1(x[sl], np.int8(x1))
            vt1 = _shift1(v[sl], np.int8(v1))
            a = xt1 + vt1
            ut = u[sl].copy()
            b = y[sl] + ut
            x2t1 = _shift1(x2[sl], np.int8(x21))
            a2 = x2t1 + vt1
            b2 = y2[sl] + ut
            if with_cigar and (flag & KSW_EZ_RIGHT):
                d = np.where(z > a, np.uint8(0), np.uint8(1))
                z = np.maximum(z, a)
                d = np.where(z > b, d, np.uint8(2))
                z = np.maximum(z, b)
                d = np.where(z > a2, d, np.uint8(3))
                z = np.maximum(z, a2)
                d = np.where(z > b2, d, np.uint8(4))
                z = np.maximum(z, b2)
            else:
                if with_cigar:
                    d = (a > z).astype(np.uint8)
                z = np.maximum(z, a)
                if with_cigar:
                    d = np.where(b > z, np.uint8(2), d)
                z = np.maximum(z, b)
                if with_cigar:
                    d = np.where(a2 > z, np.uint8(3), d)
                z = np.maximum(z, a2)
                if with_cigar:
                    d = np.where(b2 > z, np.uint8(4), d)
                z = np.maximum(z, b2)
            z = np.minimum(z, np.int8(mat0))
            u[sl] = z - vt1
            v[sl] = z - ut
            tq = z - np.int8(q)
            a = a - tq
            b = b - tq
            tq2 = z - np.int8(q2)
            a2 = a2 - tq2
            b2 = b2 - tq2
            if flag & KSW_EZ_RIGHT:
                ta, tb = a >= 0, b >= 0
                ta2, tb2 = a2 >= 0, b2 >= 0
            else:
                ta, tb = a > 0, b > 0
                ta2, tb2 = a2 > 0, b2 > 0
            x[sl] = np.where(ta, a, np.int8(0)) - np.int8(qe)
            y[sl] = np.where(tb, b, np.int8(0)) - np.int8(qe)
            x2[sl] = np.where(ta2, a2, np.int8(0)) - np.int8(q2 + e2)
            y2[sl] = np.where(tb2, b2, np.int8(0)) - np.int8(q2 + e2)
            if with_cigar:
                d |= np.where(ta, np.uint8(0x08), np.uint8(0))
                d |= np.where(tb, np.uint8(0x10), np.uint8(0))
                d |= np.where(ta2, np.uint8(0x20), np.uint8(0))
                d |= np.where(tb2, np.uint8(0x40), np.uint8(0))
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
                if _apply_zdrop(ez, max_H, r, max_t, zdrop, e2):
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
                            ez, H0, r, last_H0_t, zdrop, e2):
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
            ez.cigar = _backtrack(p_rows, off, off_end, tlen - 1, qlen - 1, rev)
        elif (not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY)
              and ez.mqe + end_bonus > ez.max):
            ez.reach_end = True
            ez.cigar = _backtrack(p_rows, off, off_end, ez.mqe_t, qlen - 1, rev)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack(p_rows, off, off_end, ez.max_t, ez.max_q, rev)
    return ez


def sw_ll(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, gapo: int,
          gape: int, m: int = 5) -> tuple[int, int, int]:
    """Plain Smith-Waterman score + end coordinates.

    Matches ksw_ll_qinit(size=2)+ksw_ll_i16 (ksw2_ll_sse.c:85-152),
    including the striped padding lanes (scored 0) and the striped-order
    tie-breaking of the query end position.  Returns (score, qe, te).
    """
    if _use_native() and len(qseq) and len(tseq):
        return native.sw_ll(np.ascontiguousarray(qseq, np.uint8),
                            np.ascontiguousarray(tseq, np.uint8),
                            mat, gapo, gape)
    qlen, tlen = len(qseq), len(tseq)
    slen = (qlen + 7) // 8
    qlen8 = slen * 8
    mat = np.asarray(mat, np.int64).reshape(m, m)
    # profile over the padded query: pads score 0 vs every target base
    prof = np.zeros((m, qlen8), np.int64)
    prof[:, :qlen] = mat[:, np.asarray(qseq, np.int64)]

    gapoe = gapo + gape
    H = np.zeros(qlen8, np.int64)
    E = np.zeros(qlen8, np.int64)
    Hmax = np.zeros(qlen8, np.int64)
    gmax, te = 0, -1
    jj = np.arange(qlen8, dtype=np.int64)
    for i in range(tlen):
        S = prof[tseq[i]]
        diag = np.empty(qlen8, np.int64)
        diag[0] = 0
        diag[1:] = H[:-1]
        E = np.maximum(np.maximum(E - gape, H - gapoe), 0)
        h0 = np.maximum(diag + S, E)
        h0 = np.maximum(h0, 0)
        # exact F via running max: F[j] = max_k<j (H[k] + gape*k) - gapoe' ...
        # F[j] = max_{k<j} H[i,k] - gapoe - (j-1-k)*gape, via a running max
        g = h0 - gapoe + gape * jj
        run = np.maximum.accumulate(g)
        F = np.zeros(qlen8, np.int64)
        F[1:] = run[:-1] - gape * (jj[1:] - 1)
        F = np.maximum(F, 0)
        H = np.maximum(h0, F)
        imax = int(H.max()) if qlen8 else 0
        if imax >= gmax:
            gmax, te = imax, i
            Hmax[:] = H
    qe = -1
    for mem_i in range(qlen8):  # striped memory order; last hit wins
        qpos = mem_i // 8 + (mem_i % 8) * slen
        if int(Hmax[qpos]) == gmax:
            qe = qpos
    return gmax, qe, te
