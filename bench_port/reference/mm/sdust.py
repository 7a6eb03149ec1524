# Frozen copy of mm2_gb_tpu_torch/ops/sdust.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""SDUST low-complexity masking (sdust.c analog).

Symmetric DUST over 3-mer words: windows whose repeat score exceeds the
threshold yield "perfect intervals" that merge into masked regions.
Used to drop minimizers falling in low-complexity sequence when the
`-T` (sdust_thres) option is set (mm_dust_minier, map.c:160-184).
"""

from __future__ import annotations

import numpy as np

from .sketch import _NT4

SD_WLEN = 3
SD_WTOT = 1 << (SD_WLEN << 1)
SD_WMSK = SD_WTOT - 1


def sdust(seq, T: int = 20, W: int = 64) -> list[tuple[int, int]]:
    """Masked [start, end) intervals of `seq` (sdust_core, sdust.c:134-164)."""
    if isinstance(seq, str):
        codes = _NT4[np.frombuffer(seq.encode(), np.uint8)]
    else:
        codes = np.asarray(seq, np.uint8)
    l_seq = codes.shape[0]

    res: list[list[int]] = []
    P: list[list[int]] = []   # perfect intervals [start, finish, r, l],
    #                           sorted by start desc then finish asc
    w: list[int] = []         # word deque for the current window
    cv = [0] * SD_WTOT
    cw = [0] * SD_WTOT
    rv = rw = L = 0

    def save_masked(start: int) -> None:
        # save_masked_regions (sdust.c:92-106)
        nonlocal P
        if not P or P[-1][0] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p[0] <= f:
                saved = True
                res[-1][1] = max(f, p[1])
        if not saved:
            res.append([p[0], p[1]])
        i = len(P) - 1
        while i >= 0 and P[i][0] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t: int) -> None:
        # shift_window (sdust.c:70-90)
        nonlocal rv, rw, L
        if len(w) >= W - SD_WLEN + 1:
            s = w.pop(0)
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > T << 1:
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start: int) -> None:
        # find_perfect (sdust.c:108-132)
        c = cv.copy()
        r = rv
        max_r = max_l = 0
        for i in range(len(w) - L - 1, -1, -1):
            t = w[i]
            r += c[t]
            c[t] += 1
            new_r, new_l = r, len(w) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j][0] >= i + start:
                    p = P[j]
                    if max_r == 0 or p[2] * max_l > max_r * p[3]:
                        max_r, max_l = p[2], p[3]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, [i + start, len(w) + (SD_WLEN - 1) + start,
                                 new_r, new_l])

    l = t = 0
    for i in range(l_seq + 1):
        b = int(codes[i]) if i < l_seq else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & SD_WMSK
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:  # N: no word spans it, but window state persists (sdust.c:156-159)
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked(start)
                start += 1
            l = t = 0
    return [(s, e) for s, e in res]


def dust_minier(mv: np.ndarray, seq: str, sdust_thres: int) -> np.ndarray:
    """Drop minimizers overlapping masked regions by more than half their
    span (mm_dust_minier, map.c:160-184)."""
    if sdust_thres <= 0 or mv.shape[0] == 0:
        return mv
    dreg = sdust(seq, sdust_thres, 64)
    if not dreg:
        return mv
    keep = np.ones(mv.shape[0], dtype=bool)
    u = 0
    n_dreg = len(dreg)
    for j in range(mv.shape[0]):
        qpos = int(mv[j, 1] & np.uint64(0xFFFFFFFF)) >> 1
        span = int(mv[j, 0] & np.uint64(0xFF))
        s = qpos - (span - 1)
        e = s + span
        while u < n_dreg and dreg[u][1] <= s:
            u += 1
        if u < n_dreg and dreg[u][0] < e:
            ln = 0
            v = u
            while v < n_dreg and dreg[v][0] < e:
                ss = max(s, dreg[v][0])
                ee = min(e, dreg[v][1])
                ln += ee - ss
                v += 1
            if ln > span >> 1:
                keep[j] = False
    return mv[keep]
