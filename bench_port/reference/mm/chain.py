# Frozen copy of mm2_gb_tpu_torch/ops/chain.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Anchor chaining: host oracle implementations.

Exact-scoring reimplementation of the reference chaining stage:
- pairwise chain score        (lchain.c:113-138 comput_sc)
- backward DP chaining        (lchain.c:148-217 mg_lchain_dp)
- RMQ / long-join chaining    (lchain.c:250-369 mg_lchain_rmq)
- score-sorted backtracking   (lchain.c:8-76    mg_chain_backtrack)
- chain compaction            (lchain.c:78-111  compact_a)

These run on the host and serve two roles: the CPU fallback for reads that
miss the device batch (the reference's own fallback strategy, map.c:1030)
and the correctness oracle for the Pallas kernels (the reference validates
its GPU kernels against the CPU path the same way, gpu/debug.h:31-39).

Scores use float32 penalty arithmetic with C truncation semantics so that
results match the reference bit for bit.
"""

from __future__ import annotations

import numpy as np

from . import ksort, native
from .hashkit import mg_log2

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
_SEG_SHIFT = np.uint64(48)
_SEG_MASK_V = np.uint64(0xFF)


def comput_sc_vec(axi: np.uint64, ayi: np.uint64, axj: np.ndarray, ayj: np.ndarray,
                  max_dist_x: int, max_dist_y: int, bw: int,
                  chn_pen_gap: np.float32, chn_pen_skip: np.float32,
                  is_cdna: bool, n_seg: int) -> np.ndarray:
    """Vectorized chain score of anchor i against candidate predecessors j.

    Returns int32 scores; INT32_MIN marks invalid pairs (lchain.c:113-138).
    """
    dq = (np.int64(np.uint64(ayi) & np.uint64(0xFFFFFFFF)).astype(np.int32)
          - (ayj & np.uint64(0xFFFFFFFF)).astype(np.int32))
    sidi = int((np.uint64(ayi) >> _SEG_SHIFT) & _SEG_MASK_V)
    sidj = ((ayj >> _SEG_SHIFT) & _SEG_MASK_V).astype(np.int32)
    same = sidj == sidi
    valid = (dq > 0) & (dq <= max_dist_x)
    with np.errstate(over="ignore"):
        dr = (np.uint64(axi) - axj).astype(np.uint32).astype(np.int32)
    valid &= ~(same & ((dr == 0) | (dq > max_dist_y)))
    dd = np.abs(dr - dq)
    valid &= ~(same & (dd > bw))
    if n_seg > 1 and not is_cdna:
        valid &= ~(same & (dr > max_dist_y))
    dg = np.minimum(dr, dq)
    q_span = ((ayj >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sc = np.minimum(q_span, dg)

    need_pen = (dd != 0) | (dg > q_span)
    lin_pen = (chn_pen_gap * dd.astype(np.float32)
               + chn_pen_skip * dg.astype(np.float32)).astype(np.float32)
    log_pen = np.where(dd >= 1, mg_log2((dd + 1).astype(np.float32)),
                       np.float32(0.0)).astype(np.float32)
    pen_std = (lin_pen + np.float32(0.5) * log_pen).astype(np.float32)
    if is_cdna or n_seg > 1:
        # lchain.c:128-134: special handling across segments / for cDNA
        pen_min = np.minimum(lin_pen, log_pen)
        diff_sid = ~same
        special = diff_sid | is_cdna           # enters the cdna/multi-seg arm
        bonus = diff_sid & (dr == 0)           # overlapping paired ends
        use_min = special & ((dr > dq) | diff_sid) & ~bonus
        adj = np.where(bonus, np.int32(1),
                       np.where(use_min, -pen_min.astype(np.int32),
                                -pen_std.astype(np.int32)))
        sc = np.where(need_pen, sc + adj, sc)
    else:
        sc = np.where(need_pen, sc - pen_std.astype(np.int32), sc)
    return np.where(valid, sc, np.int32(INT32_MIN)).astype(np.int32)


def chain_dp(ax: np.ndarray, ay: np.ndarray, max_dist_x: int, max_dist_y: int,
             bw: int, max_skip: int, max_iter: int, min_cnt: int, min_sc: int,
             chn_pen_gap: float, chn_pen_skip: float, is_cdna: bool, n_seg: int
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Backward-DP chaining (mg_lchain_dp, lchain.c:148-217).

    Returns (u, ax_out, ay_out): chain summary (score<<32|count) and the
    compacted anchor columns, exactly as the reference returns them.
    """
    n = ax.shape[0]
    if n == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                np.empty(0, np.uint64))
    if max_dist_x < bw:
        max_dist_x = bw
    if not is_cdna and max_dist_y < bw:
        max_dist_y = bw
    max_drop = INT32_MAX if is_cdna else bw

    f, p = _chain_dp_scores(ax, ay, max_dist_x, max_dist_y, bw, max_skip,
                            max_iter, chn_pen_gap, chn_pen_skip,
                            is_cdna, n_seg)
    u, v = chain_backtrack(f, p, min_cnt, min_sc, max_drop)
    if u.shape[0] == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                np.empty(0, np.uint64))
    return compact_chains(u, v, ax, ay)


def _chain_dp_scores(ax, ay, max_dist_x, max_dist_y, bw, max_skip, max_iter,
                     chn_pen_gap, chn_pen_skip, is_cdna, n_seg):
    """Score/predecessor arrays of the backward DP (lchain.c:169-207)."""
    if native.available() and max_skip >= INT32_MAX:
        return native.chain_dp(ax, ay, max_dist_x, max_dist_y, bw, max_skip,
                               max_iter, np.float32(chn_pen_gap),
                               np.float32(chn_pen_skip), int(is_cdna), n_seg)
    n = ax.shape[0]
    cg = np.float32(chn_pen_gap)
    cs = np.float32(chn_pen_skip)
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    t = np.zeros(n, dtype=np.int64)  # only used when max_skip is finite

    # window start per i: first j in the same (rev,rid) group with
    # ax[j] >= ax[i] - max_dist_x  (lchain.c:171-172)
    hi_bits = ax & np.uint64(0xFFFFFFFF00000000)
    sub = np.where(ax >= np.uint64(max_dist_x), ax - np.uint64(max_dist_x),
                   np.uint64(0))
    st_all = np.searchsorted(ax, np.maximum(hi_bits, sub), side="left")

    q_span_all = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    unlimited_skip = max_skip >= INT32_MAX

    max_ii = -1
    for i in range(n):
        st = int(st_all[i])
        if i - st > max_iter:
            st = i - max_iter
        max_f = int(q_span_all[i])
        max_j = -1
        end_j = st - 1
        if st < i:
            sc = comput_sc_vec(ax[i], ay[i], ax[st:i], ay[st:i],
                               max_dist_x, max_dist_y, bw, cg, cs,
                               is_cdna, n_seg)
            valid = sc != INT32_MIN
            tot = np.where(valid, sc.astype(np.int64) + f[st:i], INT32_MIN)
            if unlimited_skip:
                best = int(tot.max(initial=INT32_MIN))
                if best > max_f:
                    max_f = best
                    # scanning j descending, the first strict improvement wins
                    # → the largest j attaining the maximum
                    max_j = st + int(np.nonzero(tot == best)[0][-1])
            else:
                n_skip = 0
                for j in range(i - 1, st - 1, -1):
                    s = int(tot[j - st])
                    if s == INT32_MIN or sc[j - st] == INT32_MIN:
                        continue
                    if s > max_f:
                        max_f, max_j = s, j
                        if n_skip > 0:
                            n_skip -= 1
                    elif t[j] == i:
                        n_skip += 1
                        if n_skip > max_skip:
                            end_j = j
                            break
                    if p[j] >= 0:
                        t[p[j]] = i
                else:
                    end_j = st - 1
        # long-range rescue beyond the max_iter window (lchain.c:188-198)
        if max_ii < 0 or int(ax[i] - ax[max_ii]) > max_dist_x:
            max_ii = -1
            if st < i:
                fw = f[st:i]
                best_f = int(fw.max(initial=INT32_MIN))
                if best_f > INT32_MIN:
                    max_ii = st + int(np.nonzero(fw == best_f)[0][-1])
        if 0 <= max_ii < end_j:
            tmp = int(comput_sc_vec(ax[i], ay[i], ax[max_ii:max_ii + 1],
                                    ay[max_ii:max_ii + 1], max_dist_x,
                                    max_dist_y, bw, cg, cs, is_cdna, n_seg)[0])
            if tmp != INT32_MIN and max_f < tmp + int(f[max_ii]):
                max_f = tmp + int(f[max_ii])
                max_j = max_ii
        f[i] = max_f
        p[i] = max_j
        if max_ii < 0 or (int(ax[i] - ax[max_ii]) <= max_dist_x
                          and f[max_ii] < f[i]):
            max_ii = i
    return f, p


def chain_backtrack(f: np.ndarray, p: np.ndarray, min_cnt: int, min_sc: int,
                    max_drop: int) -> tuple[np.ndarray, np.ndarray]:
    """Score-sorted chain extraction (mg_chain_backtrack, lchain.c:27-76).

    Returns (u, v): u = (score<<32 | count) per chain in discovery order;
    v = anchor indices of all chains concatenated (backtrack order).
    """
    n = f.shape[0]
    cand = np.nonzero(f >= min_sc)[0]
    if cand.shape[0] == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    keys = f[cand].astype(np.int64).astype(np.uint64)
    perm = (native.radix_perm64(keys) if native.available()
            else ksort.radix_perm64(keys))
    z_y = cand[perm]
    z_x = f[cand][perm].astype(np.int64)

    import os
    if native.available() and not os.environ.get("MM2TPU_NO_NATIVE"):
        return native.chain_backtrack_native(f, p, z_y, min_cnt, min_sc,
                                             max_drop)

    t = np.zeros(n, dtype=np.int8)
    u: list[int] = []
    v: list[int] = []
    for k in range(z_y.shape[0] - 1, -1, -1):
        start = int(z_y[k])
        if t[start] != 0:
            continue
        end_i = _bk_end(max_drop, int(z_x[k]), start, f, p, t)
        n_v0 = len(v)
        i = start
        while i != end_i:
            v.append(i)
            t[i] = 1
            i = p[i]
        sc = int(z_x[k]) if i < 0 else int(z_x[k]) - int(f[i])
        cnt = len(v) - n_v0
        if sc >= min_sc and cnt > 0 and cnt >= min_cnt:
            u.append((sc << 32) | cnt)
        else:
            del v[n_v0:]
    return np.array(u, dtype=np.uint64), np.array(v, dtype=np.int64)


def _bk_end(max_drop: int, zx: int, start: int, f, p, t) -> int:
    """Walk the predecessor chain; stop at peak-drop > max_drop (lchain.c:8-25)."""
    i = start
    if i < 0 or t[i] != 0:
        return i
    max_i = i
    max_s = 0
    end_i = -1
    while True:
        t[i] = 2
        end_i = i = int(p[i])
        s = zx if i < 0 else zx - int(f[i])
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if not (i >= 0 and t[i] == 0):
            break
    i = start
    while i >= 0 and i != end_i:
        t[i] = 0
        i = int(p[i])
    return max_i


def compact_chains(u: np.ndarray, v: np.ndarray, ax: np.ndarray, ay: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reverse chains to ascending order and re-sort chains by target
    position (compact_a, lchain.c:78-111).

    Returns (u_sorted, ax_out, ay_out).
    """
    counts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    n_u = u.shape[0]
    N = v.shape[0]
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    # per chain: reverse its slice of v (backtrack emitted descending) —
    # one gather: rev_pos = start + (count-1) - (pos - start)
    seg = np.repeat(np.arange(n_u), counts)
    pos = np.arange(N, dtype=np.int64)
    rev_pos = 2 * starts[seg] + counts[seg] - 1 - pos
    big = v[rev_pos]
    bx = ax[big]
    by = ay[big]
    # sort chains by their first anchor's target position (radix on x)
    wkeys = bx[starts] if n_u else np.empty(0, np.uint64)
    perm = (native.radix_perm64(wkeys) if native.available()
            else ksort.radix_perm64(wkeys))
    # reorder whole chains by perm — one gather via per-chain offsets
    c_p = counts[perm]
    new_starts = np.concatenate(([0], np.cumsum(c_p)))[:-1]
    seg2 = np.repeat(np.arange(n_u), c_p)
    src = starts[perm][seg2] + (pos - new_starts[seg2])
    return u[perm], bx[src], by[src]
