# Frozen copy of mm2_gb_tpu_torch/ops/seed.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Seeding: query sketch → index lookup → anchors.

Reproduces the seeding stage semantics exactly:
- query-side occurrence filter      (seed.c:5-28   mm_seed_mz_flt)
- seed match collection             (seed.c:30-52  mm_seed_collect_all)
- high-occurrence streak selection  (seed.c:56-96  mm_seed_select)
- rep_len / mini_pos computation    (seed.c:98-131 mm_collect_matches)
- anchor array construction + sort  (map.c:295-331 collect_seed_hits)

Anchor encoding (the central data type, used by every later stage):
    a.x = rev << 63 | rid << 32 | rpos
    a.y = flags | seg_id << 48 | q_span << 32 | qpos
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index import MinimizerIndex
from . import ksort, native
from .opts import (MapOptions, MM_F_NO_DIAG, MM_F_NO_DUAL,
                                   MM_F_FOR_ONLY, MM_F_REV_ONLY, MM_F_QSTRAND)

MM_SEED_IGNORE = np.uint64(1 << 41)
MM_SEED_TANDEM = np.uint64(1 << 42)
MM_SEED_SELF = np.uint64(1 << 43)
MM_SEED_LONG_JOIN = np.uint64(1 << 40)
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = np.uint64(0xFF << 48)

MAX_MAX_HIGH_OCC = 128


def seed_mz_flt(mv: np.ndarray, q_occ_max: int, q_occ_frac: float) -> np.ndarray:
    """Query-side filter removing over-represented minimizers (seed.c:5-28).

    `mv` is the (n, 2) sketch array; returns the filtered copy, preserving
    original order.
    """
    n = mv.shape[0]
    if n <= q_occ_max or q_occ_frac <= 0.0 or q_occ_max <= 0:
        return mv
    if native.available():
        return mv[native.seed_mz_flt_mask(mv[:, 0], q_occ_max,
                                          q_occ_frac)]
    _, inverse, counts = np.unique(mv[:, 0], return_inverse=True,
                                   return_counts=True)
    c = counts[inverse]
    drop = (c > q_occ_max) & (c > n * q_occ_frac)
    return mv[~drop]


@dataclass
class SeedMatches:
    """Kept seed matches after occurrence filtering (mm_seed_t array analog)."""
    q_pos: np.ndarray      # uint32: qpos<<1|strand per kept seed
    q_span: np.ndarray     # int32
    seg_id: np.ndarray     # int32
    is_tandem: np.ndarray  # bool
    start: np.ndarray      # int64 index-into-occ_pos of first hit
    n: np.ndarray          # int64 hit count
    rep_len: int
    mini_pos: np.ndarray   # uint64: q_span<<32 | qpos (kept seeds, in order)


def _seed_select_flt(n_occ: np.ndarray, q_pos: np.ndarray, qlen: int,
                     max_occ: int, max_max_occ: int, dist: int) -> np.ndarray:
    """High-occurrence streak top-k selection (seed.c:56-96).

    Returns the boolean `flt` array (True = filtered out).
    """
    n = n_occ.shape[0]
    flt = np.zeros(n, dtype=bool)
    if n <= 1:
        return flt
    if not np.any(n_occ > max_occ):
        return flt
    last0 = -1
    for i in range(n + 1):
        if i == n or n_occ[i] <= max_occ:
            if i - last0 > 1:
                ps = 0 if last0 < 0 else int(q_pos[last0]) >> 1
                pe = qlen if i == n else int(q_pos[i]) >> 1
                st, en = last0 + 1, i
                max_high_occ = int((pe - ps) / dist + 0.499)
                if max_high_occ > 0:
                    max_high_occ = min(max_high_occ, MAX_MAX_HIGH_OCC)
                    sel = ksort.heap_topk_select(n_occ[st:en], max_high_occ)
                    flt[st + sel] = True
                flt[st:en] ^= True
                flt[st:en] |= (n_occ[st:en] > max_max_occ)
            last0 = i
    return flt


def collect_matches(index: MinimizerIndex, mv: np.ndarray, qlen: int,
                    max_occ: int, max_max_occ: int, dist: int) -> SeedMatches:
    """Index lookups + occurrence filtering + rep_len (seed.c:98-131)."""
    qh = mv[:, 0] >> np.uint64(8)
    start, cnt = index.lookup(qh)
    found = cnt > 0
    # tandem flag: same minimizer hash as an adjacent query minimizer
    tandem = np.zeros(mv.shape[0], dtype=bool)
    if mv.shape[0] > 1:
        same_prev = qh[1:] == qh[:-1]
        tandem[1:] |= same_prev
        tandem[:-1] |= same_prev
    q_pos = mv[found, 1].astype(np.uint32)
    q_span = (mv[found, 0] & np.uint64(0xFF)).astype(np.int32)
    seg_id = (mv[found, 1] >> np.uint64(32)).astype(np.int32)
    tandem = tandem[found]
    start = start[found]
    cnt = cnt[found]

    if dist > 0 and max_max_occ > max_occ:
        flt = _seed_select_flt(cnt, q_pos, qlen, max_occ, max_max_occ, dist)
    else:
        flt = cnt > max_occ

    # rep_len: total query length covered by filtered (repetitive) seeds,
    # merging overlapping intervals (seed.c:112-121).  The scalar loop's
    # rep_en always equals the previous member's en (ens ascend with
    # q_pos), so groups split where st > previous en — vectorized.
    idxs = np.nonzero(flt)[0]
    if idxs.shape[0]:
        en_f = (q_pos[idxs].astype(np.int64) >> 1) + 1
        st_f = en_f - q_span[idxs]
        brk = np.concatenate(([True], st_f[1:] > en_f[:-1]))
        g_first = np.nonzero(brk)[0]
        g_last = np.concatenate((g_first[1:] - 1, [idxs.shape[0] - 1]))
        rep_len = int((en_f[g_last] - st_f[g_first]).sum())
    else:
        rep_len = 0

    keep = ~flt
    mini_pos = ((q_span[keep].astype(np.uint64) << np.uint64(32))
                | (q_pos[keep].astype(np.uint64) >> np.uint64(1)))
    return SeedMatches(
        q_pos=q_pos[keep], q_span=q_span[keep], seg_id=seg_id[keep],
        is_tandem=tandem[keep], start=start[keep], n=cnt[keep],
        rep_len=int(rep_len), mini_pos=mini_pos,
    )


def collect_seed_hits(index: MinimizerIndex, opt: MapOptions, max_occ: int,
                      mv: np.ndarray, qlen: int, qname: str | None
                      ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Build the sorted anchor array (collect_seed_hits, map.c:295-331).

    Returns (ax, ay, rep_len, mini_pos): uint64 anchor columns sorted with
    the reference's (unstable, x-keyed) radix permutation.
    """
    m = collect_matches(index, mv, qlen, max_occ, opt.max_max_occ, opt.occ_dist)
    n_seeds = m.q_pos.shape[0]
    if n_seeds == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                m.rep_len, m.mini_pos)

    # default path (no ava skip_seed, no strand restriction, no qstrand):
    # one native pass expands, encodes and radix-permutes the anchors
    special = ((qname is not None
                and (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)))
               or (opt.flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY
                               | MM_F_QSTRAND)))
    if native.available() and not special:
        ax, ay = native.collect_anchors(
            index.occ_pos, m.start, m.n, m.q_pos, m.q_span, m.seg_id,
            m.is_tandem, qlen)
        return ax, ay, m.rep_len, m.mini_pos

    # expand seeds × occurrences
    counts = m.n
    seed_of_hit = np.repeat(np.arange(n_seeds, dtype=np.int64), counts)
    base = np.repeat(m.start, counts)
    within = np.arange(seed_of_hit.shape[0], dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    r = index.occ_pos[base + within]          # rid<<32 | rpos<<1 | strand

    qp = m.q_pos[seed_of_hit].astype(np.uint64)       # qpos<<1|strand
    span = m.q_span[seed_of_hit].astype(np.uint64)
    segid = m.seg_id[seed_of_hit].astype(np.uint64)
    tandem = m.is_tandem[seed_of_hit]

    keep = np.ones(r.shape[0], dtype=bool)
    is_self = np.zeros(r.shape[0], dtype=bool)
    if qname is not None and (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)):
        keep, is_self = _skip_seed_mask(index, opt.flag, r, qp, qname, qlen)
    if opt.flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY):
        fwd = (r & np.uint64(1)) == (qp & np.uint64(1))
        if opt.flag & MM_F_REV_ONLY:
            keep &= ~fwd
        if opt.flag & MM_F_FOR_ONLY:
            keep &= fwd

    r, qp, span, segid, tandem, is_self = (
        arr[keep] for arr in (r, qp, span, segid, tandem, is_self))

    rpos = (r & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
    rid_hi = r & np.uint64(0xFFFFFFFF00000000)
    fwd = (r & np.uint64(1)) == (qp & np.uint64(1))

    ax = np.where(fwd, rid_hi | rpos, np.uint64(1 << 63) | rid_hi | rpos)
    y_fwd = (span << np.uint64(32)) | (qp >> np.uint64(1))
    y_rev = (span << np.uint64(32)) | \
        (np.uint64(qlen) - ((qp >> np.uint64(1)) + np.uint64(1) - span) - np.uint64(1))
    if opt.flag & MM_F_QSTRAND:
        # query-strand mode: keep query coords, flip reference coords
        rlen = index.lens[(r >> np.uint64(32)).astype(np.int64)].astype(np.uint64)
        ax_rev = (np.uint64(1 << 63) | rid_hi
                  | (rlen - (rpos + np.uint64(1) - span) - np.uint64(1)))
        ax = np.where(fwd, rid_hi | rpos, ax_rev)
        ay = y_fwd
    else:
        ay = np.where(fwd, y_fwd, y_rev)
    ay = ay | (segid << np.uint64(MM_SEED_SEG_SHIFT))
    ay = ay | np.where(tandem, MM_SEED_TANDEM, np.uint64(0))
    ay = ay | np.where(is_self, MM_SEED_SELF, np.uint64(0))

    perm = (native.radix_perm64(ax) if native.available()
            else ksort.radix_perm64(ax))
    return ax[perm], ay[perm], m.rep_len, m.mini_pos


def _skip_seed_mask(index: MinimizerIndex, flag: int, r: np.ndarray,
                    qp: np.ndarray, qname: str, qlen: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """skip_seed for all-vs-all modes (map.c:205-227). Returns (keep, is_self)."""
    rids = (r >> np.uint64(32)).astype(np.int64)
    keep = np.ones(r.shape[0], dtype=bool)
    is_self = np.zeros(r.shape[0], dtype=bool)
    # per-rid name comparison, vectorized over the few distinct rids involved
    for rid in np.unique(rids):
        sel = rids == rid
        name = index.names[rid]
        cmp = (qname > name) - (qname < name)
        if (flag & MM_F_NO_DIAG) and cmp == 0 and int(index.lens[rid]) == qlen:
            diag = ((r[sel] & np.uint64(0xFFFFFFFF)) >> np.uint64(1)) == \
                (qp[sel].astype(np.uint64) >> np.uint64(1))
            k = keep[sel]
            k[diag] = False
            keep[sel] = k
            same_strand = (r[sel] & np.uint64(1)) == (qp[sel] & np.uint64(1))
            s = is_self[sel]
            s[same_strand & ~diag] = True
            is_self[sel] = s
        if (flag & MM_F_NO_DUAL) and cmp > 0:
            keep[sel] = False
    return keep, is_self


def _heapdown(i: int, n: int, l: list) -> None:
    """ks_heapdown with heap_lt(a,b)=a.x>b.x — a min-heap on x
    (ksort.h:43-53, map.c:202-203)."""
    k = i
    tmp = l[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and l[k][0] > l[k + 1][0]:
            k += 1
        if l[k][0] > tmp[0]:
            break
        l[i] = l[k]
        i = k
    l[i] = tmp


def collect_seed_hits_heap(index: MinimizerIndex, opt: MapOptions,
                           max_occ: int, mv: np.ndarray, qlen: int,
                           qname: str | None
                           ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Heap-merge anchor collection (collect_seed_hits_heap, map.c:229-293).

    Byte-equal anchor ordering with the reference's min-heap pop sequence,
    which differs from the sort variant only in the tie order of anchors
    sharing a reference position (MM_F_HEAP_SORT presets: sr/ava)."""
    m = collect_matches(index, mv, qlen, max_occ, opt.max_max_occ,
                        opt.occ_dist)
    n_seeds = m.q_pos.shape[0]
    if n_seeds == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                m.rep_len, m.mini_pos)
    occ = index.occ_pos
    heap = []
    for i in range(n_seeds):
        if m.n[i] > 0:
            heap.append([int(occ[m.start[i]]), i << 32])
    hs = len(heap)
    for i in range((hs >> 1) - 1, -1, -1):
        _heapdown(i, hs, heap)

    check_skip = bool(qname is not None
                      and (opt.flag & (MM_F_NO_DIAG | MM_F_NO_DUAL)))
    strand_flt = opt.flag & (MM_F_FOR_ONLY | MM_F_REV_ONLY)
    fwd_x: list[int] = []
    fwd_y: list[int] = []
    rev_x: list[int] = []
    rev_y: list[int] = []
    while hs > 0:
        r, ybits = heap[0]
        si = ybits >> 32
        q_pos = int(m.q_pos[si])
        skip = False
        is_self = False
        if check_skip:
            rid = r >> 32
            name = index.names[rid]
            cmp = (qname > name) - (qname < name)
            if (opt.flag & MM_F_NO_DIAG) and cmp == 0 \
                    and int(index.lens[rid]) == qlen:
                if (r & 0xFFFFFFFF) >> 1 == q_pos >> 1:
                    skip = True
                elif (r & 1) == (q_pos & 1):
                    is_self = True
            if not skip and (opt.flag & MM_F_NO_DUAL) and cmp > 0:
                skip = True
        if not skip and strand_flt:
            fwd = (r & 1) == (q_pos & 1)
            if fwd and (opt.flag & MM_F_REV_ONLY):
                skip = True
            if not fwd and (opt.flag & MM_F_FOR_ONLY):
                skip = True
        if not skip:
            rpos = (r & 0xFFFFFFFF) >> 1
            span = int(m.q_span[si])
            y = span << 32
            y |= int(m.seg_id[si]) << MM_SEED_SEG_SHIFT
            if m.is_tandem[si]:
                y |= 1 << 42
            if is_self:
                y |= 1 << 43
            if (r & 1) == (q_pos & 1):
                fwd_x.append((r & 0xFFFFFFFF00000000) | rpos)
                fwd_y.append(y | (q_pos >> 1))
            else:
                rev_x.append((1 << 63) | (r & 0xFFFFFFFF00000000) | rpos)
                rev_y.append(y | (qlen - ((q_pos >> 1) + 1 - span) - 1))
        # advance this seed's occurrence cursor (map.c:270-276)
        oi = ybits & 0xFFFFFFFF
        if oi < int(m.n[si]) - 1:
            heap[0] = [int(occ[int(m.start[si]) + oi + 1]),
                       (si << 32) | (oi + 1)]
        else:
            heap[0] = heap[hs - 1]
            hs -= 1
        if hs:
            _heapdown(0, hs, heap)

    ax = np.array(fwd_x + rev_x, np.uint64)
    ay = np.array(fwd_y + rev_y, np.uint64)
    return ax, ay, m.rep_len, m.mini_pos
