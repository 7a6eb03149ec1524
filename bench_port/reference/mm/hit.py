# Frozen copy of mm2_gb_tpu_torch/models/hit.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Hit post-processing: chains → mapping records, primary selection, MAPQ.

Semantics-exact reimplementation of hit.c / esterr.c:
- mm_gen_regs      (hit.c:52-88)    chains → regions, hash-randomized order
- mm_set_parent    (hit.c:125-185)  primary/secondary overlap resolution
- mm_select_sub    (hit.c:255-283)  secondary filtering
- mm_est_err       (esterr.c:30-64) per-region divergence estimate
- mm_set_mapq      (hit.c:421-466)  mapping quality model
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import ksort, native
from .hashkit import hash64_full

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2


@dataclass
class Region:
    """One candidate mapping (mm_reg1_t analog, minimap.h:105-124)."""
    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0            # offset into the anchor array
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    split: int = 0
    rev: bool = False
    inv: bool = False
    sam_pri: bool = False
    proper_frag: bool = False
    seg_split: bool = False
    seg_id: int = 0
    split_inv: bool = False
    is_alt: bool = False
    pe_thru: bool = False
    strand_retained: bool = False
    hash: int = 0
    div: float = -1.0
    # alignment extension (mm_extra_t analog); None until base alignment runs
    p: "AlnExtra | None" = None


@dataclass
class AlnExtra:
    """Base-alignment details (mm_extra_t, minimap.h:96-103)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))


def _set_coor(r: Region, qlen: int, ax: np.ndarray, ay: np.ndarray,
              is_qstrand: bool) -> None:
    """mm_reg_set_coor (hit.c:23-39); requires r.as_/r.cnt set."""
    k = r.as_
    q_span = int((ay[k] >> np.uint64(32)) & np.uint64(0xFF))
    r.rev = bool(ax[k] >> np.uint64(63))
    r.rid = int((ax[k] << np.uint64(1)) >> np.uint64(33))
    rs = int(ax[k] & np.uint64(0xFFFFFFFF))
    r.rs = rs + 1 - q_span if rs + 1 > q_span else 0
    r.re = int(ax[k + r.cnt - 1] & np.uint64(0xFFFFFFFF)) + 1
    y0 = int(ay[k] & np.uint64(0xFFFFFFFF))
    y1 = int(ay[k + r.cnt - 1] & np.uint64(0xFFFFFFFF))
    if not r.rev or is_qstrand:
        r.qs = y0 + 1 - q_span
        r.qe = y1 + 1
    else:
        r.qs = qlen - (y1 + 1)
        r.qe = qlen - (y0 + 1 - q_span)
    _cal_fuzzy_len(r, ax, ay)


def _cal_fuzzy_len(r: Region, ax: np.ndarray, ay: np.ndarray) -> None:
    """mm_cal_fuzzy_len (hit.c:8-21): seeded match/block lengths."""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    k = r.as_
    span0 = int((ay[k] >> np.uint64(32)) & np.uint64(0xFF))
    r.mlen = r.blen = span0
    if r.cnt == 1:
        return
    sl = slice(k, k + r.cnt)
    tx = (ax[sl] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ty = (ay[sl] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    span = ((ay[sl] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    tl = np.diff(tx)
    ql = np.diff(ty)
    r.blen += int(np.maximum(tl, ql).sum())
    both_over = (tl > span[1:]) & (ql > span[1:])
    r.mlen += int(np.where(both_over, span[1:], np.minimum(tl, ql)).sum())


def gen_regs(hash_: int, qlen: int, u: np.ndarray, ax: np.ndarray,
             ay: np.ndarray, is_qstrand: bool = False) -> list[Region]:
    """Chains → regions, sorted by hash-randomized score (hit.c:52-88).

    Coordinates and fuzzy lengths are computed for ALL chains in one
    vectorized pass (the semantics of _set_coor/_cal_fuzzy_len applied
    per chain via cumulative sums) — chain-dense repeat workloads make
    the per-region scalar path the mapper's bottleneck."""
    n_u = u.shape[0]
    if n_u == 0:
        return []
    counts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    ends = starts + counts - 1
    h = hash64_full((hash64_full(ax[starts]) + hash64_full(ay[starts]))
                    ^ np.uint64(hash_)).astype(np.uint32)
    zx = u ^ h.astype(np.uint64)      # score<<32 | (count ^ hash_low)
    perm = (native.radix_perm64(zx) if native.available()
            else ksort.radix_perm64(zx))
    perm = perm[::-1]                  # larger score first

    M32 = np.uint64(0xFFFFFFFF)
    tx = (ax & M32).astype(np.int64)
    ty = (ay & M32).astype(np.int64)
    span_all = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    # fuzzy match/block contributions between consecutive anchors
    # (mm_cal_fuzzy_len, hit.c:8-21); per-chain sums via cumsum deltas
    if ax.shape[0] > 1:
        d_tl = tx[1:] - tx[:-1]
        d_ql = ty[1:] - ty[:-1]
        sp1 = span_all[1:]
        c_blen = np.maximum(d_tl, d_ql)
        both = (d_tl > sp1) & (d_ql > sp1)
        c_mlen = np.where(both, sp1, np.minimum(d_tl, d_ql))
        csb = np.concatenate(([0], np.cumsum(c_blen)))
        csm = np.concatenate(([0], np.cumsum(c_mlen)))
        blen = span_all[starts] + (csb[ends] - csb[starts])
        mlen = span_all[starts] + (csm[ends] - csm[starts])
    else:
        blen = mlen = span_all[starts].copy()
    # mm_reg_set_coor (hit.c:23-39), vectorized
    rev = (ax[starts] >> np.uint64(63)).astype(bool)
    rid = ((ax[starts] << np.uint64(1)) >> np.uint64(33)).astype(np.int64)
    span0 = span_all[starts]
    rs0 = tx[starts]
    rs = np.where(rs0 + 1 > span0, rs0 + 1 - span0, 0)
    re = tx[ends] + 1
    y0 = ty[starts]
    y1 = ty[ends]
    fwd = ~rev | is_qstrand
    qs = np.where(fwd, y0 + 1 - span0, qlen - (y1 + 1))
    qe = np.where(fwd, y1 + 1, qlen - (y0 + 1 - span0))

    scores = (zx >> np.uint64(32)).astype(np.int64)
    hashes = (zx & M32).astype(np.int64)
    regs: list[Region] = []
    for i, j in enumerate(perm):
        r = Region(id=i, parent=MM_PARENT_UNSET)
        r.score = r.score0 = int(scores[j])
        r.hash = int(hashes[j])
        r.cnt = int(counts[j])
        r.as_ = int(starts[j])
        r.div = -1.0
        r.rev = bool(rev[j])
        r.rid = int(rid[j])
        r.rs = int(rs[j])
        r.re = int(re[j])
        r.qs = int(qs[j])
        r.qe = int(qe[j])
        r.mlen = int(mlen[j])
        r.blen = int(blen[j])
        regs.append(r)
    return regs


def _alt_score(score: int, alt_diff_frac: float) -> int:
    if score < 0:
        return score
    score = int(score * (1.0 - alt_diff_frac) + 0.499)
    return score if score > 0 else 1


def set_parent(regs: list[Region], mask_level: float, mask_len: int,
               sub_diff: int, hard_mask_level: bool, alt_diff_frac: float
               ) -> None:
    """Primary/secondary marking by query-interval overlap (hit.c:125-185)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for pj in w:
                rp = regs[pj]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si), min(ej, ei)))
            if cov:
                cov.sort()
                x = si
                for (cs, ce) in cov:
                    if cs > x:
                        uncov_len += cs - x
                    x = max(ce, x)
                if ei > x:
                    uncov_len += ei - x
        placed = False
        for pj in w:
            rp = regs[pj]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            min_l = min(ej - sj, ei - si)
            max_l = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            # float32 comparison, as in hit.c:166
            if (np.float32(ol) / np.float32(min_l)
                    - np.float32(uncov_len) / np.float32(max_l)
                    > np.float32(mask_level) and uncov_len <= mask_len):
                cnt_sub = 0
                sci = ri.score
                ri.parent = rp.parent
                if not rp.is_alt and ri.is_alt:
                    sci = _alt_score(sci, alt_diff_frac)
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    cnt_sub = 1
                if (rp.p is not None and ri.p is not None
                        and (rp.rid != ri.rid or rp.rs != ri.rs
                             or rp.re != ri.re or ol != min_l)):
                    sci = ri.p.dp_max
                    if not rp.is_alt and ri.is_alt:
                        sci = _alt_score(sci, alt_diff_frac)
                    rp.p.dp_max2 = max(rp.p.dp_max2, sci)
                    if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                placed = True
                break
        if not placed:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0


def set_sam_pri(regs: list[Region]) -> int:
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = n_pri == 1
        else:
            r.sam_pri = False
    return n_pri


def sync_regs(regs: list[Region]) -> None:
    """Re-number ids and remap parents after removals (hit.c:231-253)."""
    if not regs:
        return
    max_id = max(r.id for r in regs)
    tmp = [-1] * (max_id + 1)
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        r.id = i
        if r.parent == MM_PARENT_TMP_PRI:
            r.parent = i
        elif r.parent >= 0 and tmp[r.parent] >= 0:
            r.parent = tmp[r.parent]
        else:
            r.parent = MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(regs: list[Region], pri_ratio: float, min_diff: int,
               best_n: int, check_strand: bool, min_strand_sc: int
               ) -> list[Region]:
    """Drop weak secondary hits (mm_select_sub, hit.c:255-283)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    # in-place compaction with parent lookups against the partially
    # compacted array, exactly like the C loop (hit.c:259-273)
    buf = list(regs)
    n = len(buf)
    k = 0
    n_2nd = 0
    for i in range(n):
        r = buf[i]
        pidx = r.parent
        rp = buf[pidx] if 0 <= pidx < n else None
        keep = False
        if pidx == i or r.inv:
            keep = True
        elif ((np.float32(r.score) >= np.float32(rp.score) * np.float32(pri_ratio)
               or r.score + min_diff >= rp.score) and n_2nd < best_n):
            if not (r.qs == rp.qs and r.qe == rp.qe and r.rid == rp.rid
                    and r.rs == rp.rs and r.re == rp.re):
                keep = True
                n_2nd += 1
        elif (check_strand and n_2nd < best_n and r.score > min_strand_sc
              and r.rev != rp.rev):
            r.strand_retained = True
            keep = True
            n_2nd += 1
        if keep:
            buf[k] = r
            k += 1
    out = buf[:k]
    if k != n:
        sync_regs(out)
    return out


def filter_strand_retained(regs: list[Region]) -> list[Region]:
    """hit.c:285-296."""
    out = []
    for r in regs:
        p = regs[r.parent] if 0 <= r.parent < len(regs) else r
        if (not r.strand_retained or r.div < p.div * 5.0 or r.div < 0.01):
            out.append(r)
    return out


def est_err(index, qlen: int, regs: list[Region], ax: np.ndarray,
            ay: np.ndarray, mini_pos: np.ndarray) -> None:
    """Divergence estimate from seed survival (esterr.c:30-64)."""
    n = mini_pos.shape[0]
    if n == 0:
        return
    spans = (mini_pos >> np.uint64(32)) & np.uint64(0xFF)
    avg_k = np.float32(float(spans.sum(dtype=np.uint64)) / n)
    mp_low = (mini_pos & np.uint64(0xFFFFFFFF)).astype(np.int64)

    y_low = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
    y_span = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    a_rev = (ax >> np.uint64(63)).astype(bool)
    qpos_all = np.where(a_rev, qlen - 1 - (y_low + 1 - y_span), y_low)

    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        seq = qpos_all[r.as_:r.as_ + r.cnt]
        if r.rev:
            seq = seq[::-1]
        x0 = int(seq[0])
        # binary search in mini_pos (esterr.c:16-28)
        idx = np.searchsorted(mp_low, x0)
        if idx >= n or mp_low[idx] != x0:
            continue
        st = en = int(idx)
        n_match = 1
        if r.cnt > 1:
            # the reference's two-pointer (esterr.c:40-49) matches seed
            # query positions against mini_pos in order; it stops at the
            # first chain seed that is absent or non-advancing
            jp = np.searchsorted(mp_low, seq[1:])
            ok = (jp < n)
            ok &= np.where(ok, mp_low[np.minimum(jp, n - 1)] == seq[1:],
                           False)
            prev = np.concatenate(([st], jp[:-1]))
            ok &= jp > prev
            bad = np.nonzero(~ok)[0]
            run = int(bad[0]) if bad.size else ok.shape[0]
            if run > 0:
                n_match += run
                en = int(jp[run - 1])
        n_tot = en - st + 1
        l_ref = int(index.lens[r.rid])
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        # NB: esterr.c:61 uses qs (not qe) in the tail-extension test
        if qlen - r.qs > avg_k and l_ref - r.re > avg_k:
            n_tot += 1
        if n_match >= n_tot:
            r.div = 0.0
        else:
            r.div = float(np.float32(
                1.0 - math.pow(n_match / n_tot, 1.0 / float(avg_k))))


def _logf(x: float) -> float:
    """float32 natural log with float64 evaluation then rounding (≈ glibc
    logf), including the IEEE edge cases merged split dumps can hit:
    logf(0) = -inf (no error), logf(x<0) = nan."""
    x = float(x)
    if x == 0.0:
        return float("-inf")
    if x < 0.0 or math.isnan(x):
        return float("nan")
    return float(np.float32(math.log(x)))


def _ftoi(x) -> int:
    """C (int) cast of a float: truncation, with the x86 cvttss2si
    convention for invalid inputs (NaN / ±inf / out of int32 range all
    yield INT_MIN) — mm_set_mapq relies on this for degenerate regs
    (score 0 from merged split dumps)."""
    x = float(x)
    if math.isnan(x) or x >= 2147483648.0 or x < -2147483648.0:
        return -2147483648
    return int(x)


def _fdiv(a, b) -> np.float32:
    """float32 division with C semantics (0/0 = nan, x/0 = ±inf)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.float32(np.float32(a) / np.float32(b))


def set_mapq(regs: list[Region], min_chain_sc: int, match_sc: int,
             rep_len: int, is_sr: bool) -> None:
    """MAPQ model (mm_set_mapq, hit.c:421-466).

    Every ternary follows the C comparison direction exactly: NaN
    operands (possible for calloc-zeroed regs from merged split dumps)
    make `a < b` false, which picks a different branch than a min()
    would."""
    if not regs:
        return
    q_coef = np.float32(40.0)
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    uniq_ratio = _fdiv(sum_sc, sum_sc + rep_len)
    with np.errstate(invalid="ignore", over="ignore"):
        for r in regs:
            if r.inv:
                r.mapq = 0
            elif r.parent == r.id:
                pen_s1 = (np.float32(1.0) if r.score > 100
                          else np.float32(0.01) * np.float32(r.score)
                          ) * uniq_ratio
                pen_cm = (np.float32(1.0) if r.cnt > 10
                          else np.float32(0.1) * np.float32(r.cnt))
                pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
                subsc = max(r.subsc, min_chain_sc)
                if r.p is not None and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                    identity = _fdiv(r.mlen, r.blen)
                    x = _fdiv(_fdiv(np.float32(r.p.dp_max2)
                                    * np.float32(subsc), r.p.dp_max),
                              r.score0)
                    mapq = _ftoi(identity * pen_cm * q_coef
                                 * (np.float32(1.0) - x * x)
                                 * np.float32(_logf(_fdiv(r.p.dp_max,
                                                          match_sc))))
                    if not is_sr:
                        mapq_alt = _ftoi(
                            np.float32(6.02) * identity * identity
                            * np.float32(r.p.dp_max - r.p.dp_max2)
                            / np.float32(match_sc) + np.float32(0.499))
                        mapq = mapq if mapq < mapq_alt else mapq_alt
                else:
                    x = _fdiv(subsc, r.score0)
                    if r.p is not None:
                        identity = _fdiv(r.mlen, r.blen)
                        mapq = _ftoi(identity * pen_cm * q_coef
                                     * (np.float32(1.0) - x)
                                     * np.float32(_logf(_fdiv(r.p.dp_max,
                                                              match_sc))))
                    else:
                        mapq = _ftoi(pen_cm * q_coef
                                     * (np.float32(1.0) - x)
                                     * np.float32(_logf(r.score)))
                # int32 wrap on the subtraction, as the compiled C does
                mapq = ((mapq - _ftoi(np.float32(4.343)
                                      * np.float32(_logf(r.n_sub + 1))
                                      + np.float32(0.499))
                         + 2**31) % 2**32) - 2**31
                mapq = max(mapq, 0)
                r.mapq = min(mapq, 60)
                if (r.p is not None and r.p.dp_max > r.p.dp_max2
                        and r.mapq == 0):
                    r.mapq = 1
            else:
                r.mapq = 0
    _set_inv_mapq(regs)


def _set_inv_mapq(regs: list[Region]) -> None:
    """Inversion hits inherit flanking MAPQ (hit.c:394-419)."""
    if len(regs) < 3 or not any(r.inv for r in regs):
        return
    aux = sorted(
        ((r.rid << 32 | r.rs, i) for i, r in enumerate(regs)
         if r.parent == i or r.parent < 0),
    )
    for k in range(1, len(aux) - 1):
        inv = regs[aux[k][1]]
        if inv.inv:
            l, rr = regs[aux[k - 1][1]], regs[aux[k + 1][1]]
            inv.mapq = min(l.mapq, rr.mapq)


def split_reg(r: Region, n: int, qlen: int, ax: np.ndarray, ay: np.ndarray,
              is_qstrand: bool) -> "Region | None":
    """Split a region at anchor n after a Z-drop (mm_split_reg, hit.c:106-123).

    Mutates r in place and returns the tail region (or None)."""
    import copy
    if n <= 0 or n >= r.cnt:
        return None
    r2 = copy.copy(r)
    r2.id = -1
    r2.sam_pri = False
    r2.p = None
    r2.split_inv = False
    r2.cnt = r.cnt - n
    # C float steps: (int)(score * ((float)cnt2 / cnt) + .499)
    ratio = np.float32(np.float32(r2.cnt) / np.float32(r.cnt))
    r2.score = int(float(np.float32(np.float32(r.score) * ratio)) + 0.499)
    r2.as_ = r.as_ + n
    if r.parent == r.id:
        r2.parent = MM_PARENT_TMP_PRI
    _set_coor(r2, qlen, ax, ay, is_qstrand)
    r.cnt -= r2.cnt
    r.score -= r2.score
    _set_coor(r, qlen, ax, ay, is_qstrand)
    r.split |= 1
    r2.split |= 2
    return r2


def squeeze_a(regs: list[Region], ax: np.ndarray, ay: np.ndarray) -> int:
    """Compact referenced anchors to a prefix of ax/ay, in target order
    (mm_squeeze_a, hit.c:311-329).  Mutates ax/ay and regs[].as_."""
    order = sorted(range(len(regs)), key=lambda i: (regs[i].as_, i))
    as_ = 0
    for i in order:
        r = regs[i]
        if r.as_ != as_:
            ax[as_:as_ + r.cnt] = ax[r.as_:r.as_ + r.cnt]
            ay[as_:as_ + r.cnt] = ay[r.as_:r.as_ + r.cnt]
            r.as_ = as_
        as_ += r.cnt
    return as_


def filter_regs(opt, qlen: int, regs: list[Region]) -> list[Region]:
    """Drop low-support / low-identity regions (mm_filter_regs, hit.c:290-309)."""
    out = []
    for r in regs:
        flt = False
        if not r.inv and not r.seg_split and r.cnt < opt.min_cnt:
            flt = True
        if r.p is not None:
            if r.mlen < opt.min_chain_score:
                flt = True
            elif r.p.dp_max < opt.min_dp_max:
                flt = True
            elif (r.qs > qlen * opt.max_clip_ratio
                  and qlen - r.qe > qlen * opt.max_clip_ratio):
                flt = True
        if not flt:
            out.append(r)
    return out


def hit_sort(regs: list[Region], alt_diff_frac: float) -> list[Region]:
    """Sort by dp_max (or chain score), hash tie-broken, descending
    (mm_hit_sort, hit.c:188-218).  Equal keys keep reversed input order,
    matching the reference's stable radix sort + reversed copy-out."""
    if len(regs) <= 1:
        return regs
    keep = [r for r in regs if r.inv or r.cnt > 0]
    if not keep:
        return []
    keys = []
    for r in keep:
        score = r.p.dp_max if r.p is not None else r.score
        if r.is_alt:
            score = _alt_score(score, alt_diff_frac)
        keys.append((score << 32 | r.hash))
    order = np.argsort(np.array(keys, np.uint64), kind="stable")
    return [keep[int(i)] for i in order[::-1]]


def seg_gen(hash_: int, qlens: list[int], regs0: list[Region],
            ax: np.ndarray, ay: np.ndarray):
    """Split fragment chains into per-segment chains (mm_seg_gen,
    hit.c:331-386).  Returns (regs_per_seg, anchors_per_seg)."""
    n_segs = len(qlens)
    acc = [0]
    for q in qlens[:-1]:
        acc.append(acc[-1] + q)
    qlen_sum = acc[-1] + qlens[-1]
    seg_mask = np.uint64(0xFF << 48)

    seg_u = [[] for _ in range(n_segs)]     # (score<<32|count) per chain
    seg_ax = [[] for _ in range(n_segs)]
    seg_ay = [[] for _ in range(n_segs)]
    for r in regs0:
        counts = [0] * n_segs
        for j in range(r.cnt):
            sid = int((ay[r.as_ + j] & seg_mask) >> np.uint64(48))
            counts[sid] += 1
            rev = bool(int(ax[r.as_ + j]) >> 63)
            shift = (qlen_sum - (qlens[sid] + acc[sid])) if rev else acc[sid]
            seg_ax[sid].append(ax[r.as_ + j])
            seg_ay[sid].append(ay[r.as_ + j] - np.uint64(shift))
        for s in range(n_segs):
            if counts[s]:
                seg_u[s].append((r.score << 32) | counts[s])

    regs_per_seg = []
    anchors_per_seg = []
    for s in range(n_segs):
        u = np.array(seg_u[s], np.uint64)
        sx = np.array(seg_ax[s], np.uint64)
        sy = np.array(seg_ay[s], np.uint64)
        regs = gen_regs(hash_, qlens[s], u, sx, sy, False)
        for r in regs:
            r.seg_split = True
            r.seg_id = s
        regs_per_seg.append(regs)
        anchors_per_seg.append((sx, sy))
    return regs_per_seg, anchors_per_seg


def select_sub_multi(regs: list[Region], pri_ratio: float, pri1: float,
                     pri2: float, max_gap_ref: int, min_diff: int,
                     best_n: int, n_segs: int, qlens: list[int]
                     ) -> list[Region]:
    """Multi-segment secondary selection (mm_select_sub_multi, pe.c:6-43)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    max_dist = qlens[0] + qlens[1] + max_gap_ref if n_segs == 2 else 0
    buf = list(regs)
    n = len(buf)
    k = 0
    n_2nd = 0
    for i in range(n):
        r = buf[i]
        keep = False
        if r.parent == i:
            keep = True
        elif r.score + min_diff >= buf[r.parent].score:
            keep = True
        else:
            p = buf[r.parent]
            if (p.rev == r.rev and p.rid == r.rid
                    and r.re - p.rs < max_dist and p.re - r.rs < max_dist):
                if r.score >= p.score * pri1:
                    keep = True
            else:
                is_par_both = (n_segs == 2 and p.qs < qlens[0]
                               and p.qe > qlens[0])
                is_chi_both = (n_segs == 2 and r.qs < qlens[0]
                               and r.qe > qlens[0])
                if is_chi_both or is_chi_both == is_par_both:
                    if r.score >= p.score * pri_ratio:
                        keep = True
                elif r.score >= p.score * pri2:
                    keep = True
        if keep and r.parent != i:
            if n_2nd >= best_n:
                keep = False
            n_2nd += 1
        if keep:
            buf[k] = r
            k += 1
    out = buf[:k]
    if k != n:
        sync_regs(out)
    return out


def mark_alt(index, regs: list[Region]) -> None:
    """Flag hits on ALT contigs (mm_mark_alt, hit.c:90-97)."""
    if getattr(index, "n_alt", 0) == 0:
        return
    for r in regs:
        if index.alt_mask[r.rid]:
            r.is_alt = True
