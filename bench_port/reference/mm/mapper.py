# Frozen copy of mm2_gb_tpu_torch/models/mapper.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Per-read mapping orchestration (the mm_map_frag pipeline, map.c:638-792).

This is the host-side reference pipeline: seed → chain → post-process.
The TPU batch pipeline (mm2_gb_tpu/models/pipeline.py) produces identical
results by running the chaining stage on-device for batches of reads and
falling back to this path for reads that miss a batch (the reference uses
the same CPU-fallback strategy, map.c:1030-1035).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import hit as hitmod
from .hit import Region
from .index import MinimizerIndex
from . import chain as chain_ops
from . import chain_rmq as rmq_ops
from . import seed as seed_ops
from .sketch import sketch
from . import ksort, native
from .hashkit import read_order_hash
from .opts import (MapOptions, MM_F_ALL_CHAINS, MM_F_CIGAR,
                                   MM_F_HARD_MLEVEL, MM_F_HEAP_SORT,
                                   MM_F_NO_HASH_NAME,
                                   MM_F_NO_LJOIN, MM_F_QSTRAND, MM_F_RMQ,
                                   MM_F_SPLICE, MM_F_SR, MM_I_HPC)

INT32_MAX = 2**31 - 1


@dataclass
class MapResult:
    """Result of mapping one read/fragment."""
    regs: list[Region]
    rep_len: int
    frag_gap: int
    # per-segment regions for multi-segment fragments; [regs] when n_segs==1
    seg_regs: "list[list[Region]] | None" = None
    # anchors kept for the alignment stage
    ax: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    ay: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))


def collect_minimizers(index: MinimizerIndex, opt: MapOptions,
                       seqs: list[str]) -> np.ndarray:
    """Query sketch over fragment segments (collect_minimizers, map.c:186-199)."""
    chunks = []
    total = 0
    for sid, s in enumerate(seqs):
        if len(s) == 0:
            total += len(s)
            continue
        mm = sketch(s, index.w, index.k, sid, bool(index.flag & MM_I_HPC))
        if total:
            mm = mm.copy()
            mm[:, 1] += np.uint64(total << 1)
        if opt.sdust_thres > 0:  # mask low-complexity minimizers (map.c:194-195)
            from .sdust import dust_minier
            mm = dust_minier(mm, s, opt.sdust_thres)
        chunks.append(mm)
        total += len(s)
    if not chunks:
        return np.empty((0, 2), dtype=np.uint64)
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]


def _chain_gaps(opt: MapOptions, qlen_sum: int) -> tuple[int, int]:
    """max chaining gaps on query/reference (map.c:678-689)."""
    is_sr = bool(opt.flag & MM_F_SR)
    max_gap_qry = max(qlen_sum, opt.max_gap) if is_sr else opt.max_gap
    if opt.max_gap_ref > 0:
        max_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_gap_ref = opt.max_gap
    return max_gap_qry, max_gap_ref


def chain_anchors(index: MinimizerIndex, opt: MapOptions, qlen_sum: int,
                  n_segs: int, ax: np.ndarray, ay: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chaining dispatch incl. the long-join rescue (map.c:690-707).

    Returns (u, ax_out, ay_out) — the final chain set for this read.
    """
    max_gap_qry, max_gap_ref = _chain_gaps(opt, qlen_sum)
    is_splice = bool(opt.flag & MM_F_SPLICE)
    chn_pen_gap = np.float32(float(np.float32(opt.chain_gap_scale)) * 0.01 * index.k)
    chn_pen_skip = np.float32(float(np.float32(opt.chain_skip_scale)) * 0.01 * index.k)

    if opt.flag & MM_F_RMQ:
        u, cx, cy = rmq_ops.chain_rmq(
            ax, ay, opt.max_gap, opt.rmq_inner_dist, opt.bw,
            opt.max_chain_skip, opt.rmq_size_cap, opt.min_cnt,
            opt.min_chain_score, chn_pen_gap, chn_pen_skip)
    else:
        u, cx, cy = chain_ops.chain_dp(
            ax, ay, max_gap_ref, max_gap_qry, opt.bw, opt.max_chain_skip,
            opt.max_chain_iter, opt.min_cnt, opt.min_chain_score,
            chn_pen_gap, chn_pen_skip, is_splice, n_segs)

    # long-join rescue with RMQ chaining over the compacted anchors.
    # The OUTER condition alone makes the max_occ re-chain an else-if in
    # the reference (map.c:698-709): when it holds, the caller must skip
    # the max_occ branch even if the rescue emptied the chain set.
    ljoin = (opt.bw_long > opt.bw
             and (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)) == 0
             and n_segs == 1 and u.shape[0] > 1)
    if ljoin:
        cnt0 = int(u[0] & np.uint64(0xFFFFFFFF))
        st = int(cy[0] & np.uint64(0xFFFFFFFF))
        en = int(cy[cnt0 - 1] & np.uint64(0xFFFFFFFF))
        if (qlen_sum - (en - st) > opt.rmq_rescue_size
                or en - st > qlen_sum * opt.rmq_rescue_ratio):
            perm = (native.radix_perm64(cx) if native.available()
                    else ksort.radix_perm64(cx))
            cx, cy = cx[perm], cy[perm]
            u, cx, cy = rmq_ops.chain_rmq(
                cx, cy, opt.max_gap, opt.rmq_inner_dist, opt.bw_long,
                opt.max_chain_skip, opt.rmq_size_cap, opt.min_cnt,
                opt.min_chain_score, chn_pen_gap, chn_pen_skip)
    return u, cx, cy, ljoin


def _dbg_anchor_line(index, ax, ay, i, gap_ref_i):
    x = int(ax[i])
    y = int(ay[i])
    rid = (x << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    x32 = int(np.int32(np.uint32(x & 0xFFFFFFFF)))
    y32 = int(np.int32(np.uint32(y & 0xFFFFFFFF)))
    span = (y >> 32) & 0xFF
    strand = "+-"[x >> 63]
    if gap_ref_i < 0:
        gap = 0
    else:
        xp, yp = int(ax[gap_ref_i]), int(ay[gap_ref_i])
        gap = (y32 - int(np.int32(np.uint32(yp & 0xFFFFFFFF)))) \
            - (x32 - int(np.int32(np.uint32(xp & 0xFFFFFFFF))))
    return (index.names[rid] + "\t" + str(x32) + "\t" + strand + "\t"
            + str(y32) + "\t" + str(span) + "\t" + str(gap))


def _dbg_seed_dump(index, ax, ay, rep_len):
    """RS/SD anchor dump, byte-identical to --print-seeds (map.c:383-388)."""
    import sys
    w = sys.stderr.write
    w("RS\t" + str(rep_len) + "\n")
    for i in range(ax.shape[0]):
        w("SD\t" + _dbg_anchor_line(index, ax, ay, i, i - 1) + "\n")


def _dbg_chain_dump(index, regs, ax, ay):
    """CN per-chain anchor dump (map.c:600-604)."""
    import sys
    w = sys.stderr.write
    for j, r in enumerate(regs):
        for i in range(r.as_, r.as_ + r.cnt):
            w("CN\t" + str(j) + "\t" + _dbg_anchor_line(
                index, ax, ay, i, -1 if i == r.as_ else i - 1) + "\n")


def map_frag(index: MinimizerIndex, opt: MapOptions, seqs: list[str],
             qname: str | None = None) -> MapResult:
    """Map one read (or multi-segment fragment); returns candidate regions.

    Single-segment version of mm_map_frag (map.c:638-792); multi-segment
    splitting (mm_seg_gen) is handled by the caller for frag mode.
    """
    n_segs = len(seqs)
    qlens = [len(s) for s in seqs]
    qlen_sum = sum(qlens)
    if qlen_sum == 0 or n_segs <= 0 or n_segs > 255:
        return MapResult([], 0, 0)
    if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
        return MapResult([], 0, 0)
    is_sr = bool(opt.flag & MM_F_SR)

    hash_ = read_order_hash(qname, qlen_sum, opt.seed,
                            bool(opt.flag & MM_F_NO_HASH_NAME))

    mv = collect_minimizers(index, opt, seqs)
    if opt.q_occ_frac > 0.0:
        mv = seed_ops.seed_mz_flt(mv, opt.mid_occ, opt.q_occ_frac)
    collect = (seed_ops.collect_seed_hits_heap
               if opt.flag & MM_F_HEAP_SORT else
               seed_ops.collect_seed_hits)
    ax, ay, rep_len, mini_pos = collect(
        index, opt, opt.mid_occ, mv, qlen_sum, qname)
    if opt.dbg_print_seed:
        _dbg_seed_dump(index, ax, ay, rep_len)

    u, cx, cy, ljoin = chain_anchors(index, opt, qlen_sum, n_segs, ax, ay)

    # re-chain with a higher occurrence cutoff, mostly for short reads —
    # an ELSE-IF of the long-join branch (map.c:708-731): skipped when
    # the long-join condition held, even if its rescue emptied u
    if (not ljoin and opt.max_occ > opt.mid_occ and rep_len > 0
            and not (opt.flag & MM_F_RMQ)):
        rechain = False
        if u.shape[0] > 0:
            counts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
            scores = (u >> np.uint64(32)).astype(np.int64)
            max_i = int(np.argmax(scores))
            off = int(counts[:max_i].sum())
            seg_ids = (cy[off:off + int(counts[max_i])]
                       & seed_ops.MM_SEED_SEG_MASK)
            n_chained = int((seg_ids[1:] != seg_ids[:-1]).sum()) + 1
            rechain = n_chained < n_segs
        else:
            rechain = True
        if rechain:
            ax, ay, rep_len, mini_pos = collect(
                index, opt, opt.max_occ, mv, qlen_sum, qname)
            max_gap_qry, max_gap_ref = _chain_gaps(opt, qlen_sum)
            chn_pen_gap = np.float32(float(np.float32(opt.chain_gap_scale)) * 0.01 * index.k)
            chn_pen_skip = np.float32(float(np.float32(opt.chain_skip_scale)) * 0.01 * index.k)
            u, cx, cy = chain_ops.chain_dp(
                ax, ay, max_gap_ref, max_gap_qry, opt.bw, opt.max_chain_skip,
                opt.max_chain_iter, opt.min_cnt, opt.min_chain_score,
                chn_pen_gap, chn_pen_skip, bool(opt.flag & MM_F_SPLICE), n_segs)

    _, max_gap_ref = _chain_gaps(opt, qlen_sum)
    regs = hitmod.gen_regs(hash_, qlen_sum, u, cx, cy,
                           bool(opt.flag & MM_F_QSTRAND))
    if index.n_alt:  # map.c:738-741
        hitmod.mark_alt(index, regs)
        regs = hitmod.hit_sort(regs, opt.alt_drop)
    if opt.dbg_print_seed or opt.dbg_print_chain:
        _dbg_chain_dump(index, regs, cx, cy)  # regs index the compacted a[]
    if n_segs == 1:
        regs = post_process(index, opt, qlen_sum, n_segs, qlens, regs, cx, cy,
                            mini_pos, rep_len, seqs)
        res = MapResult(regs, rep_len, max_gap_ref, cx, cy)
        res.seg_regs = [regs]
        return res
    # ---- multi-segment fragment (map.c:617-628) ----
    if not (opt.flag & MM_F_ALL_CHAINS):
        hitmod.set_parent(regs, opt.mask_level, opt.mask_len,
                          opt.a * 2 + opt.b, bool(opt.flag & MM_F_HARD_MLEVEL),
                          opt.alt_drop)
        regs = hitmod.select_sub_multi(regs, opt.pri_ratio, 0.2, 0.7,
                                       max_gap_ref, index.k * 2, opt.best_n,
                                       n_segs, qlens)
    if not is_sr and not (opt.flag & MM_F_QSTRAND):
        hitmod.est_err(index, qlen_sum, regs, cx, cy, mini_pos)
        regs = hitmod.filter_strand_retained(regs)
    seg_regs, seg_anchors = hitmod.seg_gen(hash_, qlens, regs, cx, cy)
    for s in range(n_segs):
        hitmod.set_parent(seg_regs[s], opt.mask_level, opt.mask_len,
                          opt.a * 2 + opt.b, bool(opt.flag & MM_F_HARD_MLEVEL),
                          opt.alt_drop)
        if opt.flag & MM_F_CIGAR:
            from . import align as align_ops
            sax, say = seg_anchors[s]
            seg_regs[s] = align_ops.align_regs(index, opt, qlens[s], seqs[s],
                                               seg_regs[s], sax, say)
            if not (opt.flag & MM_F_ALL_CHAINS):
                hitmod.set_parent(seg_regs[s], opt.mask_level, opt.mask_len,
                                  opt.a * 2 + opt.b,
                                  bool(opt.flag & MM_F_HARD_MLEVEL),
                                  opt.alt_drop)
                seg_regs[s] = hitmod.select_sub(seg_regs[s], opt.pri_ratio,
                                                index.k * 2, opt.best_n,
                                                False, int(opt.max_gap * 0.8))
                hitmod.set_sam_pri(seg_regs[s])
        hitmod.set_mapq(seg_regs[s], opt.min_chain_score, opt.a, rep_len,
                        is_sr)
    if n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & MM_F_CIGAR):
        from . import pe
        pe.pair(max_gap_ref, opt.pe_bonus, opt.a * 2 + opt.b, opt.a, qlens,
                seg_regs)
    res = MapResult(seg_regs[0], rep_len, max_gap_ref, cx, cy)
    res.seg_regs = seg_regs
    return res


def post_process(index: MinimizerIndex, opt: MapOptions, qlen_sum: int,
                 n_segs: int, qlens: list[int], regs: list[Region],
                 cx: np.ndarray, cy: np.ndarray, mini_pos: np.ndarray,
                 rep_len: int, seqs: list[str] | None = None) -> list[Region]:
    """chain_post + est_err + mapq (map.c:737-773, single-segment path)."""
    is_sr = bool(opt.flag & MM_F_SR)
    if not (opt.flag & MM_F_ALL_CHAINS):
        hitmod.set_parent(regs, opt.mask_level, opt.mask_len,
                          opt.a * 2 + opt.b, bool(opt.flag & MM_F_HARD_MLEVEL),
                          opt.alt_drop)
        if n_segs <= 1:
            regs = hitmod.select_sub(regs, opt.pri_ratio, index.k * 2,
                                     opt.best_n, True, int(opt.max_gap * 0.8))
        # multi-segment selection handled in the frag-mode pipeline
    if not is_sr and not (opt.flag & MM_F_QSTRAND):
        hitmod.est_err(index, qlen_sum, regs, cx, cy, mini_pos)
        regs = hitmod.filter_strand_retained(regs)
    if n_segs == 1:
        if opt.flag & MM_F_CIGAR:
            from . import align as align_ops
            regs = align_ops.align_regs(index, opt, qlen_sum, seqs[0],
                                        regs, cx, cy)
            # re-pick primaries over the aligned set (align_regs wrapper,
            # map.c:343-352)
            if not (opt.flag & MM_F_ALL_CHAINS):
                hitmod.set_parent(regs, opt.mask_level, opt.mask_len,
                                  opt.a * 2 + opt.b,
                                  bool(opt.flag & MM_F_HARD_MLEVEL),
                                  opt.alt_drop)
                regs = hitmod.select_sub(regs, opt.pri_ratio, index.k * 2,
                                         opt.best_n, False,
                                         int(opt.max_gap * 0.8))
                hitmod.set_sam_pri(regs)
        hitmod.set_mapq(regs, opt.min_chain_score, opt.a, rep_len, is_sr)
    return regs
