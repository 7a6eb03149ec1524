"""Paired-end pairing and multi-segment helpers (pe.c analog)."""

from __future__ import annotations

import math

import numpy as np

from mm2_gb_tpu_torch.models.hit import Region


def set_pe_thru(qlens: list[int], regs: list[list[Region]]) -> None:
    """Flag read-through pairs (mm_set_pe_thru, pe.c:45-63)."""
    n_pri = [0, 0]
    pri = [-1, -1]
    for s in range(2):
        for i, r in enumerate(regs[s]):
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = i
    if n_pri[0] == 1 and n_pri[1] == 1:
        p = regs[0][pri[0]]
        q = regs[1][pri[1]]
        if (p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3
                and abs(p.re - q.re) < 3
                and ((p.qs == 0 and qlens[1] - q.qe == 0)
                     or (q.qs == 0 and qlens[0] - p.qe == 0))):
            p.pe_thru = q.pe_thru = True


def pair(max_gap_ref: int, pe_bonus: int, sub_diff: int, match_sc: int,
         qlens: list[int], regs: list[list[Region]]) -> None:
    """Pick & boost the best proper pair (mm_pair, pe.c:76-177).

    Mutates regs in place: proper_frag, parent lifting, sam_pri sync and
    the PE MAPQ model.
    """
    entries = []  # (s, rev, key, region)
    dp_thres = 0
    segs = 0
    for s in range(2):
        mx = 0
        for r in regs[s]:
            key = (r.rid << 32) | ((r.rs << 1) & 0xFFFFFFFF) | (s ^ int(r.rev))
            entries.append([s, int(r.rev), key, r])
            if r.p is not None:
                mx = max(mx, r.p.dp_max)
            segs |= 1 << s
        dp_thres += mx
    if segs != 3:
        return
    dp_thres = max(dp_thres - pe_bonus, 0)
    entries.sort(key=lambda x: x[2])  # radix by key: stable ascending

    best = -1
    max_idx = [None, None]
    last = [-1, -1]
    sc: list[int] = []
    for i, (s, rev, key, r) in enumerate(entries):
        if key & 1:  # reverse first read or forward second read
            if last[rev] < 0:
                continue
            q = entries[last[rev]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[rev], -1, -1):
                if entries[j][1] != rev or entries[j][0] == s:
                    continue
                q = entries[j][3]
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.p.dp_max + q.p.dp_max < dp_thres:
                    continue
                score = ((r.p.dp_max + q.p.dp_max) << 32) | \
                    ((r.hash + q.hash) & 0xFFFFFFFF)
                if score > best:
                    best = score
                    max_idx[entries[j][0]] = entries[j][3]
                    max_idx[s] = r
                sc.append(score)
        else:
            last[rev] = i
    sc.sort()

    if sc and best > 0:
        rr = [max_idx[0], max_idx[1]]
        rr[0].proper_frag = rr[1].proper_frag = True
        for s in range(2):
            r = rr[s]
            if r.id != r.parent:  # lift to primary (pe.c:140-146)
                p = regs[s][r.parent]
                for x in regs[s]:
                    if x.parent == p.id:
                        x.parent = r.id
                p.mapq = 0
            if not r.sam_pri:
                for x in regs[s]:
                    x.sam_pri = False
                r.sam_pri = True
        mapq_pe = max(rr[0].mapq, rr[1].mapq)
        n_sub = sum(1 for v in sc if (v >> 32) + sub_diff >= best >> 32)
        if len(sc) > 1:
            alt = int(np.float32(
                np.float32(6.02) * ((best >> 32) - (sc[-2] >> 32)) / match_sc
                - np.float32(4.343) * np.float32(math.log(n_sub))))
            mapq_pe = min(mapq_pe, alt)
        for r in rr:
            if r.mapq < mapq_pe:
                r.mapq = int(0.2 * r.mapq + 0.8 * mapq_pe + 0.499)
        if len(sc) == 1:
            for r in rr:
                r.mapq = max(r.mapq, 2)
        elif (best >> 32) > (sc[-2] >> 32):
            for r in rr:
                r.mapq = max(r.mapq, 1)

    set_pe_thru(qlens, regs)
