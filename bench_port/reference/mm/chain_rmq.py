# Frozen copy of mm2_gb_tpu_torch/ops/chain_rmq.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""RMQ-based chaining (assembly / long-join mode).

Host oracle for the reference's RMQ-tree chaining (mg_lchain_rmq,
lchain.c:250-369): each anchor queries, over a sliding window of active
predecessors, the one maximizing f[j] - 0.5*gap_pen*((int32)x_j + (int32)y_j)
(a linear lower-bound relaxation of the chain score), then refines within
max_dist_inner by explicit iteration.

The reference stores candidates in an RMQ-augmented AVL tree (krmq.h)
whose min-priority TIE answer depends on tree topology — part of the
byte contract.  KrmqAvl below (and its C++ twin csrc/krmq_avl.h) is an
exact behavioral emulation: same key order (lc_elem_cmp), strict-<
priority (lc_elem_lt2), the krmq_update_min aggregation tie rules with
their call-site argument order, AVL insert/erase shapes, and the
two-path LCA traversal of krmq_rmq — cross-fuzzed 260/260 op streams
identical against a harness built from the reference's own krmq.h
(goldens: tests/golden/krmq_ops.json.gz).  The inner tree is only
iterated in key order (unique keys), so a sorted list reproduces it.
"""

from __future__ import annotations

import bisect

import numpy as np

from .chain import (INT32_MAX, INT32_MIN, chain_backtrack,
                                  compact_chains)
from .hashkit import mg_log2


def _sc_simple(axi: int, ayi: int, axj: int, ayj: int,
               cg: np.float32, cs: np.float32) -> tuple[int, bool, int]:
    """comput_sc_simple (lchain.c:230-248): (score, exact, width)."""
    dq = (ayi & 0xFFFFFFFF) - (ayj & 0xFFFFFFFF)
    dq = (dq + 2**31) % 2**32 - 2**31  # int32 semantics
    dr = ((axi - axj) & 0xFFFFFFFF)
    dr = (dr + 2**31) % 2**32 - 2**31
    dd = dr - dq if dr > dq else dq - dr
    dg = dr if dr < dq else dq
    q_span = (ayj >> 32) & 0xFF
    sc = q_span if q_span < dg else dg
    exact = (dd == 0 and dg <= q_span)
    if dd or dq > q_span:
        lin = np.float32(cg * np.float32(dd) + cs * np.float32(dg))
        log = mg_log2(np.float32(dd + 1)) if dd >= 1 else np.float32(0.0)
        sc -= int(np.float32(lin + np.float32(0.5) * log))
    return int(sc), exact, int(dd)


class KrmqAvl:
    """Exact krmq.h emulation (see module docstring; C++ twin:
    csrc/krmq_avl.h).  Nodes are parallel lists indexed by int; key is
    the composite ((int64)y << 32) | (uint32)i."""

    __slots__ = ("key", "pri", "ch", "s", "bal", "free", "root", "count")

    def __init__(self) -> None:
        self.key: list[int] = []
        self.pri: list[float] = []
        self.ch: list[list[int]] = []
        self.s: list[int] = []
        self.bal: list[int] = []
        self.free: list[int] = []
        self.root = -1
        self.count = 0

    def _lt2(self, a: int, b: int) -> bool:
        return self.pri[a] < self.pri[b]

    def _upd(self, p: int, a: int, b: int) -> None:
        # krmq_update_min (krmq.h:154-157); argument order is the tie rule
        s = p if a < 0 or self._lt2(p, self.s[a]) else self.s[a]
        self.s[p] = s if b < 0 or self._lt2(s, self.s[b]) else self.s[b]

    def _rot1(self, p: int, d: int) -> int:
        o = 1 - d
        q = self.ch[p][o]
        sv = self.s[p]
        a, b = self.ch[p][d], self.ch[q][d]
        self.ch[p][o] = self.ch[q][d]
        self._upd(p, a, b)
        self.s[q] = sv
        self.ch[q][d] = p
        return q

    def _rot2(self, p: int, d: int) -> int:
        o = 1 - d
        q = self.ch[p][o]
        r = self.ch[q][d]
        sv = self.s[p]
        pa, pb = self.ch[p][d], self.ch[r][d]
        qa, qb = self.ch[q][o], self.ch[r][o]
        self.ch[p][o] = self.ch[r][d]
        self._upd(p, pa, pb)
        self.ch[q][d] = self.ch[r][o]
        self._upd(q, qa, qb)
        self.s[r] = sv
        self.ch[r][d] = p
        self.ch[r][o] = q
        b1 = 1 if d == 0 else -1
        if self.bal[r] == b1:
            self.bal[q], self.bal[p] = 0, -b1
        elif self.bal[r] == 0:
            self.bal[q] = self.bal[p] = 0
        else:
            self.bal[q], self.bal[p] = b1, 0
        self.bal[r] = 0
        return r

    def _alloc(self, key: int, pri: float) -> int:
        if self.free:
            x = self.free.pop()
            self.key[x], self.pri[x] = key, pri
            self.ch[x][0] = self.ch[x][1] = -1
            self.s[x], self.bal[x] = x, 0
        else:
            x = len(self.key)
            self.key.append(key)
            self.pri.append(pri)
            self.ch.append([-1, -1])
            self.s.append(x)
            self.bal.append(0)
        return x

    def insert(self, key: int, pri: float) -> None:
        x = self._alloc(key, pri)
        path: list[int] = []
        stack: list[int] = []
        bp, bq = self.root, -1
        p, q, which = self.root, -1, 0
        while p >= 0:
            kp = self.key[p]
            if key == kp:
                self.free.append(x)
                return
            if self.bal[p] != 0:
                bq, bp = q, p
                del stack[:]
            which = 1 if key > kp else 0
            stack.append(which)
            path.append(p)
            q = p
            p = self.ch[p][which]
        self.count += 1
        if q < 0:
            self.root = x
        else:
            self.ch[q][which] = x
        if bp < 0:
            return
        for i in range(len(path) - 1, -1, -1):
            self._upd(path[i], self.ch[path[i]][0], self.ch[path[i]][1])
            if self.s[path[i]] != x:
                break
        # stack holds directions from bp down (reset at bp)
        p, ti = bp, 0
        while p != x:
            if stack[ti] == 0:
                self.bal[p] -= 1
            else:
                self.bal[p] += 1
            p = self.ch[p][stack[ti]]
            ti += 1
        if -2 < self.bal[bp] < 2:
            return
        w = 1 if self.bal[bp] < 0 else 0
        b1 = 1 if w == 0 else -1
        qq = self.ch[bp][1 - w]
        if self.bal[qq] == b1:
            r = self._rot1(bp, w)
            self.bal[qq] = self.bal[bp] = 0
        else:
            r = self._rot2(bp, w)
        if bq < 0:
            self.root = r
        else:
            self.ch[bq][0 if self.ch[bq][0] == bp else 1] = r

    def erase(self, key: int) -> bool:
        if self.root < 0:
            return False
        path: list[int] = []
        dirs: list[int] = []
        fake = self._alloc(self.key[self.root], self.pri[self.root])
        self.ch[fake][0] = self.root
        self.bal[fake] = self.bal[self.root]
        p, cmp = fake, -1
        while cmp != 0:
            which = 1 if cmp > 0 else 0
            dirs.append(which)
            path.append(p)
            p = self.ch[p][which]
            if p < 0:
                self.free.append(fake)
                return False
            kp = self.key[p]
            cmp = -1 if key < kp else (1 if key > kp else 0)
        self.count -= 1
        d = len(path)
        if self.ch[p][1] < 0:
            self.ch[path[d - 1]][dirs[d - 1]] = self.ch[p][0]
        else:
            q = self.ch[p][1]
            if self.ch[q][0] < 0:
                self.ch[q][0] = self.ch[p][0]
                self.bal[q] = self.bal[p]
                self.ch[path[d - 1]][dirs[d - 1]] = q
                path.append(q)
                dirs.append(1)
                d += 1
            else:
                e = d
                path.append(-1)   # placeholder for r at slot e
                dirs.append(1)
                d += 1
                while True:
                    dirs.append(0)
                    path.append(q)
                    d += 1
                    r = self.ch[q][0]
                    if self.ch[r][0] < 0:
                        break
                    q = r
                self.ch[r][0] = self.ch[p][0]
                self.ch[q][0] = self.ch[r][1]
                self.ch[r][1] = self.ch[p][1]
                self.bal[r] = self.bal[p]
                self.ch[path[e - 1]][dirs[e - 1]] = r
                path[e] = r
                dirs[e] = 1
        for i in range(d - 1, -1, -1):
            self._upd(path[i], self.ch[path[i]][0], self.ch[path[i]][1])
        d -= 1
        while d > 0:
            q = path[d]
            which = dirs[d]
            other = 1 - which
            b1, b2 = (1, 2) if which == 0 else (-1, -2)
            self.bal[q] += b1
            if self.bal[q] == b1:
                break
            if self.bal[q] == b2:
                r = self.ch[q][other]
                if self.bal[r] == -b1:
                    self.ch[path[d - 1]][dirs[d - 1]] = self._rot2(q, which)
                else:
                    self.ch[path[d - 1]][dirs[d - 1]] = self._rot1(q, which)
                    if self.bal[r] == 0:
                        self.bal[r] = -b1
                        self.bal[q] = b1
                        break
                    self.bal[r] = self.bal[q] = 0
            d -= 1
        self.root = self.ch[fake][0]
        self.free.append(fake)
        self.free.append(p)
        return True

    def rmq(self, lo: int, up: int) -> int:
        """Min-priority node index with key in CLOSED [lo, up], exact
        krmq_rmq traversal (krmq.h:110-150); -1 if empty."""
        if self.root < 0:
            return -1
        paths = ([], [])
        pcmps = ([], [])
        for w, bound in enumerate((lo, up)):
            p = self.root
            while p >= 0:
                kp = self.key[p]
                cmp = -1 if bound < kp else (1 if bound > kp else 0)
                paths[w].append(p)
                pcmps[w].append(cmp)
                if cmp == 0:
                    break
                p = self.ch[p][1 if cmp > 0 else 0]
        n0, n1 = len(paths[0]), len(paths[1])
        lca = 0
        while lca < n0 and lca < n1:
            if (paths[0][lca] == paths[1][lca] and pcmps[0][lca] <= 0
                    and pcmps[1][lca] >= 0):
                break
            lca += 1
        if lca == n0 or lca == n1:
            return -1
        mn = paths[0][lca]
        for i in range(lca + 1, n0):
            if pcmps[0][i] <= 0:
                if self._lt2(paths[0][i], mn):
                    mn = paths[0][i]
                rc = self.ch[paths[0][i]][1]
                if rc >= 0 and self._lt2(self.s[rc], mn):
                    mn = self.s[rc]
        for i in range(lca + 1, n1):
            if pcmps[1][i] >= 0:
                if self._lt2(paths[1][i], mn):
                    mn = paths[1][i]
                lc = self.ch[paths[1][i]][0]
                if lc >= 0 and self._lt2(self.s[lc], mn):
                    mn = self.s[lc]
        return mn


class _ActiveSet:
    """Sorted active-candidate set keyed by ((int32)y, i)."""

    def __init__(self) -> None:
        self.keys: list[tuple[int, int]] = []   # (y, i) sorted
        self.pri: dict[int, float] = {}          # i -> priority

    def insert(self, y: int, i: int, pri: float) -> None:
        bisect.insort(self.keys, (y, i))
        self.pri[i] = pri

    def remove(self, y: int, i: int) -> None:
        if i in self.pri:
            del self.pri[i]
            k = bisect.bisect_left(self.keys, (y, i))
            if k < len(self.keys) and self.keys[k] == (y, i):
                del self.keys[k]

    def __len__(self) -> int:
        return len(self.keys)

    def rmq(self, lo_y: int, hi_y: int) -> int | None:
        """Min-priority element with y in (lo_y, hi_y], i.e. the closed
        krmq interval [(lo_y, INT32_MAX), (hi_y, 0)] (lchain.c:318-320)."""
        best_i = None
        best = None
        lo_k = bisect.bisect_right(self.keys, (lo_y, INT32_MAX))
        hi_k = bisect.bisect_right(self.keys, (hi_y, 0))
        for y, i in self.keys[lo_k:hi_k]:
            pr = self.pri[i]
            if best is None or pr < best:
                best, best_i = pr, i
        return best_i

    def iter_desc_from(self, y_max: int):
        """Elements with (y, i) <= (y_max, +inf), descending (lchain.c:330-336)."""
        k = bisect.bisect_right(self.keys, (y_max, INT32_MAX))
        for idx in range(k - 1, -1, -1):
            yield self.keys[idx]


def chain_rmq(ax: np.ndarray, ay: np.ndarray, max_dist: int,
              max_dist_inner: int, bw: int, max_chn_skip: int,
              cap_rmq_size: int, min_cnt: int, min_sc: int,
              chn_pen_gap: float, chn_pen_skip: float
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """mg_lchain_rmq (lchain.c:250-369). Returns (u, ax_out, ay_out)."""
    n = ax.shape[0]
    if n == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                np.empty(0, np.uint64))
    if max_dist < bw:
        max_dist = bw
    if max_dist_inner <= 0 or max_dist_inner >= max_dist:
        max_dist_inner = 0
    max_drop = bw
    cg = np.float32(chn_pen_gap)
    cs = np.float32(chn_pen_skip)

    from . import native
    import os
    if native.available() and not os.environ.get("MM2TPU_NO_NATIVE"):
        f, p = native.chain_rmq_scores(ax, ay, max_dist, max_dist_inner, bw,
                                       max_chn_skip, cap_rmq_size, float(cg),
                                       float(cs))
        u, v = chain_backtrack(f, p, min_cnt, min_sc, max_drop)
        if u.shape[0] == 0:
            return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                    np.empty(0, np.uint64))
        return compact_chains(u, v, ax, ay)

    half_gap = 0.5 * float(cg)  # double, as in lchain.c:297

    axl = [int(v) for v in ax]
    ayl = [int(v) for v in ay]

    def i32(v: int) -> int:
        v &= 0xFFFFFFFF
        return v - 2**32 if v >= 2**31 else v

    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    t = np.zeros(n, dtype=np.int64)
    outer = KrmqAvl()
    inner = _ActiveSet() if max_dist_inner > 0 else None

    i0 = 0
    st = 0
    st_inner = 0
    for i in range(n):
        q_span = (ayl[i] >> 32) & 0xFF
        max_f = q_span
        max_j = -1
        # activate finished anchors (strictly smaller x)
        if i0 < i and axl[i0] != axl[i]:
            for j in range(i0, i):
                yj = i32(ayl[j])
                # wrapping int32 sum, as the reference's int arithmetic
                # wraps in practice (lchain.c:285)
                sum32 = i32((axl[j] + ayl[j]) & 0xFFFFFFFF)
                pri = -(int(f[j]) + half_gap * sum32)
                outer.insert((yj << 32) | j, pri)
                if inner is not None:
                    inner.insert(yj, j, pri)
            i0 = i
        # retire out-of-window candidates
        while st < i and (axl[i] >> 32 != axl[st] >> 32
                          or axl[i] > axl[st] + max_dist
                          or outer.count > cap_rmq_size):
            outer.erase((i32(ayl[st]) << 32) | st)
            st += 1
        if inner is not None:
            while st_inner < i and (axl[i] >> 32 != axl[st_inner] >> 32
                                    or axl[i] > axl[st_inner] + max_dist_inner
                                    or len(inner) > cap_rmq_size):
                inner.remove(i32(ayl[st_inner]), st_inner)
                st_inner += 1
        # RMQ candidate: CLOSED [(yi-max_dist, INT32_MAX), (yi, 0)]
        yi = i32(ayl[i])
        cand = outer.rmq(((yi - max_dist) << 32) | INT32_MAX, yi << 32)
        if cand >= 0:
            j = outer.key[cand] & 0xFFFFFFFF
            sc, exact, width = _sc_simple(axl[i], ayl[i], axl[j], ayl[j], cg, cs)
            sc += int(f[j])
            if width <= bw and sc > max_f:
                max_f, max_j = sc, j
            if not exact and inner is not None and len(inner) and yi > 0:
                n_skip = 0
                for (yj, j) in inner.iter_desc_from(yi - 1):
                    if yj < yi - max_dist_inner:
                        break
                    sc, _, width = _sc_simple(axl[i], ayl[i], axl[j], ayl[j],
                                              cg, cs)
                    sc += int(f[j])
                    if width <= bw:
                        if sc > max_f:
                            max_f, max_j = sc, j
                            if n_skip > 0:
                                n_skip -= 1
                        elif t[j] == i:
                            n_skip += 1
                            if n_skip > max_chn_skip:
                                break
                        if p[j] >= 0:
                            t[p[j]] = i
        f[i] = max_f
        p[i] = max_j
    u, v = chain_backtrack(f, p, min_cnt, min_sc, max_drop)
    if u.shape[0] == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint64),
                np.empty(0, np.uint64))
    return compact_chains(u, v, ax, ay)
