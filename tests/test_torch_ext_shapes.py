"""Launch shapes of the port's two extension kernels, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what
decides their work is Python, checked here: each extension's class (a
warp, eight to a block, or a block of 256 threads), the shared memory,
the global scratch and the order of the work list.  So is a numpy mirror
of how a warp or a block of the extension kernels owns a row's lanes,
four to a word, and reduces their ranked keys to the row maximum.
"""

import numpy as np
import pytest

from mm2_gb_tpu_torch.ops import ksw2
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS


def _draw(rng, n, q_max, t_max):
    """n seeded (qlen, tlen) pairs, qlen in [1, q_max], tlen in [1,
    t_max], the largest of each among them."""
    ql = rng.integers(1, q_max + 1, n)
    tl = rng.integers(1, t_max + 1, n)
    ql[0], tl[1] = q_max, t_max
    return ql, tl


@pytest.mark.parametrize("kind", ["flowcell", "cdna"])
def test_every_extension_of_the_smoke_sets_is_a_warp(kind):
    """The flowcell --qstrand run's extensions (qlen to 106, tlen to 210)
    and the cDNA set's splice extensions (qlen to 139, tlen to 276), 200
    and 1,000 a launch, longest first: every one a warp, eight to a
    block, none in scratch; the block's shared memory eight times the
    largest state."""
    rng = np.random.default_rng(808)
    if kind == "flowcell":
        ql, tl = _draw(rng, 200, 106, 210)
        need, shape = K.ext_bytes, K.ext_shape
    else:
        ql, tl = _draw(rng, 1000, 139, 276)
        need, shape = KS.ext_ring_bytes, KS.ext_ring_shape
    order = np.argsort(-(ql + tl), kind="stable")
    ql, tl = ql[order], tl[order]
    sh = shape(ql, tl)
    n = ql.shape[0]
    assert (sh.n_block, sh.n_warp) == (0, n)
    assert sh.work.tolist() == list(range(n)) + [-1] * (-n % K.FILL_WARPS)
    assert (sh.scr_off == -1).all() and sh.scratch == 0
    assert sh.warp_stride == int(need(ql, tl).max())
    assert sh.smem == K.FILL_WARPS * sh.warp_stride


def test_ext_shape_per_class():
    """extd2_ext's classes: a warp for at most WARP_LANES lanes whose
    state fits WARP_EXT_MAX, a block for a wider one or a long query
    beside a narrow target, the state of a block past EXT_SMEM_MAX in
    global scratch at disjoint offsets; no LONG_FILLS rule (the longest
    narrow extensions stay warps); block-class entries first, then the
    warp-class ones, -1 padding the last block."""
    ql = np.array([8000, 300, 100, 106, 2, 180, 5000])
    tl = np.array([400, 3300, 520, 210, 7, 496, 3000])
    need = K.ext_bytes(ql, tl)
    assert need.tolist() == [K.fill_bytes(q, t) + 4 * ((t + 15) // 16 * 16)
                             for q, t in zip(ql, tl)]
    assert need[0] > K.WARP_EXT_MAX >= need[[3, 4, 5]].max()
    assert (need[[1, 6]] > K.EXT_SMEM_MAX).all()
    assert (need[[0, 2]] <= K.EXT_SMEM_MAX).all()
    sh = K.ext_shape(ql, tl)
    assert (sh.n_block, sh.n_warp) == (4, 3)
    assert sh.work.tolist() == [0, 1, 2, 6, 3, 4, 5] + [-1] * 5
    assert sh.scr_off.tolist() == [-1, 0, -1, -1, -1, -1, int(need[1])]
    assert sh.scratch == int(need[1] + need[6])
    assert sh.warp_stride == int(need[[3, 4, 5]].max())
    assert sh.smem == max(K.FILL_WARPS * sh.warp_stride,
                          int(need[[0, 2]].max()))
    # many extensions as long as the longest: warps all the same
    same = K.ext_shape(np.full(200, 106), np.full(200, 210))
    assert (same.n_block, same.n_warp) == (0, 200)


def test_ext_ring_shape_per_class():
    """exts2_ext's classes: a warp for rings of at most WARP_RING lanes
    (min(qlen, tlen) + 80, a power of two from 64), else a block, with
    its rings past EXT_SMEM_MAX (1024 lanes) in global scratch; no
    LONG_FILLS rule; block-class entries first."""
    ql = np.array([139, 177, 1040, 20, 176, 900])
    tl = np.array([20000, 3000, 1400, 30, 276, 3000])
    lanes = KS.fill_ring_lanes(ql, tl)
    assert lanes.tolist() == [256, 512, 2048, 128, 256, 1024]
    need = KS.ext_ring_bytes(ql, tl)
    assert need.tolist() == [(KS.FILL_LANE_BYTES + 4) * r + 16
                             for r in lanes]
    assert need[2] > KS.EXT_SMEM_MAX >= need[5]
    sh = KS.ext_ring_shape(ql, tl)
    assert (sh.n_block, sh.n_warp) == (3, 3)
    assert sh.work.tolist() == [1, 2, 5, 0, 3, 4] + [-1] * 5
    assert sh.scr_off.tolist() == [-1, -1, 0, -1, -1, -1]
    assert sh.scratch == int(need[2])
    assert sh.warp_stride == int(need[[0, 3, 4]].max())
    assert sh.smem == max(K.FILL_WARPS * sh.warp_stride, int(need[5]))


def _rank(t, st0, en0):
    """lane_rank (csrc/ksw2_row_max.cuh): row_max's rank of lane t."""
    nb, d = (en0 - st0) // 4, t - st0
    return 0 if t == en0 else (1 + (d % 4) * nb + d // 4 if d < 4 * nb
                               else 1 + d)


def _kernel_row_max(H, st0, en0, nt):
    """The extension kernels' row maximum of lanes [st0, en0] by nt
    threads (ExtLanes, warp_row_max, block_row_max): the words of the
    16-aligned window [st0 & ~15, ...] go to threads (word index) mod nt,
    four lanes each; a word's best is its largest H and the smallest
    rank at it, and a thread keeps the best of its words; a warp takes
    the largest H of its threads, the smallest rank at it and that
    rank's lane, and a block the warp of the largest (H, inverted rank)
    key."""
    st = st0 & ~15
    best = [(-2**31, 2**31 - 1, 0)] * nt          # (H, rank, lane)
    for t0 in range(st, en0 + 1, 4):
        lanes = [t for t in range(t0, t0 + 4) if st0 <= t <= en0]
        if not lanes:
            continue
        wh = max(int(H[t]) for t in lanes)
        wr = min((_rank(t, st0, en0) << 2) | (t - t0) for t in lanes
                 if int(H[t]) == wh)
        tid = (t0 - st) // 4 % nt
        bh, br, _bt = best[tid]
        if wh > bh or (wh == bh and wr >> 2 < br):
            best[tid] = (wh, wr >> 2, t0 + (wr & 3))
    keys = []
    for w in range(0, nt, 32):
        thr = best[w:w + 32]
        m = max(b[0] for b in thr)
        rank = min(b[1] for b in thr if b[0] == m)
        mt = max(b[2] if b[:2] == (m, rank) else -1 for b in thr)
        keys.append((m * 2**32 + (0x7fffffff - rank), m, mt))
    _key, m, mt = max(keys)
    return m, mt


@pytest.mark.parametrize("nt", [32, 256], ids=["warp", "block"])
def test_row_max_mirror_matches_the_oracle(nt):
    """A warp's (and a block's) ownership of a row's lanes and its key
    reduction pick ksw2kit's row_max (max H, max_t) on seeded rows whose
    H values tie across rank classes: en0, the 4-lane blocks by
    ((t - st0) % 4, (t - st0) / 4) and the tail lanes."""
    rng = np.random.default_rng(31 + nt)
    seen = set()
    for k in range(400):
        st0 = int(rng.integers(0, 40))
        en0 = st0 + int(rng.integers(0, 300 if k % 2 else 20))
        H = np.full(en0 + 20, -(2**30), np.int64)
        # few values, so that ties are everywhere; a lane of the window
        # sometimes far above the rest, sometimes the en0 lane
        H[st0:en0 + 1] = rng.integers(-3, 3, en0 - st0 + 1) + int(
            rng.integers(-50, 50))
        if k % 5 == 0:
            H[int(rng.integers(st0, en0 + 1))] += 7
        want = ksw2._row_max(H, st0, en0, None, int(H[en0]))
        got = _kernel_row_max(H, st0, en0, nt)
        assert got == (int(want[0]), int(want[1])), (st0, en0)
        nb = (en0 - st0) // 4
        d = want[1] - st0
        seen.add("en0" if want[1] == en0 else
                 "block" if d < 4 * nb else "tail")
    assert seen == {"en0", "block", "tail"}


def _recording_row_max(monkeypatch, mod):
    """Record, for each row the pure-Python oracle's _row_max ranks, the
    rank classes of the lanes that reach its maximum."""
    from mm2_gb_tpu_torch.ops import ksw2 as ksw2_mod
    rows, row_max = [], ksw2_mod._row_max

    def rec(H, st0, en0, add, h_en0):
        out = row_max(H, st0, en0, add, h_en0)
        nb = (en0 - st0) // 4
        hs = np.append(np.asarray(H[st0:en0], np.int64), h_en0)
        d = np.nonzero(hs == out[0])[0]
        rows.append({"en0" if k == en0 - st0 else
                     "block" if k < 4 * nb else "tail" for k in d})
        return out
    monkeypatch.setattr(ksw2_mod, "_use_native", lambda: False)
    monkeypatch.setattr(mod, "_row_max", rec)
    return rows


def _dropped_beside_running(work, n_warp_start, dropped):
    """Whether some block of eight warp-class entries holds a Z-dropped
    extension beside one that did not drop."""
    w = work[n_warp_start:]
    for b in range(0, w.shape[0], 8):
        f = w[b:b + 8]
        f = f[f >= 0]
        if dropped[f].any() and not dropped[f].all():
            return True
    return False


@pytest.mark.parametrize("right", [False, True], ids=["default", "right"])
def test_ext_class_mix_covers_the_kernel_cases(monkeypatch, right):
    """The GPU tests' extd2_ext launch (chip_smoke.ext_class_mix): warp-
    and block-class extensions in one launch, a Z-drop in a block of
    warps whose other warps run on, a block-class Z-drop, reach_end
    starts and row maxima tied across rank classes (the pure-Python
    oracle's rows); the twins equal that oracle."""
    from chip_smoke import ext_class_mix, ext_oracle, ext_result_err
    flag = 0x40 | (0x82 if right else 0)
    meta, qb, tb, zd, prm, flag, eb = ext_class_mix(808, flag)
    rows = _recording_row_max(monkeypatch, ksw2)
    want = ext_oracle(meta, qb, tb, zd, prm, flag, eb)
    assert any(len(c) > 1 for c in rows)
    order = np.argsort(-(meta[:, 0] + meta[:, 1]), kind="stable")
    sh = K.ext_shape(meta[order, 0], meta[order, 1])
    assert sh.n_block > 0 and sh.n_warp > 0
    dropped = want[0][order, 8] > 0
    assert _dropped_beside_running(sh.work, sh.n_block, dropped)
    assert dropped[sh.work[:sh.n_block]].any()
    assert want[0][:, 9].any()
    got = K.extd2_ext_batch(meta, qb, tb, zd, prm, flag, eb, "cpu")
    assert ext_result_err(got, want) == 0


def test_splice_ext_class_mix_covers_the_kernel_cases(monkeypatch):
    """The GPU tests' exts2_ext launch (chip_smoke.splice_ext_class_mix):
    warp- and block-class extensions in one launch, a Z-drop in a block
    of warps whose other warps run on, both flag forms and whole-matrix
    starts (no EXTZ_ONLY), row maxima tied across rank classes; the
    twins equal the pure-Python oracle."""
    from chip_smoke import (ext_result_err, splice_ext_class_mix,
                            splice_ext_oracle)
    from mm2_gb_tpu_torch.ops import ksw2_splice
    meta, qb, tb, jb, fl, zd, prm = splice_ext_class_mix(909)
    rows = _recording_row_max(monkeypatch, ksw2_splice)
    want = splice_ext_oracle(meta, qb, tb, jb, fl, zd, prm)
    assert any(len(c) > 1 for c in rows)
    order = np.argsort(-(meta[:, 0] + meta[:, 1]), kind="stable")
    sh = KS.ext_ring_shape(meta[order, 0], meta[order, 1])
    assert sh.n_block > 0 and sh.n_warp > 0
    assert _dropped_beside_running(sh.work, sh.n_block,
                                   want[0][order, 8] > 0)
    right = (fl & 0x82) == 0x82
    assert right.any() and not right.all()
    assert ((fl & 0x40) == 0).any()
    got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, "cpu")
    assert ext_result_err(got, want) == 0
