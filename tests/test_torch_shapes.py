"""Launch shapes of the port's gap-fill and chain kernels, on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py);
what decides their work (each fill's or segment's class, the shared
memory and scratch each one takes, the order of the work list) is
Python, checked here, and so is a mirror of the chain kernel's ring
schedule, which must keep every anchor a step reads in its slot.
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import kernel_operands, workloads
from mm2_gb_tpu_torch.ops import chain_gpu as G
from mm2_gb_tpu_torch.ops import ksw2_gpu as K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mm2_gb_tpu_torch", "csrc")


def _const(source, name):
    """The value of `constexpr int name = <int>;` in csrc/<source>."""
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_python_constants_match_the_kernels():
    """The shapes Python computes assume the kernels' block sizes, warps
    to a block, blocks an SM, the reversed query's pad, the splice ring's
    pad and the extension kernels' slots for a block's warps."""
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    assert _const("extd2_kernel.cu", "kFillThreads") == 32 * K.FILL_WARPS
    assert _const("exts2_kernel.cu", "kFillThreads") == 32 * K.FILL_WARPS
    assert _const("extd2_kernel.cu", "kQPad") == K.QUERY_PAD
    assert _const("exts2_kernel.cu", "kRingPad") == KS.FILL_RING_PAD
    with open(os.path.join(CSRC, "ksw2_row_max.cuh")) as f:
        assert re.search(r"long long key\[2\]\[(\d+)\];",
                         f.read()).group(1) == str(K.FILL_WARPS)
    assert _const("chain_kernel.cu", "kChainThreads") == G.CHAIN_THREADS
    assert _const("chain_kernel.cu", "kGroupThreads") == G.GROUP_THREADS
    assert (_const("chain_kernel.cu", "kChainBlocksPerSm")
            == G.CHAIN_BLOCKS_PER_SM)


def test_extd2_fill_bytes_hold_the_kernel_state():
    """fill_bytes: ten state rows and the target row of nbytes (tlen up
    to a multiple of 16) lanes, the reversed query with its pads (a
    multiple of 16) and four int32 slots."""
    assert K.fill_bytes(np.array([213]), np.array([213])).tolist() == [
        11 * 224 + 272 + 16]
    assert K.fill_bytes(np.array([1]), np.array([1])).tolist() == [
        11 * 16 + 64 + 16]
    got = K.fill_bytes(np.arange(1, 600), np.arange(600, 1, -1))
    assert (got % 16 == 0).all()


def test_extd2_fill_shape_per_fill_class():
    """extd2_fill's launch takes each fill's class on its own: a warp for
    fills of at most WARP_LANES lanes, else a block, and a block for the
    LONG_FILLS longest fills with at least half the longest one's rows;
    block-class fills past FILL_SMEM_MAX keep their state in global
    scratch at disjoint offsets; block-class fills come first, warp-class
    ones eight to a block; the warp stride holds every warp-class fill
    and the shared memory eight strides and every block-class fill in
    shared memory."""
    ql = np.array([213, 300, 6000, 200, 10, 700, 5, 480, 4000])
    tl = np.array([213, 700, 7000, 200, 5, 690, 10, 497, 7100])
    sh = K.fill_shape(ql, tl)
    need = K.fill_bytes(ql, tl)
    # 7000 and 7100 lanes are past the cap; 700, 690: wider than a warp
    assert (need[[2, 8]] > K.FILL_SMEM_MAX).all()
    assert (need[[0, 1, 3, 4, 5, 6, 7]] <= K.FILL_SMEM_MAX).all()
    assert (sh.n_block, sh.n_warp) == (4, 5)
    assert sh.work.tolist() == [1, 2, 5, 8, 0, 3, 4, 6, 7] + [-1] * 3
    assert sh.scr_off.tolist() == [-1, -1, 0, -1, -1, -1, -1, -1,
                                   int(need[2])]
    assert sh.scratch == int(need[2] + need[8])
    warp = np.array([0, 3, 4, 6, 7])
    assert sh.warp_stride == int(need[warp].max()) == int(need[7])
    assert sh.smem == max(K.FILL_WARPS * sh.warp_stride,
                          int(need[[1, 5]].max()))
    # a fill alone is its launch's longest: a block, no warp stride
    only = K.fill_shape(ql[:1], tl[:1])
    assert (only.n_block, only.n_warp, only.warp_stride) == (1, 0, 0)
    assert only.smem == int(need[0])
    # many fills as long as the longest: the LONG_FILLS first take blocks
    same = K.fill_shape(np.full(200, 213), np.full(200, 213))
    assert (same.n_block, same.n_warp) == (K.LONG_FILLS,
                                           200 - K.LONG_FILLS)
    assert same.work[:K.LONG_FILLS].tolist() == list(range(K.LONG_FILLS))


def test_extd2_fill_batch_aligns_regions(monkeypatch):
    """The gap-fill batch gives each fill a 16-aligned direction-byte
    region (the kernel's word stores), and counts the fills whose state
    its launches put in global scratch."""
    from chip_smoke import _pack_fills, fill_oracle, fill_result_err
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(3)
    pairs, ws = [], []
    for n in (7, 30, 33, 90):
        t = rng.integers(0, 4, n).astype(np.uint8)
        pairs.append((t[rng.random(n) < 0.9].copy(), t))
        ws.append(-1)
    meta, qb, tb = _pack_fills(pairs, ws)
    prm = K.fill_params(O.set_preset(None)[1])
    seen = []
    fill = K.extd2_fill

    def rec(*a, **kw):
        seen.append(a[7].clone())
        return fill(*a, **kw)
    monkeypatch.setattr(K, "extd2_fill", rec)
    monkeypatch.setattr(K, "FILL_SMEM_MAX", 1000)
    st = K.FillStats()
    am = ksw2.KSW_EZ_APPROX_MAX
    got = K.extd2_fill_batch(meta, qb, tb, prm, "cpu", am, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, am)) == 0
    assert len(seen) == 1 and (seen[0] % 16 == 0).all()
    # the longest (90) is a block-class fill past the patched cap
    assert st.scratch_fills == 1


def _segments(lens, wide):
    """Back-to-back segments of the given lengths, every anchor's range
    the segment's `wide` (cut at its end), and their starts and ends."""
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    rng = np.zeros(bounds[-1], np.int32)
    for (s, e), w in zip(zip(bounds[:-1], bounds[1:]), wide):
        i = np.arange(s, e)
        rng[s:e] = np.minimum(w, e - 1 - i)
    starts, ends = G.segment_work(bounds)
    return starts, ends, rng


def test_segment_shape_per_segment_class():
    """Each segment's class: a warp for at most SHORT_LEN anchors, a
    group of GROUP_THREADS for at most MID_LEN, else the block; each
    class listed longest first (stable), long before mid before short;
    a long segment's window in the ring when the segment fits it or its
    widest range plus CHAIN_THREADS does, else in global memory."""
    assert (G.SHORT_LEN, G.MID_LEN) == (256, 1024)
    lens = [2, 256, 257, 1024, 1025, 4096, 5000, 5000, 4097, 30]
    wide = [1, 200, 256, 1000, 1024, 4095, 3584, 3585, 4096, 29]
    starts, ends, rng = _segments(lens, wide)
    sh = G.segment_shape(starts, ends, rng)
    got_lens = (sh.work[:, 1] - sh.work[:, 0]).tolist()
    assert (sh.n_long, sh.n_mid, sh.n_short) == (5, 2, 3)
    assert got_lens == [5000, 5000, 4097, 4096, 1025, 1024, 257, 256, 30, 2]
    assert sh.work[:, 2].tolist() == [3584, 3585, 4096, 4095, 1024, 1000,
                                      256, 200, 29, 1]
    # the second 5000 and the 4097 are wider than the ring allows
    assert sh.work[:, 3].tolist() == [1, 0, 0, 1, 1, 1, 1, 1, 1, 1]
    # the same segments in another order give the same work
    rev = G.segment_shape(starts[::-1], ends[::-1], rng)
    assert np.array_equal(np.sort(rev.work, 0), np.sort(sh.work, 0))
    empty = G.segment_shape(starts[:0], ends[:0], rng)
    assert (empty.work.shape, empty.n_long) == ((0, 4), 0)


def _ring_holds(s, e, wide, nt, slots):
    """A mirror of the chain kernel's ring schedule (chain_one): every nt
    steps the unit loads anchors [jb, jb + nt) into slot a % slots; the
    lo scan of warp w reads ranges from max(s, jb + 32 w - wide) up to
    its steps j, and a step's window lies in [j - wide, j).  True when
    every anchor read is the one its slot holds: since anchors are
    loaded in order, when the oldest one read is held, so are the later
    ones loaded."""
    held = [-1] * slots
    for jb in range(s, e, nt):
        for a in range(jb, min(jb + nt, e)):
            held[a % slots] = a
        for j in range(jb, min(jb + nt, e)):
            lo = max(s, jb + (j - jb) // 32 * 32 - wide)
            if lo < j and held[lo % slots] != lo:
                return False
    return True


@pytest.mark.parametrize("nt,share", [(G.CHAIN_THREADS, 1),
                                      (G.GROUP_THREADS, 4), (32, 16)],
                         ids=["block", "group", "warp"])
def test_chain_ring_holds_the_window(nt, share):
    """The ring of a unit of nt threads (its share of RING_SLOTS) keeps
    every anchor a step reads while the widest range plus nt fits it, and
    fails at one slot fewer; a segment that fits the ring keeps them with
    any range.  segment_shape sends the others to the global window."""
    slots = G.RING_SLOTS // share
    wide = slots - nt
    assert _ring_holds(0, 3 * slots, wide, nt, slots)
    assert _ring_holds(5, 5 + slots, slots - 1, nt, slots)
    assert not _ring_holds(0, 3 * slots, wide, nt, slots - 1)
    assert not _ring_holds(0, 3 * slots, wide + 1, nt, slots)
    if nt == G.CHAIN_THREADS:
        starts, ends, rng = _segments([3 * slots, 3 * slots],
                                      [wide, wide + 1])
        sh = G.segment_shape(starts, ends, rng)
        assert sh.work[:, 2:].tolist() == [[wide, 1], [wide + 1, 0]]


def test_every_class_workload_has_every_class():
    """The smoke's every_class workload (held against the twin and the
    oracle on the card) puts segments in every class of the chain kernel,
    the global-window one among them."""
    ax, ay, a = next((w[1], w[2], w[3]) for w in workloads()
                     if w[0] == "every_class")
    bounds = np.array([0, ax.shape[0]], np.int64)
    ops, _kw, _ = kernel_operands(ax, ay, bounds, a, "cpu")
    sh = G.segment_shape(ops[3].numpy(), ops[4].numpy(), ops[2].numpy())
    assert min(sh.n_long, sh.n_mid, sh.n_short) > 0
    assert set(sh.work[:sh.n_long, 3].tolist()) == {0, 1}


@pytest.mark.parametrize("name", ["ties_across_warps", "dd_2p24"])
def test_chain_tie_and_far_workloads(name):
    """The smoke's chain workloads for ties spread over a block's warps
    and gap differences across 2^24: the twin equals the port's host
    oracle."""
    ax, ay, a = next((w[1], w[2], w[3]) for w in workloads()
                     if w[0] == name)
    bounds = np.array([0, ax.shape[0]], np.int64)
    ops, kw, _ = kernel_operands(ax, ay, bounds, a, "cpu")
    f, p = G.chain_segments(*ops, **kw)
    fo, po = G.chain_scores_host(ax, ay, a["max_dist_x"], a["max_dist_y"],
                                 a["bw"], a["max_iter"], a["cg"], a["cs"],
                                 a["is_cdna"])
    prel = p.numpy().astype(np.int64)
    assert np.array_equal(f.numpy(), fo)
    assert np.array_equal(np.where(prel > 0, np.arange(prel.shape[0]) - prel,
                                   -1), po)
    if name == "ties_across_warps":
        # each of the last ten sees ~200 equal totals: the largest i wins
        assert p[-10:].tolist() == list(range(1, 11))
        assert len(set(f[-10:].tolist())) == 1
