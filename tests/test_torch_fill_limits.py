"""The DP kernels' launch shapes stay within the card's shared memory for
any query length, on the CPU.

A fill's state in the genomic fill kernel holds its whole reversed
query, so a narrow fill beside a query of tens of kb may not take a
warp: eight warps' state would pass the shared memory a block may have
(227 KB) and the launch would raise.  For every launch-shape function of
the four DP kernels, on mixes with queries up to 60,000 bases (300,000
in the ultra-long mix) beside targets of at most 512, and the other way
round: the block's shared memory stays within 227 KB; FILL_WARPS warps'
state stays within the share that keeps the kernel's blocks an SM (for
extd2_fill, within FILL_SMEM_MAX); each fill is in the work list once;
each fill's scratch region is what the chunker budgets for it.
"""

import os
import re

import numpy as np
import pytest

from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS

BLOCK_SMEM = 232_448   # the dynamic shared memory a block may have (sm_90)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mm2_gb_tpu_torch", "csrc")


def _const(source, name):
    """The value of `constexpr int name = <int>;` in csrc/<source>."""
    with open(os.path.join(CSRC, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def _chunker_scratch(need, smem_max, every):
    """The scratch the batch functions budget for each fill (the splice
    fills' budget counts every fill as if in scratch)."""
    return np.asarray(need) if every else K.scratch_bytes(need, smem_max)


# name -> (shape, state bytes, block cap, the cap on FILL_WARPS warps'
# state, whether the chunker budgets every fill)
SHAPES = {
    "extd2_fill": (K.fill_shape, K.fill_bytes, K.FILL_SMEM_MAX,
                   K.FILL_SMEM_MAX, False),
    "extd2_ext": (K.ext_shape, K.ext_bytes, K.EXT_SMEM_MAX,
                  BLOCK_SMEM // _const("extd2_kernel.cu", "kExtBlocksPerSm"),
                  False),
    "exts2_fill": (KS.fill_shape, KS.fill_bytes, KS.FILL_SMEM_MAX,
                   BLOCK_SMEM // _const("exts2_kernel.cu",
                                        "kFillBlocksPerSm"), True),
    "exts2_ext": (KS.ext_ring_shape, KS.ext_ring_bytes, KS.EXT_SMEM_MAX,
                  BLOCK_SMEM // _const("exts2_kernel.cu", "kExtBlocksPerSm"),
                  False),
}


def _mix(name):
    """(qlen, tlen) of a launch, longest first as the batch functions
    order it."""
    if name == "warp_beside_longest":   # not among the longest: no block
        ql = [61_000, 60_000] + [200] * 100
        tl = [61_000, 512] + [200] * 100
    elif name == "many_long_queries":   # more than LONG_FILLS of them
        ql, tl = [30_000] * 140, [512] * 140
    elif name == "past_a_warp_share":   # 8 such warps pass FILL_SMEM_MAX
        ql = [10_000, 4_000] + [100] * 200
        tl = [10_000, 500] + [100] * 200
    elif name == "ultralong":   # queries to 300 kb beside narrow targets
        # (the ultra-long set's -c run on the card made none past 314
        # bases; its 100-300 kb reads bound a fill's query)
        n, rng = 300, np.random.default_rng(300)
        a = np.exp(rng.uniform(0, np.log(300_000), n)).astype(np.int64)
        b = rng.integers(1, 513, n)
        flip = rng.random(n) < 0.3
        ql, tl = np.where(flip, b, a), np.where(flip, a, b)
        ql[:4], tl[:4] = 300_000, (512, 1, 300, 314)
    else:   # narrow targets beside queries to 60 kb, and the reverse
        n, rng = 300, np.random.default_rng(int(name[6:]))
        a = np.exp(rng.uniform(0, np.log(60_000), n)).astype(np.int64)
        b = rng.integers(1, 513, n)
        flip = rng.random(n) < 0.3
        ql, tl = np.where(flip, b, a), np.where(flip, a, b)
        ql[:3], tl[:3] = 60_000, (512, 1, 300)
    ql, tl = np.asarray(ql, np.int64), np.asarray(tl, np.int64)
    order = np.argsort(-(ql + tl), kind="stable")
    return ql[order], tl[order]


@pytest.mark.parametrize("mix", ["warp_beside_longest", "many_long_queries",
                                 "past_a_warp_share", "random0", "random1",
                                 "random2", "ultralong"])
@pytest.mark.parametrize("kernel", list(SHAPES))
def test_launch_shape_fits_the_shared_memory(kernel, mix):
    shape, nbytes, smem_max, warps_max, every = SHAPES[kernel]
    ql, tl = _mix(mix)
    sh = shape(ql, tl)
    need = nbytes(ql, tl)
    assert sh.smem <= BLOCK_SMEM
    assert K.FILL_WARPS * sh.warp_stride <= warps_max
    work = sh.work[sh.work >= 0]
    assert sorted(work.tolist()) == list(range(ql.shape[0]))
    assert sh.n_block + sh.n_warp == ql.shape[0]
    scratch = np.where(sh.scr_off >= 0, need, 0)
    assert sh.scratch == int(scratch.sum())
    budget = _chunker_scratch(need, smem_max, every)
    if every:
        assert (scratch <= budget).all()
    else:
        assert (scratch == budget).all()
    # block-class fills in shared memory fit it; warp-class ones are
    # within the stride
    warp = np.zeros(ql.shape[0], bool)
    warp[sh.work[sh.n_block:][sh.work[sh.n_block:] >= 0]] = True
    assert (need[warp] <= sh.warp_stride).all()
    assert (need[~warp & (sh.scr_off < 0)] <= sh.smem).all()


def test_a_narrow_fill_beside_a_long_query_takes_a_block():
    """extd2_fill: a fill of at most WARP_LANES target lanes takes a warp
    only while its state fits WARP_FILL_MAX (a query of ~3.5 kb at 512
    lanes); past that it takes a block, in shared memory up to
    FILL_SMEM_MAX and in global scratch beyond."""
    assert K.FILL_WARPS * K.WARP_FILL_MAX <= K.FILL_SMEM_MAX
    ql = np.array([20_000, 3_000, 3_600, 24_500, 72_000, 100])
    tl = np.array([20_000, 512, 512, 500, 300, 100])
    need = K.fill_bytes(ql, tl)
    assert need[1] <= K.WARP_FILL_MAX < need[2]
    assert need[3] <= K.FILL_SMEM_MAX < need[4]
    sh = K.fill_shape(ql, tl)
    assert sh.work[:sh.n_block].tolist() == [0, 2, 3, 4]
    assert sh.work[sh.n_block:sh.n_block + sh.n_warp].tolist() == [1, 5]
    assert (sh.scr_off >= 0).tolist() == [True, False, False, False, True,
                                          False]
    assert sh.warp_stride == int(need[1])
    assert sh.smem == max(K.FILL_WARPS * int(need[1]), int(need[3]))


def test_a_mapping_run_gives_a_long_insert_fill_a_block(tmp_path):
    """A mapping run that makes narrow fills past WARP_FILL_MAX, at the
    default -r: reads with an 8 kb and a 17 kb insert
    (chip_smoke.insertion_reads), whose long joins make gap fills of
    ~8,200 and ~17,200 query bases beside ~200 target bases in one
    launch.  The first has less than half the longest's rows, so by its
    width alone it would take a warp and put eight warps' state past
    FILL_SMEM_MAX; every launch keeps within it, and --gpu-chain
    --gpu-align -c on the twins equals the host path."""
    import torch

    from chip_smoke import insertion_run, warp_rule_shape
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dev, host, shapes = insertion_run((8_000, 17_000), [],
                                          torch.device("cpu"), str(tmp_path))
    finally:
        torch.set_num_threads(n)
    assert dev[0] == host[0] == 0
    assert dev[1] == host[1]
    assert "\tcg:Z:10000M8000I10000M" in dev[1]
    assert "\tcg:Z:10000M17000I10000M" in dev[1]
    past = 0
    for ql, tl, sh in shapes:
        assert sh.smem <= BLOCK_SMEM
        assert K.FILL_WARPS * sh.warp_stride <= K.FILL_SMEM_MAX
        old = warp_rule_shape(ql, tl)
        past += K.FILL_WARPS * old.warp_stride > K.FILL_SMEM_MAX
    assert past >= 1
