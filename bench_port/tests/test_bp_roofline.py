"""The frozen roofline arithmetic against hand-counted cases."""

import numpy as np

from bench_port.tests import bp_tiny  # noqa: F401
from bench_port import roofline as R


def test_band_cells_whole_matrix_and_band():
    assert R.band_cells([3], [4], [-1]).tolist() == [12]
    assert R.band_cells([3], [4], [10]).tolist() == [12]
    # w = 0: the anti-diagonals r of a 3 x 3 matrix keep st0..en0 with
    # st0 = max(0, r - 2, (r + 1) >> 1), en0 = min(2, r, r >> 1):
    # r = 0: 0..0, r = 1: 1..0 (none), r = 2: 1..1, r = 3: 2..1 (none),
    # r = 4: 2..2 -> 3 cells, the diagonal
    assert R.band_cells([3], [3], [0]).tolist() == [3]


def test_ranges_and_segments():
    # one read, one strand and contig: positions 0, 10, 20, 1000
    ax = np.array([0, 10, 20, 1000], np.uint64)
    rng = R.compute_ranges(ax, np.array([0, 4]), 15, 5000)
    assert rng.tolist() == [1, 1, 0, 0]
    assert R.cut_segments(rng).tolist() == [0, 3, 4]
    # another contig starts a group: no successor across it
    ax2 = np.array([0, 5, (1 << 32) | 6], np.uint64)
    assert R.compute_ranges(ax2, np.array([0, 3]), 100, 5000).tolist() \
        == [1, 0, 0]
    # max_iter caps a range
    assert R.compute_ranges(ax, np.array([0, 4]), 2000, 2).tolist() \
        == [2, 2, 1, 0]


def test_chain_work_counts():
    ax = np.array([0, 10, 20, 1000], np.uint64)
    nbytes, ops = R.chain_work([(ax, np.array([0, 4]), 15, 5000)])
    assert (nbytes, ops) == (20 * 4 + 8 * 2, 2 * R.OPS_PER["chain"])
    # no successor anywhere: no launch, nothing counted
    assert R.chain_work([(ax[:1], np.array([0, 1]), 15, 5000)]) == (0, 0)


def test_fill_work_counts():
    meta = np.array([[3, 4, -1, 400], [0, 5, 10, 400]], np.int64)
    nbytes, ops = R.fill_work([meta])
    assert ops == 12 * R.OPS_PER["fill"]
    assert nbytes == 3 + 4 + 12 + 4


def test_bound_and_share():
    ms, what = R._bound(3.35e9, 0)
    assert what == "bytes" and abs(ms - 1.0) < 1e-12
    ms, what = R._bound(0, 67e9)
    assert what == "operations" and abs(ms - 1.0) < 1e-12
    assert abs(R.share(3.35e9, 0, 0.004) - 25.0) < 1e-9
    assert R.share(0, 0, 1.0) is None
