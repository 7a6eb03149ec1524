"""PyTorch chain port (mm2_gb_tpu_torch.ops.chain_gpu) vs the JAX package.

Each test feeds the same numpy-made operands to the JAX function (Pallas
in interpret mode on the CPU, or the XLA twin) and to its port (the
plain PyTorch twin on CPU tensors); every comparison is exact, since
scores and predecessors are integers and the float penalties must round
bit for bit.  The CUDA kernel itself is compared on the card
(`gpu`-marked test; chip_smoke.py runs the same checks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm2_gb_tpu.ops import chain as chain_ops
from mm2_gb_tpu.ops import chain_tpu
from mm2_gb_tpu.ops.chain_xla import chain_bucket_xla
from mm2_gb_tpu.utils.hashkit import mg_log2
from mm2_gb_tpu_torch.ops import chain_gpu

CG = float(np.float32(float(np.float32(0.8)) * 0.01 * 15))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_anchors(n, seed, step_hi=12, jitter=6):
    rng = np.random.default_rng(seed)
    rpos = np.cumsum(rng.integers(1, step_hi, n))
    qpos = rpos + rng.integers(-jitter, jitter + 1, n)
    qpos = np.maximum.accumulate(np.maximum(qpos, 1))
    ax = rpos.astype(np.uint64)
    ay = (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)
    return ax, ay


def _multi_segment():
    chunks, base = [], 0
    for s in range(5):
        ax, ay = _synthetic_anchors(80, s + 2)
        chunks.append((ax + np.uint64(base), ay))
        base += int(ax[-1]) + 50000
    return (np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]))


def _dense_repeat():
    rng = np.random.default_rng(7)
    rpos = (np.sort(rng.integers(0, 3000, 900)).astype(np.uint64)
            + np.arange(900, dtype=np.uint64))
    qpos = (rpos + rng.integers(-200, 200, 900).astype(np.int64)).clip(1)
    return rpos, (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64)


def _hpc():
    """Non-uniform minimizer spans (HPC sketches): the host route."""
    ax, ay = _synthetic_anchors(300, 4)
    spans = np.random.default_rng(4).integers(15, 30, 300).astype(np.uint64)
    return ax, (spans << np.uint64(32)) | (ay & np.uint64(0xFFFFFFFF))


# (name, anchors, max_dist_x, max_dist_y, bw, max_iter, cs, is_cdna)
WORKLOADS = [
    ("small_segments", lambda: _synthetic_anchors(50, 0),
     5000, 5000, 500, 5000, 0.0, False),
    ("medium_dense", lambda: _synthetic_anchors(500, 1, step_hi=6),
     5000, 5000, 500, 5000, 0.0, False),
    ("multi_segment_gaps", _multi_segment, 5000, 5000, 500, 5000, 0.0,
     False),
    ("dense_repeat", _dense_repeat, 5000, 5000, 500, 5000, 0.0, False),
    ("is_cdna", lambda: _synthetic_anchors(600, 11, step_hi=40, jitter=300),
     5000, 2000, 500, 5000, float(np.float32(0.3)), True),
    ("hpc_host_route", _hpc, 5000, 5000, 500, 5000, 0.0, False),
    # successor ranges wider than the TPU's largest window (5120): the
    # JAX package chains these segments on its oversize host route, the
    # port on the device path like any other
    ("oversize_host_route",
     lambda: _synthetic_anchors(6000, 9, step_hi=2),
     50000, 50000, 500, 40000, 0.0, False),
]


@pytest.mark.parametrize("name,make,mdx,mdy,bw,max_iter,cs,is_cdna",
                         WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_chain_scores_match_jax_and_oracle(name, make, mdx, mdy, bw,
                                           max_iter, cs, is_cdna):
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
    ax, ay = make()
    bounds = np.array([0, ax.shape[0]], np.int64)
    met = GpuMetrics()
    fp, pp = chain_gpu.chain_scores_device(
        ax, ay, bounds, mdx, mdy, bw, max_iter, CG, cs, is_cdna=is_cdna,
        device="cpu", metrics=met)
    fj, pj = chain_tpu.dispatch_scores(ax, ay, bounds, mdx, mdy, bw,
                                       max_iter, CG, cs,
                                       is_cdna=is_cdna).collect()
    fo, po = chain_ops._chain_dp_scores(
        ax, ay, max(mdx, bw), max(mdy, bw), bw, 2**31 - 1, max_iter,
        np.float32(CG), np.float32(cs), is_cdna, 1)
    assert np.array_equal(fp, fj) and np.array_equal(pp, pj)
    assert np.array_equal(fp, fo) and np.array_equal(pp, po)
    assert met.n_host_hpc == (name == "hpc_host_route")
    assert met.n_dispatch == (name != "hpc_host_route")
    if name == "oversize_host_route":
        rng = chain_gpu.compute_ranges(ax, bounds, mdx, max_iter)
        assert rng.max() > 5120


def test_an_hpc_batch_chains_each_read_alone():
    """HPC anchors of two reads in one batch take the host route read by
    read: each read's scores and predecessors are the oracle's on that
    read alone, as on the host path.  The first read lies past the second
    on the reference, so a batch chained as one read (the JAX package's
    dispatch_scores) keeps the second read's window open from the first
    read on, and joins its two runs of anchors across a gap of 5,210
    reference bases (more than max_dist_x) and 4,810 query bases."""
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
    k = np.arange(100, dtype=np.uint64)
    xs = [20_000 + 10 * k[:50], 10 * k, 6_200 + 10 * k]
    qs = [10 * k[:50], 10 * k, 5_800 + 10 * k]
    ax = np.concatenate(xs)
    q = np.concatenate(qs)
    spans = np.random.default_rng(30).integers(15, 30, q.shape[0])
    ay = (spans.astype(np.uint64) << np.uint64(32)) | q
    bounds = np.array([0, 50, 250], np.int64)
    met = GpuMetrics()
    f, p = chain_gpu.dispatch_scores(ax, ay, bounds, 5000, 5000, 500, 5000,
                                     CG, 0.0, metrics=met,
                                     device="cpu").collect()
    assert met.n_host_hpc == 1 and met.n_dispatch == 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        fo, po = chain_ops._chain_dp_scores(
            ax[s:e], ay[s:e], 5000, 5000, 500, 2**31 - 1, 5000,
            np.float32(CG), np.float32(0.0), False, 1)
        assert np.array_equal(f[s:e], fo)
        assert np.array_equal(p[s:e], np.where(po >= 0, po + s, -1))
    assert p[150] == -1   # the second run starts a chain of its own


def test_a_batch_without_segments_stays_on_the_host():
    """Anchors that have no successor (one anchor a read, or anchors
    farther apart than max_dist_x) make no segment: every anchor keeps
    its span and no predecessor, as on the host path, and nothing goes
    to the device (on the card the chain wrapper returned before its
    launch, its timing events unrecorded, and collect raised)."""
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
    ax = np.arange(4, dtype=np.uint64) * np.uint64(20_000)
    ay = (np.uint64(15) << np.uint64(32)) | np.arange(4, dtype=np.uint64)
    bounds = np.array([0, 1, 3, 4], np.int64)
    met = GpuMetrics()
    pend = chain_gpu.dispatch_scores(ax, ay, bounds, 5000, 5000, 500, 5000,
                                     CG, 0.0, metrics=met, device="cpu")
    assert pend.collected and met.n_dispatch == 0
    f, p = pend.collect()
    assert f.tolist() == [15] * 4 and p.tolist() == [-1] * 4
    fo, po = chain_ops._chain_dp_scores(ax, ay, 5000, 5000, 500, 2**31 - 1,
                                        5000, np.float32(CG),
                                        np.float32(0.0), False, 1)
    assert np.array_equal(f, fo) and np.array_equal(p, po)


def test_multi_segment_workload_cuts():
    ax, _ = _multi_segment()
    rng = chain_gpu.compute_ranges(ax, np.array([0, ax.shape[0]], np.int64),
                                   5000, 5000)
    assert chain_gpu.cut_segments(rng).shape[0] > 5
    assert np.array_equal(rng, chain_tpu.compute_ranges(
        ax, np.array([0, ax.shape[0]], np.int64), 5000, 5000))


def test_compute_ranges_numpy_fallback(monkeypatch):
    """Without the native host-kit, compute_ranges takes its numpy form,
    which gives the native ranges (several reads, both strands)."""
    from mm2_gb_tpu_torch.utils import native
    r = np.random.default_rng(12)
    parts, bounds = [], [0]
    for i in range(6):
        ax, _ = _synthetic_anchors(int(r.integers(1, 300)), 40 + i,
                                   step_hi=int(r.integers(2, 90)))
        parts.append(ax | (np.uint64(i % 2) << np.uint64(63)))
        bounds.append(bounds[-1] + ax.shape[0])
    ax = np.concatenate(parts)
    bounds = np.array(bounds, np.int64)
    want = chain_gpu.compute_ranges(ax, bounds, 5000, 300)
    monkeypatch.setattr(native, "available", lambda: False)
    assert np.array_equal(chain_gpu.compute_ranges(ax, bounds, 5000, 300),
                          want)


def test_segment_work_order():
    bounds = np.array([0, 1, 4, 6, 13, 14, 17], np.int64)
    starts, ends = chain_gpu.segment_work(bounds)
    assert starts.tolist() == [6, 1, 14, 4]      # longest first, stable
    assert ends.tolist() == [13, 4, 17, 6]
    assert [len(v) for v in chain_gpu.segment_work(bounds[:1])] == [0, 0]


def test_twin_matches_xla_bucket():
    """chain_segments_torch equals chain_xla.chain_bucket_xla (the JAX
    package's plain twin) on one packed bucket."""
    ax, ay = _synthetic_anchors(60, 9)
    rngv = chain_tpu.compute_ranges(ax, np.array([0, 60], np.int64),
                                    5000, 5000)
    L = W = 64
    X, Y, S, R = (np.zeros((L + W, 128), np.int32) for _ in range(4))
    x32 = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    y32 = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    X[:60, 0], Y[:60, 0], S[:60, 0], R[:60, 0] = x32, y32, 15, rngv
    fx, px = chain_bucket_xla(X, Y, S, R, L=L, W=W, max_dist_x=5000,
                              max_dist_y=5000, bw=500, cg=CG, cs=0.0)
    t = torch.from_numpy
    starts, ends = chain_gpu.segment_work(chain_gpu.cut_segments(rngv))
    ft, pt = chain_gpu.chain_segments_torch(
        t(x32), t(y32), t(rngv), t(starts), t(ends), span=15,
        max_dist_x=5000, max_dist_y=5000, bw=500, cg=CG, cs=0.0)
    assert np.array_equal(np.asarray(fx)[:60, 0], ft.numpy())
    assert np.array_equal(np.asarray(px)[:60, 0], pt.numpy())


def test_mg_log2_matches_jax_and_host():
    dd = np.concatenate([np.arange(1, 4096),
                         np.random.default_rng(0).integers(1, 2**24, 5000)])
    x = (dd + 1).astype(np.float32)
    port = chain_gpu.mg_log2_f32(torch.from_numpy(x)).numpy()
    jx = np.asarray(jax.jit(chain_tpu._mg_log2_f32)(jnp.asarray(x)))
    assert np.array_equal(port.view(np.uint32), jx.view(np.uint32))
    assert np.array_equal(port.view(np.uint32), mg_log2(x).view(np.uint32))


@pytest.mark.parametrize("mdx,mdy,is_cdna", [
    (5000, 5000, False), (5000, 2000, False), (5000, 5000, True),
    (20000, 5000, True)])
def test_pair_score_matches_jax(mdx, mdy, is_cdna):
    """Random and edge operands: |dr - dq| up to 2^24, dr > dq (intron
    side under is_cdna), dr == 0, dq <= 0, out-of-window pairs."""
    r = np.random.default_rng(mdx + mdy + is_cdna)
    n = 4000
    xp = r.integers(0, 2**30, n).astype(np.int32)
    yp = r.integers(0, 2**30, n).astype(np.int32)
    dr = np.concatenate([r.integers(-50, 6000, n // 2),
                         r.integers(-2**24, 2**24, n // 2)])
    dq = np.concatenate([r.integers(-50, 6000, n // 2),
                         r.integers(-100, 3000, n // 2)])
    dr[:50] = 0
    dq[50:100] = dr[50:100]          # dd == 0
    dr[100:200] = dq[100:200] + r.integers(1, 2**24, 100)   # dr > dq
    xs = (xp.astype(np.int64) + dr).astype(np.int32)
    ys = (yp.astype(np.int64) + dq).astype(np.int32)
    fp = r.integers(15, 5000, n).astype(np.int32)
    cs = float(np.float32(0.3))
    jfn = jax.jit(functools.partial(
        chain_tpu._pair_score, max_dist_x=mdx, max_dist_y=mdy, bw=500,
        cg=jnp.float32(CG), cs=jnp.float32(cs), is_cdna=is_cdna))
    jt, jv = jfn(xs, ys, 15, xp, yp, 15, fp)
    t = torch.from_numpy
    pt, pv = chain_gpu.pair_score(t(xs), t(ys), 15, t(xp), t(yp), 15, t(fp),
                                  mdx, mdy, 500, CG, cs, is_cdna)
    assert np.array_equal(np.asarray(jv), pv.numpy())
    assert np.array_equal(np.asarray(jt), pt.numpy())


def test_cpu_tensors_take_the_twin():
    """On CPU tensors the wrapper runs the plain twin (no launch); it
    rejects operands the kernel does not take."""
    ax, ay = _synthetic_anchors(200, 3)
    rng = chain_gpu.compute_ranges(ax, np.array([0, 200], np.int64),
                                   5000, 5000)
    starts, ends = chain_gpu.segment_work(chain_gpu.cut_segments(rng))
    t = torch.from_numpy
    x = t((ax & np.uint64(0xFFFFFFFF)).astype(np.int32))
    y = t((ay & np.uint64(0xFFFFFFFF)).astype(np.int32))
    kw = dict(span=15, max_dist_x=5000, max_dist_y=5000, bw=500, cg=CG,
              cs=0.0)
    before = chain_gpu.launches
    f, p = chain_gpu.chain_segments(x, y, t(rng), t(starts), t(ends), **kw)
    ft, pt = chain_gpu.chain_segments_torch(x, y, t(rng), t(starts),
                                            t(ends), **kw)
    assert chain_gpu.launches == before
    assert torch.equal(f, ft) and torch.equal(p, pt)
    with pytest.raises(ValueError):
        chain_gpu.chain_segments(x.long(), y, t(rng), t(starts), t(ends),
                                 **kw)
