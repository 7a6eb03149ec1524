"""Extensions of the PyTorch port (mm2_gb_tpu_torch.ops.ksw2_gpu) on the
CPU: the plain twins of the extd2_ext kernel and of ksw2_backtrack with
per-fill starts, driven through extd2_ext_batch, against the JAX
package's ext_batch_device at its CPU default (which resolves to
ksw2.extd2, as the JAX package's own tests run it).  Every Extz field
and the CIGAR are integers: tolerance 0.  Every input is made from a
numpy seed.
"""

import numpy as np
import pytest
import torch

from mm2_gb_tpu.ops import ksw2 as jksw2
from mm2_gb_tpu.ops.ksw2_tpu import FillCall, ext_batch_device
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.utils import opts as O

MAT = jksw2.gen_simple_mat(5, 2, 4, 1)
EXTO = jksw2.KSW_EZ_EXTZ_ONLY
RIGHT, REVC = jksw2.KSW_EZ_RIGHT, jksw2.KSW_EZ_REV_CIGAR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_pair(rng, qlen, tlen, div=0.1):
    """test_ksw2_tpu.py's pair: a shared prefix, div substitutions."""
    base = rng.integers(0, 4, max(qlen, tlen)).astype(np.uint8)
    t = base[:tlen].copy()
    q = base[:qlen].copy()
    n_mut = int(qlen * div)
    if n_mut:
        pos = rng.integers(0, qlen, n_mut)
        q[pos] = rng.integers(0, 4, n_mut).astype(np.uint8)
    return q, t


def _check(calls, flag, end_bonus=-1, q=4, e=2, q2=24, e2=1, mat=MAT):
    """extd2_ext_batch on the twins against ext_batch_device, every Extz
    field and the CIGAR; returns the batch's FillStats."""
    meta = np.array([[len(c.qseq), len(c.tseq), c.w] for c in calls],
                    np.int64)
    qb = np.concatenate([c.qseq for c in calls]).astype(np.uint8)
    tb = np.concatenate([c.tseq for c in calls]).astype(np.uint8)
    zd = np.array([c.zdrop for c in calls], np.int64)
    st = K.FillStats()
    before = (K.ext_launches, K.backtrack_launches)
    fields, cig_off, cig_blob = K.extd2_ext_batch(
        meta, qb, tb, zd, K.fill_params_from(mat, q, e, q2, e2), flag,
        end_bonus, "cpu", st)
    want = ext_batch_device(calls, mat, q, e, q2, e2, flag, end_bonus)
    for k, ez in enumerate(want):
        assert fields[k].tolist() == [int(getattr(ez, f))
                                      for f in K.EXT_FIELDS], k
        assert np.array_equal(cig_blob[cig_off[k]:cig_off[k + 1]],
                              ez.cigar), k
    # CPU tensors take the twins: no kernel launch is counted
    assert (K.ext_launches, K.backtrack_launches) == before
    assert st.ext_fills == len(calls)
    return st


@pytest.mark.parametrize("qlen,tlen", [(80, 90), (300, 280), (511, 700)])
def test_extension_matches_ext_batch_device(qlen, tlen):
    rng = np.random.default_rng(qlen)
    q, t = _rand_pair(rng, qlen, tlen)
    st = _check([FillCall(q, t, 500, False, 400)], EXTO)
    assert st.ext_host_fills == 0 and st.ext_cells == qlen * tlen


def test_extension_right_rev():
    """The left-extension configuration (align.c:700-711)."""
    rng = np.random.default_rng(41)
    q, t = _rand_pair(rng, 250, 260)
    _check([FillCall(q[::-1].copy(), t[::-1].copy(), 500, True, 400)],
           EXTO | RIGHT | REVC)


def test_extension_zdrop_mid_matrix():
    """A matched head, then an unrelated tail: the DP Z-drops mid-matrix
    and the CIGAR starts at the maximum."""
    rng = np.random.default_rng(43)
    base = rng.integers(0, 4, 1200).astype(np.uint8)
    q = base[:1000].copy()
    t = base[:1200].copy()
    q[500:] = rng.integers(0, 4, 500).astype(np.uint8)
    want = jksw2.extd2(q, t, MAT, 4, 2, 24, 1, 500, 100, -1, EXTO)
    assert want.zdropped and want.score == jksw2.KSW_NEG_INF
    _check([FillCall(q, t, 500, False, 100)], EXTO)


def test_extension_reach_end():
    """A near-identical pair with an end bonus reaches the query end:
    the backtrack starts at (mqe_t, qlen - 1)."""
    rng = np.random.default_rng(47)
    q, t = _rand_pair(rng, 200, 210, div=0.02)
    want = jksw2.extd2(q, t, MAT, 4, 2, 24, 1, 500, 400, 10, EXTO)
    assert want.reach_end
    _check([FillCall(q, t, 500, False, 400)], EXTO, end_bonus=10)


def test_row_maximum_ties_across_rank_classes(monkeypatch):
    """Low-complexity pairs whose rows hold their maximum at several
    lanes: at en0 and in the body, in several 4-lane columns, in the
    body and the tail.  The twin's ranked argmax picks the oracle's
    lane (the oracle's pure-NumPy row_max is watched to show the ties
    happen)."""
    seen = set()
    row_max = jksw2._row_max

    def watched(H, st0, en0, add, h_en0):
        mh, mt = row_max(H, st0, en0, add, h_en0)
        en1 = st0 + (en0 - st0) // 4 * 4
        at = [t for t in range(st0, en0) if int(H[t]) == mh]
        if h_en0 == mh and at:
            seen.add("en0")
        if len({(t - st0) % 4 for t in at if t < en1}) > 1:
            seen.add("columns")
        if any(t < en1 for t in at) and any(t >= en1 for t in at):
            seen.add("tail")
        return mh, mt
    monkeypatch.setenv("MM2TPU_NO_NATIVE", "1")
    monkeypatch.setattr(jksw2, "_row_max", watched)
    rng = np.random.default_rng(53)
    calls = []
    for unit, n_q, n_t in ((1, 40, 43), (2, 61, 58), (3, 50, 53),
                           (4, 47, 47), (6, 70, 66)):
        rep = rng.integers(0, 4, unit).astype(np.uint8)
        calls.append(FillCall(np.tile(rep, n_q)[:n_q].copy(),
                              np.tile(rep, n_t)[:n_t].copy(), 500, False,
                              400))
        calls.append(FillCall(np.tile(rep, n_q)[:n_q].copy(),
                              np.tile(rep, n_t)[:n_t].copy(), 500, True,
                              400))
    _check(calls[0::2], EXTO)
    _check(calls[1::2], EXTO | RIGHT | REVC)
    assert seen == {"en0", "columns", "tail"}


def test_extension_qe_swap():
    """q + e > q2 + e2: the penalties swap (ksw2_tpu.py:1689)."""
    rng = np.random.default_rng(23)
    q, t = _rand_pair(rng, 200, 200)
    _check([FillCall(q, t, 500, False, 400)], EXTO, q=24, e=1, q2=4, e2=2)


def test_extension_ambiguous_bases():
    rng = np.random.default_rng(13)
    q, t = _rand_pair(rng, 150, 160)
    q[10:14] = 4
    t[70:75] = 4
    _check([FillCall(q, t, 500, False, 400), FillCall(q[::-1].copy(),
                                                       t[::-1].copy(), 500,
                                                       True, 400)],
           EXTO)


def test_extension_band_collapse_takes_the_host_route():
    """|qlen - tlen| past the band: ksw2.extd2 on the host, counted."""
    rng = np.random.default_rng(19)
    q, t = _rand_pair(rng, 50, 400)
    q2, t2 = _rand_pair(rng, 120, 110)
    st = _check([FillCall(q, t, 10, False, 400),
                 FillCall(q2, t2, 500, False, 400)], EXTO)
    assert (st.ext_fills, st.ext_host_fills, st.ext_chunks) == (2, 1, 1)
    assert st.ext_cells == 120 * 110


def test_extension_past_the_shared_memory_budget():
    """tlen past ~2.9 kb: the kernel keeps the fill's state (ext_bytes:
    the fill kernel's and the int32 H row) in global scratch; the twin's
    answer is the same."""
    rng = np.random.default_rng(59)
    t = rng.integers(0, 4, 3300).astype(np.uint8)
    q = t[:180].copy()
    q[rng.random(180) < 0.05] = 1
    assert K.ext_bytes(180, 3300) > K.EXT_SMEM_MAX
    st = _check([FillCall(q, t, -1, False, 400)], EXTO, end_bonus=5)
    assert st.scratch_fills == 1


def test_twins_with_starts_directly():
    """extd2_ext_torch, then ksw2_backtrack_torch from the starts it
    picked, on fills of every start kind (reach_end, the maximum, none:
    a query whose every base scores below 0)."""
    rng = np.random.default_rng(61)
    pairs = [_rand_pair(rng, 120, 130, div=0.01),
             _rand_pair(rng, 150, 140, div=0.6)]
    pairs.append((np.full(30, 1, np.uint8), np.full(30, 2, np.uint8)))
    _io, mo = O.set_preset(None)
    prm = K.fill_params(mo)
    ql = torch.tensor([len(q) for q, _ in pairs], dtype=torch.int32)
    tl = torch.tensor([len(t) for _, t in pairs], dtype=torch.int32)
    qoff = torch.cumsum(ql.long(), 0) - ql.long()
    toff = torch.cumsum(tl.long(), 0) - tl.long()
    w = torch.full((3,), 751, dtype=torch.int32)
    zd = torch.full((3,), 400, dtype=torch.int32)
    pb = torch.from_numpy(K.p_bound(ql.numpy(), tl.numpy(), w.numpy()))
    p_off = torch.cumsum(pb, 0) - pb
    qb = torch.from_numpy(np.concatenate([q for q, _ in pairs]))
    tb = torch.from_numpy(np.concatenate([t for _, t in pairs]))
    ext, p = K.extd2_ext_torch(qb, tb, qoff, toff, ql, tl, w, zd, p_off,
                               int(pb.sum()), prm, False, 10)
    co = torch.cat([torch.zeros(1, dtype=torch.int64),
                    torch.cumsum((ql + tl).long(), 0)])
    cig, nc = K.ksw2_backtrack_torch(p, p_off, ql, tl, w, co, False,
                                     starts=ext[:, 10:])
    for k, (q, t) in enumerate(pairs):
        ez = jksw2.extd2(q, t, prm.mat, mo.q, mo.e, mo.q2, mo.e2, 751, 400,
                         10, EXTO)
        assert ext[k, :10].tolist() == [int(getattr(ez, f))
                                        for f in K.EXT_FIELDS]
        words = cig[co[k]:co[k] + nc[k]].numpy().view(np.uint32)
        assert np.array_equal(words, ez.cigar)
    kinds = ["reach" if e[9] else "max" if e[10] >= 0 else "none"
             for e in ext.tolist()]
    assert kinds == ["reach", "max", "none"] and nc[2] == 0


def test_ext_wrappers_refuse_what_the_kernel_does_not_take():
    z8 = torch.zeros(4, dtype=torch.uint8)
    i64 = torch.zeros(1, dtype=torch.int64)
    i32 = torch.ones(1, dtype=torch.int32)
    _io, mo = O.set_preset(None)
    prm = K.fill_params(mo)
    with pytest.raises(ValueError, match="zdrop"):
        K.extd2_ext(z8, z8, i64, i64, i32, i32, i32, i64, i64, 64, prm,
                    False, 0)
    gate = K.fill_params_from(jksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1)
    with pytest.raises(ValueError, match="host route"):
        K.extd2_ext(z8, z8, i64, i64, i32, i32, i32, i32, i64, 64, gate,
                    False, 0)
    with pytest.raises(ValueError, match="starts"):
        K.ksw2_backtrack(z8, i64, i32, i32, i32, torch.zeros(
            2, dtype=torch.int64), False, starts=torch.zeros(
                (1, 2), dtype=torch.int64))
    for flag in (jksw2.KSW_EZ_APPROX_MAX, EXTO | jksw2.KSW_EZ_SCORE_ONLY):
        with pytest.raises(ValueError, match="unsupported flag"):
            K.extd2_ext_batch(np.zeros((0, 3), np.int64), z8.numpy(),
                              z8.numpy(), np.zeros(0, np.int64), prm, flag,
                              0, "cpu")


@pytest.mark.parametrize("right,bonus", [(False, -1), (True, 10)],
                         ids=["left_rule", "right_rule_bonus"])
def test_twin_fill_results_do_not_depend_on_company(right, bonus):
    """A fill's extension and direction bytes are the same in a run of
    the twin over six fills as in a run over it alone (the card's checks
    hold a launch's fills against one twin run over several launches)."""
    rng = np.random.default_rng(67)
    pairs = [_rand_pair(rng, int(rng.integers(20, 160)),
                        int(rng.integers(20, 160)), div=0.08)
             for _ in range(6)]
    _io, mo = O.set_preset("map-hifi")
    prm = K.fill_params(mo)
    ql = torch.tensor([len(q) for q, _ in pairs], dtype=torch.int32)
    tl = torch.tensor([len(t) for _, t in pairs], dtype=torch.int32)
    qoff = torch.cumsum(ql.long(), 0) - ql.long()
    toff = torch.cumsum(tl.long(), 0) - tl.long()
    w = torch.full((6,), 200, dtype=torch.int32)
    zd = torch.tensor([400, 20, -1, 100, 400, 50], dtype=torch.int32)
    pb = torch.from_numpy(K.p_bound(ql.numpy(), tl.numpy(), w.numpy()))
    p_off = torch.cumsum(pb, 0) - pb
    qb = torch.from_numpy(np.concatenate([q for q, _ in pairs]))
    tb = torch.from_numpy(np.concatenate([t for _, t in pairs]))
    ext, p = K.extd2_ext_torch(qb, tb, qoff, toff, ql, tl, w, zd, p_off,
                               int(pb.sum()), prm, right, bonus)
    for k in range(6):
        one, p1 = K.extd2_ext_torch(qb, tb, qoff[k:k + 1], toff[k:k + 1],
                                    ql[k:k + 1], tl[k:k + 1], w[k:k + 1],
                                    zd[k:k + 1], torch.zeros(1, dtype=torch.int64),
                                    int(pb[k]), prm, right, bonus)
        assert torch.equal(ext[k], one[0])
        s, e = int(p_off[k]), int(p_off[k] + pb[k])
        assert torch.equal(p[s:e], p1)


def test_extension_chunks_split_by_budget(monkeypatch):
    """Under a small chunk budget the extensions run in several chunks
    (the fill batches' shared chunk loop) with the same results."""
    from mm2_gb_tpu_torch.utils import gpucfg
    rng = np.random.default_rng(71)
    calls = [FillCall(*_rand_pair(rng, int(rng.integers(60, 220)),
                                  int(rng.integers(60, 220))), 500, False,
                      400) for _ in range(8)]
    monkeypatch.setattr(gpucfg, "CPU_FILL_CHUNK_BYTES", 60_000)
    st = _check(calls, EXTO, end_bonus=10)
    assert st.ext_chunks >= 3 and st.ext_host_fills == 0
