"""Splice gap fills of the PyTorch port (mm2_gb_tpu_torch.ops.ksw2s_gpu)
on the CPU: the plain twins of the exts2_fill kernel and of the intron
mode of ksw2_backtrack, driven through exts2_fill_batch, against
mm2_gb_tpu.ops.ksw2_splice.exts2 (what the JAX package's host path runs)
and ksw2_tpu.exts2_batch_device; the site-score twin against
ksw2_splice._splice_sites; the slice end to end against the splice40
golden.  Scores, CIGAR words and site scores are integers: tolerance 0.
Every input is made from a numpy seed.
"""

import gzip
import io

import numpy as np
import pytest
import torch

from chip_smoke import (_pack_splice, fill_result_err, splice_oracle,
                        splice_workloads)
from mm2_gb_tpu.ops import ksw2
from mm2_gb_tpu.ops import ksw2_splice as S
from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

AM = ksw2.KSW_EZ_APPROX_MAX
FOR, REV, FLANK = (ksw2.KSW_EZ_SPLICE_FOR, ksw2.KSW_EZ_SPLICE_REV,
                   ksw2.KSW_EZ_SPLICE_FLANK)
RIGHT, REVC = ksw2.KSW_EZ_RIGHT, ksw2.KSW_EZ_REV_CIGAR

WORKLOADS = list(splice_workloads(n_pairs=16, max_intron=300,
                                  long_intron=1500, n_long=2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(preset="splice"):
    return KS.splice_params(O.set_preset(preset)[1])


@pytest.mark.parametrize("flag", [0, FOR, REV, FOR | REV, FOR | FLANK,
                                  REV | FLANK, FOR | REV | FLANK])
@pytest.mark.parametrize("rev_cigar", [False, True])
def test_splice_sites_match_python(flag, rev_cigar):
    """splice_sites_torch == ksw2_splice._splice_sites over the motif
    flags, REV_CIGAR on and off, no junction bytes or random ones, and
    targets of 0 to 4 bases (no donor fits) and longer."""
    rng = np.random.default_rng(flag + 7 * rev_cigar)
    flag |= REVC if rev_cigar else 0
    for tlen in [0, 1, 3, 4, 5, 6, 17, 40, 77]:
        for junc_on in (False, True):
            t = rng.integers(0, 5 if tlen % 2 else 4, tlen).astype(np.uint8)
            t[:tlen // 2] = np.resize([2, 3, 0, 2, 0, 1, 3, 2], tlen // 2)
            junc = (rng.integers(0, 16, tlen).astype(np.uint8) if junc_on
                    else None)
            nbytes = (tlen + 15) // 16 * 16
            for noncan, bonus in ((9, 9), (15, 5), (4, 0)):
                want = S._splice_sites(t, tlen, nbytes, noncan, bonus, flag,
                                       junc)
                got = KS.splice_sites_torch(t, tlen, nbytes, noncan, bonus,
                                            flag, junc)
                assert np.array_equal(got[0].numpy(), want[0])
                assert np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("name,meta,qb,tb,jb,fl,prm", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_twins_match_ksw2_splice_exts2(name, meta, qb, tb, jb, fl, prm):
    """The smoke's splice workloads (every flag variant and fill kind,
    the splice and splice:hq presets, an int8-wrapping junction bonus, an
    odd non-canonical cost, a ring past the shared-memory cap, the mat
    gate) through exts2_fill_batch on the twins."""
    before = (KS.fill_launches, K.backtrack_launches)
    st = K.FillStats()
    got = KS.exts2_fill_batch(meta, qb, tb, jb, fl, prm, "cpu", st)
    assert fill_result_err(got, splice_oracle(meta, qb, tb, jb, fl, prm,
                                              S.exts2)) == 0
    assert st.fills == meta.shape[0]
    assert st.device_fills + st.host_fills == st.fills
    if name == "mat_gate":
        assert prm.host_only and st.host_fills == st.fills
    else:
        assert st.device_fills == st.fills and st.chunks == 1
    assert (st.scratch_fills > 0) == (name == "noncan_odd")
    # CPU tensors take the twins: no kernel launch is counted
    assert (KS.fill_launches, K.backtrack_launches) == before


def _splice_case(seed, rev, lead=0):
    """A query of 1-3 exons against a target with 60-400 bp introns
    (GT..AG, or GA..TG for REV_CIGAR fills), after `lead` unrelated
    target bases (tests/test_ksw2_tpu.py::_mk_splice_case's shape)."""
    r = np.random.default_rng(seed)
    n_ex = int(r.integers(1, 4))
    qs = r.integers(0, 4, size=int(r.integers(80, 300))).astype(np.uint8)
    bnds = (np.sort(r.choice(np.arange(1, len(qs) - 1), size=n_ex - 1,
                             replace=False)) if n_ex > 1 else [])
    t = [r.integers(0, 4, lead).astype(np.uint8)]
    pieces = np.split(qs, bnds)
    for k, p in enumerate(pieces):
        p = p.copy()
        mask = r.random(len(p)) < 0.05
        p[mask] = r.integers(0, 4, size=int(mask.sum()))
        t.append(p)
        if k < len(pieces) - 1:
            intr = r.integers(0, 4, size=int(r.integers(60, 400))
                              ).astype(np.uint8)
            intr[:2], intr[-2:] = ((2, 0), (3, 2)) if rev else ((2, 3), (0, 2))
            t.append(intr)
    return qs, np.concatenate(t).astype(np.uint8)


@pytest.mark.parametrize("extra", [0, FLANK, RIGHT, REV | FLANK, REVC,
                                   RIGHT | REVC],
                         ids=["for", "flank", "right", "rev_flank",
                              "rev_cigar", "right_rev_cigar"])
def test_twins_match_exts2_batch_device(extra):
    """The five flag variants of tests/test_ksw2_tpu.py:204-210 and
    RIGHT|REV_CIGAR on seeded multi-exon pairs, BED junction bytes on
    half of them, and a pair whose leading 120 unaligned target bases
    become N: the twins equal ksw2_splice.exts2 and the JAX package's
    exts2_batch_device (at its default CPU resolution)."""
    from mm2_gb_tpu.ops.ksw2_tpu import FillCall, exts2_batch_device
    mat = ksw2.gen_simple_mat(5, 1, 2, 1)
    q_, e_, q2_, noncan, jb = 2, 1, 32, 9, 9
    prm = KS.splice_params_from(mat, q_, e_, q2_, noncan, jb)
    flag = AM | FOR | extra
    rev = bool(extra & REVC)
    fills = []
    for seed in range(4):
        qs, ts = _splice_case(50 + seed, rev, lead=120 if seed == 3 else 0)
        junc = (np.random.default_rng(seed).integers(0, 4, size=len(ts))
                .astype(np.uint8) if seed % 2 else None)
        fills.append((qs, ts, flag, junc))
    got = KS.exts2_fill_batch(*_pack_splice(fills), prm, "cpu")
    jax = exts2_batch_device(
        [FillCall(q, t, -1, bool(flag & RIGHT), -1) for q, t, _f, _j in fills],
        mat, q_, e_, q2_, noncan, jb, flag, [j for *_x, j in fills])
    for k, (q, t, f, j) in enumerate(fills):
        ez = S.exts2(q, t, mat, q_, e_, q2_, noncan, -1, jb, f, j)
        cig = got[2][got[1][k]:got[1][k + 1]]
        assert got[0][k] == ez.score == jax[k].score
        assert np.array_equal(cig, ez.cigar.astype(np.uint32))
        assert np.array_equal(cig, np.asarray(jax[k].cigar, np.uint32))
    # the lead: a tail deletion of > long_thres bases, emitted as N
    lead = got[2][got[1][3]:got[1][4]]
    first = lead[-1] if rev else lead[0]
    assert first & 0xF == 3 and first >> 4 >= prm.long_thres + 1


def test_backtrack_intron_mode_and_rev_per_fill():
    """ksw2_backtrack_torch: min_intron_len 0 is the extd2 backtrack (state
    3 and the tail are D), > 0 turns them into N; a per-fill rev_cigar
    equals the scalar flag on each fill."""
    fills = [(q, t, AM | FOR | (REVC if k % 2 else 0), None)
             for k, (q, t) in enumerate(_splice_case(60 + k, bool(k % 2),
                                                     lead=100)
                                        for k in range(4))]
    meta, qb, tb, jb, fl = _pack_splice(fills)
    prm = _params()
    n = meta.shape[0]
    ql = torch.tensor(meta[:, 0], dtype=torch.int32)
    tl = torch.tensor(meta[:, 1], dtype=torch.int32)
    pb = K.p_bound(meta[:, 0], meta[:, 1], meta[:, 0] + meta[:, 1])
    po = torch.tensor(np.concatenate([[0], np.cumsum(pb)[:-1]]))
    z = torch.zeros(n, dtype=torch.int64)
    sc, p = KS.exts2_fill_torch(
        torch.from_numpy(qb), torch.from_numpy(tb), torch.from_numpy(jb),
        torch.tensor(np.concatenate([[0], np.cumsum(meta[:, 0])[:-1]])),
        torch.tensor(np.concatenate([[0], np.cumsum(meta[:, 1])[:-1]])),
        z - 1, ql, tl, torch.tensor(fl, dtype=torch.int32), po,
        int(pb.sum()), prm)
    co = torch.tensor(np.concatenate([[0], np.cumsum(meta[:, 0]
                                                     + meta[:, 1])]))
    w = ql + tl
    rev = torch.tensor(fl & REVC > 0)
    cig_n, nc_n = K.ksw2_backtrack_torch(p, po, ql, tl, w, co, rev,
                                         prm.long_thres)
    cig_d, nc_d = K.ksw2_backtrack_torch(p, po, ql, tl, w, co, rev, 0)
    for k, (q, t, f, _j) in enumerate(fills):
        ops_n = cig_n[co[k]:co[k] + nc_n[k]].numpy() & 0xF
        ops_d = cig_d[co[k]:co[k] + nc_d[k]].numpy() & 0xF
        assert 3 in ops_n and 3 not in ops_d
        ez = S.exts2(q, t, prm.mat, prm.q, prm.e, prm.q2, prm.noncan, -1,
                     prm.junc_bonus, f, None)
        assert np.array_equal(cig_n[co[k]:co[k] + nc_n[k]].numpy()
                              .view(np.uint32), ez.cigar)
        one, one_n = K.ksw2_backtrack_torch(
            p, po[k:k + 1], ql[k:k + 1], tl[k:k + 1], w[k:k + 1],
            co[k:k + 2] - co[k], bool(rev[k]), prm.long_thres)
        assert torch.equal(one[:int(one_n[0])],
                           cig_n[co[k]:co[k] + nc_n[k]])


def test_splice_params_match_exts2_batch_device():
    """The derivation of ksw2_tpu.exts2_batch_device (:816-825) for the
    splice presets; no q/e swap."""
    for preset in ("splice", "splice:hq", "cdna"):
        _io, opt = O.set_preset(preset)
        prm = KS.splice_params(opt)
        mat = np.asarray(ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi),
                         np.int8)
        q, e, q2 = opt.q, opt.e, opt.q2
        long_thres = (q2 - q) // e - 1
        if q2 > q + e + long_thres * e:
            long_thres += 1
        assert np.array_equal(prm.mat, mat)
        assert (prm.q, prm.e, prm.q2, prm.noncan, prm.junc_bonus) == (
            q, e, q2, opt.noncan, opt.junc_bonus)
        assert (prm.mat0, prm.mat1) == (int(mat[0]), int(mat[1]))
        assert prm.sc_n == (-e if int(mat[24]) == 0 else int(mat[24]))
        assert (prm.long_thres, prm.long_diff) == (
            long_thres, long_thres * e - (q2 - q))
        assert not prm.host_only


def test_ring_lanes():
    """A state ring's lanes: by default the least power of two >=
    min(qlen, tlen) + 32, the same from numpy and from tensors."""
    ql = np.array([1, 31, 32, 33, 200, 224, 225, 5000, 7])
    tl = np.array([9, 500, 40, 40, 20000, 224, 300, 2500, 1])
    want = []
    for a, b in zip(ql, tl):
        r = 32
        while r < min(a, b) + 32:
            r <<= 1
        want.append(r)
    assert KS.ring_lanes(ql, tl).tolist() == want
    assert KS.ring_lanes(torch.from_numpy(ql),
                         torch.from_numpy(tl)).tolist() == want


def test_fill_shape_per_fill_class():
    """exts2_fill's launch takes each fill's class on its own: a warp for
    rings of at most WARP_RING lanes (min(qlen, tlen) + 80, a power of two
    from 64), else a block, and a block for the LONG_FILLS longest fills
    with at least half the longest one's rows; block-class rings past
    FILL_SMEM_MAX go to global scratch; block-class fills come first,
    warp-class ones eight to a block; the shared memory is the larger of
    eight warp rings and the widest block ring in shared memory."""
    ql = np.array([10, 176, 177, 5000, 300, 4100, 10, 20])
    tl = np.array([20000, 3000, 3000, 5000, 20, 4200, 5, 3000])
    lanes = KS.fill_ring_lanes(ql, tl)
    assert lanes.tolist() == [128, 256, 512, 8192, 128, 8192, 128, 128]
    assert KS.fill_ring_lanes(torch.from_numpy(ql),
                              torch.from_numpy(tl)).tolist() == lanes.tolist()
    sh = KS.fill_shape(ql, tl)
    assert (sh.n_block, sh.n_warp) == (4, 4)
    assert sh.work.tolist() == [0, 2, 3, 5, 1, 4, 6, 7] + [-1] * 4
    lb = KS.FILL_LANE_BYTES
    big = lb * 8192 + 16
    assert big > KS.FILL_SMEM_MAX >= lb * 512 + 16
    assert sh.scr_off.tolist() == [-1, -1, -1, 0, -1, big, -1, -1]
    assert sh.scratch == 2 * big
    assert sh.warp_stride == lb * 256 + 16
    assert sh.smem == max(KS.FILL_WARPS * sh.warp_stride, lb * 512 + 16)
    # a fill alone is its launch's longest: a block, and no warp stride
    only = KS.fill_shape(ql[6:7], tl[6:7])
    assert (only.n_block, only.n_warp, only.warp_stride, only.smem) == (
        1, 0, 0, lb * 128 + 16)
    # many fills as long as the longest: the LONG_FILLS first take blocks
    same = KS.fill_shape(np.full(200, 10), np.full(200, 5000))
    assert (same.n_block, same.n_warp) == (KS.LONG_FILLS, 200 - KS.LONG_FILLS)


def _ring_schedule_holds(qlen, tlen, pad, batch=32):
    """The fill kernel's ring schedule (csrc/exts2_kernel.cu): every
    `batch` rows the TJ and query rings take the bytes loaded a batch
    earlier and the lanes the next batch of rows reaches are entered
    (their site scores read TJ 2 lanes before and 3 after).  True when
    every lane a row reads (state at [st - 1, last], TJ over the score
    store span, the query at r - t) is the one its slot holds, with a
    ring of the least power of two >= max(64, min(qlen, tlen) + pad)."""
    n_rows, nbytes = qlen + tlen - 1, (tlen + 15) // 16 * 16
    R = 64
    while R < min(qlen, tlen) + pad:
        R <<= 1
    m = R - 1
    state, tj, qr = [-1] * R, [-1] * R, [-1] * R

    def bound(r):   # lane_bound
        return min(min(min(r, n_rows - 1), tlen - 1) + 15, nbytes - 1)

    def enter(t):
        if any(tj[k & m] != k for k in range(max(t - 2, 0), t + 4)):
            return False
        state[t & m] = t
        return True
    tj_hi, q_hi = bound(0) + 3, 0
    for t in range(tj_hi + 1):
        tj[t & m] = t
    qr[0] = 0
    if not all(enter(t) for t in range(tj_hi - 2)):
        return False
    exposed = tj_hi - 3
    tj_pf, q_pf = bound(batch) + 3, min(batch, qlen - 1)
    last_st = last_en = -1
    for r in range(n_rows):
        st0, en0 = max(0, r - qlen + 1), min(tlen - 1, r)
        st, en = st0 & -16, en0 | 15
        hi = min(st0 + 16 * ((en0 - st0) // 16 + 1), nbytes)
        if st > 0 and last_st <= st - 1 <= last_en \
                and state[(st - 1) & m] != st - 1:
            return False
        for t in range(st, max(en, hi - 1) + 1):
            if state[t & m] != t or st0 <= t < hi and (
                    tj[t & m] != t or t <= r and qr[(r - t) & m] != r - t):
                return False
        if r % batch == 0 and r + 1 < n_rows:
            if tj_pf - tj_hi > 32 or q_pf - q_hi > 32:   # a lane a thread
                return False
            for k in range(tj_hi + 1, tj_pf + 1):
                tj[k & m] = k
            for k in range(q_hi + 1, q_pf + 1):
                qr[k & m] = k
            tj_hi, q_hi = tj_pf, q_pf
            if not all(enter(t) for t in range(exposed + 1,
                                               bound(r + batch) + 1)):
                return False
            exposed = bound(r + batch)
            tj_pf = bound(r + 2 * batch) + 3
            q_pf = min(r + 2 * batch, qlen - 1)
        last_st, last_en = st, en
    return True


def test_fill_ring_pad_covers_the_batches():
    """FILL_RING_PAD lanes beyond min(qlen, tlen) keep every lane the
    fill kernel's rows read in its slot while the ring is filled a batch
    of 32 rows ahead (the derivation asks for 32 + 34); 40 would not."""
    rng = np.random.default_rng(5)
    sizes = [(1, 1), (1, 50), (50, 1), (10, 900), (900, 10), (200, 200),
             (33, 17), (20, 300)]
    sizes += [tuple(int(x) for x in rng.integers(1, 400, 2))
              for _ in range(30)]
    assert all(_ring_schedule_holds(q, t, KS.FILL_RING_PAD)
               for q, t in sizes)
    assert not all(_ring_schedule_holds(q, t, 40) for q, t in sizes)


def test_host_route_is_counted():
    """An empty side takes ksw2_splice.exts2 and is counted; options with
    q2 <= q + e or a matrix past the gate send every fill there."""
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    fills = [(t[:120].copy(), t, AM | FOR, None),
             (np.empty(0, np.uint8), t, AM | FOR, None),
             (t[:50].copy(), np.empty(0, np.uint8), AM | FOR, None),
             (t[100:200].copy(), t[90:210].copy(), AM | FOR | RIGHT,
              rng.integers(0, 16, 120).astype(np.uint8))]
    packed = _pack_splice(fills)
    mat = ksw2.gen_simple_mat(5, 1, 2, 1)
    for prm, n_host in ((_params(), 2),
                        (KS.splice_params_from(mat, 2, 1, 3, 9, 9), 4),
                        (KS.splice_params_from(ksw2.gen_simple_mat(
                            5, 1, 40, 1), 2, 1, 32, 9, 9), 4)):
        st = K.FillStats()
        got = KS.exts2_fill_batch(*packed, prm, "cpu", st)
        assert fill_result_err(got, splice_oracle(*packed, prm,
                                                  S.exts2)) == 0
        assert (st.fills, st.host_fills) == (4, n_host)
        assert st.device_fills == 4 - n_host
    assert st.cells == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z8 = torch.zeros(4, dtype=torch.uint8)
    i64 = torch.zeros(1, dtype=torch.int64)
    i32 = torch.ones(1, dtype=torch.int32)
    prm = _params()
    with pytest.raises(ValueError, match="flags"):
        KS.exts2_fill(z8, z8, z8, i64, i64, i64, i32, i32, i64, i64, 64, prm)
    with pytest.raises(ValueError, match="has 2 elements"):
        KS.exts2_fill(z8, z8, z8, i64, i64, i64, i32, i32, i32,
                      torch.zeros(2, dtype=torch.int64), 64, prm)
    gate = KS.splice_params_from(ksw2.gen_simple_mat(5, 1, 40, 1), 2, 1, 32,
                                 9, 9)
    with pytest.raises(ValueError, match="host route"):
        KS.exts2_fill(z8, z8, z8, i64, i64, i64, i32, i32, i32, i64, 64,
                      gate)
    meta = np.array([[2, 2, 0]], np.int64)
    two = np.zeros(2, np.uint8)
    for flags in ([ksw2.KSW_EZ_EXTZ_ONLY], [FOR],
                  [AM | ksw2.KSW_EZ_APPROX_DROP]):
        with pytest.raises(ValueError, match="unsupported flags"):
            KS.exts2_fill_batch(meta, two, two, two[:0], np.array(flags),
                                prm, "cpu")
    with pytest.raises(ValueError, match="junction bytes"):
        KS.exts2_fill_batch(np.array([[2, 2, 1]]), two, two, two[:1],
                            np.array([AM | FOR]), prm, "cpu")
    with pytest.raises(ValueError, match="per-fill rev_cigar"):
        K.ksw2_backtrack(z8, i64, i32, i32, i32,
                         torch.zeros(2, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.uint8))


def test_chunks_split_by_budget(monkeypatch):
    """A small chunk budget splits a batch into several launches of the
    twins; the results do not change."""
    from mm2_gb_tpu_torch.utils import gpucfg
    _name, meta, qb, tb, jb, fl, prm = WORKLOADS[0]
    want = splice_oracle(meta, qb, tb, jb, fl, prm, S.exts2)
    monkeypatch.setattr(gpucfg, "CPU_FILL_CHUNK_BYTES", 1_200_000)
    st = K.FillStats()
    got = KS.exts2_fill_batch(meta, qb, tb, jb, fl, prm, "cpu", st)
    assert st.chunks >= 3
    assert fill_result_err(got, want) == 0


def test_smoke_holds_each_fill_of_at_most_n_rows(monkeypatch):
    """chip_smoke's per-fill twin selection: the fills of at most n rows
    are a suffix of each launch (longest first), and one twin run over
    those suffixes of every launch (re-based by _splice_suffix and
    merged) gives each fill the scores, direction bytes and CIGAR slots
    its own launch gave it."""
    from chip_smoke import (_merge_splice_calls, _splice_suffix,
                            recording_splice)
    from mm2_gb_tpu_torch.utils import gpucfg
    _name, meta, qb, tb, jb, fl, prm = WORKLOADS[0]
    monkeypatch.setattr(gpucfg, "CPU_FILL_CHUNK_BYTES", 1_200_000)
    with recording_splice() as calls:
        KS.exts2_fill_batch(meta, qb, tb, jb, fl, prm, "cpu")
    assert len(calls) >= 3
    n_rows = 1100
    cut = []
    for c in calls:
        rows = (c[0][6] + c[0][7]).numpy()
        assert (np.diff(rows) <= 0).all()
        cut.append(int((rows > n_rows).sum()))
    held = [(i, k0) for i, k0 in enumerate(cut)
            if k0 < calls[i][0][6].shape[0]]
    assert len(held) >= 2 and any(k0 > 0 for _i, k0 in held)
    fa, ba, bases = _merge_splice_calls([_splice_suffix(calls[i], k0)
                                         for i, k0 in held])
    sc_t, p_t = KS.exts2_fill_torch(*fa)
    cg_t, nc_t = K.ksw2_backtrack_torch(p_t, *ba)
    for (i, k0), (f0, p0, c0) in zip(held, bases):
        (fa_i, sc, _fp, ba_i, cig, nc) = calls[i]
        n = fa_i[6].shape[0] - k0
        po, co = fa_i[9], ba_i[4]
        _sc, p = KS.exts2_fill_torch(*fa_i)
        assert torch.equal(sc_t[f0:f0 + n], sc[k0:])
        assert torch.equal(p_t[p0:p0 + fa_i[10] - int(po[k0])],
                           p[int(po[k0]):])
        assert torch.equal(cg_t[c0:c0 + int(co[-1] - co[k0])],
                           cig[int(co[k0]):])
        assert torch.equal(nc_t[f0:f0 + n], nc[k0:])


@pytest.mark.slow
def test_twins_match_exts2_interpret_mode():
    """The JAX package's Pallas exts2 kernel in interpret mode
    (exts2_batch_device(interpret=True)) on one small case."""
    from mm2_gb_tpu.ops.ksw2_tpu import FillCall, exts2_batch_device
    mat = ksw2.gen_simple_mat(5, 1, 2, 1)
    prm = KS.splice_params_from(mat, 2, 1, 32, 9, 9)
    flag = AM | FOR | FLANK
    q, t = _splice_case(51, False)
    junc = np.random.default_rng(1).integers(0, 4, len(t)).astype(np.uint8)
    got = KS.exts2_fill_batch(*_pack_splice([(q, t, flag, junc)]), prm, "cpu")
    dev = exts2_batch_device([FillCall(q, t, -1, False, -1)], mat, 2, 1, 32,
                             9, 9, flag, [junc], interpret=True)[0]
    assert got[0][0] == dev.score
    assert np.array_equal(got[2], np.asarray(dev.cigar, np.uint32))


def test_slice_matches_splice40_golden():
    """The slice on CPU tensors: `-x splice --gpu-align -c` through
    map_file_gpu_records (is_cdna chain twin, collect pass, exts2 and
    intron backtrack twins, the fill cache) equals the reference's
    splice40 golden byte for byte."""
    from mm2_gb_tpu_torch.cli import res_regs_out
    from mm2_gb_tpu_torch.models import pipeline as gp
    io_, mo = O.set_preset("splice")
    mo.max_chain_skip = 2**31 - 1
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG | O.MM_F_TPU_ALIGN
    index = MinimizerIndex.from_fasta(golden_path("splice_genome.fa.gz"), io_)
    O.mapopt_update(mo, index)
    out = io.StringIO()
    met = gp.GpuMetrics()
    before = (KS.fill_launches, K.backtrack_launches)
    for sr, regs in gp.map_file_gpu_records(
            index, mo, [golden_path("splice_reads.fa.gz")], met, 2,
            device="cpu"):
        res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len, False, None,
                     0, 1, [regs])
    with gzip.open(golden_path("splice40.skipinf.c.paf.gz"), "rt") as f:
        assert out.getvalue() == f.read()
    fs = met.fills
    assert fs.fills == fs.device_fills > 200 and fs.host_fills == 0
    assert fs.cells > 5e7 and fs.chunks == 1
    assert (KS.fill_launches, K.backtrack_launches) == before
