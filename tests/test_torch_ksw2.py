"""Gap fills of the PyTorch port (mm2_gb_tpu_torch.ops.ksw2_gpu) on the
CPU: the plain twins of the extd2_fill and ksw2_backtrack kernels, driven
through extd2_fill_batch, against mm2_gb_tpu.ops.ksw2.extd2 (what the
JAX package itself runs for these fills on the CPU: extd2_batch_device
resolves to its host oracle there).  Score and CIGAR, tolerance 0.
Every input is made from a numpy seed; the port's side takes its options
from the port's own copies.

The first test is the sim200 --qstrand golden through the genomic
Python fill session (the twins of the fill and extension kernels end to
end; tests/test_torch_session.py holds the rest of that route).  It is
the longest test of the suite, and it comes first in a file of many
tests on purpose: pytest-xdist's --dist loadfile hands files out by
their number of tests, most first, so in a file of its own it would
start last and end the run late.
"""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from chip_smoke import (_pack_fills, fill_oracle, fill_result_err,
                        fill_workloads)
from mm2_gb_tpu.ops import ksw2
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_gpu_path(argv):
    """The --gpu-chain --gpu-align run path (cli._run) on the CPU twins:
    (rc, stdout, stderr)."""
    argv, args = cli.parse_args(["--max-chain-skip=2147483647",
                                 "--gpu-chain", "--gpu-align", *argv])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli._run(args, argv, io_, mo, torch.device("cpu"))
    return rc, out.getvalue(), err.getvalue()


def test_qstrand_gpu_align_matches_golden():
    """`--gpu-chain --gpu-align --qstrand -c` (test_e2e_paf.py:288-290's
    flags) on the twins equals the reference's golden byte for byte; the
    fills and extensions go through the Python fill session."""
    before = (K.fill_launches, K.ext_launches, K.backtrack_launches)
    rc, out, err = _run_gpu_path(["--qstrand", "-c", "-v", "3",
                                  golden_path("simref.fa.gz"),
                                  golden_path("simreads.fa.gz")])
    assert rc == 0
    with gzip.open(golden_path("sim200.qstrand.c.paf.gz"), "rt") as f:
        assert out == f.read()
    line = next(line for line in err.splitlines()
                if line.startswith("[M::gpu] fills:"))
    assert " 0 host-routed) in" in line.split("; extensions:")[0]
    assert "; extensions: 0 " not in line
    # the real pass found every fill and extension in the device results
    assert line.endswith("real-pass misses (aligned on the host): 0 fill, "
                         "0 ext, 0 splice")
    assert (K.fill_launches, K.ext_launches, K.backtrack_launches) == before


WORKLOADS = list(fill_workloads(n_pairs=16, max_len=160, long_len=400))


@pytest.mark.parametrize("name,meta,qb,tb,prm,flag", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_twins_match_ksw2_extd2(name, meta, qb, tb, prm, flag):
    before = (K.fill_launches, K.backtrack_launches)
    st = K.FillStats()
    got = K.extd2_fill_batch(meta, qb, tb, prm, "cpu", flag, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag,
                                               ksw2.extd2)) == 0
    assert st.fills == meta.shape[0]
    assert st.device_fills + st.host_fills == st.fills
    if name == "mat_gate":
        assert st.host_fills == st.fills and st.chunks == 0
    else:
        assert st.device_fills > 0 and st.chunks >= 1
    # CPU tensors take the twins: no kernel launch is counted
    assert (K.fill_launches, K.backtrack_launches) == before


@pytest.mark.parametrize("preset", [None, "map-pb", "map-hifi", "asm5",
                                    "asm10", "asm20"])
def test_fill_params_match_extd2_batch_device(preset):
    """The derivation of ksw2_tpu.extd2_batch_device (:1318-1327)."""
    _io, opt = O.set_preset(preset)
    mat = np.asarray(ksw2.gen_simple_mat(5, opt.a, opt.b, opt.sc_ambi),
                     np.int8)
    q, e, q2, e2 = opt.q, opt.e, opt.q2, opt.e2
    m = 5
    mat0, mat1 = int(mat[0]), int(mat[1])
    qq, ee, qq2, ee2 = (q, e, q2, e2) if q + e <= q2 + e2 else (q2, e2, q, e)
    sc_n = -ee2 if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    long_thres = (qq2 - qq) // (ee - ee2) - 1 if ee != ee2 else 0
    if qq2 + ee2 + long_thres * ee2 > qq + ee + long_thres * ee:
        long_thres += 1
    long_diff = long_thres * (ee - ee2) - (qq2 - qq) - ee2
    prm = K.fill_params(opt)
    assert np.array_equal(prm.mat, mat)
    assert (prm.q, prm.e, prm.q2, prm.e2) == (q, e, q2, e2)
    assert (prm.qq, prm.ee, prm.qq2, prm.ee2) == (qq, ee, qq2, ee2)
    assert (prm.mat0, prm.mat1, prm.sc_n) == (mat0, mat1, sc_n)
    assert (prm.long_thres, prm.long_diff) == (long_thres, long_diff)
    assert prm.mat_gate == (-int(mat.min()) > 2 * (qq + ee))


def test_band_collapse_matches_row_window():
    """band_collapses equals the oracle's walk: some _row_window is None."""
    qs, ts, ws, want = [], [], [], []
    for ql in range(1, 40, 3):
        for tl in range(1, 40, 3):
            for w in (0, 1, 2, 3, 5, 8, 16, 33):
                qs.append(ql)
                ts.append(tl)
                ws.append(w)
                want.append(any(ksw2._row_window(r, ql, tl, w, w) is None
                                for r in range(ql + tl - 1)))
    assert np.array_equal(K.band_collapses(qs, ts, ws), np.array(want))


def test_p_bound_holds_every_row():
    """Each fill's rows (widths en - st + 1) fit in p_bound bytes."""
    rng = np.random.default_rng(3)
    ql = rng.integers(1, 700, 400)
    tl = rng.integers(1, 700, 400)
    w = rng.choice([1, 16, 51, 200, 751, 30001], 400)
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    rows = int((ql + tl - 1).max())
    used = K._row_widths(t(ql), t(tl), t(w), rows).sum(1).numpy()
    assert (used <= K.p_bound(ql, tl, w)).all()


def test_host_route_is_counted():
    """Band collapse, an empty side and the mat gate take ksw2.extd2 and
    are counted; the rest runs on the twins."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    pairs = [(t[:280].copy(), t),          # fits the band
             (t[:20].copy(), t),           # 280 bp length gap, w 16: collapse
             (np.empty(0, np.uint8), t),   # empty query
             (t[:100].copy(), t[:90].copy())]
    ws = [-1, 16, -1, 51]
    meta, qb, tb = _pack_fills(pairs, ws)
    _io, mo = O.set_preset(None)
    prm = K.fill_params(mo)
    st = K.FillStats()
    got = K.extd2_fill_batch(meta, qb, tb, prm, "cpu", stats=st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm,
                                            ksw2.KSW_EZ_APPROX_MAX,
                                            ksw2.extd2)) == 0
    assert (st.fills, st.device_fills, st.host_fills) == (4, 2, 2)
    assert st.cells == 280 * 300 + 100 * 90
    gate = K.fill_params_from(ksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1)
    assert gate.mat_gate
    st = K.FillStats()
    got = K.extd2_fill_batch(meta, qb, tb, gate, "cpu", stats=st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, gate,
                                            ksw2.KSW_EZ_APPROX_MAX,
                                            ksw2.extd2)) == 0
    assert (st.device_fills, st.host_fills) == (0, 4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    z8 = torch.zeros(4, dtype=torch.uint8)
    i64 = torch.zeros(1, dtype=torch.int64)
    i32 = torch.ones(1, dtype=torch.int32)
    _io, mo = O.set_preset(None)
    prm = K.fill_params(mo)
    with pytest.raises(ValueError, match="qlen"):
        K.extd2_fill(z8, z8, i64, i64, i64, i32, i32, i64, 64, prm, False)
    gate = K.fill_params_from(ksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1)
    with pytest.raises(ValueError, match="host route"):
        K.extd2_fill(z8, z8, i64, i64, i32, i32, i32, i64, 64, gate, False)
    with pytest.raises(ValueError, match="cig_off"):
        K.ksw2_backtrack(z8, i64, i32, i32, i32, i64, False)
    with pytest.raises(ValueError, match="unsupported flag"):
        K.extd2_fill_batch(np.zeros((0, 4), np.int64), z8.numpy(),
                           z8.numpy(), prm, "cpu", ksw2.KSW_EZ_EXTZ_ONLY)


def test_chunks_split_by_budget(monkeypatch):
    """A small chunk budget splits the batch into several launches of
    the twins; the results do not change."""
    from mm2_gb_tpu_torch.utils import gpucfg
    name, meta, qb, tb, prm, flag = WORKLOADS[0]
    want = fill_oracle(meta, qb, tb, prm, flag, ksw2.extd2)
    monkeypatch.setattr(gpucfg, "CPU_FILL_CHUNK_BYTES", 40_000)
    st = K.FillStats()
    got = K.extd2_fill_batch(meta, qb, tb, prm, "cpu", flag, st)
    assert st.chunks > 2
    assert fill_result_err(got, want) == 0


def _map_paf(tmp_path, align):
    """PAF lines of a small seeded read set through the port's pipeline
    on CPU tensors, -c, with or without --gpu-align."""
    from mm2_gb_tpu_torch.models import pipeline as gp
    from mm2_gb_tpu_torch.models.index import MinimizerIndex
    from mm2_gb_tpu_torch.utils.simulate import (random_reference,
                                                 simulate_readset)
    ref = random_reference(40_000, seed=41)
    reads = simulate_readset(ref, 4, 1_500, 3_000, seed=42)
    path = tmp_path / "q.fa"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    io_, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG
    if align:
        mo.flag |= O.MM_F_TPU_ALIGN
    index = MinimizerIndex.from_strings([ref], io_, names=["c"])
    O.mapopt_update(mo, index)
    return list(gp.map_file_gpu(index, mo, [str(path)], device="cpu"))


def test_real_pass_reads_the_device_table(tmp_path, monkeypatch):
    """Adding 1 to every device score changes the PAF: the real pass
    takes the port's results from the C++ table and does not recompute
    them."""
    base = _map_paf(tmp_path, align=False)
    assert base and _map_paf(tmp_path, align=True) == base
    batch = K.extd2_fill_batch
    seen = []

    def poisoned(*a, **kw):
        scores, cig_off, cig_blob = batch(*a, **kw)
        seen.append(scores.shape[0])
        return scores + 1, cig_off, cig_blob
    monkeypatch.setattr(K, "extd2_fill_batch", poisoned)
    bad = _map_paf(tmp_path, align=True)
    assert seen and seen[0] > 0
    assert bad != base


def test_fill_chunk_budget_from_free_memory(monkeypatch):
    """The fill chunk budget is the measured constant on a card with
    room, a quarter of free memory on one without; the CPU twins take
    their own smaller budget."""
    from mm2_gb_tpu_torch.utils import gpucfg
    free = [40 << 30]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free[0], 80 << 30))
    cuda = torch.device("cuda")
    assert gpucfg.fill_chunk_bytes(cuda) == gpucfg.FILL_CHUNK_BYTES
    free[0] = 1 << 30
    assert gpucfg.fill_chunk_bytes(cuda) == (1 << 30) // 4 \
        < gpucfg.FILL_CHUNK_BYTES
    free[0] = 1 << 10
    assert gpucfg.fill_chunk_bytes(cuda) == 1 << 20
    assert gpucfg.fill_chunk_bytes(torch.device("cpu")) \
        == gpucfg.CPU_FILL_CHUNK_BYTES


# --------------------------------------------------------------------------
# The gap-fill kernel's cell update in 16-bit lanes (extd2_kernel.cu: cell2
# and the word loop of extd2_one), step by step in NumPy, against the
# oracle's own row: extd2's loop body in the port's ops/ksw2.py, run on the
# same state.  Every output byte (u, v, x, y, x2, y2, the score row) and
# every direction byte, under KSW_EZ_RIGHT and without.
# --------------------------------------------------------------------------

def _prmt(a, b, sel, sign=False):
    """prmt.b32 of words a, b (uint32 arrays) with selector sel; sign:
    bit 3 of a selector nibble replicates the byte's sign (__byte_perm's
    selectors here leave it 0)."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(
        a, np.uint64)
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(src, sel).shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        byte = (src >> ((nib & np.uint64(7)) * np.uint64(8))) & np.uint64(255)
        if sign:
            byte = np.where(nib & np.uint64(8),
                            np.where(byte & np.uint64(128), 255, 0), byte)
        out |= np.asarray(byte, np.uint64) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _u32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32)


def _halves(a):
    a = np.asarray(a, np.int64)
    lo, hi = a & 0xFFFF, (a >> 16) & 0xFFFF
    return (np.where(lo >= 0x8000, lo - 0x10000, lo),
            np.where(hi >= 0x8000, hi - 0x10000, hi))


def _join(lo, hi):
    return _u32((lo & 0xFFFF) | ((hi & 0xFFFF) << 16))


def _add_s16x2(a, b):   # PTX add.s16x2: each half wraps
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(al + bl, ah + bh)


def _max_s16x2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.maximum(al, bl), np.maximum(ah, bh))


def _min_s16x2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.minimum(al, bl), np.minimum(ah, bh))


def _add32(*xs):   # 32-bit adds: the low lane's carry reaches the high lane
    return _u32(sum(np.asarray(x, np.int64) for x in xs))


def _neg(x):
    return -np.asarray(x, np.int64)


def _lane2(v, g):
    return _u32(((int(v) & 0xFF) << 8 | g) * 0x10001)


# by KSW_EZ_RIGHT: the candidates' tags (fill_consts), the aux byte of q
# and q2 and the zero lane (CellTags)
CELL_TAGS = {True: (dict(s=0, x=1, y=2, x2=3, y2=4), 0xC0, 0x00400040),
             False: (dict(s=7, x=6, y=5, x2=4, y2=3), 0x40, 0x00C000C0)}


def _cell2(s, x, v, x2, u, y, y2, k, right):
    """cell2<RIGHT>: one register of two 16-bit lanes, each step as the
    kernel takes it: (z before the min, u, v, x, y, x2, y2)."""
    zero = CELL_TAGS[right][2]
    z = _max_s16x2(_add_s16x2(x, v), s)   # __viaddmax_s16x2
    z = _max_s16x2(_add_s16x2(y, u), z)
    z = _max_s16x2(_add_s16x2(x2, v), z)
    z = _max_s16x2(_add_s16x2(y2, u), z)
    zm = _min_s16x2(z, k["m0"])
    nq, nq2 = _add32(k["q"], _neg(zm)), _add32(k["q2"], _neg(zm))
    qe, qe2 = _neg(k["qe"]), _neg(k["qe2"])
    return (z, _add32(zm, _neg(v), 0x10000), _add32(zm, _neg(u), 0x10000),
            _add32(_max_s16x2(_add32(x, v, nq), zero), qe),
            _add32(_max_s16x2(_add32(y, u, nq), zero), qe),
            _add32(_max_s16x2(_add32(x2, v, nq2), zero), qe2),
            _add32(_max_s16x2(_add32(y2, u, nq2), zero), qe2))


def _words(a, at):
    """The 32-bit words of byte array a at byte offsets at (clipped)."""
    at = np.clip(at, 0, a.shape[0] - 4)
    b = np.asarray(a).view(np.uint8).astype(np.uint32)
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16 | b[at + 3] << 24


def _put(a, at, w):
    b = a.view(np.uint8)
    for i in range(4):
        b[at + i] = (w >> np.uint32(8 * i)) & np.uint32(255)


def _bcast(v):
    return np.uint32((int(v) & 0xFF) * 0x01010101)


def _pick(m, a, b):
    return (b & m) | (a & ~m)


def _kernel_row(st8, tb, qr, r, qlen, win, last, bv, prm, right):
    """extd2_one's row r (fill mode) over the words of [st, last]:
    st8 holds the int8 arrays S, U, Y, Y2, and XP, VP, X2P (the previous
    row's x, v, x2); the current row's x, v, x2 go to XC, VC, X2C.  tb:
    the staged target, qr: the staged reversed query.  Returns the
    direction bytes of [st, en]."""
    st, en, st0, en0 = win
    last_st, last_en = last
    tag, q_aux, _zero = CELL_TAGS[right]
    qq, ee, qq2, ee2 = prm.qq, prm.ee, prm.qq2, prm.ee2
    k = dict(m0=_lane2(prm.mat0, 0), q=_lane2(qq, q_aux),
             q2=_lane2(qq2, q_aux), qe=_lane2(qq + ee, 0),
             qe2=_lane2(qq2 + ee2, 0))
    nqe, nqe2 = (-qq - ee) & 0xFF, (-qq2 - ee2) & 0xFF
    S, U, Y, Y2 = st8["S"], st8["U"], st8["Y"], st8["Y2"]
    XP, VP, X2P = st8["XP"], st8["VP"], st8["X2P"]
    x1, x21, v1 = nqe, nqe2, nqe
    if st > 0:
        if last_st <= st - 1 <= last_en:
            x1, x21, v1 = (int(a[st - 1]) & 0xFF for a in (XP, X2P, VP))
    else:
        v1 = bv & 0xFF
    nbytes = S.shape[0]
    hi = min(st0 + 16 * ((en0 - st0) // 16 + 1), nbytes)
    t0 = np.arange(st, max(en, hi - 1) + 1, 4)
    # the score row: a prmt lookup of each lane's index
    lo_f, hi_f = st0 - t0, hi - t0
    fresh = sum(np.where((i >= lo_f) & (i < hi_f), 0xFF << (8 * i), 0)
                for i in range(4)).astype(np.uint32)
    z = _words(S, t0)
    t_b = _words(tb, t0)
    k0 = 16 + qlen - 1 - r + t0   # kQPad + qlen - 1 - r + t0
    w0 = k0 & ~3
    q64 = (_words(qr, w0).astype(np.uint64)
           | _words(qr, w0 + 4).astype(np.uint64) << np.uint64(32))
    q_b = (q64 >> (8 * (k0 - w0)).astype(np.uint64)).astype(np.uint32)
    ix = (t_b ^ q_b) | ((t_b | q_b) & np.uint32(0x04040404))
    sel = _prmt(ix + (ix >> np.uint32(4)), 0, 0x20)
    sc_lo = np.uint32((prm.mat0 & 0xFF) | (int(_bcast(prm.mat1)) << 8
                                           & 0xFFFFFFFF))
    z = np.where(fresh != 0,
                 _pick(fresh, z, _prmt(sc_lo, _bcast(prm.sc_n), sel)), z)
    for at, w in zip(t0[fresh != 0], z[fresh != 0]):
        _put(S, at, np.uint32(w))
    # the window's words
    keep = t0 <= en
    t0, z = t0[keep], z[keep]
    shifted = {}
    for name, a, b1 in (("x", XP, x1), ("v", VP, v1), ("x2", X2P, x21)):
        cur = _words(a, t0)
        shifted[name] = np.where(
            t0 == st, _u32((cur.astype(np.int64) << 8) | b1),
            _prmt(_words(a, t0 - 4), cur, 0x6543))
    ut, yt, y2t = _words(U, t0), _words(Y, t0), _words(Y2, t0)
    if en >= r:   # lane r restarts
        at = (r >= t0) & (r < t0 + 4)
        m = np.where(at, _u32(0xFF << (8 * np.clip(r - t0, 0, 3))), 0
                     ).astype(np.uint32)
        ut = _pick(m, ut, _bcast(bv))
        yt = _pick(m, yt, _bcast(nqe))
        y2t = _pick(m, y2t, _bcast(nqe2))
    halves = []
    for sel in (0x2404, 0x3414):   # lanes_e, lanes_o
        ln = (lambda w, g: _prmt(w, g, sel))
        halves.append(_cell2(ln(z, tag["s"]), ln(shifted["x"], tag["x"]),
                             ln(shifted["v"], 0), ln(shifted["x2"], tag["x2"]),
                             ln(ut, 0), ln(yt, tag["y"]), ln(y2t, tag["y2"]),
                             k, right))
    e, o = halves
    for i, a in enumerate(("U", "VC", "XC", "Y", "X2C", "Y2"), start=1):
        j = (1, 2, 3, 4, 5, 6)[i - 1]
        w = _prmt(e[j], o[j], 0x7351)
        for at, wv in zip(t0, w):
            _put(st8[a], at, wv)
    tg = _prmt(e[0], o[0], 0x6240)
    sg = [_prmt(e[j], o[j], 0xEAC8, sign=True) for j in (3, 4, 5, 6)]
    bits = [0x08080808, 0x10101010, 0x20202020, 0x40404040]
    if right:
        d = tg
        for s_, b in zip(sg, bits):
            d = d | (s_ & np.uint32(b))
    else:
        d = ~tg & np.uint32(0x07070707)
        for s_, b in zip(sg, bits):
            d = d | (~s_ & np.uint32(b))
    return np.ascontiguousarray(d.astype(np.uint32)).view(np.uint8)


def _oracle_row_block():
    """The row of ops/ksw2.py's extd2, from the boundary values to the
    direction bytes, as source to run on a given state."""
    import inspect
    import textwrap

    from mm2_gb_tpu_torch.ops import ksw2 as pk2
    lines = inspect.getsource(pk2.extd2).splitlines()
    a = next(i for i, ln in enumerate(lines) if ln.strip() == "if st > 0:")
    b = next(i for i, ln in enumerate(lines)
             if ln.strip() == "off[r], off_end[r] = st, en")
    return compile(textwrap.dedent("\n".join(lines[a:b + 1])),
                   "ksw2.extd2 row", "exec"), pk2


def _cell_presets():
    """Every preset of utils/opts (aliases once) whose scoring the card
    takes (mat_gate False)."""
    names = [None, "ava-ont", "map-pb", "ava-pb", "map-hifi", "asm5", "asm10",
             "asm20", "sr", "splice", "splice:hq"]
    return [p for p in names
            if not K.fill_params(O.set_preset(p)[1]).mat_gate]


@pytest.mark.parametrize("preset", _cell_presets(),
                         ids=lambda p: p or "map-ont")
def test_cell_update_in_16bit_lanes_matches_oracle_row(preset):
    """The kernel's word loop on random rows: the scenario draws a fill
    shape, a band and a row r (so the 16-aligned window, the score store
    span past en0, the boundary lane st - 1 read from the previous row
    or not, the reset lane r and bound_v's four cases), bases with N, and
    the state: half the rows draw every int8 value (every value any
    state word can reach, and the ones past that, where the casts wrap),
    half the values of a real fill (u, v in [-qe, m0 + qe], x, y in [-qe,
    -e], x2, y2 in [-qe2, -e2], scores 0 and the matrix's), where ties
    between the candidates are frequent.  The rows' u, y, y2, score row,
    x, v, x2 and direction bytes equal the oracle's, under KSW_EZ_RIGHT
    and without."""
    code, pk2 = _oracle_row_block()
    prm = K.fill_params(O.set_preset(preset)[1])
    qq, ee, qq2, ee2 = prm.qq, prm.ee, prm.qq2, prm.ee2
    lt, ld = prm.long_thres, prm.long_diff
    bound_v = (lambda r: -qq - ee if r == 0 else -ee if r < lt
               else ld if r == lt else -ee2)
    seen = {n: np.zeros(256, bool) for n in ("s", "x", "v", "x2", "u", "y",
                                             "y2")}
    for right in (False, True):
        rng = np.random.default_rng(9_000 + 2 * _cell_presets().index(preset)
                                    + right)
        cases = bound_cases = 0
        while cases < 80:
            tlen, qlen = (int(x) for x in rng.integers(1, 700, 2))
            w = int(rng.choice([-1, -1, 16, 51, 200]))
            w = max(qlen, tlen) if w < 0 else w
            r = int(rng.choice([0, 1, lt, lt + 1,
                                int(rng.integers(0, qlen + tlen - 1))]))
            if r > qlen + tlen - 2:
                continue
            win = pk2._row_window(r, qlen, tlen, w, w)
            if win is None:
                continue
            st, en, st0, en0 = win
            nbytes = (tlen + 15) // 16 * 16 + 16   # the store span fits
            full = cases % 2 == 0
            if full:
                draw = {n: rng.integers(-128, 128, nbytes) for n in
                        ("S", "U", "Y", "Y2", "XP", "VP", "X2P")}
            else:
                box = lambda lo, hi: rng.integers(lo, hi + 1, nbytes)
                draw = dict(U=box(-qq - ee, prm.mat0 + qq + ee),
                            VP=box(-qq - ee, prm.mat0 + qq + ee),
                            Y=box(-qq - ee, -ee), XP=box(-qq - ee, -ee),
                            Y2=box(-qq2 - ee2, -ee2), X2P=box(-qq2 - ee2, -ee2),
                            S=rng.choice([0, prm.mat0, prm.mat1, prm.sc_n],
                                         nbytes))
            st8 = {n: np.asarray(a, np.int64).astype(np.int8)
                   for n, a in draw.items()}
            for n in ("XC", "VC", "X2C"):
                st8[n] = rng.integers(-128, 128, nbytes).astype(np.int8)
            tseq = rng.integers(0, 4, tlen).astype(np.uint8)
            qseq = rng.integers(0, 4, qlen).astype(np.uint8)
            tseq[rng.random(tlen) < 0.08] = 4
            qseq[rng.random(qlen) < 0.08] = 4
            last = (st - 16 * int(rng.integers(0, 2)),
                    en - 16 * int(rng.integers(0, 3)))
            bound_cases += st > 0 and last[0] <= st - 1 <= last[1]
            # the oracle's row on copies of the state
            smem = np.zeros(nbytes * 2 + (qlen + 15) // 16 * 16 + 16, np.int8)
            smem[:nbytes] = st8["S"]
            smem[nbytes:nbytes + tlen] = tseq.view(np.int8)
            smem[2 * nbytes:2 * nbytes + qlen] = qseq[::-1].view(np.int8)
            ns = dict(np=np, _shift1=pk2._shift1, _row_scores=pk2._row_scores,
                      KSW_EZ_RIGHT=pk2.KSW_EZ_RIGHT, smem=smem, s=smem[:nbytes],
                      sf_off=nbytes, qr_off=2 * nbytes, r=r, qlen=qlen,
                      st=st, en=en, st0=st0, en0=en0, last_st=last[0],
                      last_en=last[1], bound_v=bound_v, q=qq, e=ee, q2=qq2,
                      e2=ee2, qe=qq + ee, mat0=prm.mat0, mat1=prm.mat1,
                      sc_N=prm.sc_n, with_cigar=True,
                      flag=pk2.KSW_EZ_RIGHT if right else 0,
                      u=st8["U"].copy(), y=st8["Y"].copy(),
                      y2=st8["Y2"].copy(), x=st8["XP"].copy(),
                      v=st8["VP"].copy(), x2=st8["X2P"].copy(),
                      n_col=en - st + 1, p_rows={},
                      off=np.zeros(r + 1, np.int64),
                      off_end=np.zeros(r + 1, np.int64))
            exec(code, ns)
            # the kernel's row, on its staged target and reversed query
            tb = np.zeros(nbytes, np.uint8)
            tb[:tlen] = tseq
            qr = np.zeros((qlen + 16 + 32 + 15) & ~15, np.uint8)
            qr[16:16 + qlen] = qseq[::-1]
            kin = {n: a.copy() for n, a in st8.items()}
            d = _kernel_row(kin, tb, qr, r, qlen, win, last, bound_v(r), prm,
                            right)
            sl = slice(st, en + 1)
            assert np.array_equal(kin["S"], ns["s"])
            for kn, on in (("U", "u"), ("Y", "y"), ("Y2", "y2")):
                assert np.array_equal(kin[kn], ns[on]), kn
            for kn, on in (("XC", "x"), ("VC", "v"), ("X2C", "x2")):
                assert np.array_equal(kin[kn][sl], ns[on][sl]), kn
            assert np.array_equal(d, ns["p_rows"][r]), (preset, right, r)
            for n, a in (("s", ns["s"]), ("x", st8["XP"]), ("v", st8["VP"]),
                         ("x2", st8["X2P"]), ("u", st8["U"]), ("y", st8["Y"]),
                         ("y2", st8["Y2"])):   # the values the window reads
                seen[n][a[max(st - 1, 0):en + 1].view(np.uint8)] = True
            cases += 1
        assert bound_cases > 0
    # every int8 value of the six state words; the score row's values
    # are the matrix's (and 0 before a row stores) besides the stale
    # lanes [st, st0), which read the drawn ones
    assert all(seen[n].all() for n in ("x", "v", "x2", "u", "y", "y2"))
    assert seen["s"][np.array([0, prm.mat0, prm.mat1, prm.sc_n]) & 0xFF].all()
