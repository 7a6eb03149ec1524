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
