"""The port's CUDA kernels on the card (`gpu` marker; skips without CUDA).

Run on a machine with a GPU:
    python -m pytest tests/test_torch_gpu.py -m gpu -q
This file imports no JAX, so it runs where only PyTorch is installed.
Each kernel must equal its plain PyTorch twin and the host oracle
element for element (tolerance 0: scores, predecessors, direction bytes
and CIGAR words are integers).
"""

import gzip
import os

import numpy as np
import pytest
import torch

from chip_smoke import (ext_oracle, ext_result_err, ext_workloads,
                        fill_oracle, fill_result_err, fill_workloads,
                        hold_ext_calls, hold_fill_calls, hold_splice_calls,
                        hold_splice_ext_calls, kernel_operands,
                        recording_ext, recording_fills, recording_splice,
                        recording_splice_ext, splice_ext_oracle,
                        splice_ext_workloads, splice_oracle, splice_workloads,
                        workloads)
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu, ksw2s_gpu
from mm2_gb_tpu_torch.ops.chain import _chain_dp_scores
from mm2_gb_tpu_torch.utils.hashkit import mg_log2

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

WORKLOADS = list(workloads())
FILLS = list(fill_workloads(n_pairs=32, max_len=400, long_len=4800))
SPLICE = list(splice_workloads(n_pairs=24, max_intron=1000,
                               long_intron=8000, n_long=3))
EXTS = list(ext_workloads(n_pairs=32, max_len=400))
SPLICE_EXTS = list(splice_ext_workloads(n_pairs=24, max_intron=600))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name,ax,ay,a", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_kernel_matches_twin_and_oracle(cuda, name, ax, ay, a):
    bounds = np.array([0, ax.shape[0]], np.int64)
    ops, kw, _ = kernel_operands(ax, ay, bounds, a, cuda)
    before = chain_gpu.launches
    f, p = chain_gpu.chain_segments(*ops, **kw)
    ft, pt = chain_gpu.chain_segments_torch(*ops, **kw)
    torch.cuda.synchronize()
    assert chain_gpu.launches == before + 1
    assert torch.equal(f, ft) and torch.equal(p, pt)
    fo, po = _chain_dp_scores(ax, ay, kw["max_dist_x"], kw["max_dist_y"],
                              a["bw"], 2**31 - 1, a["max_iter"],
                              np.float32(a["cg"]), np.float32(a["cs"]),
                              a["is_cdna"], 1)
    assert np.array_equal(f.cpu().numpy(), fo)
    prel = p.cpu().numpy().astype(np.int64)
    assert np.array_equal(np.where(prel > 0, np.arange(prel.shape[0]) - prel,
                                   -1), po)


def test_a_batch_without_segments_on_the_card(cuda):
    """A batch whose anchors make no segment (a part of a multi-part index
    can give one) collects on the card: every anchor keeps its span and
    no predecessor, and no launch is made (the wrapper used to return
    before its launch with its timing events unrecorded, and collect
    raised)."""
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
    ax = np.arange(4, dtype=np.uint64) * np.uint64(20_000)
    ay = (np.uint64(15) << np.uint64(32)) | np.arange(4, dtype=np.uint64)
    met = GpuMetrics()
    before = chain_gpu.launches
    f, p = chain_gpu.dispatch_scores(
        ax, ay, np.array([0, 1, 3, 4], np.int64), 5000, 5000, 500, 5000,
        0.12, 0.0, metrics=met, device=cuda).collect()
    assert chain_gpu.launches == before
    assert f.tolist() == [15] * 4 and p.tolist() == [-1] * 4


@pytest.mark.parametrize("seed", [1020, 1063, 2126, 2230])
def test_the_fuzz_seeds_the_card_found(cuda, seed, tmp_path):
    """The seeds on which the port's fuzzer found the card's run apart
    from the JAX package's host path (RMQ chaining, an HPC batch, a part
    of a multi-part index without a segment, -T), each against that
    host path in a subprocess, byte for byte, with its drawn flags."""
    import io

    from mm2_gb_tpu_torch.tools import fuzz_diff
    out = io.StringIO()
    c = fuzz_diff.campaign([seed], cuda, str(tmp_path), out=out)
    assert not c.failed, out.getvalue()


def test_mg_log2_kernel_bits(cuda):
    dd = np.concatenate([np.arange(1, 4096),
                         np.random.default_rng(0).integers(1, 2**24, 5000)])
    x = (dd + 1).astype(np.float32)
    got = chain_gpu.mg_log2_kernel(torch.from_numpy(x).to(cuda))
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          mg_log2(x).view(np.uint32))


@pytest.mark.parametrize("flags,ref,query,golden", [
    ([], "simref.fa.gz", "simreads.fa.gz", "sim200.skipinf.paf.gz"),
    (["--cs", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz"),
    (["-x", "splice", "-c"], "splice_genome.fa.gz", "splice_reads.fa.gz",
     "splice40.skipinf.c.paf.gz"),
    (["-x", "ava-ont"], "simreads.fa.gz", "simreads.fa.gz",
     "ava.skipinf.paf.gz"),
], ids=["sim200", "sim200_cs_c", "splice40_is_cdna", "ava_ont"])
def test_gpu_chain_cli_matches_golden(cuda, flags, ref, query, golden,
                                      capsys):
    from mm2_gb_tpu_torch.cli import main
    before = chain_gpu.launches
    rc = main(["--gpu-chain", "--max-chain-skip=2147483647", *flags,
               os.path.join(GOLDEN, ref), os.path.join(GOLDEN, query)])
    assert rc == 0
    assert chain_gpu.launches > before
    with gzip.open(os.path.join(GOLDEN, golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


@pytest.mark.parametrize("name,meta,qb,tb,prm,flag", FILLS,
                         ids=[w[0] for w in FILLS])
def test_fill_kernels_match_twins_and_oracle(cuda, name, meta, qb, tb, prm,
                                             flag):
    before = ksw2_gpu.fill_launches
    st = ksw2_gpu.FillStats()
    with recording_fills() as calls:
        got = ksw2_gpu.extd2_fill_batch(meta, qb, tb, prm, cuda, flag, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag)) == 0
    assert ksw2_gpu.fill_launches == before + len(calls)
    assert (len(calls) > 0) == (st.device_fills > 0)
    assert hold_fill_calls(calls, name, verbose=False)[0] == 0


@pytest.mark.parametrize("flags,ref,query,golden", [
    (["--cs", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz"),
    (["-x", "map-hifi", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.map-hifi.c.paf.gz"),
    (["-f", "0.0002,50", "-c"], "rep60.fa.gz", "rep60_q.fa.gz",
     "rep60.maxocc.c.paf.gz"),
    (["--alt", os.path.join(GOLDEN, "alt.txt"), "-c"], "altref.fa.gz",
     "simreads.fa.gz", "alt200.c.paf.gz"),
    (["-c"], "invq4.ref.fa.gz", "invq4.q.fa.gz", "invq4.skipinf.c.paf.gz"),
    *[(["-x", p, "-c"], "simref.fa.gz", "simreads.fa.gz",
       f"sim200.{p}.c.paf.gz") for p in ("asm5", "asm10", "asm20")],
], ids=["sim200_cs_c", "map_hifi_c", "rep60_max_occ", "alt200", "invq4",
        "asm5_c", "asm10_c", "asm20_c"])
def test_gpu_align_cli_matches_golden(cuda, flags, ref, query, golden,
                                      capsys):
    from mm2_gb_tpu_torch.cli import main
    before = ksw2_gpu.fill_launches, ksw2_gpu.backtrack_launches
    rc = main(["--gpu-chain", "--gpu-align", "--max-chain-skip=2147483647",
               *flags, os.path.join(GOLDEN, ref), os.path.join(GOLDEN, query)])
    assert rc == 0
    assert ksw2_gpu.fill_launches > before[0]
    assert ksw2_gpu.backtrack_launches > before[1]
    with gzip.open(os.path.join(GOLDEN, golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


@pytest.mark.parametrize("name,meta,qb,tb,jb,fl,prm", SPLICE,
                         ids=[w[0] for w in SPLICE])
def test_splice_kernels_match_twins_and_oracle(cuda, name, meta, qb, tb, jb,
                                               fl, prm):
    before = ksw2s_gpu.fill_launches
    st = ksw2_gpu.FillStats()
    with recording_splice() as calls:
        got = ksw2s_gpu.exts2_fill_batch(meta, qb, tb, jb, fl, prm, cuda, st)
    assert fill_result_err(got, splice_oracle(meta, qb, tb, jb, fl,
                                              prm)) == 0
    assert ksw2s_gpu.fill_launches == before + len(calls)
    assert (len(calls) > 0) == (st.device_fills > 0)
    assert hold_splice_calls(calls, name, verbose=False)[0] == 0


@pytest.mark.parametrize("flags,ref,query,golden", [
    (["-c"], "splice_genome.fa.gz", "splice_reads.fa.gz",
     "splice40.skipinf.c.paf.gz"),
    (["--junc-bed", os.path.join(GOLDEN, "splice.bed.gz"), "-c"],
     "splice_genome.fa.gz", "splice_reads.fa.gz",
     "splice40.juncbed.c.paf.gz"),
    (["-G", "8000", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.splice-G8k.c.paf.gz"),
], ids=["splice40", "splice40_juncbed", "sim200_G8k"])
def test_gpu_align_splice_cli_matches_golden(cuda, flags, ref, query, golden,
                                             capsys):
    from mm2_gb_tpu_torch.cli import main
    before = ksw2s_gpu.fill_launches, ksw2_gpu.backtrack_launches
    rc = main(["--gpu-chain", "--gpu-align", "--max-chain-skip=2147483647",
               "-x", "splice", *flags, os.path.join(GOLDEN, ref),
               os.path.join(GOLDEN, query)])
    assert rc == 0
    assert ksw2s_gpu.fill_launches > before[0]
    assert ksw2_gpu.backtrack_launches > before[1]
    with gzip.open(os.path.join(GOLDEN, golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


@pytest.mark.parametrize("name,meta,qb,tb,zd,prm,flag,eb", EXTS,
                         ids=[w[0] for w in EXTS])
def test_ext_kernels_match_twins_and_oracle(cuda, name, meta, qb, tb, zd, prm,
                                            flag, eb):
    before = ksw2_gpu.ext_launches, ksw2_gpu.start_backtrack_launches
    st = ksw2_gpu.FillStats()
    with recording_ext() as calls:
        got = ksw2_gpu.extd2_ext_batch(meta, qb, tb, zd, prm, flag, eb, cuda,
                                       st)
    assert ext_result_err(got, ext_oracle(meta, qb, tb, zd, prm, flag,
                                          eb)) == 0
    assert ksw2_gpu.ext_launches == before[0] + len(calls)
    assert ksw2_gpu.start_backtrack_launches == before[1] + len(calls)
    assert (len(calls) > 0) == (st.ext_fills > st.ext_host_fills)
    assert hold_ext_calls(calls, name, verbose=False)[0] == 0


@pytest.mark.parametrize("flags,golden", [
    (["--qstrand", "-c"], "sim200.qstrand.c.paf.gz"),
    (["--print-aln-seq", "--cs", "-c"], "sim200.skipinf.cs.paf.gz")],
    ids=["qstrand", "print_aln_seq"])
def test_gpu_align_python_session_matches_golden(cuda, flags, golden,
                                                 capsys):
    """The routes of the Python fill session: gap fills and extensions
    on the card, the reference's bytes."""
    from mm2_gb_tpu_torch.cli import main
    before = ksw2_gpu.fill_launches, ksw2_gpu.ext_launches
    rc = main(["--gpu-chain", "--gpu-align", "--max-chain-skip=2147483647",
               *flags, os.path.join(GOLDEN, "simref.fa.gz"),
               os.path.join(GOLDEN, "simreads.fa.gz")])
    assert rc == 0
    assert ksw2_gpu.fill_launches > before[0]
    assert ksw2_gpu.ext_launches > before[1]
    with gzip.open(os.path.join(GOLDEN, golden), "rt") as f:
        assert capsys.readouterr().out == f.read()


@pytest.mark.parametrize("name,meta,qb,tb,jb,fl,zd,prm", SPLICE_EXTS,
                         ids=[w[0] for w in SPLICE_EXTS])
def test_splice_ext_kernels_match_twins_and_oracle(cuda, name, meta, qb, tb,
                                                   jb, fl, zd, prm):
    """The exts2 kernel's extension mode and the intron backtrack from its
    starts: equal to the twins and ksw2_splice.exts2 (every Extz field,
    the CIGAR), the global-scratch ring among them."""
    before = ksw2s_gpu.ext_launches, ksw2_gpu.start_backtrack_launches
    st = ksw2_gpu.FillStats()
    with recording_splice_ext() as calls:
        got = ksw2s_gpu.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, cuda,
                                        st)
    assert ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl, zd,
                                                 prm)) == 0
    assert ksw2s_gpu.ext_launches == before[0] + len(calls)
    assert ksw2_gpu.start_backtrack_launches == before[1] + len(calls)
    assert (len(calls) > 0) == (st.ext_fills > st.ext_host_fills)
    assert (st.scratch_fills > 0) == (name == "long")
    assert hold_splice_ext_calls(calls, name, verbose=False)[0] == 0


@pytest.mark.parametrize("flags,golden", [
    ([], "sim200.skipinf.paf.gz"),
    (["--gpu-align", "--cs", "-c"], "sim200.skipinf.cs.paf.gz")],
    ids=["chain", "align"])
def test_two_devices_on_one_card(cuda, flags, golden):
    """parallel.mesh.map_file_multichip over [cuda:0, cuda:0]: two shards
    on two streams of one card give the golden bytes of one device."""
    import io
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.models.index import MinimizerIndex
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
    from mm2_gb_tpu_torch.parallel.mesh import map_file_multichip
    from mm2_gb_tpu_torch.utils import opts as O
    argv, args = cli.parse_args(["--max-chain-skip=2147483647", *flags,
                                 "r.fa", "q.fa"])
    io_, mo = O.set_preset(None)
    cli.apply_overrides(args, io_, mo)
    index = MinimizerIndex.from_fasta(os.path.join(GOLDEN, "simref.fa.gz"),
                                      io_)
    O.mapopt_update(mo, index)
    met, out = GpuMetrics(), io.StringIO()
    before = chain_gpu.launches
    for sr, regs in map_file_multichip(
            index, mo, [os.path.join(GOLDEN, "simreads.fa.gz")],
            [cuda, cuda], met, 2):
        cli.res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len, False,
                         None, 0, 1, [regs])
    assert chain_gpu.launches == before + met.n_dispatch
    assert met.n_dispatch == 2 * met.n_batches
    with gzip.open(os.path.join(GOLDEN, golden), "rt") as f:
        assert out.getvalue() == f.read()


def _splice_mix(rng):
    """Splice fills on both sides of the fill kernel's warp/block class
    boundary (rings of WARP_RING lanes: min(qlen, tlen) 176), to go into
    one launch: queries of 10 to 400 bases, two exons around an intron
    of 300-3000 bases (GT..AG, or GA..TG under REV_CIGAR), every flag
    variant, N bases in every third, BED junction bytes in every
    other."""
    from chip_smoke import SPLICE_VARIANTS, _mutate_splice
    fills = []
    for k, ql in enumerate([10, 10, 12, 40, 150, 176, 177, 200, 260, 300,
                            400, 60, 10, 180, 90, 390]):
        flag = 0x08 | SPLICE_VARIANTS[k % len(SPLICE_VARIANTS)]
        a = int(rng.integers(1, ql)) if ql > 1 else 1
        ex = rng.integers(0, 4, ql).astype(np.uint8)
        intron = rng.integers(0, 4, int(rng.integers(300, 3000))
                              ).astype(np.uint8)
        rc = bool(flag & 0x80)
        intron[:2] = (2, 0) if rc else (2, 3)
        intron[-2:] = (3, 2) if rc else (0, 2)
        t = np.concatenate([ex[:a], intron, ex[a:]])
        q = _mutate_splice(rng, ex, 0.04, 0.02)
        if k % 3 == 0:
            q[rng.random(q.shape[0]) < 0.05] = 4
            t[rng.random(t.shape[0]) < 0.02] = 4
        junc = (rng.integers(0, 16, t.shape[0]).astype(np.uint8) if k % 2
                else None)
        fills.append((q, t, flag, junc))
    return fills


@pytest.mark.parametrize("in_scratch", [False, True],
                         ids=["shared", "scratch"])
def test_exts2_fill_warp_and_block_classes(cuda, monkeypatch, in_scratch):
    """The fill kernel on one launch that mixes warp-class fills (qlen 10)
    with block-class ones (min(qlen, tlen) past 176, and the longest):
    equal to the twins (scores, direction bytes, CIGARs) and to
    ksw2_splice.exts2, also with fill regions that are not 4-aligned;
    with the shared-memory cap at 0, every block-class fill keeps its
    rings in global scratch."""
    from chip_smoke import _pack_splice
    from mm2_gb_tpu_torch.utils import opts as O
    if in_scratch:
        monkeypatch.setattr(ksw2s_gpu, "FILL_SMEM_MAX", 0)
    prm = ksw2s_gpu.splice_params(O.set_preset("splice")[1])
    meta, qb, tb, jb, fl = _pack_splice(_splice_mix(
        np.random.default_rng(606)))
    st = ksw2_gpu.FillStats()
    with recording_splice() as calls:
        got = ksw2s_gpu.exts2_fill_batch(meta, qb, tb, jb, fl, prm, cuda, st)
    assert fill_result_err(got, splice_oracle(meta, qb, tb, jb, fl,
                                              prm)) == 0
    assert len(calls) == 1
    shape = ksw2s_gpu.fill_shape(calls[0][0][6].cpu().numpy(),
                                 calls[0][0][7].cpu().numpy())
    assert shape.n_block > 0 and shape.n_warp > 0
    assert (st.scratch_fills == shape.n_block) == in_scratch
    assert (st.scratch_fills > 0) == in_scratch
    assert hold_splice_calls(calls, "mix", verbose=False)[0] == 0
    # regions that are not 4-aligned take the kernel's byte stores
    fa = list(calls[0][0])
    fa[9], fa[10] = fa[9] + 1, fa[10] + 1
    sc, p = ksw2s_gpu.exts2_fill(*fa)
    sct, pt = ksw2s_gpu.exts2_fill_torch(*fa)
    assert torch.equal(sc, sct) and torch.equal(p, pt)


def _fill_operands(pairs, ws, cuda):
    """Device operands of gap fills (q, t) with bands ws: (qblob, tblob,
    qoff, toff, qlen, tlen, w, p_off, p_total, cig_off)."""
    ql = np.array([len(q) for q, _t in pairs], np.int64)
    tl = np.array([len(t) for _q, t in pairs], np.int64)
    w = np.asarray(ws, np.int64)
    wv = np.where(w < 0, np.maximum(ql, tl), w)
    pb = ksw2_gpu.p_bound(ql, tl, wv)

    def off(x):
        return torch.from_numpy(np.concatenate([[0], np.cumsum(x)])).to(cuda)
    blob = (lambda xs: torch.from_numpy(np.concatenate(xs).astype(np.uint8))
            .to(cuda))
    i32 = (lambda x: torch.from_numpy(x.astype(np.int32)).to(cuda))
    p_off = off(pb)
    return (blob([q for q, _t in pairs]), blob([t for _q, t in pairs]),
            off(ql)[:-1], off(tl)[:-1], i32(ql), i32(tl), i32(w),
            p_off[:-1], int(p_off[-1]), off(ql + tl))


@pytest.mark.parametrize("mode", ["genomic", "intron", "starts",
                                  "intron_starts"])
def test_backtrack_kernel_matches_twin(cuda, mode):
    """The backtrack kernel against ksw2_backtrack_torch on the same
    direction bytes, in its four modes (genomic fills, intron mode, from
    per-fill starts, intron mode from starts): walks of up to ~6,000
    steps (many tiles), banded fills whose walks meet off-band cells
    (forced states; starts anywhere in the matrix, most of them off a
    16-lane band), long tail deletions (N in intron mode), starts of -1,
    REV_CIGAR per fill."""
    from chip_smoke import _mutate_splice, _walk_steps, splice_pairs
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(["genomic", "intron", "starts",
                                 "intron_starts"].index(mode) + 71)
    intron = mode.startswith("intron")
    if intron:
        pairs, flags, junc = [], [], []
        for q, t, flag, j in splice_pairs(rng, 24, 3000):
            pairs.append((q, t))
            flags.append(flag)
            junc.append(np.zeros(0, np.uint8) if j is None else j)
        ws = [len(q) + len(t) for q, t in pairs]
        prm = ksw2s_gpu.splice_params(O.set_preset("splice")[1])
    else:
        pairs = []
        for k in range(24):
            t = rng.integers(0, 4, int(rng.integers(600, 3000))
                             ).astype(np.uint8)
            pairs.append((_mutate_splice(rng, t, 0.05, 0.02), t))
        ws = [(16, 51, 200, -1)[k % 4] for k in range(24)]
        keep = ~ksw2_gpu.band_collapses(
            [len(q) for q, _t in pairs], [len(t) for _q, t in pairs],
            [w if w >= 0 else max(len(q), len(t))
             for w, (q, t) in zip(ws, pairs)])
        pairs = [p for p, k in zip(pairs, keep) if k]
        ws = [w for w, k in zip(ws, keep) if k]
        prm = ksw2_gpu.fill_params(O.set_preset(None)[1])
    qb, tb, qo, to, ql, tl, w, po, p_total, co = _fill_operands(pairs, ws,
                                                               cuda)
    n = ql.shape[0]
    if intron:
        jl = np.array([len(j) for j in junc], np.int64)
        jo = torch.from_numpy(np.where(
            jl > 0, np.concatenate([[0], np.cumsum(jl)])[:-1], -1)).to(cuda)
        jb = torch.from_numpy(np.concatenate(junc)).to(cuda)
        fl = torch.tensor(flags, dtype=torch.int32, device=cuda)
        _sc, p = ksw2s_gpu.exts2_fill(qb, tb, jb, qo, to, jo, ql, tl, fl, po,
                                      p_total, prm)
        mil = prm.long_thres
    else:
        _sc, p = ksw2_gpu.extd2_fill(qb, tb, qo, to, ql, tl, w, po, p_total,
                                     prm, False)
        mil = 0
    starts = None
    if mode.endswith("starts"):
        i0 = (rng.random(n) * tl.cpu().numpy()).astype(np.int32)
        j0 = (rng.random(n) * ql.cpu().numpy()).astype(np.int32)
        i0[::5] = -1
        j0[2::7] = -1
        starts = torch.from_numpy(np.stack([i0, j0], 1)).to(cuda)
    rev = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    before = ksw2_gpu.backtrack_launches
    cg, nc = ksw2_gpu.ksw2_backtrack(p, po, ql, tl, w, co, rev, mil,
                                     starts=starts)
    cgt, nct = ksw2_gpu.ksw2_backtrack_torch(p, po, ql, tl, w, co, rev, mil,
                                             starts)
    torch.cuda.synchronize()
    assert ksw2_gpu.backtrack_launches == before + 1
    assert torch.equal(nc, nct) and torch.equal(cg, cgt)
    assert int(_walk_steps(cg, nc, co).max()) > 40 * 32   # 40 tiles
    if starts is not None:
        assert int((nc == 0).sum()) == int(((starts < 0).any(1)).sum()) > 0
    if intron:
        assert bool(((cg & 15) == 3).any())   # N runs


def _extd2_mix(rng):
    """Gap fills on both sides of the fill kernel's warp/block class
    boundary (WARP_LANES: tlen 512), to go into one launch: targets of 10
    to 1,500 bases against mutated copies of 60-120% of their length,
    bands 16 to the whole matrix (the whole matrix past 512), N bases in
    every third."""
    from chip_smoke import _mutate_splice
    pairs, ws = [], []
    for k, tl in enumerate([10, 40, 200, 300, 496, 497, 512, 513, 700, 1500,
                            90, 250, 60, 1200, 30, 480]):
        t = rng.integers(0, 4, tl).astype(np.uint8)
        q = _mutate_splice(rng, t, 0.05, 0.03)
        q = q[:max(1, int(tl * rng.uniform(0.6, 1.2)))].copy()
        if k % 3 == 0:
            q[rng.random(q.shape[0]) < 0.05] = 4
        pairs.append((q, t))
        ws.append(-1 if tl > 512 else (-1, 16, 51, 200)[k % 4])
    return pairs, ws


@pytest.mark.parametrize("right", [False, True], ids=["default", "right"])
@pytest.mark.parametrize("in_scratch", [False, True],
                         ids=["shared", "scratch"])
def test_extd2_fill_warp_and_block_classes(cuda, monkeypatch, right,
                                           in_scratch):
    """The gap-fill kernel on one launch that mixes warp-class fills (at
    most WARP_LANES lanes) with block-class ones (wider, and the
    longest), under KSW_EZ_RIGHT and without: equal to the twins (scores,
    direction bytes, CIGARs) and to ksw2.extd2, also with fill regions
    that are not 4-aligned; with the shared-memory cap at 0, every
    block-class fill keeps its state in global scratch."""
    from chip_smoke import _pack_fills
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
    if in_scratch:
        monkeypatch.setattr(ksw2_gpu, "FILL_SMEM_MAX", 0)
    prm = ksw2_gpu.fill_params(O.set_preset(None)[1])
    flag = ksw2.KSW_EZ_APPROX_MAX | (ksw2.KSW_EZ_RIGHT if right else 0)
    pairs, ws = _extd2_mix(np.random.default_rng(707 + right))
    meta, qb, tb = _pack_fills(pairs, ws)
    st = ksw2_gpu.FillStats()
    with recording_fills() as calls:
        got = ksw2_gpu.extd2_fill_batch(meta, qb, tb, prm, cuda, flag, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag)) == 0
    assert len(calls) == 1
    shape = ksw2_gpu.fill_shape(calls[0][0][4].cpu().numpy(),
                                calls[0][0][5].cpu().numpy())
    assert shape.n_block > 0 and shape.n_warp > 0
    assert (st.scratch_fills == shape.n_block) == in_scratch
    assert (st.scratch_fills > 0) == in_scratch
    assert hold_fill_calls(calls, "mix", verbose=False)[0] == 0
    # regions that are not 4-aligned take the kernel's byte stores
    fa = list(calls[0][0])
    fa[7], fa[8] = fa[7] + 1, fa[8] + 1
    sc, p = ksw2_gpu.extd2_fill(*fa)
    sct, pt = ksw2_gpu.extd2_fill_torch(*fa)
    assert torch.equal(sc, sct) and torch.equal(p, pt)


@pytest.mark.parametrize("right", [False, True], ids=["default", "right"])
def test_extd2_fill_long_queries_beside_warps(cuda, right):
    """Queries of 4,000 to 72,000 bases beside targets of at most 512
    (chip_smoke.long_query_mix) in one launch with warp-class fills: each
    long-query fill takes a block (the longest with its state in global
    scratch), and the batch equals ksw2.extd2, exact."""
    from chip_smoke import _pack_fills, long_query_mix
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
    prm = ksw2_gpu.fill_params(O.set_preset(None)[1])
    flag = ksw2.KSW_EZ_APPROX_MAX | (ksw2.KSW_EZ_RIGHT if right else 0)
    meta, qb, tb = _pack_fills(*long_query_mix(
        np.random.default_rng(31 + right)))
    st = ksw2_gpu.FillStats()
    with recording_fills() as calls:
        got = ksw2_gpu.extd2_fill_batch(meta, qb, tb, prm, cuda, flag, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag)) == 0
    assert len(calls) == 1
    ql = calls[0][0][4].cpu().numpy()
    shape = ksw2_gpu.fill_shape(ql, calls[0][0][5].cpu().numpy())
    assert set(np.nonzero(ql >= 4_000)[0]) <= set(
        shape.work[:shape.n_block].tolist())
    assert (ql >= 4_000).sum() == 3 and shape.n_warp > 0
    assert st.scratch_fills >= 1


def test_a_mapping_run_with_long_inserts_at_a_wide_long_join(cuda,
                                                            tmp_path):
    """--gpu-chain --gpu-align -c -r 500,80000 on reads with a 30 kb and a
    61 kb insert (chip_smoke.insertion_run): their gap fills have ~30,200
    and ~61,200 query bases beside ~200 target bases.  By its width alone
    the first would take a warp and eight warps' state would pass the
    232,448 B a block may have (the launch would raise); the run equals
    the host path, every launch within FILL_SMEM_MAX's rule."""
    from chip_smoke import insertion_run, warp_rule_shape
    dev, host, shapes = insertion_run((30_000, 61_000), ["-r", "500,80000"],
                                      cuda, str(tmp_path))
    assert dev[0] == host[0] == 0
    assert dev[1] == host[1] and "\tcg:Z:10000M61000I10000M" in dev[1]
    assert shapes
    assert all(sh.smem <= 232_448 and ksw2_gpu.FILL_WARPS * sh.warp_stride
               <= ksw2_gpu.FILL_SMEM_MAX for _ql, _tl, sh in shapes)
    assert any(warp_rule_shape(ql, tl).smem > 232_448
               for ql, tl, _sh in shapes)


@pytest.mark.parametrize("name", ["every_class", "ties_across_warps",
                                  "dd_2p24"])
def test_chain_kernel_classes(cuda, name):
    """The chain kernel's size classes in one launch: segments of a warp,
    of a group of four warps and of the block, with the window in the
    ring and (a widest range past it) in global memory; equal totals
    spread over a block's warps (the largest i wins); gap differences
    across 2^24.  Equal to the twin and to chain_scores_host, exact."""
    ax, ay, a = next((w[1], w[2], w[3]) for w in WORKLOADS if w[0] == name)
    bounds = np.array([0, ax.shape[0]], np.int64)
    ops, kw, _ = kernel_operands(ax, ay, bounds, a, cuda)
    shape = chain_gpu.segment_shape(ops[3].cpu().numpy(),
                                    ops[4].cpu().numpy(),
                                    ops[2].cpu().numpy())
    if name == "every_class":
        assert min(shape.n_long, shape.n_mid, shape.n_short) > 0
        assert set(shape.work[:shape.n_long, 3].tolist()) == {0, 1}
    before = chain_gpu.launches
    f, p = chain_gpu.chain_segments(*ops, **kw, shape=shape)
    ft, pt = chain_gpu.chain_segments_torch(*ops, **kw)
    torch.cuda.synchronize()
    assert chain_gpu.launches == before + 1
    assert torch.equal(f, ft) and torch.equal(p, pt)
    fo, po = chain_gpu.chain_scores_host(
        ax, ay, a["max_dist_x"], a["max_dist_y"], a["bw"], a["max_iter"],
        a["cg"], a["cs"], a["is_cdna"])
    prel = p.cpu().numpy().astype(np.int64)
    assert np.array_equal(f.cpu().numpy(), fo)
    assert np.array_equal(np.where(prel > 0, np.arange(prel.shape[0]) - prel,
                                   -1), po)


@pytest.mark.parametrize("right", [False, True], ids=["default", "right"])
@pytest.mark.parametrize("in_scratch", [False, True],
                         ids=["shared", "scratch"])
def test_extd2_ext_warp_and_block_classes(cuda, monkeypatch, right,
                                          in_scratch):
    """The extension kernel on one launch that mixes warp-class
    extensions (a Z-drop in a block of warps whose other warps run on,
    periodic pairs whose row maxima tie across rank classes, reach_end
    starts) with block-class ones past WARP_LANES lanes (one Z-dropped),
    in both flag forms: equal to the twins (every field, direction bytes,
    CIGARs) and to ksw2.extd2, also with fill regions that are not
    4-aligned; with the shared-memory cap at 0, every block-class
    extension keeps its state in global scratch.  The mix's cases are
    checked on the CPU (tests/test_torch_ext_shapes.py)."""
    from chip_smoke import ext_class_mix
    if in_scratch:
        monkeypatch.setattr(ksw2_gpu, "EXT_SMEM_MAX", 0)
    meta, qb, tb, zd, prm, flag, eb = ext_class_mix(
        808, 0x40 | (0x82 if right else 0))
    st = ksw2_gpu.FillStats()
    with recording_ext() as calls:
        got = ksw2_gpu.extd2_ext_batch(meta, qb, tb, zd, prm, flag, eb, cuda,
                                       st)
    assert ext_result_err(got, ext_oracle(meta, qb, tb, zd, prm, flag,
                                          eb)) == 0
    assert len(calls) == 1
    shape = ksw2_gpu.ext_shape(calls[0][0][4].cpu().numpy(),
                               calls[0][0][5].cpu().numpy())
    assert shape.n_block > 0 and shape.n_warp > 0
    assert (st.scratch_fills == shape.n_block) == in_scratch
    assert (st.scratch_fills > 0) == in_scratch
    assert got[0][:, 8].any() and got[0][:, 9].any()
    assert hold_ext_calls(calls, "mix", verbose=False)[0] == 0
    # regions that are not 4-aligned take the kernel's byte stores
    fa = list(calls[0][0])
    fa[8], fa[9] = fa[8] + 1, fa[9] + 1
    e, p = ksw2_gpu.extd2_ext(*fa)
    et, pt = ksw2_gpu.extd2_ext_torch(*fa)
    assert torch.equal(e, et) and torch.equal(p, pt)


@pytest.mark.parametrize("in_scratch", [False, True],
                         ids=["shared", "scratch"])
def test_exts2_ext_warp_and_block_classes(cuda, monkeypatch, in_scratch):
    """The splice extension kernel on one launch that mixes warp-class
    read ends (a Z-drop in a block of warps whose other warps run on,
    periodic pairs whose row maxima tie across rank classes) with
    block-class ones, in both flag forms and with whole-matrix starts:
    equal to the twins and to ksw2_splice.exts2, also with fill regions
    that are not 4-aligned; with the shared-memory cap at 0, every
    block-class extension keeps its rings in global scratch."""
    from chip_smoke import splice_ext_class_mix
    if in_scratch:
        monkeypatch.setattr(ksw2s_gpu, "EXT_SMEM_MAX", 0)
    meta, qb, tb, jb, fl, zd, prm = splice_ext_class_mix(909)
    st = ksw2_gpu.FillStats()
    with recording_splice_ext() as calls:
        got = ksw2s_gpu.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, cuda,
                                        st)
    assert ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl, zd,
                                                 prm)) == 0
    assert len(calls) == 1
    shape = ksw2s_gpu.ext_ring_shape(calls[0][0][6].cpu().numpy(),
                                     calls[0][0][7].cpu().numpy())
    assert shape.n_block > 0 and shape.n_warp > 0
    assert (st.scratch_fills == shape.n_block) == in_scratch
    assert (st.scratch_fills > 0) == in_scratch
    assert hold_splice_ext_calls(calls, "mix", verbose=False)[0] == 0
    fa = list(calls[0][0])
    fa[10], fa[11] = fa[10] + 1, fa[11] + 1
    e, p = ksw2s_gpu.exts2_ext(*fa)
    et, pt = ksw2s_gpu.exts2_ext_torch(*fa)
    assert torch.equal(e, et) and torch.equal(p, pt)


def _cell_edge_pairs(rng, ext):
    """Fills at the edges of the fill kernel's cell update: odd target
    lengths on both sides of the warp/block boundary (WARP_LANES: 512)
    and one past 1,400 lanes (its state in scratch under the test's cap),
    queries of 70-120% of them, bands of 16, 51 and 200 whose 16-aligned
    windows run stale lanes beside the whole matrix, N bases in every
    third pair (both sides), an unrelated pair; extensions (ext) take the
    whole matrix, with unrelated tails under a tight Z-drop in two."""
    from chip_smoke import _mutate_splice
    pairs, ws, zd = [], [], []
    for k, (tl, w) in enumerate([
            (97, 16), (211, 51), (213, 200), (301, -1), (333, 16), (511, 51),
            (509, 200), (497, -1), (701, 51), (1499, 200), (45, -1),
            (151, 16), (275, 51), (613, -1), (9, 200), (399, 16)]):
        t = rng.integers(0, 4, tl).astype(np.uint8)
        q = (rng.integers(0, 4, tl).astype(np.uint8) if k == 4
             else _mutate_splice(rng, t, 0.05, 0.03))
        if w < 0 or ext:
            q = q[:max(1, int(tl * rng.uniform(0.7, 1.2)))].copy()
        if k % 3 == 0:
            q[rng.random(q.shape[0]) < 0.05] = 4
            t[rng.random(tl) < 0.03] = 4
        if ext and k in (2, 13):
            q[q.shape[0] // 3:] = rng.integers(0, 4, q.shape[0]
                                               - q.shape[0] // 3)
        pairs.append((q, t))
        ws.append(-1 if ext else w)
        zd.append(60 if ext and k in (2, 13) else 400)
    return pairs, ws, np.array(zd)


@pytest.mark.parametrize("right", [False, True], ids=["default", "right"])
def test_extd2_cell_update_edges(cuda, monkeypatch, right):
    """The fill and extension kernels' cell update in 16-bit lanes at its
    edges, under asm5's scoring (the widest q2 + e2 of the presets, 82,
    and a mismatch of -19): _cell_edge_pairs in one fill launch that holds
    warp-class fills, block-class ones in shared memory and one in global
    scratch (the shared-memory cap lowered between them), then one
    extension launch of the same classes with Z-drops.  Scores, direction
    bytes, CIGARs and every extension field equal the twins and ksw2.extd2,
    also with direction regions that are not 4-aligned."""
    from chip_smoke import _pack_ext, _pack_fills
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
    prm = ksw2_gpu.fill_params(O.set_preset("asm5")[1])
    assert prm.qq2 + prm.ee2 == 82 and not prm.mat_gate
    monkeypatch.setattr(ksw2_gpu, "FILL_SMEM_MAX", 12_000)
    monkeypatch.setattr(ksw2_gpu, "EXT_SMEM_MAX", 16_000)
    rng = np.random.default_rng(1919 + right)
    pairs, ws, _zd = _cell_edge_pairs(rng, ext=False)
    keep = ~ksw2_gpu.band_collapses(
        [len(q) for q, _t in pairs], [len(t) for _q, t in pairs],
        [w if w >= 0 else max(len(q), len(t)) for w, (q, t) in zip(ws, pairs)])
    meta, qb, tb = _pack_fills([p for p, k in zip(pairs, keep) if k],
                               [w for w, k in zip(ws, keep) if k])
    flag = ksw2.KSW_EZ_APPROX_MAX | (ksw2.KSW_EZ_RIGHT if right else 0)
    st = ksw2_gpu.FillStats()
    with recording_fills() as calls:
        got = ksw2_gpu.extd2_fill_batch(meta, qb, tb, prm, cuda, flag, st)
    assert fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag)) == 0
    assert len(calls) == 1 and st.host_fills == 0
    shape = ksw2_gpu.fill_shape(calls[0][0][4].cpu().numpy(),
                                calls[0][0][5].cpu().numpy())
    block = shape.work[:shape.n_block]
    assert shape.n_warp > 0
    assert (shape.scr_off[block] >= 0).any() and (shape.scr_off[block]
                                                  < 0).any()
    assert hold_fill_calls(calls, "cell edges", verbose=False)[0] == 0
    fa = list(calls[0][0])
    fa[7], fa[8] = fa[7] + 1, fa[8] + 1   # direction regions 4k + 1
    sc, p = ksw2_gpu.extd2_fill(*fa)
    sct, pt = ksw2_gpu.extd2_fill_torch(*fa)
    assert torch.equal(sc, sct) and torch.equal(p, pt)
    # extension mode: the same classes, with Z-drops
    pairs, ws, zd = _cell_edge_pairs(rng, ext=True)
    meta, qb, tb = _pack_ext(pairs, ws)
    eflag = ksw2.KSW_EZ_EXTZ_ONLY | (ksw2.KSW_EZ_RIGHT if right else 0)
    st = ksw2_gpu.FillStats()
    with recording_ext() as calls:
        got = ksw2_gpu.extd2_ext_batch(meta, qb, tb, zd, prm, eflag, 10, cuda,
                                       st)
    assert ext_result_err(got, ext_oracle(meta, qb, tb, zd, prm, eflag,
                                          10)) == 0
    assert len(calls) == 1
    shape = ksw2_gpu.ext_shape(calls[0][0][4].cpu().numpy(),
                               calls[0][0][5].cpu().numpy())
    block = shape.work[:shape.n_block]
    assert shape.n_warp > 0
    assert (shape.scr_off[block] >= 0).any() and (shape.scr_off[block]
                                                  < 0).any()
    assert got[0][:, 8].any()   # a Z-drop
    assert hold_ext_calls(calls, "cell edges", verbose=False)[0] == 0
    fa = list(calls[0][0])
    fa[8], fa[9] = fa[8] + 1, fa[9] + 1
    e, p = ksw2_gpu.extd2_ext(*fa)
    et, pt = ksw2_gpu.extd2_ext_torch(*fa)
    assert torch.equal(e, et) and torch.equal(p, pt)
