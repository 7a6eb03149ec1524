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

from chip_smoke import (fill_oracle, fill_result_err, fill_workloads,
                        hold_fill_calls, hold_splice_calls, kernel_operands,
                        recording_fills, recording_splice, splice_oracle,
                        splice_workloads, workloads)
from mm2_gb_tpu.ops.chain import _chain_dp_scores
from mm2_gb_tpu.utils.hashkit import mg_log2
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu, ksw2s_gpu

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

WORKLOADS = list(workloads())
FILLS = list(fill_workloads(n_pairs=32, max_len=400, long_len=4800))
SPLICE = list(splice_workloads(n_pairs=24, max_intron=1000,
                               long_intron=8000, n_long=3))


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
], ids=["sim200", "sim200_cs_c", "splice40_is_cdna"])
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
], ids=["sim200_cs_c", "map_hifi_c", "rep60_max_occ", "alt200", "invq4"])
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
