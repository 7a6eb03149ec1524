"""PyTorch pipeline port (mm2_gb_tpu_torch.models.pipeline) vs the JAX
package's device pipeline and host mapper, on CPU tensors (the chain
kernel's plain twin).  Outputs are compared as PAF bytes."""

import gzip
import io

import numpy as np
import pytest

from mm2_gb_tpu.models.index import MinimizerIndex
from mm2_gb_tpu.utils import opts as O
from mm2_gb_tpu.utils.fastx import SeqRecord
from mm2_gb_tpu.utils.paf import write_paf
from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset
from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.utils import gpucfg
from tests.conftest import golden_path


def _setup(ref_len, n_reads, lo, hi, seed):
    ref = random_reference(ref_len, seed=seed)
    reads = simulate_readset(ref, n_reads, lo, hi, seed=seed + 1)
    io_, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io_, names=["c"])
    O.mapopt_update(mo, index)
    return index, mo, reads


def _paf(index, mo, sr, regs):
    return [write_paf(r, sr.rec.name, sr.rec.length, index, mo.flag,
                      sr.rep_len) for r in regs]


def test_map_batch_gpu_matches_jax_pipeline_and_host():
    """seed -> chain (twin) -> backtrack -> post equals the JAX package's
    map_batch_tpu (Pallas interpret mode) and the host mapper."""
    from mm2_gb_tpu.models.mapper import map_frag
    from mm2_gb_tpu.models.pipeline import map_batch_tpu
    index, mo, reads = _setup(60_000, 6, 1_000, 4_000, 7)
    recs = [SeqRecord(i, n, s) for i, (n, s) in enumerate(reads)]
    port = gp.map_batch_gpu(index, mo, recs, device="cpu")
    jx = map_batch_tpu(index, mo, recs)
    n_hits = 0
    for rec, (sr, regs), (sj, rj) in zip(recs, port, jx):
        host = map_frag(index, mo, [rec.seq], rec.name)
        got = _paf(index, mo, sr, regs)
        assert got == _paf(index, mo, sj, rj)
        assert got == [write_paf(r, rec.name, rec.length, index, mo.flag,
                                 host.rep_len) for r in host.regs]
        n_hits += len(got)
    assert n_hits >= len(recs)


def _write_fasta(tmp_path, reads):
    path = tmp_path / "q.fa"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    return str(path)


def _run_records(index, mo, qpath, n_threads=1):
    met = gp.GpuMetrics()
    out = []
    for sr, regs in gp.map_file_gpu_records(index, mo, [qpath], met,
                                            n_threads, device="cpu"):
        out.append((sr.rec.name, _paf(index, mo, sr, regs)))
    return out, met


def test_batch_caps_split_and_match(tmp_path):
    """max_anchors_batch splits the accumulation into several device
    batches with overflow spill; output equals the uncapped run."""
    index, mo, reads = _setup(30_000, 4, 600, 1_200, 11)
    qpath = _write_fasta(tmp_path, reads)
    base, met0 = _run_records(index, mo, qpath)
    assert met0.n_batches == 1 and met0.n_dispatch == 1
    old = gpucfg._current
    try:
        gpucfg._current = gpucfg.GpuConfig(max_anchors_batch=200)
        capped, met1 = _run_records(index, mo, qpath)
    finally:
        gpucfg._current = old
    assert met1.n_batches > 1
    assert met1.n_spills > 0
    assert capped == base


def test_threads_give_identical_records(tmp_path):
    """-t 1 and -t 4 (pooled seed and finish) emit the same records in
    the same order; map_file_gpu writes the same PAF lines."""
    index, mo, reads = _setup(80_000, 24, 800, 5_000, 21)
    qpath = _write_fasta(tmp_path, reads)
    one, _ = _run_records(index, mo, qpath, 1)
    four, _ = _run_records(index, mo, qpath, 4)
    assert [n for n, _ in one] == [n for n, _ in reads]
    assert one == four
    lines = list(gp.map_file_gpu(index, mo, [qpath], device="cpu"))
    assert lines == [line for _, paf in one for line in paf]


@pytest.mark.parametrize("preset,flags,query,ref,golden", [
    (None, 0, "simreads.fa.gz", "simref.fa.gz", "sim200.skipinf.paf.gz"),
    (None, O.MM_F_OUT_CS | O.MM_F_CIGAR | O.MM_F_OUT_CG, "simreads.fa.gz",
     "simref.fa.gz", "sim200.skipinf.cs.paf.gz"),
    ("splice", O.MM_F_CIGAR | O.MM_F_OUT_CG, "splice_reads.fa.gz",
     "splice_genome.fa.gz", "splice40.skipinf.c.paf.gz"),
], ids=["sim200", "sim200_cs_c", "splice40_is_cdna"])
def test_slice_matches_golden(preset, flags, query, ref, golden):
    """The slice on CPU tensors: map_file_gpu_records output equals the
    reference binary's goldens byte for byte (splice: is_cdna chaining)."""
    from mm2_gb_tpu.cli import res_regs_out
    io_, mo = O.set_preset(preset)
    mo.max_chain_skip = 2**31 - 1
    mo.flag |= flags
    index = MinimizerIndex.from_fasta(golden_path(ref), io_)
    O.mapopt_update(mo, index)
    out = io.StringIO()
    met = gp.GpuMetrics()
    for sr, regs in gp.map_file_gpu_records(index, mo, [golden_path(query)],
                                            met, 2, device="cpu"):
        res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len, False, None,
                     0, 1, [regs])
    with gzip.open(golden_path(golden), "rt") as f:
        assert out.getvalue() == f.read()
    assert met.n_dispatch == met.n_batches == 1
    assert met.n_host_hpc == 0
    assert met.n_pairs > 0


def test_metrics_report(capsys):
    met = gp.GpuMetrics(n_reads=2, n_pairs=10, t_kernel=0.5, n_host_hpc=3)
    met.report(2)
    assert capsys.readouterr().err == ""
    met.report(3)
    err = capsys.readouterr().err
    assert "host route: 3 HPC batches" in err
    assert "(0.000 Gpairs/s)" in err


def test_empty_batch_has_no_dispatch():
    index, mo, _ = _setup(20_000, 1, 500, 600, 31)
    recs = [SeqRecord(0, "r0", "")]
    out = gp.map_batch_gpu(index, mo, recs, device="cpu")
    assert len(out) == 1 and out[0][1] == []
    assert np.array_equal(out[0][0].ax, np.empty(0, np.uint64))
