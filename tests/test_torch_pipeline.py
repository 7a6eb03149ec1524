"""PyTorch pipeline port (mm2_gb_tpu_torch.models.pipeline) vs the JAX
package's device pipeline and host mapper, on CPU tensors (the chain
kernel's plain twin).  Outputs are compared as PAF bytes.  The port's
inputs (index, options, records) come from the port's own copies of the
host layer; where the JAX package runs too, its inputs come from its own
modules."""

import copy
import gzip
import io
import os

import numpy as np
import pytest
import torch

from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.utils import gpucfg
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.fastx import SeqRecord
from mm2_gb_tpu_torch.utils.paf import write_paf
from mm2_gb_tpu_torch.utils.simulate import random_reference, simulate_readset
from tests.conftest import golden_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_setup(ref_len, n_reads, lo, hi, seed):
    """_setup's index, options and reads, made by the JAX package."""
    from mm2_gb_tpu.models.index import MinimizerIndex as JIndex
    from mm2_gb_tpu.utils import opts as JO
    from mm2_gb_tpu.utils.simulate import (random_reference as jref,
                                           simulate_readset as jreads)
    ref = jref(ref_len, seed=seed)
    reads = jreads(ref, n_reads, lo, hi, seed=seed + 1)
    io_, mo = JO.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = JIndex.from_strings([ref], io_, names=["c"])
    JO.mapopt_update(mo, index)
    return index, mo, reads


def test_map_batch_gpu_matches_jax_pipeline_and_host():
    """seed -> chain (twin) -> backtrack -> post equals the JAX package's
    map_batch_tpu (Pallas interpret mode) and its host mapper, each side
    on inputs made by its own modules."""
    from mm2_gb_tpu.models.mapper import map_frag
    from mm2_gb_tpu.models.pipeline import map_batch_tpu
    from mm2_gb_tpu.utils.fastx import SeqRecord as JRecord
    from mm2_gb_tpu.utils.paf import write_paf as jpaf
    index, mo, reads = _setup(60_000, 6, 1_000, 4_000, 7)
    jindex, jmo, jreads = _jax_setup(60_000, 6, 1_000, 4_000, 7)
    assert jreads == reads
    recs = [SeqRecord(i, n, s) for i, (n, s) in enumerate(reads)]
    jrecs = [JRecord(i, n, s) for i, (n, s) in enumerate(reads)]
    port = gp.map_batch_gpu(index, mo, recs, device="cpu")
    jx = map_batch_tpu(jindex, jmo, jrecs)
    n_hits = 0
    for rec, (sr, regs), (sj, rj) in zip(jrecs, port, jx):
        host = map_frag(jindex, jmo, [rec.seq], rec.name)
        got = _paf(index, mo, sr, regs)
        assert got == [jpaf(r, sj.rec.name, sj.rec.length, jindex, jmo.flag,
                            sj.rep_len) for r in rj]
        assert got == [jpaf(r, rec.name, rec.length, jindex, jmo.flag,
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
    from mm2_gb_tpu_torch.cli import res_regs_out
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
    assert "fills:" not in err
    met.fills.fills, met.fills.device_fills, met.fills.host_fills = 7, 5, 2
    met.fills.cells, met.fills.fill_ms, met.fills.chunks = 4_000_000, 2.0, 1
    met.report(3)
    err = capsys.readouterr().err
    assert ("fills: 7 (5 device, 2 host-routed) in 1 chunks; 4000000 "
            "cells; fill kernel 2.000 ms (2.000 GCUPS)") in err


def test_empty_batch_has_no_dispatch():
    index, mo, _ = _setup(20_000, 1, 500, 600, 31)
    recs = [SeqRecord(0, "r0", "")]
    out = gp.map_batch_gpu(index, mo, recs, device="cpu")
    assert len(out) == 1 and out[0][1] == []
    assert np.array_equal(out[0][0].ax, np.empty(0, np.uint64))


def test_real_pass_exception_closes_the_fill_session(tmp_path, monkeypatch):
    """An exception in the real pass, after the batch's device results
    are in the C++ aligner's table, leaves the fill session off: a later
    run's host alignment does not answer from that (here poisoned)
    table."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    index, mo, reads = _setup(40_000, 4, 1_500, 3_000, 41)
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG
    qpath = _write_fasta(tmp_path, reads)
    base = list(gp.map_file_gpu(index, mo, [qpath], device="cpu"))
    assert base
    batch, finish = K.extd2_fill_batch, gp.finish_read

    def poisoned(*a, **kw):
        scores, cig_off, cig_blob = batch(*a, **kw)
        return scores + 1, cig_off, cig_blob

    def real_pass_fails(*a, dump=True):
        if dump:
            raise RuntimeError("real pass")
        return finish(*a, dump=dump)
    monkeypatch.setattr(K, "extd2_fill_batch", poisoned)
    monkeypatch.setattr(gp, "finish_read", real_pass_fails)
    align = copy.copy(mo)
    align.flag |= O.MM_F_TPU_ALIGN
    with pytest.raises(RuntimeError, match="real pass"):
        list(gp.map_file_gpu(index, align, [qpath], device="cpu"))
    monkeypatch.setattr(gp, "finish_read", finish)
    assert list(gp.map_file_gpu(index, mo, [qpath], device="cpu")) == base


def _splice_subset(tmp_path):
    """Index and options of `-x splice -c` on the splice40 genome, and
    four of its reads (a ~4 s run on the twins)."""
    with gzip.open(golden_path("splice_reads.fa.gz"), "rt") as f:
        recs = f.read().split(">")[1:]
    qpath = tmp_path / "q4.fa"
    qpath.write_text("".join(">" + r for r in recs[16:20]))
    io_, mo = O.set_preset("splice")
    mo.max_chain_skip = 2**31 - 1
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG
    index = MinimizerIndex.from_fasta(golden_path("splice_genome.fa.gz"), io_)
    O.mapopt_update(mo, index)
    align = copy.copy(mo)
    align.flag |= O.MM_F_TPU_ALIGN
    return index, mo, align, str(qpath)


def test_splice_real_pass_reads_the_fill_cache(tmp_path, monkeypatch):
    """-x splice --gpu-align: the collect pass's fills reach the exts2
    batch once each, and the real pass takes their results from the fill
    cache (adding 1 to every device score changes the PAF) and does not
    recompute them; the cache is gone after the run."""
    from mm2_gb_tpu_torch.ops import align as align_ops
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    index, mo, align, qpath = _splice_subset(tmp_path)
    base = list(gp.map_file_gpu(index, mo, [qpath], device="cpu"))
    assert base and list(gp.map_file_gpu(index, align, [qpath],
                                         device="cpu")) == base
    batch = KS.exts2_fill_batch
    seen = []

    def poisoned(meta, *a, **kw):
        scores, cig_off, cig_blob = batch(meta, *a, **kw)
        seen.append(meta)
        return scores + 1, cig_off, cig_blob
    monkeypatch.setattr(KS, "exts2_fill_batch", poisoned)
    bad = list(gp.map_file_gpu(index, align, [qpath], device="cpu"))
    assert len(seen) == 1 and seen[0].shape[0] > 10
    assert bad != base
    assert align_ops._fill_cache is None


def test_real_pass_exception_clears_the_fill_cache(tmp_path, monkeypatch):
    """An exception in a splice run's real pass, after the batch's device
    results are in the Python fill cache, leaves no cache behind: a later
    host run's alignment does not answer from that (here poisoned)
    cache, and its PAF is unchanged."""
    from mm2_gb_tpu_torch.ops import align as align_ops
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    index, mo, align, qpath = _splice_subset(tmp_path)
    base = list(gp.map_file_gpu(index, mo, [qpath], device="cpu"))
    batch, finish = KS.exts2_fill_batch, gp.finish_read

    def poisoned(*a, **kw):
        scores, cig_off, cig_blob = batch(*a, **kw)
        return scores + 1, cig_off, cig_blob

    def real_pass_fails(*a, dump=True):
        if dump:
            raise RuntimeError("real pass")
        return finish(*a, dump=dump)
    monkeypatch.setattr(KS, "exts2_fill_batch", poisoned)
    monkeypatch.setattr(gp, "finish_read", real_pass_fails)
    with pytest.raises(RuntimeError, match="real pass"):
        list(gp.map_file_gpu(index, align, [qpath], device="cpu"))
    monkeypatch.setattr(gp, "finish_read", finish)
    assert list(gp.map_file_gpu(index, mo, [qpath], device="cpu")) == base
    assert align_ops._fill_cache is None


def test_print_seeds_once_with_gpu_align(capsys):
    """--gpu-chain --gpu-align -c --print-seeds: the fill collect pass
    writes no dump, so the RS/SD/CN lines appear once, equal to the
    reference's, and the PAF equals the -c golden."""
    from mm2_gb_tpu_torch import cli
    argv, args = cli.parse_args([
        "--max-chain-skip=2147483647", "--gpu-chain", "--gpu-align", "-c",
        "--print-seeds", golden_path("invq4.ref.fa.gz"),
        golden_path("invq4.q.fa.gz")])
    io_, mo = O.set_preset(args.preset)
    assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
    cap = capsys.readouterr()
    with gzip.open(golden_path("invq4.skipinf.c.paf.gz"), "rt") as f:
        assert cap.out == f.read()
    dumps = [line for line in cap.err.splitlines()
             if line[:3] in ("RS\t", "SD\t", "CN\t")]
    with gzip.open(golden_path("invq4.print-seeds.txt.gz"), "rt") as f:
        assert dumps == f.read().splitlines()
    assert "fills: 45 (45 device, 0 host-routed)" in cap.err


def test_print_seeds_once_with_splice_align(tmp_path, capsys):
    """-x splice --gpu-align --print-seeds: the Python collect pass writes
    no dump, so the RS/SD/CN lines and the PAF equal those of the run
    without --gpu-align."""
    from mm2_gb_tpu_torch import cli
    _index, _mo, _align, qpath = _splice_subset(tmp_path)
    runs = []
    for align in ([], ["--gpu-align"]):
        argv, args = cli.parse_args([
            "--max-chain-skip=2147483647", "--gpu-chain", *align, "-x",
            "splice", "-c", "--print-seeds",
            golden_path("splice_genome.fa.gz"), qpath])
        io_, mo = O.set_preset(args.preset)
        assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
        cap = capsys.readouterr()
        runs.append((cap.out, [line for line in cap.err.splitlines()
                               if line[:3] in ("RS\t", "SD\t", "CN\t")]))
    assert runs[0][1] and runs[1] == runs[0]


def test_align_routes(monkeypatch):
    """--gpu-align's routes: the C++ aligner's session for plain genomic
    runs, the Python session for splice, --qstrand, --print-aln-seq and
    no native kit (the JAX pipeline's _prefill_native declines those);
    -x sr and single gap costs align on the host, and so do splice
    options whose q2 is no intron open."""
    def opt(preset=None, flag=O.MM_F_CIGAR | O.MM_F_TPU_ALIGN, **kw):
        _io, mo = O.set_preset(preset)
        mo.flag |= flag
        for k, v in kw.items():
            setattr(mo, k, v)
        return mo
    assert gp.use_device_align(opt()) and gp._native_session(opt())
    for mo in (opt("splice"), opt("splice", dbg_print_aln_seq=True),
               opt(flag=O.MM_F_CIGAR | O.MM_F_TPU_ALIGN | O.MM_F_QSTRAND),
               opt(dbg_print_aln_seq=True)):
        assert gp.use_device_align(mo) and not gp._native_session(mo)
    assert not gp.use_device_align(opt("splice", q2=3))
    for mo in (opt("sr"), opt(q2=4, e2=2), opt(flag=O.MM_F_TPU_ALIGN),
               opt(flag=O.MM_F_CIGAR)):
        assert not gp.use_device_align(mo)
    monkeypatch.setattr(gp.native, "available", lambda: False)
    assert gp.use_device_align(opt()) and not gp._native_session(opt())


def test_fill_cache_counts_misses_by_kind(capsys):
    """The Python fill session's cache counts the real pass's misses (a
    fill or extension it then aligns on the host) by kind, and the
    fills: line reports them."""
    from mm2_gb_tpu_torch.ops import align as align_ops
    from mm2_gb_tpu_torch.ops import ksw2
    met = gp.GpuMetrics()
    q, t = np.array([0, 1, 2], np.uint8), np.array([0, 1, 3], np.uint8)
    hit = ksw2.Extz()
    cache = gp._FillCache(met.fills.misses, False)
    key = align_ops._fill_key(q, t, 10, ksw2.KSW_EZ_APPROX_MAX, 400, 0)
    cache[key] = hit
    assert cache.get(key) is hit
    for flag in (ksw2.KSW_EZ_APPROX_MAX, ksw2.KSW_EZ_EXTZ_ONLY,
                 ksw2.KSW_EZ_EXTZ_ONLY | ksw2.KSW_EZ_RIGHT
                 | ksw2.KSW_EZ_REV_CIGAR):
        assert cache.get(align_ops._fill_key(t, q, 10, flag, 400, 0)) is None
    splice = gp._FillCache(met.fills.misses, True)
    assert splice.get(key) is None
    assert met.fills.misses == {"fill": 1, "ext": 2, "splice": 1}
    met.fills.ext_fills = 3
    met.report(3)
    assert capsys.readouterr().err.rstrip("\n").endswith(
        "real-pass misses (aligned on the host): 1 fill, 2 ext, 1 splice")


def test_host_kit_build_failure_is_reported(tmp_path, monkeypatch, capsys):
    """A host kit that cannot be built (no g++, or g++ fails) is said on
    stderr, with g++'s messages, and leaves no library behind."""
    from mm2_gb_tpu_torch.utils import native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SOURCES", ("missing.cpp",))
    path = str(tmp_path / "libhostkit-test.so")
    native._build(path)
    err = capsys.readouterr().err
    assert "host kit: g++ failed" in err and "missing.cpp" in err
    assert "NumPy host layer runs instead" in err
    assert sorted(os.listdir(tmp_path)) == ["lock"]
    monkeypatch.setattr("shutil.which", lambda _name: None)
    native._build(path)
    assert "host kit: no g++ to build it" in capsys.readouterr().err
    assert not os.path.exists(path)

