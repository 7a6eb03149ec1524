"""The genomic Python fill session of the PyTorch port on the CPU: the
routes the C++ aligner does not carry (--qstrand, --print-aln-seq, no
native kit) take models.pipeline._prefill_device, whose collect pass
records the gap fills and extensions that the twins of the extd2 fill
and extension kernels then solve.

Each side's inputs come from its own package: the port's from the
port's copies of the host layer, the JAX package's from its modules.
Caches, PAF and dump lines are compared exactly.  The sim200 --qstrand
golden of this route is the first test of tests/test_torch_ksw2.py
(why there: that file's docstring).
"""

import contextlib
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.ops import align as align_ops
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

SKIP_INF = "--max-chain-skip=2147483647"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with gzip.open(golden_path(name), "rt") as f:
        return f.read()


def _subset(tmp_path, fasta, lo, hi):
    """Reads lo..hi-1 of a gzipped FASTA golden input, as a file, and
    their names."""
    with gzip.open(golden_path(fasta), "rt") as f:
        recs = f.read().split(">")[1:][lo:hi]
    path = tmp_path / f"sub{lo}_{hi}.fa"
    path.write_text("".join(">" + r for r in recs))
    return str(path), {r.split(None, 1)[0] for r in recs}


def _lines_of(text, names):
    return "".join(line + "\n" for line in text.splitlines()
                   if line.split("\t", 1)[0] in names)


def _run_host(argv):
    """The host path of the port's `_run` (its copies of the JAX
    package's host layer): argv without --gpu-chain."""
    argv, args = cli.parse_args(argv)
    io_, mo = O.set_preset(args.preset)
    return cli._run(args, argv, io_, mo)


def _run_gpu_path(argv):
    """The --gpu-chain --gpu-align run path (cli._run) on the CPU twins:
    (rc, stdout, stderr)."""
    argv, args = cli.parse_args([SKIP_INF, "--gpu-chain", "--gpu-align",
                                 *argv])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli._run(args, argv, io_, mo, torch.device("cpu"))
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------- the cache

def _slices(pkg, n_reads, seed, extra_flag, preset=None):
    """(index, options, slices) of a seeded read set, chained and cut into
    per-read (sr, f, p) slices by the given pipeline package."""
    if pkg == "jax":
        from mm2_gb_tpu.models import pipeline as pl
        from mm2_gb_tpu.models.index import MinimizerIndex
        from mm2_gb_tpu.utils import opts as opts
        from mm2_gb_tpu.utils.fastx import SeqRecord
        from mm2_gb_tpu.utils.simulate import (random_reference,
                                               simulate_readset)
    else:
        from mm2_gb_tpu_torch.models import pipeline as pl
        from mm2_gb_tpu_torch.models.index import MinimizerIndex
        from mm2_gb_tpu_torch.utils import opts as opts
        from mm2_gb_tpu_torch.utils.fastx import SeqRecord
        from mm2_gb_tpu_torch.utils.simulate import (random_reference,
                                                     simulate_readset)
    ref = random_reference(80_000, seed=seed)
    reads = simulate_readset(ref, n_reads, 1_000, 6_000, seed=seed + 1)
    io_, mo = opts.set_preset(preset)
    mo.max_chain_skip = 2**31 - 1
    mo.flag |= (opts.MM_F_CIGAR | opts.MM_F_OUT_CG | opts.MM_F_TPU_ALIGN
                | extra_flag)
    index = MinimizerIndex.from_strings([ref], io_, names=["c"])
    opts.mapopt_update(mo, index)
    acc = [pl.seed_read(index, mo, SeqRecord(i, n, s))
           for i, (n, s) in enumerate(reads)]
    if pkg == "jax":
        acc, bounds, pend = pl._dispatch_batch(index, mo, acc,
                                               pl.TpuMetrics())
    else:
        acc, bounds, pend = pl._dispatch_batch(index, mo, acc,
                                               gp.GpuMetrics(),
                                               torch.device("cpu"))
    f, p = pend.collect()
    slices = []
    for i, sr in enumerate(acc):
        s, e = int(bounds[i]), int(bounds[i + 1])
        slices.append((sr, f[s:e], np.where(p[s:e] >= 0, p[s:e] - s, -1)))
    return index, mo, slices


@pytest.mark.parametrize("flag,preset", [
    (O.MM_F_QSTRAND | O.MM_F_NO_INV, None), (0, None), (0, "map-hifi")],
    ids=["qstrand", "default", "map_hifi"])
def test_prefill_device_cache_matches_jax(flag, preset):
    """For the same seeded slices, the port's _prefill_device leaves the
    same fill cache as the JAX package's (gap fills, extensions; the
    JAX side's batches resolve to ksw2.extd2 on the CPU), key by key and
    field by field."""
    from mm2_gb_tpu.models import pipeline as jp
    from mm2_gb_tpu.ops import align as jalign
    jindex, jmo, jslices = _slices("jax", 5, 71, flag, preset)
    saved = jalign.collect_ext
    try:
        jp._prefill_device(jindex, jmo, jslices)
        want = jalign._fill_cache
    finally:
        jalign.set_fill_cache(None)
        jalign.collect_ext = saved
    index, mo, slices = _slices("port", 5, 71, flag, preset)
    met = gp.GpuMetrics()
    try:
        gp._prefill_device(index, mo, slices, met, torch.device("cpu"))
        got = align_ops._fill_cache
        assert align_ops.collect_ext
    finally:
        gp._end_fill_session()
    assert not align_ops.collect_ext and align_ops._fill_cache is None
    assert got.keys() == want.keys()
    kinds = {k[3] & (jalign.ksw2.KSW_EZ_EXTZ_ONLY
                     | jalign.ksw2.KSW_EZ_APPROX_MAX) for k in want}
    assert kinds == {jalign.ksw2.KSW_EZ_EXTZ_ONLY,
                     jalign.ksw2.KSW_EZ_APPROX_MAX}
    fields = ("score", "max", "zdropped", "max_q", "max_t", "mqe", "mqe_t",
              "mte", "mte_q", "reach_end")
    for key, ez in want.items():
        g = got[key]
        assert [getattr(g, f) for f in fields] == \
            [getattr(ez, f) for f in fields]
        assert np.array_equal(g.cigar, ez.cigar)
    fs = met.fills
    assert fs.fills + fs.ext_fills == len(want) and fs.ext_fills > 0
    assert fs.host_fills == 0


# ---------------------------------------------------------- the byte gates

@pytest.mark.parametrize("preset,flags,ref,query,golden,lo,hi", [
    (None, ["--cs", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz", 0, 8),
    ("splice", ["-c"], "splice_genome.fa.gz", "splice_reads.fa.gz",
     "splice40.skipinf.c.paf.gz", 16, 19)],
    ids=["default", "splice"])
def test_gpu_align_without_native_kit(preset, flags, ref, query, golden, lo,
                                      hi, tmp_path, monkeypatch):
    """--gpu-align with no native kit (the whole host layer in NumPy, the
    fills through the Python session) gives the golden's lines for a
    few of its reads."""
    monkeypatch.setattr(gp.native, "available", lambda: False)
    qpath, names = _subset(tmp_path, query, lo, hi)
    rc, out, err = _run_gpu_path([*(["-x", preset] if preset else []),
                                  *flags, "-v", "3", golden_path(ref),
                                  qpath])
    assert rc == 0
    assert out and out == _lines_of(_gold(golden), names)
    assert "fills:" in err


def _dump_lines(err):
    """The --print-aln-seq dump of a run's stderr: the `===>` headers,
    the target and query lines and the `score=` lines."""
    return [line for line in err.splitlines()
            if line.startswith(("===>", "score="))
            or (line and set(line) <= set("ACGTN"))]


@pytest.mark.parametrize("preset,flags,lo,hi", [
    ("splice", ["-c", "--print-aln-seq"], 16, 18),
    (None, ["--qstrand", "-c"], 20, 28),
    (None, ["-c", "--print-aln-seq"], 3, 5)],
    ids=["splice_print_aln_seq", "qstrand", "print_aln_seq"])
def test_python_session_route_matches_host(preset, flags, lo, hi, tmp_path):
    """The three routes of the Python fill session give the port's host
    path's PAF and `python -m mm2_gb_tpu`'s, and (--print-aln-seq) the
    same dump lines: the collect pass writes none."""
    ref, query = (("splice_genome.fa.gz", "splice_reads.fa.gz")
                  if preset else ("simref.fa.gz", "simreads.fa.gz"))
    qpath, _names = _subset(tmp_path, query, lo, hi)
    argv = [*(["-x", preset] if preset else []), *flags, golden_path(ref),
            qpath]
    rc, out, err = _run_gpu_path(argv)
    assert rc == 0 and out
    host_out, host_err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(host_out), \
            contextlib.redirect_stderr(host_err):
        assert _run_host([SKIP_INF, *argv]) == 0
    jax = subprocess.run([sys.executable, "-m", "mm2_gb_tpu", SKIP_INF,
                          *argv], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         timeout=600)
    assert jax.returncode == 0, jax.stderr[-2000:]
    assert out == host_out.getvalue() == jax.stdout
    dumps = _dump_lines(err)
    assert dumps == _dump_lines(host_err.getvalue()) \
        == _dump_lines(jax.stderr)
    assert bool(dumps) == ("--print-aln-seq" in flags)


# ------------------------------------------------------------ the session

def test_real_pass_exception_restores_collect_ext(tmp_path, monkeypatch):
    """An exception in a --qstrand run's real pass, after the batch's
    device results (here poisoned) are in the Python fill cache, leaves
    neither the cache nor the extension collection behind: a later host
    run in the same process aligns on the host, with unchanged PAF."""
    qpath, _names = _subset(tmp_path, "simreads.fa.gz", 30, 34)
    argv = ["--qstrand", "-c", golden_path("simref.fa.gz"), qpath]
    host = io.StringIO()
    with contextlib.redirect_stdout(host):
        assert _run_host([SKIP_INF, *argv]) == 0
    batch, finish = K.extd2_ext_batch, gp.finish_read
    seen = []

    def poisoned(*a, **kw):
        fields, cig_off, cig_blob = batch(*a, **kw)
        seen.append(fields.shape[0])
        return fields + 1, cig_off, cig_blob

    def real_pass_fails(*a, dump=True):
        if dump:
            raise RuntimeError("real pass")
        return finish(*a, dump=dump)
    monkeypatch.setattr(K, "extd2_ext_batch", poisoned)
    monkeypatch.setattr(gp, "finish_read", real_pass_fails)
    with pytest.raises(RuntimeError, match="real pass"):
        _run_gpu_path(argv)
    assert seen and seen[0] > 0
    assert not align_ops.collect_ext and align_ops._fill_cache is None
    monkeypatch.setattr(gp, "finish_read", finish)
    again = io.StringIO()
    with contextlib.redirect_stdout(again):
        assert _run_host([SKIP_INF, *argv]) == 0
    assert again.getvalue() == host.getvalue()
