"""CLI of the PyTorch port (mm2_gb_tpu_torch.cli).

Without --gpu-chain the port maps on its own copy of the host path;
with it, `_run` maps through the GPU pipeline.  Here (no CUDA device)
`_run` is driven with a CPU device, which takes the kernels' plain
twins, so the port's own run path (with --gpu-align, its gap fills too)
is held against the goldens.  The routes of the Python fill session
(--qstrand, --print-aln-seq, no native kit) are held in
tests/test_torch_session.py.
"""

import gzip
import json
import os
import re

import pytest
import torch

import mm2_gb_tpu
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu, ksw2s_gpu
from mm2_gb_tpu_torch.utils import gpucfg
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

SKIP_INF = "--max-chain-skip=2147483647"


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


def _no_pg(s):
    return [line for line in s.splitlines() if not line.startswith("@PG")]


def _run_host(argv):
    """The host path of the port's `_run` (its copies of the JAX
    package's host layer): argv without --gpu-chain."""
    argv, args = cli.parse_args(argv)
    io_, mo = O.set_preset(args.preset)
    return cli._run(args, argv, io_, mo)


def _run_on_cpu(argv):
    """The --gpu-chain run path (cli._run) on the CPU twins."""
    argv, args = cli.parse_args([SKIP_INF, "--gpu-chain", *argv])
    io_, mo = O.set_preset(args.preset)
    return cli._run(args, argv, io_, mo, torch.device("cpu"))


def test_host_path_matches_golden(capsys):
    """The host path of the port's `_run` (its copies of the JAX
    package's host layer) gives the golden bytes."""
    rc = _run_host([SKIP_INF, golden_path("simref.fa.gz"),
                    golden_path("simreads.fa.gz")])
    assert rc == 0
    assert capsys.readouterr().out == _gold("sim200.skipinf.paf.gz")


@pytest.mark.parametrize("flags,ref,query,golden", [
    ([], "simref.fa.gz", "simreads.fa.gz", "sim200.skipinf.paf.gz"),
    (["--cs=short", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz"),
    (["-f", "0.0002,50", "-c"], "rep60.fa.gz", "rep60_q.fa.gz",
     "rep60.maxocc.c.paf.gz"),
    (["--gpu-align", "--cs", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz"),
    (["--gpu-align", "-c"], "invq4.ref.fa.gz", "invq4.q.fa.gz",
     "invq4.skipinf.c.paf.gz"),
    (["--gpu-align", "-x", "splice", "--junc-bed",
      golden_path("splice.bed.gz"), "-c"], "splice_genome.fa.gz",
     "splice_reads.fa.gz", "splice40.juncbed.c.paf.gz"),
    (["--gpu-align", "-x", "asm5", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.asm5.c.paf.gz"),
], ids=["sim200", "sim200_cs_c", "max_occ_rechain", "sim200_cs_c_align",
        "invq4_c_align", "splice40_juncbed_align", "asm5_c_align"])
def test_gpu_run_path_matches_golden(flags, ref, query, golden, capsys):
    before = (chain_gpu.launches, ksw2_gpu.fill_launches,
              ksw2_gpu.backtrack_launches, ksw2s_gpu.fill_launches)
    rc = _run_on_cpu([*flags, golden_path(ref), golden_path(query)])
    assert rc == 0
    cap = capsys.readouterr()
    assert cap.out == _gold(golden)
    # the asm presets chain by RMQ, on the host
    rmq = "1" if "asm5" in flags else "0"
    assert "[M::gpu]" in cap.err and ("host route: 0 HPC batches, "
                                      f"{rmq} RMQ batches") in cap.err
    m = re.search(r"fills: (\d+) \((\d+) device, (\d+) host-routed\)",
                  cap.err)
    if "--gpu-align" in flags:
        assert int(m.group(1)) > 0 and int(m.group(2)) > 0
        assert m.group(3) == "0"   # no fill routed to the host
    else:
        assert m is None
    # CPU tensors: no kernel launch
    assert (chain_gpu.launches, ksw2_gpu.fill_launches,
            ksw2_gpu.backtrack_launches, ksw2s_gpu.fill_launches) == before


def test_gpu_run_frag_mode_falls_back_to_host(capsys):
    """Paired-end (fragment mode) input chains on the host, with the JAX
    package's warning, and keeps its bytes."""
    rc = _run_on_cpu(["-x", "sr", "-a", golden_path("simref.fa.gz"),
                      golden_path("pe_1.fq.gz"), golden_path("pe_2.fq.gz")])
    assert rc == 0
    cap = capsys.readouterr()
    assert "falling back to host chaining" in cap.err
    assert _no_pg(cap.out) == _no_pg(_gold("pe300.sr.skipinf.sam.gz"))


def test_gpu_run_multipart_routes(capsys, tmp_path):
    """-I with several query files keeps the host route (warning, same
    bytes); one query file maps part by part on the device."""
    rc = _run_on_cpu(["-I", "100k", "-c", "--split-prefix",
                      str(tmp_path / "sp"), golden_path("splitq_ref.fa.gz"),
                      golden_path("splitq_q1.fa.gz"),
                      golden_path("splitq_q2.fa.gz")])
    assert rc == 0
    cap = capsys.readouterr()
    assert "falling back to host chaining" in cap.err
    out = "\n".join(_no_pg(cap.out)) + "\n"
    assert out == _gold("splitq.I100k.c.paf.gz")
    rc = _run_on_cpu(["-c", "-I", "20k", golden_path("multi3.fa.gz"),
                      golden_path("multi3_q.fa.gz")])
    assert rc == 0
    cap = capsys.readouterr()
    assert cap.out == _gold("multi3.noI.c.paf.gz")
    assert "falling back" not in cap.err and "not yet ported" not in cap.err


def test_main_takes_the_card_without_gpu_chain(monkeypatch, capsys):
    """The entry point maps on the CUDA device with or without
    --gpu-chain: with no card it exits 1, names the host route
    (`--device cpu`) and maps nothing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main([SKIP_INF, golden_path("simref.fa.gz"),
                   golden_path("simreads.fa.gz")])
    assert rc == 1
    cap = capsys.readouterr()
    assert "needs a CUDA device" in cap.err and "`--device cpu`" in cap.err
    assert cap.out == ""


def test_gpu_chain_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--gpu-chain", SKIP_INF, golden_path("simref.fa.gz"),
                   golden_path("simreads.fa.gz")])
    assert rc != 0
    cap = capsys.readouterr()
    assert "needs a CUDA device" in cap.err
    assert cap.out == ""


@pytest.mark.parametrize("flag", ["--gpu-align", "--tpu-align"])
def test_align_flag_is_accepted(flag, monkeypatch, capsys):
    """--gpu-align (the port's name) and --tpu-align both parse and set
    MM_F_TPU_ALIGN; without a card the run stops at the device check."""
    argv, args = cli.parse_args(["--gpu-chain", flag, "-c", "r.fa", "q.fa"])
    assert args.tpu_align and "--tpu-align" in argv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--gpu-chain", flag, "-c", SKIP_INF,
                   golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 1
    cap = capsys.readouterr()
    assert "needs a CUDA device" in cap.err and cap.out == ""


@pytest.mark.parametrize("flags", [
    ["--tpu-devices", "2"], ["--tpu-devices", "0"],
    ["--tpu-nproc", "2"], ["--tpu-profile", "prof"]],
    ids=["devices2", "devices_all", "nproc2", "profile"])
def test_unported_flags_exit_1(flags, monkeypatch, capsys):
    """The scale-out flags the port once refused (several devices or
    processes, the profile) parse and reach the device check: without a
    card they exit 1 there, with no output, no fallback and no "not yet
    ported" (tests/test_torch_mesh.py runs them on CPU devices)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--gpu-chain", *flags, golden_path("simref.fa.gz"),
                   golden_path("simreads.fa.gz")])
    assert rc == 1
    cap = capsys.readouterr()
    assert "needs a CUDA device" in cap.err and cap.out == ""
    assert "not yet ported" not in cap.err


def test_gpu_spellings_of_the_scale_out_flags():
    """--gpu-devices, --gpu-nproc, --gpu-rank, --gpu-coord and
    --gpu-profile (also in their =VALUE form) are the parser's --tpu-*
    flags."""
    argv, args = cli.parse_args([
        "--gpu-devices", "2", "--gpu-nproc=4", "--gpu-rank", "3",
        "--gpu-coord", "127.0.0.1:1234", "--gpu-profile=prof", "--gpu-align",
        "r.fa", "q.fa"])
    assert (args.tpu_devices, args.tpu_nproc, args.tpu_rank) == (2, 4, 3)
    assert args.tpu_coord == "127.0.0.1:1234" and args.tpu_profile == "prof"
    assert args.tpu_align and "--tpu-nproc=4" in argv


@pytest.mark.parametrize("flags", [
    ["-x", "splice", "-c", "--print-aln-seq"], ["--qstrand", "-c"],
    ["--print-aln-seq", "-c"]],
    ids=["splice_print_aln_seq", "qstrand", "print_aln_seq"])
def test_python_session_routes_need_a_card(flags, monkeypatch, capsys):
    """The routes of the Python fill session parse and reach the device
    check: without a card `--gpu-chain --gpu-align` exits 1 there, with
    no output and no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--gpu-chain", "--gpu-align", *flags,
                   golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 1
    cap = capsys.readouterr()
    assert "needs a CUDA device" in cap.err and "not yet ported" \
        not in cap.err
    assert cap.out == ""


def test_gpu_cfg_json_is_read(tmp_path, capsys):
    """--gpu-cfg (and a TPU config JSON) fills GpuConfig's batch caps;
    the TPU-only fields are ignored; output is unchanged."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"window_classes": [5120, 1024],
                               "max_anchors_batch": 300000,
                               "lanes": 128, "tile": 128}))
    old_cfg = gpucfg._current
    try:
        rc = _run_host(["--gpu-cfg", str(cfg), SKIP_INF,
                        golden_path("simref.fa.gz"),
                        golden_path("simreads.fa.gz")])
        assert rc == 0
        assert capsys.readouterr().out == _gold("sim200.skipinf.paf.gz")
        cur = gpucfg.current_config()
        assert cur == gpucfg.GpuConfig(max_anchors_batch=300000,
                                       max_reads_batch=200_000,
                                       caps_explicit=True)
        tpu = gpucfg.load_gpu_config(os.path.join(
            os.path.dirname(mm2_gb_tpu.__file__), "configs",
            "v5e_over50k.json"))
        assert tpu == gpucfg.GpuConfig(max_anchors_batch=4_000_000,
                                       max_reads_batch=50_000,
                                       caps_explicit=True)
        bad = gpucfg.load_gpu_config(str(tmp_path / "missing.json"))
        assert bad == gpucfg.GpuConfig()
        assert "cannot read" in capsys.readouterr().err
    finally:
        gpucfg._current = old_cfg


def test_derive_caps_from_free_memory(monkeypatch, capsys):
    """The anchor cap holds on a card with room for two batches, and is
    lowered to what free memory holds otherwise; never raised."""
    old = gpucfg._current
    free = [8 << 30]
    try:
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None: (free[0], 80 << 30))
        gpucfg._current = gpucfg.GpuConfig()
        gpucfg.derive_caps(torch.device("cuda"), 2)
        assert gpucfg._current == gpucfg.GpuConfig()
        free[0] = 10 << 20
        gpucfg.derive_caps(torch.device("cuda"), 2)
        want = (10 << 20) // gpucfg.BYTES_PER_ANCHOR
        assert gpucfg._current.max_anchors_batch == want < 1_000_000
        assert gpucfg._current.max_reads_batch == 200_000
        assert "lowered to" in capsys.readouterr().err
        gpucfg._current = gpucfg.GpuConfig(max_anchors_batch=123,
                                           caps_explicit=True)
        free[0] = 1 << 10
        gpucfg.derive_caps(torch.device("cuda"), 0)
        assert gpucfg._current.max_anchors_batch == 123
        gpucfg._current = gpucfg.GpuConfig()
        gpucfg.derive_caps(torch.device("cpu"), 0)
        assert gpucfg._current == gpucfg.GpuConfig()
    finally:
        gpucfg._current = old
