"""The port's host route, `python -m mm2_gb_tpu_torch --device cpu`.

`cli.main` reads the port's own `--device {cuda,cpu}` before its copied
parser sees the arguments.  `--device cpu` runs the host path of `_run`
(the port's verbatim copy of the JAX package's) and is the reference of
every card-side check: chip_smoke.py holds each card route to it, the
port's fuzzer runs it as its reference side and the e2e bench stage
times it as its baseline.  So the link to the JAX package lies here, on
the CPU:

- `cli.main(["--device", "cpu", ...])` equals `mm2_gb_tpu.cli.main` byte
  for byte, in process, on the non-device flags of every e2e
  configuration (flowcell-like reads at map-ont, `-c`, `--qstrand -c`; a
  small cDNA set at `-ax splice`; reads from the ultra-long set's
  generator; flowcell-like reads against themselves at `-x ava-ont`;
  small HiFi and assembly sets at `-ax map-hifi` and `-cx asm5 --cs`),
  on the repo's goldens, and on the fuzzer's workloads run
  through its default reference command in a subprocess;
- `--device cpu` with a device flag, a bad `--device`, and no CUDA device
  without `--device cpu` each exit 1 with a message, mapping nothing;
- `python -m mm2_gb_tpu_torch --device cpu` imports neither torch nor
  JAX nor the JAX package;
- no string constant in the port's sources or chip_smoke.py starts the
  JAX package (a module name to run, or an import in a `-c` script), and
  chip_smoke.py's `_host` refuses such an argv.
"""

import ast
import contextlib
import gzip
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from mm2_gb_tpu import cli as jcli
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.tools import fuzz_diff as F
from mm2_gb_tpu_torch.utils import e2ebench as E
from mm2_gb_tpu_torch.utils import gpucfg
from mm2_gb_tpu_torch.utils.simulate import (random_reference,
                                             random_repetitive_reference,
                                             simulate_readset)
from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_INF = "--max-chain-skip=2147483647"
HOST = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(main, argv):
    """(rc, stdout, stderr) of a CLI entry point run in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    """The port's host route and the JAX package's CLI on argv: both exit
    0; the port's stdout."""
    rc, port, err = _main(cli.main, [*HOST, *argv])
    assert rc == 0, err[-2000:]
    rc, jax, err = _main(jcli.main, argv)
    assert rc == 0, err[-2000:]
    assert port == jax
    return port


def _fasta(path, records):
    with open(path, "w") as f:
        f.writelines(f">{name}\n{seq}\n" for name, seq in records)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Small seeded inputs from the generators of the e2e configurations'
    sets: the flowcell's (random_reference, simulate_readset, seeds 1 and
    3), the cDNA set's (chip_smoke.cdna_set, seed 11) and the ultra-long
    set's (random_repetitive_reference, seeds 11 and 12), the HiFi and
    assembly sets' (chip_smoke.hifi_set, asm_set, seed 21), each cut in
    size, and for the overlap configuration 24 flowcell-like reads at
    about 2.5x coverage as both the target and the query: (ref, reads) by
    set."""
    import chip_smoke
    d = tmp_path_factory.mktemp("hostroute")
    ref = random_reference(300_000, seed=1)
    fc = (_fasta(d / "fc_ref.fa", [("chr1", ref)]),
          _fasta(d / "fc_reads.fa", simulate_readset(ref, 8, 5_000, 20_000,
                                                     seed=3)))
    ul_ref = random_repetitive_reference(600_000, seed=11, n_arrays=8)
    ul = (_fasta(d / "ul_ref.fa", [("chr1", ul_ref)]),
          _fasta(d / "ul_reads.fa", simulate_readset(ul_ref, 3, 30_000,
                                                     60_000, seed=12)))
    cdna = chip_smoke.cdna_set(24, genome_len=400_000, max_intron=5_000,
                               work=str(d))
    ava = _fasta(d / "ava_reads.fa", simulate_readset(
        random_reference(120_000, seed=1), 24, 5_000, 20_000, seed=3))
    hifi = chip_smoke.hifi_set(6, genome_len=200_000, n_chrom=1,
                               work=str(d))
    asm = chip_smoke.asm_set(genome_len=200_000, n_chrom=1,
                             sv_gap=(20_000, 40_000),
                             contig_len=(50_000, 100_000), work=str(d))
    return {"flowcell": fc, "ultralong": ul, "cdna": cdna, "ava": (ava, ava),
            "hifi": hifi, "asm": asm}


# the card side's flags of each e2e configuration (chip_smoke.e2e_configs,
# the smoke's ultra-long phase at -x map-ont) and the set it maps
E2E = [
    ("chain", ["--gpu-chain"], "flowcell"),
    ("map_ont", ["-x", "map-ont", "--gpu-chain"], "flowcell"),
    ("align", ["--gpu-chain", "--gpu-align", "-c"], "flowcell"),
    ("qstrand", ["--gpu-chain", "--gpu-align", "--qstrand", "-c"],
     "flowcell"),
    ("cdna", ["-ax", "splice", "--gpu-chain", "--gpu-align"], "cdna"),
    ("ultralong", ["--gpu-chain", "--gpu-cfg", os.path.join(
        gpucfg.CONFIG_DIR, "h100_over50k.json")], "ultralong"),
    ("ava", ["-x", "ava-ont", "--gpu-chain"], "ava"),
    ("hifi", ["-ax", "map-hifi", "--gpu-chain", "--gpu-align"], "hifi"),
    ("asm", ["-cx", "asm5", "--cs", "--gpu-chain", "--gpu-align"], "asm"),
]


@pytest.mark.parametrize("extra,name", [(e, n) for _t, e, n in E2E],
                         ids=[t for t, _e, _n in E2E])
def test_the_host_route_is_the_jax_host_path(extra, name, inputs):
    """Each configuration's baseline flags (e2ebench.host_flags of the
    card side's) map to the JAX package's bytes, SAM's @PG line too."""
    out = _both([SKIP_INF, "-t", "2", *E.host_flags(extra), *inputs[name]])
    assert out.count("\n") >= 3
    if "-ax" in extra:   # SAM
        assert out.startswith("@SQ")
    if "splice" in extra:   # with introns
        assert re.search(r"\t[0-9MIDS]+N", out)


@pytest.mark.parametrize("flags,ref,query,golden", [
    ([], "simref.fa.gz", "simreads.fa.gz", "sim200.skipinf.paf.gz"),
    (["--cs", "-c"], "simref.fa.gz", "simreads.fa.gz",
     "sim200.skipinf.cs.paf.gz"),
    (["-x", "splice", "-c"], "splice_genome.fa.gz", "splice_reads.fa.gz",
     "splice40.skipinf.c.paf.gz"),
    (["-f", "0.0002,50", "-c"], "rep60.fa.gz", "rep60_q.fa.gz",
     "rep60.maxocc.c.paf.gz"),
    (["-c", "-I", "20k"], "multi3.fa.gz", "multi3_q.fa.gz",
     "multi3.noI.c.paf.gz"),
    (["-a", "-I", "20k"], "multi3.fa.gz", "multi3_q.fa.gz",
     "multi3.noI.sam.gz"),
], ids=["sim200", "sim200_cs_c", "splice40", "rep60", "multi3",
        "multi3_sam"])
def test_the_host_route_gives_the_goldens(flags, ref, query, golden):
    out = _both([SKIP_INF, *flags, golden_path(ref), golden_path(query)])
    with gzip.open(golden_path(golden), "rt") as f:
        want = f.read()
    if "-a" in flags:   # the reference binary's @PG names its own command
        out, want = (
            "".join(line for line in s.splitlines(keepends=True)
                    if not line.startswith("@PG")) for s in (out, want))
    assert out == want


@pytest.mark.parametrize("kind", ["genomic", "splice", "pe"])
def test_the_fuzzers_reference_is_the_host_route(kind, tmp_path):
    """The fuzzer's default reference command is the host route; on a seed
    of each kind (scale 0.1) it gives the JAX package's bytes."""
    assert F.REF_CMD == E.HOST_CMD == [sys.executable, "-m",
                                       "mm2_gb_tpu_torch", "--device", "cpu"]
    seed = next(s for s in range(1000, 2000) if F.draw_kind(s) == kind)
    w = F.make_workload(seed, str(tmp_path), 0.1)
    argv = F.reference_argv(w)
    rc, out, err = F.run_reference(F.REF_CMD, argv)
    assert rc == 0, err[-2000:]
    rc, want, err = _main(jcli.main, argv)
    assert rc == 0, err[-2000:]
    assert out == want and out.count("\n") >= 1


def test_the_module_route_imports_no_torch_and_no_jax():
    """`python -m mm2_gb_tpu_torch --device cpu` (the e2e baseline's
    command) maps sim200 to its golden and imports neither torch, nor
    jax, nor any module of the JAX package (-X importtime lists every
    module the child imported)."""
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "mm2_gb_tpu_torch", *HOST, SKIP_INF,
                        golden_path("simref.fa.gz"),
                        golden_path("simreads.fa.gz")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with gzip.open(golden_path("sim200.skipinf.paf.gz"), "rt") as f:
        assert r.stdout == f.read()
    mods = {line.rsplit("|", 1)[1].strip().split(".")[0]
            for line in r.stderr.splitlines()
            if line.startswith("import time:") and "|" in line}
    assert "mm2_gb_tpu_torch" in mods
    assert not mods & {"torch", "jax", "mm2_gb_tpu"}


# each device flag (e2ebench.DEVICE_FLAGS, a value where it takes one),
# the name the error gives it; then by =, by prefix and at its default
REFUSED = [([f, "2"] if v else [f], "--gpu-" + f[6:])
           for f, v in E.DEVICE_FLAGS.items()] + [
    (["--gpu-devices=2"], "--gpu-devices"), (["--tpu-al"], "--gpu-align"),
    (["--gpu-rank", "0"], "--gpu-rank")]


@pytest.mark.parametrize("flags,name", REFUSED,
                         ids=[*E.DEVICE_FLAGS, "devices_eq", "abbreviated",
                              "at_default"])
def test_a_device_flag_with_device_cpu_exits_1(flags, name):
    """--device cpu refuses every device flag and names it, mapping
    nothing; it never drops the flag."""
    for argv in ([*HOST, *flags], [*flags, "--device=cpu"]):
        rc, out, err = _main(cli.main, [*argv, SKIP_INF,
                                        golden_path("simref.fa.gz"),
                                        golden_path("simreads.fa.gz")])
        assert (rc, out) == (1, "")
        assert err == ("[ERROR] --device cpu maps on the host and takes no "
                       f"device flag: {name}\n")


@pytest.mark.parametrize("argv,msg", [
    (["--device", "gpu"], "--device takes cuda or cpu, not 'gpu'"),
    (["--device=cuda:0"], "--device takes cuda or cpu, not 'cuda:0'"),
    (["--device="], "--device takes cuda or cpu, not ''"),
], ids=["gpu", "indexed", "empty"])
def test_a_bad_device_exits_1(argv, msg):
    rc, out, err = _main(cli.main, [*argv, golden_path("simref.fa.gz"),
                                    golden_path("simreads.fa.gz")])
    assert (rc, out, err) == (1, "", f"[ERROR] {msg}\n")


def test_device_without_a_value_exits_1():
    rc, out, err = _main(cli.main, [golden_path("simref.fa.gz"), "--device"])
    assert (rc, out) == (1, "")
    assert err == "[ERROR] --device needs a value: cuda or cpu\n"


def test_take_device():
    assert cli.take_device(["a", "b"]) == ("cuda", ["a", "b"])
    assert cli.take_device(["--device", "cpu", "-c", "a"]) == ("cpu",
                                                              ["-c", "a"])
    assert cli.take_device(["-c", "--device=cpu", "a", "--device",
                            "cuda"]) == ("cuda", ["-c", "a"])


@pytest.mark.parametrize("device", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
def test_no_cuda_device_names_device_cpu(device, monkeypatch):
    """With no CUDA device the card route exits 1 and names --device cpu;
    it maps nothing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _main(cli.main, [*device, SKIP_INF,
                                    golden_path("simref.fa.gz"),
                                    golden_path("simreads.fa.gz")])
    assert (rc, out) == (1, "")
    assert "needs a CUDA device" in err and "`--device cpu`" in err
    assert "mm2_gb_tpu`" not in err


def test_the_usage_block_adds_the_device_line():
    """The copied usage block, then one line of the port's: --device."""
    rc, out, err = _main(cli.main, [])
    jrc, _jout, jerr = _main(jcli.main, [])
    assert (rc, out, jrc) == (1, "", 1)
    assert err == jerr + cli._DEVICE_USAGE
    assert cli._DEVICE_USAGE.count("\n") == 1
    assert cli._DEVICE_USAGE.lstrip().startswith("--device ")


# a string constant that starts the JAX package: its name, one of its
# modules (what `-m` or importlib runs), or an import of it in a script
_JAX_NAME = re.compile(r"mm2_gb_tpu(\.\w[\w.]*)?")
_JAX_IMPORT = re.compile(r"(?:^|[\s;])(?:import|from)\s+mm2_gb_tpu(?!\w)")


def _starts_jax(tree):
    """The string constants of a module's tree that start the JAX package,
    as (line, text).  A constant compared with a name (`m == ...`,
    `.startswith(...)`) reads a module name; it runs nothing."""
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Constant) and isinstance(node.value,
                                                              str)):
            continue
        up = parents.get(node)
        if isinstance(up, ast.Compare) or (
                isinstance(up, ast.Call) and isinstance(up.func,
                                                        ast.Attribute)
                and up.func.attr == "startswith"):
            continue
        s = node.value
        if _JAX_NAME.fullmatch(s) or _JAX_IMPORT.search(s):
            yield node.lineno, s


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "mm2_gb_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_no_source_starts_the_jax_package():
    """No string constant of the port's sources or chip_smoke.py names the
    JAX package or one of its modules, or imports it in a script: nothing
    the port or the smoke runs, in process or in a child, needs it."""
    files = _sources()
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += [(os.path.relpath(path, ROOT), *hit)
                for hit in _starts_jax(tree)]
    assert bad == []


@pytest.mark.parametrize("src,n", [
    ('subprocess.run([sys.executable, "-m", "mm2_gb_tpu"])', 1),
    ('REF = ["-m", "mm2_gb_tpu.tools.paftools"]', 1),
    ('importlib.import_module("mm2_gb_tpu.cli")', 1),
    ('code = "import sys\\nfrom mm2_gb_tpu.utils import native\\n"', 1),
    ('code = "import os; import mm2_gb_tpu"', 1),
    ('ok = ["-m", "mm2_gb_tpu_torch", "--device", "cpu"]', 0),
    ('code = "from mm2_gb_tpu_torch import cli"', 0),
    ('src = "mm2_gb_tpu/ops/chain_tpu.py:222"', 0),
    ('bad = m == "mm2_gb_tpu" or m.startswith("mm2_gb_tpu.")', 0),
], ids=["run", "module", "importlib", "script_from", "script_import",
        "port", "port_script", "path", "compare"])
def test_the_static_check_finds_what_starts_the_jax_package(src, n):
    assert len(list(_starts_jax(ast.parse(src)))) == n


def test_the_smokes_host_runs_refuse_the_jax_package(capsys):
    """chip_smoke._host fails the smoke on an argv that runs the JAX
    package (-m) or imports it in a -c script, before it starts a child;
    the port's modules pass."""
    import chip_smoke
    for args in (["-m", "mm2_gb_tpu", SKIP_INF], ["-m", "mm2_gb_tpu.cli"],
                 ["-c", "from mm2_gb_tpu.utils import native\n"],
                 ["-c", "import sys; import mm2_gb_tpu"]):
        with pytest.raises(SystemExit) as e:
            chip_smoke._host(args, "t")
        assert e.value.code == 1
        assert "the run would start the JAX package" in capsys.readouterr().out
    assert chip_smoke.PORT_HOST == E.HOST_CMD
    assert chip_smoke._host(["-c", "import mm2_gb_tpu_torch; print(1)"],
                            "t") == "1\n"
