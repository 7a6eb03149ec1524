"""The PyTorch port never imports JAX, nor any module of the JAX package.

The run check is a subprocess: this test process already holds JAX (the
JAX package's tests import it).  The child blocks every `jax` and every
`mm2_gb_tpu` import (the name, or the prefix `mm2_gb_tpu.`; the port's
`mm2_gb_tpu_torch` passes), then imports each module of
mm2_gb_tpu_torch, maps reads through the GPU pipeline on CPU tensors,
through the CLI's host path and through the CLI's `--gpu-chain
--gpu-align -c` run path on CPU tensors, for the default preset, for
`-x splice` (the exts2 fills) and for `--qstrand` (the Python fill
session's gap fills and extensions), and runs the two ranks of a
`--tpu-nproc 2` run and the port's mergeshards.  A static check reads
every import of the port's sources (the parallel/ and tools/
subpackages among them) and of chip_smoke.py.  A last check holds the
port's host path against the JAX package's on the same seeded input.
"""

import ast
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, io, contextlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        for pkg in ("jax", "mm2_gb_tpu"):
            if name == pkg or name.startswith(pkg + "."):
                raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import pkgutil
import mm2_gb_tpu_torch
for mod in pkgutil.walk_packages(mm2_gb_tpu_torch.__path__,
                                 "mm2_gb_tpu_torch."):
    if mod.name != "mm2_gb_tpu_torch.__main__":   # that one runs the CLI
        importlib.import_module(mod.name)
assert {"mm2_gb_tpu_torch.parallel.mesh",
        "mm2_gb_tpu_torch.tools.mergeshards", "mm2_gb_tpu_torch.api",
        "mm2_gb_tpu_torch.tools.paftools", "mm2_gb_tpu_torch.tools.mmphase",
        "mm2_gb_tpu_torch.utils.timeline"} <= set(sys.modules)

from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.fastx import SeqRecord
from mm2_gb_tpu_torch.utils.simulate import random_reference, simulate_readset
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.models.pipeline import map_batch_gpu

ref = random_reference(30_000, seed=5)
reads = simulate_readset(ref, 3, 800, 2_000, seed=6)
io_, mo = O.set_preset(None)
mo.max_chain_skip = 2**31 - 1
index = MinimizerIndex.from_strings([ref], io_, names=["c"])
O.mapopt_update(mo, index)
out = map_batch_gpu(index, mo, [SeqRecord(i, n, s)
                                for i, (n, s) in enumerate(reads)], "cpu")
assert sum(len(regs) for _, regs in out) >= 3
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    argv, args = cli.parse_args(["--max-chain-skip=2147483647", sys.argv[1],
                                 sys.argv[2]])
    io_, mo = O.set_preset(args.preset)
    assert cli._run(args, argv, io_, mo) == 0
assert buf.getvalue().count("\n") > 100

import os, tempfile, torch
tmp = tempfile.mkdtemp()
with open(os.path.join(tmp, "r.fa"), "w") as f:
    f.write(">c\n" + ref + "\n")
with open(os.path.join(tmp, "q.fa"), "w") as f:
    f.write("".join(">%s\n%s\n" % r for r in reads))
argv, args = cli.parse_args(["--max-chain-skip=2147483647", "--gpu-chain",
                             "--gpu-align", "-c", "-v", "3",
                             os.path.join(tmp, "r.fa"),
                             os.path.join(tmp, "q.fa")])
io_, mo = O.set_preset(args.preset)
buf, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
    assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
assert buf.getvalue().count("\tcg:Z:") >= 3
assert "fills: " in err.getvalue()
single_c = buf.getvalue()

import gzip
with gzip.open(sys.argv[3], "rt") as f:
    recs = f.read().split(">")[1:]
with open(os.path.join(tmp, "s.fa"), "w") as f:
    f.write("".join(">" + r for r in recs[16:18]))
argv, args = cli.parse_args(["--max-chain-skip=2147483647", "--gpu-chain",
                             "--gpu-align", "-x", "splice", "-c", "-v", "3",
                             sys.argv[4], os.path.join(tmp, "s.fa")])
io_, mo = O.set_preset(args.preset)
buf, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
    assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
assert any("N" in line.split("cg:Z:")[1]           # an intron
           for line in buf.getvalue().splitlines() if "cg:Z:" in line)
assert " 0 host-routed" in err.getvalue()

argv, args = cli.parse_args(["--max-chain-skip=2147483647", "--gpu-chain",
                             "--gpu-align", "--qstrand", "-c", "-v", "3",
                             os.path.join(tmp, "r.fa"),
                             os.path.join(tmp, "q.fa")])
io_, mo = O.set_preset(args.preset)
buf, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
    assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
assert buf.getvalue().count("\tcg:Z:") >= 3
assert "; extensions: 0 " not in err.getvalue()

pre = os.path.join(tmp, "rk")
for rank in ("0", "1"):
    argv, args = cli.parse_args(["--max-chain-skip=2147483647", "--gpu-chain",
                                 "--gpu-align", "-c", "--tpu-nproc", "2",
                                 "--tpu-rank", rank, "-o", pre,
                                 os.path.join(tmp, "r.fa"),
                                 os.path.join(tmp, "q.fa")])
    io_, mo = O.set_preset(args.preset)
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
from mm2_gb_tpu_torch.tools import mergeshards
merged = io.StringIO()
assert mergeshards.merge(pre, 2, merged) == 0
assert merged.getvalue() == single_c

from mm2_gb_tpu_torch.utils import native
assert native.available()
assert os.path.dirname(native._lib_path()) == native.BUILD_DIR
assert native.BUILD_DIR.endswith(os.path.join("build", "hostkit"))
assert "jax" not in sys.modules
assert not [m for m in sys.modules
            if m == "mm2_gb_tpu" or m.startswith("mm2_gb_tpu.")]
print("NOJAX_OK")
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "MM2TPU_FORCE_CPU"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", SCRIPT,
                        golden_path("simref.fa.gz"),
                        golden_path("simreads.fa.gz"),
                        golden_path("splice_reads.fa.gz"),
                        golden_path("splice_genome.fa.gz")],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


def _imports(path):
    """Every module name an import statement of a source file names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_nothing_of_the_jax_package():
    """No .py file of mm2_gb_tpu_torch, and not chip_smoke.py, imports
    `mm2_gb_tpu` or a module under it (the port keeps its own copies)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "mm2_gb_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(f, m) for f in files for m in _imports(f)
           if m == "mm2_gb_tpu" or m.startswith("mm2_gb_tpu.")
           or m == "jax" or m.startswith("jax.")]
    assert bad == []


def _seeded_input(tmp_path):
    """A seeded reference and read sets (numpy): long reads with
    substitutions and indels on both strands, and read pairs."""
    rng = np.random.default_rng(83)
    ref = rng.integers(0, 4, 120_000).astype(np.uint8)
    ref[50_000:50_600] = np.tile(rng.integers(0, 4, 6), 100)   # a repeat
    lut, comp = np.frombuffer(b"ACGT", np.uint8), np.array([3, 2, 1, 0])

    def mutate(s):
        u = rng.random(s.shape[0])
        s = np.where(u < 0.04, rng.integers(0, 4, s.shape[0]), s)
        return np.delete(s, np.nonzero(u > 0.985)[0])

    reads, pairs1, pairs2 = [], [], []
    for i in range(14):
        st = int(rng.integers(0, 110_000))
        r = mutate(ref[st:st + int(rng.integers(800, 9_000))])
        reads.append(comp[r[::-1]] if i % 2 else r)
    for i in range(20):
        st = int(rng.integers(0, 119_000))
        frag = ref[st:st + int(rng.integers(300, 600))]
        pairs1.append(frag[:150])
        pairs2.append(comp[frag[-150:][::-1]])

    def fa(name, seqs):
        path = tmp_path / name
        path.write_bytes(b"".join(b">r%d\n%s\n" % (i, lut[s].tobytes())
                                  for i, s in enumerate(seqs)))
        return str(path)
    return (fa("ref.fa", [ref]), fa("reads.fa", reads),
            fa("p1.fa", pairs1), fa("p2.fa", pairs2))


@pytest.mark.parametrize("flags", [
    ["-c"], ["--cs", "-c"], ["-a"], ["-x", "splice", "-c"],
    ["-x", "sr", "-a", "PAIR"], ["--qstrand", "-c"]],
    ids=["c", "cs_c", "sam", "splice", "sr_pair", "qstrand_c"])
def test_host_path_matches_the_jax_package(flags, tmp_path):
    """The port's host path (its own copies) and the JAX package's map
    the same seeded input to the same bytes."""
    from mm2_gb_tpu import cli as jcli
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.utils import opts as O

    def port_host(argv):   # the host path of the port's _run
        argv, args = cli.parse_args(argv)
        io_, mo = O.set_preset(args.preset)
        return cli._run(args, argv, io_, mo)
    ref, reads, p1, p2 = _seeded_input(tmp_path)
    query = [p1, p2] if "PAIR" in flags else [reads]
    argv = ["--max-chain-skip=2147483647", "-t", "2",
            *(f for f in flags if f != "PAIR"), ref, *query]
    outs = []
    for main in (port_host, jcli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main(list(argv)) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") >= 14
