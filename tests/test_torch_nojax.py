"""The PyTorch port never imports JAX.

Runs in a subprocess: this test process already holds JAX (the JAX
package's tests import it).  The child blocks every `jax` import, then
imports each module of mm2_gb_tpu_torch, maps reads through the GPU
pipeline on CPU tensors, through the CLI's host path and through the
CLI's `--gpu-chain --gpu-align -c` run path on CPU tensors, for the
default preset and for `-x splice` (the exts2 fills).
"""

import os
import subprocess
import sys

from tests.conftest import golden_path

SCRIPT = r"""
import importlib, io, contextlib, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
for m in ("mm2_gb_tpu_torch", "mm2_gb_tpu_torch.cli",
          "mm2_gb_tpu_torch.ops.chain_gpu", "mm2_gb_tpu_torch.ops.ksw2_gpu",
          "mm2_gb_tpu_torch.ops.ksw2s_gpu",
          "mm2_gb_tpu_torch.models.pipeline", "mm2_gb_tpu_torch.utils.gpucfg",
          "mm2_gb_tpu_torch.utils.kernels"):
    importlib.import_module(m)

from mm2_gb_tpu.models.index import MinimizerIndex
from mm2_gb_tpu.utils import opts as O
from mm2_gb_tpu.utils.fastx import SeqRecord
from mm2_gb_tpu.utils.simulate import random_reference, simulate_readset
from mm2_gb_tpu_torch.cli import main
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
    assert main(["--max-chain-skip=2147483647", sys.argv[1],
                 sys.argv[2]]) == 0
assert buf.getvalue().count("\n") > 100

import os, tempfile, torch
from mm2_gb_tpu_torch import cli
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
assert "jax" not in sys.modules
assert "mm2_gb_tpu.ops.ksw2_tpu" not in sys.modules
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
