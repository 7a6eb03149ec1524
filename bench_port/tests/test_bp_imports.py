"""What the benchmark loads: neither JAX nor the JAX package in a run,
nothing of the program in the reference, and none of the JAX package's
benchmark files anywhere."""

import ast
import os
import subprocess
import sys

from bench_port.tests.bp_tiny import ROOT
from bench_port import harness

BENCH = os.path.join(ROOT, "bench_port")


def _sources(sub=""):
    for d, _dirs, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("mm2_gb_tpu_torch_probe", sys)
    try:
        assert "mm2_gb_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("mm2_gb_tpu_torch_probe")
    sys.modules["mm2_gb_tpu.probe"] = sys
    try:
        assert harness.forbidden_modules() == ["mm2_gb_tpu.probe"]
    finally:
        sys.modules.pop("mm2_gb_tpu.probe")


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "mm2_gb_tpu_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_benchmarks():
    for path in _sources():
        if path == os.path.abspath(__file__):
            continue
        text = open(path).read()
        for word in ("benchmarks/", "bench.py", "BENCH_", "MULTICHIP_"):
            assert word not in text, (path, word)


def test_a_run_loads_no_jax():
    """A tiny run on the CPU in a child process: afterwards sys.modules
    holds no module of jax, jaxlib, flax or mm2_gb_tpu."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from bench_port.tests import bp_tiny\n"
        "from bench_port import harness\n"
        "def main():\n"
        "    res = harness.run(bp_tiny.cell('hifi.sam'), 5, 0.5, False,"
        " device='cpu')\n"
        "    print(json.dumps(dict(correct=res['correct'],"
        " bad=harness.forbidden_modules())))\n"
        "if __name__ == '__main__':\n"
        "    main()\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert '"bad": []' in last and '"correct": true' in last, last
