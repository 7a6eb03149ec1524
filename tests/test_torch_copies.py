"""The port's copies of the JAX package's host modules stay copies, and its
host kit builds and runs under a sanitizer.

The port keeps its own copy of each host module it needs (the JAX
package is the reference and is never imported by the port).  Apart from
the import statements, each copy equals its original once the port's
package name is read as the JAX package's (and, in a copy with changes
of its own, once the definitions listed for it are left out); the C++
sources of the port's host kit equal the JAX package's csrc/ byte for
byte.  The ubsan and asan builds of the port's kit
(`native.build_sanitized`, the JAX package's `make -C csrc ubsan` and
`asan`) map the sim200 reads on the host path in a child, with
MM2TPU_NATIVE_LIB pointing at them, to the golden bytes and without a
sanitizer's report.
"""

import ast
import gzip
import os
import subprocess
import sys

import pytest

from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mm2_gb_tpu_torch")
JAX = os.path.join(ROOT, "mm2_gb_tpu")

# the verbatim copies (but for imports), by path in both packages
COPIES = [
    "utils/opts.py", "utils/fastx.py", "utils/hashkit.py", "utils/ksort.py",
    "utils/paf.py", "utils/sam.py", "utils/simulate.py",
    "ops/sketch.py", "ops/sdust.py", "ops/seed.py", "ops/chain.py",
    "ops/chain_rmq.py", "ops/ksw2.py", "ops/ksw2_splice.py", "ops/align.py",
    "models/index.py", "models/hit.py", "models/mapper.py", "models/pe.py",
    "models/stream.py", "tools/mergeshards.py",
    "utils/timeline.py", "api.py", "tools/mmphase.py", "tools/paftools.py",
]
# the copies with changes of their own: the top-level definitions that
# differ, and why; every other definition of the original is copied
EXCEPTIONS = {
    # the port builds its own kit (build/hostkit, a hash of its sources,
    # the sanitizer builds) where the JAX package runs make in csrc/
    "utils/native.py": {"_lib_path", "_load"},
    # per-part mapping takes the device to map on
    "models/splitmerge.py": {"map_multipart"},
    # the Aligner maps on the card unless the caller asks for the host
    # (device="cpu"), where the JAX package's maps on the host only
    "api.py": {"Aligner"},
}


def _body(path, skip=()):
    """The module's source lines without its import statements (and the
    blank lines between their groups) and the top-level definitions
    named in skip, the port's package name read as the JAX package's."""
    with open(path) as f:
        src = f.read()
    drop = set()
    tree = ast.parse(src, path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    lines = src.splitlines()
    for n in range(2, len(lines)):   # a blank line n between import groups
        if not lines[n - 1].strip() and n - 1 in drop and n + 1 in drop:
            drop.add(n)
    for node in tree.body:
        if getattr(node, "name", None) in skip:
            start = min([node.lineno] + [d.lineno
                                         for d in node.decorator_list])
            drop.update(range(start, node.end_lineno + 1))
    return [line.replace("mm2_gb_tpu_torch", "mm2_gb_tpu")
            for i, line in enumerate(lines, 1) if i not in drop]


def _defs(path):
    """Top-level functions and classes: name -> source (imports dropped,
    package name mapped as in _body)."""
    with open(path) as f:
        src = f.read()
    out = {}
    for node in ast.parse(src, path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            seg = ast.get_source_segment(src, node)
            kept = [line for line in seg.splitlines()
                    if not line.strip().startswith(("import ", "from "))]
            out[node.name] = "\n".join(kept).replace("mm2_gb_tpu_torch",
                                                     "mm2_gb_tpu")
    return out


def _sanitized_run(sanitizer, env_extra=()):
    """Build the port's host kit with the sanitizer and map sim200 with it
    on the host path (--cs -c at --max-chain-skip=2147483647) in a child,
    the sanitizer's runtime preloaded: the child's CompletedProcess."""
    from mm2_gb_tpu_torch.utils import native
    lib = native.build_sanitized(sanitizer)
    assert lib and os.path.dirname(lib) == native.BUILD_DIR
    assert os.path.basename(lib).startswith(f"libhostkit-{sanitizer}-")
    assert lib == native._build_path(sanitizer) != native._build_path()
    runtime = subprocess.run(["g++", f"-print-file-name=lib{sanitizer}.so"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    child = (
        "import sys\n"
        "from mm2_gb_tpu_torch import cli\n"
        "from mm2_gb_tpu_torch.utils import native, opts\n"
        "assert native._lib_path() == sys.argv[1] and native.available()\n"
        "argv, args = cli.parse_args(sys.argv[2:])\n"
        "io_, mo = opts.set_preset(args.preset)\n"
        "sys.exit(cli._run(args, argv, io_, mo))\n")
    env = dict(os.environ, MM2TPU_NATIVE_LIB=lib, LD_PRELOAD=runtime,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""),
               **dict(env_extra))
    env.pop("MM2TPU_FORCE_CPU", None)
    return subprocess.run([sys.executable, "-c", child, lib,
                           "--max-chain-skip=2147483647", "--cs", "-c", "-t",
                           "2", golden_path("simref.fa.gz"),
                           golden_path("simreads.fa.gz")],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


def _golden_cs():
    with gzip.open(golden_path("sim200.skipinf.cs.paf.gz"), "rt") as f:
        return f.read()


def test_the_sanitizer_build_maps_the_goldens():
    """The ubsan build of the port's host kit in a child on the host path
    (--cs -c at --max-chain-skip=2147483647, sim200): the golden bytes,
    and no `runtime error:` on stderr."""
    r = _sanitized_run("ubsan")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "runtime error:" not in r.stderr
    assert r.stdout == _golden_cs()


def test_the_asan_build_maps_the_goldens():
    """The asan build likewise: the golden bytes, and no AddressSanitizer
    report (one would also end the child with an error)."""
    r = _sanitized_run("asan", {"ASAN_OPTIONS": "detect_leaks=0"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "AddressSanitizer" not in r.stderr
    assert r.stdout == _golden_cs()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original_but_imports(rel):
    skip = EXCEPTIONS.get(rel, ())
    assert (_body(os.path.join(PORT, rel), skip)
            == _body(os.path.join(JAX, rel), skip))


@pytest.mark.parametrize("rel", sorted(EXCEPTIONS))
def test_copies_with_changes_differ_only_where_listed(rel):
    port, jax = (_defs(os.path.join(d, rel)) for d in (PORT, JAX))
    differ = {n for n in jax if port.get(n) != jax[n]}
    assert differ == EXCEPTIONS[rel]


def test_host_kit_sources_equal_the_jax_packages():
    host = os.path.join(PORT, "csrc", "host")
    names = sorted(os.listdir(host))
    assert names == sorted(n for n in os.listdir(os.path.join(ROOT, "csrc"))
                           if n.endswith((".cpp", ".h")))
    for name in names:
        with open(os.path.join(host, name), "rb") as a, \
                open(os.path.join(ROOT, "csrc", name), "rb") as b:
            assert a.read() == b.read(), name
