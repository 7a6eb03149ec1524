"""The port's differential fuzzer (mm2_gb_tpu_torch.tools.fuzz_diff).

- Its generators reproduce the repo's tools/fuzz_diff.py seed for seed:
  for seeds of every original kind, the same files byte for byte (the
  original's written under tmp_path instead of /tmp) and the same flags
  but for the work directory in their paths.
- A small campaign, seeds 0..7, covers every kind, `long` included.  It
  runs at scale 0.1: reference lengths, read lengths and read counts are
  a tenth of the tool's, with floors (a genomic reference of 2-40 kb and
  3-6 reads, a splice genome of 4-20 kb, 4-20 read pairs, a long-read
  reference of 100-400 kb with 3-10 kb reads and inserts of 300 bases to
  6 kb).  Each seed's `--gpu-chain` run path on the CPU (the kernels'
  plain twins, `--gpu-align` where the flags align) is held against the
  JAX package's host path in this process, byte for byte.
- The flags each side gets, and the command line: exit 0 when the two
  sides match, 1 on a divergence.
"""

import contextlib
import io
import os
import random
import sys

import pytest
import torch

from mm2_gb_tpu import cli as jcli
from mm2_gb_tpu_torch.tools import fuzz_diff as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.1
CAMPAIGN = range(8)
# seeds on which both tools draw the same kind
SAME_KIND = [(1, "genomic"), (3, "genomic"), (9, "genomic"),
             (5, "splice"), (6, "splice"), (20, "pe"), (23, "pe")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def original():
    """The repo's tools/fuzz_diff.py, imported from its directory."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import fuzz_diff
    finally:
        sys.path.pop(0)
    return fuzz_diff


@pytest.mark.parametrize("seed,kind", SAME_KIND,
                         ids=[f"{k}{s}" for s, k in SAME_KIND])
def test_generators_reproduce_the_original(seed, kind, original, tmp_path,
                                           monkeypatch):
    written = {}

    def write_fa(path, recs):   # the original's file, under tmp_path
        local = str(tmp_path / "orig" / os.path.basename(path))
        written[path] = local
        F.write_fa(local, recs)
    os.makedirs(tmp_path / "orig")
    monkeypatch.setattr(original, "write_fa", write_fa)
    rng = random.Random(seed)
    assert rng.choices(["genomic", "splice", "pe"], [0.6, 0.25, 0.15])[0] \
        == kind == F.draw_kind(seed)
    flags, files = {"genomic": original.make_genomic,
                    "splice": original.make_splice,
                    "pe": original.make_pe}[kind](rng, seed)
    w = F.make_workload(seed, str(tmp_path / "port"))
    assert w.kind == kind and len(w.files) == len(files) == len(written)
    for a, b in zip(files, w.files):
        with open(written[a], "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert w.flags == [f.replace("/tmp/", w.work + "/") for f in flags]
    assert w.threads in F.THREADS


def test_the_small_campaign_covers_every_kind():
    assert {F.draw_kind(s) for s in CAMPAIGN} == set(F.KINDS)


def _jax_host(argv):
    """The JAX package's host path in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jcli.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("seed", CAMPAIGN)
def test_a_campaign_seed_matches_the_jax_host_path(seed, tmp_path):
    out = io.StringIO()
    c = F.campaign([seed], torch.device("cpu"), str(tmp_path), ref=_jax_host,
                   scale=SCALE, out=out)
    r = c.results[0]
    assert r.ok, out.getvalue()
    assert r.rc == (0, 0) and r.lines[0] == r.lines[1]
    assert out.getvalue().startswith(f"ok   seed={seed} ")
    # CPU tensors: no kernel launch, every run still reports its routes
    assert not +r.launches
    # the per-part mapping of a multi-part index prints no `-v 3` lines
    parts = any(f in ("-I", "--split-prefix") for f in r.w.flags)
    on_device = "host_chain_fallback" not in r.routes and not parts
    assert (r.routes["hpc_host_batches"] > 0) == (on_device
                                                  and "-H" in r.w.flags)
    if on_device and F.aligns(r.w.flags):
        assert r.routes["fills"] + r.routes["extensions"] > 0


# seeds whose card run differed from the host path before their repair,
# with the part of their flags the repair concerns (their -c left out:
# the twins take minutes for those reads' fills), and the route each
# repaired run must report, if any
FOUND = [(1020, ["-x", "asm20"], "rmq_host_batches"),
         (1063, ["-x", "map-pb"], "hpc_host_batches"),
         (2230, ["-T", "20"], None)]


@pytest.mark.parametrize("seed,flags,route", FOUND,
                         ids=["rmq_asm20_1020", "hpc_map_pb_1063",
                              "sdust_2230"])
def test_a_seed_the_card_found_matches(seed, flags, route, tmp_path):
    """RMQ chaining (-x asm20) chains on the host, as on the host path, not
    with the chain kernel's DP; the HPC host route (-x map-pb) chains each
    read of a batch alone; -T masks low-complexity query minimizers
    before the device chains them.  Each run differed from the host path
    before (s2 10513 against 10512; cm 332 against 356; cm 2382 against
    2381)."""
    w = F.make_workload(seed, str(tmp_path))
    assert w.flags == flags + ["-c"]
    w.flags = flags
    dev = F.run_device(F.device_argv(w), torch.device("cpu"))
    r = F.compare(w, dev, _jax_host(F.reference_argv(w)), F.Counter(), 0)
    assert r.ok, r.line()
    assert r.lines[0] >= 13 and (route is None or r.routes[route] > 0)


def test_each_side_gets_its_flags():
    w = F.Workload(7, "splice", ["-x", "splice", "-u", "b", "-c",
                                 "--tpu-chain", "--tpu-align"],
                   ["r.fa", "q.fa"], 4, "d")
    assert F.device_argv(w) == [F.SKIP_INF, "-t", "4", "--gpu-chain",
                                "--gpu-align", "-x", "splice", "-u", "b",
                                "-c", "r.fa", "q.fa"]
    assert F.reference_argv(w) == [F.SKIP_INF, "-t", "4", "-x", "splice",
                                   "-u", "b", "-c", "r.fa", "q.fa"]
    for flags, align in ((["-H"], False), (["--dual=no"], False),
                         (["-a", "-Y"], True), (["--cs=long", "-c"], True),
                         (["-a", "--MD"], True), (["-k", "28", "-w", "28"],
                                                  False)):
        w.flags = flags
        assert ("--gpu-align" in F.device_argv(w)) == align
    w.flags = ["-I", "10k", "--split-prefix", "d/sp", "--tpu-chain", "-c"]
    assert F.device_argv(w)[4:-2] == ["--gpu-align", "-I", "10k",
                                      "--split-prefix", "d/sp", "-c"]
    assert F.reference_argv(w)[3:-2] == ["-I", "10k", "--split-prefix",
                                         "d/sp.ref", "-c"]


def test_the_command_line_tells_a_match_from_a_divergence(tmp_path, capsys):
    """Seed 3 (genomic, -H: the chain takes the host route) on the CPU
    against the JAX package's host path in a subprocess: exit 0; against
    a command that prints nothing: exit 1, and the seed's files kept."""
    args = ["1", "3", "--device", "cpu", "--work", str(tmp_path)]
    assert F.main(args) == 0
    out = capsys.readouterr().out
    assert out.startswith("ok   seed=3 genomic  -t 8 flags=-H ")
    assert "1/1 matched" in out and not os.path.exists(tmp_path / "3")
    assert F.main(args + ["--ref-cmd", f"{sys.executable} -c pass"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("FAIL seed=3 genomic") and "0/1 matched" in out
    assert os.path.exists(tmp_path / "3" / "fz_3_r.fa")
