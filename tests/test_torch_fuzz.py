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
- The `ava` kind, which no seed draws (`--kind ava`): reads against
  themselves at -x ava-*, two seeds at scale 0.1 on the twins against
  the port's host route (itself held to the JAX package's host path),
  each with overlaps to compare; a seed whose output breaks the overlap
  filters fails; and a genomic seed that draws -x ava-ont (reads named
  q{i} against a reference named fr or ctg{k}: NO_DUAL drops every hit)
  is counted among the seeds whose two outputs were both empty.
- The `asm` kind, which no seed draws either (`--kind asm`): contigs with
  SVs against their reference at -x asm*, one seed at scale 0.1 on the
  twins against the JAX package's host path; a seed of either kind no
  seed draws fails when both its outputs are empty.
"""

import contextlib
import io
import os
import random
import sys

import pytest
import torch

from mm2_gb_tpu import cli as jcli
from mm2_gb_tpu_torch import cli
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


def _host_route(argv):
    """The port's host route (`cli.main --device cpu`) in this process,
    equal to the JAX package's host path on the same arguments."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--device", "cpu", *argv])
    assert (rc, out.getvalue()) == _jax_host(argv)[:2]
    return rc, out.getvalue(), err.getvalue()


# ava seeds at scale 0.1: -x ava-ont, and -x ava-ont -c (--gpu-align)
AVA_SEEDS = [(0, ["-x", "ava-ont"]), (1, ["-x", "ava-ont", "-c"])]


@pytest.mark.parametrize("seed,flags", AVA_SEEDS, ids=["ava_ont", "ava_ont_c"])
def test_an_ava_seed_compares_overlaps(seed, flags, tmp_path):
    out = io.StringIO()
    c = F.campaign([seed], torch.device("cpu"), str(tmp_path),
                   ref=_host_route, scale=SCALE, out=out, kind="ava")
    r = c.results[0]
    assert r.ok, out.getvalue()
    assert (r.w.kind, r.w.flags) == ("ava", flags)
    assert r.w.threads in F.THREADS and r.w.files[0] == r.w.files[1]
    assert r.lines[0] == r.lines[1] > 0 and not r.empty and r.faults == 0
    assert r.routes["hpc_host_batches"] == r.routes["rmq_host_batches"] == 0
    assert (r.routes["fills"] > 0) == ("-c" in flags)
    assert c.totals()["empty"] == {}
    assert "both outputs empty: 0 seeds" in c.summary()


def test_an_ava_seed_that_breaks_the_overlap_filters_fails(tmp_path):
    """Both sides give the same bytes, but a line has its query name
    after its target name: the seed fails and says why."""
    w = F.make_workload(0, str(tmp_path), SCALE, kind="ava")
    line = "s9\t900\t0\t800\t+\ts10\t900\t0\t800\t700\t800\t0\n"
    r = F.compare(w, (0, line, ""), (0, line, ""), F.Counter(), 0)
    assert not r.ok and r.faults == 1 and not r.empty
    assert "overlap-filter faults=1" in r.line()
    w.kind = "genomic"   # the check reads ava seeds only
    assert F.compare(w, (0, line, ""), (0, line, ""), F.Counter(), 0).ok


def test_a_genomic_seed_at_ava_ont_is_counted_empty(tmp_path):
    """Seed 18 draws the genomic kind and -x ava-ont: reads q{i} against
    a reference named fr or ctg{k}, so NO_DUAL drops every anchor and
    both sides print nothing.  The seed matches, and the summary counts
    it as a match that compared nothing."""
    out = io.StringIO()
    c = F.campaign([18], torch.device("cpu"), str(tmp_path), ref=_jax_host,
                   scale=SCALE, out=out)
    r = c.results[0]
    assert r.ok and (r.w.kind, r.w.flags) == ("genomic", ["-x", "ava-ont"])
    assert r.empty and r.lines == (0, 0)
    assert c.totals()["empty"] == {"genomic -x ava-ont": 1}
    assert ("both outputs empty: 1 seeds, by kind and flags "
            "{'genomic -x ava-ont': 1}") in c.summary()


def test_an_asm_seed_aligns_contigs(tmp_path):
    """Seed 2 of the asm kind at scale 0.1 (one contig of 26 kb with
    deletions and insertions, at -x asm10 -c --cs): its chains go to the
    host by RMQ, its gap fills through the fill twin, and its PAF equals
    the JAX package's host path's."""
    out = io.StringIO()
    c = F.campaign([2], torch.device("cpu"), str(tmp_path), ref=_jax_host,
                   scale=SCALE, out=out, kind="asm")
    r = c.results[0]
    assert r.ok, out.getvalue()
    assert (r.w.kind, r.w.flags) == ("asm", ["-x", "asm10", "-c", "--cs"])
    assert r.lines[0] == r.lines[1] > 0 and not r.empty
    assert r.routes["rmq_host_batches"] > 0
    assert r.routes["hpc_host_batches"] == 0
    assert r.routes["fills"] > 0 and r.routes["fills_host"] == 0


@pytest.mark.parametrize("kind", F.OTHER_KINDS)
def test_a_seed_of_a_kind_no_seed_draws_fails_on_empty_outputs(kind,
                                                               tmp_path):
    w = F.make_workload(0, str(tmp_path), SCALE, kind=kind)
    r = F.compare(w, (0, "", ""), (0, "", ""), F.Counter(), 0)
    assert not r.ok and r.empty and "both outputs empty" in r.line()
    w.kind = "genomic"   # a drawn kind may compare two empty outputs
    assert F.compare(w, (0, "", ""), (0, "", ""), F.Counter(), 0).ok


# the smoke's fuzz seeds (chip_smoke.FUZZ_SEEDS): each one's kind and
# flags, as its comment there gives them
SMOKE_SEEDS = {1001: ("splice", ["-x", "splice:hq", "-c"]),
               1002: ("genomic", ["-D", "-c"]),
               1013: ("pe", ["-x", "sr", "-a", "--secondary", "no"]),
               1020: ("genomic", ["-x", "asm20", "-c"]),
               1025: ("genomic", ["-I", "100k", "--split-prefix", "-c"]),
               1036: ("genomic", ["--tpu-chain", "-f", "0.0002,5000", "-c"]),
               1043: ("long", ["-r", "500,80000", "-c"]),
               1058: ("genomic", ["-a", "--MD"]),
               1063: ("genomic", ["-x", "map-pb", "-c"])}


def test_the_smokes_fuzz_seeds_are_the_ones_it_names():
    import chip_smoke
    assert chip_smoke.FUZZ_SEEDS == tuple(SMOKE_SEEDS)
    assert {F.draw_kind(s) for s in SMOKE_SEEDS} == set(F.KINDS)


@pytest.mark.parametrize("seed", list(SMOKE_SEEDS))
def test_a_smoke_fuzz_seed_draws_its_kind_and_flags(seed, tmp_path):
    w = F.make_workload(seed, str(tmp_path))
    flags = [f for f in w.flags if not f.startswith(w.work)]
    assert (w.kind, flags) == SMOKE_SEEDS[seed]


def _reached(seed, kind, flags, launches=(), routes=()):
    """A matching seed's result with the given launches and routes."""
    w = F.Workload(seed, kind, list(flags), [], 1, "")
    return F.SeedResult(w, True, (0, 0), (1, 1), "", F.Counter(launches),
                        F.Counter(routes), 0.0)


def _full_campaign(drop=None):
    """A campaign that reaches all that chip_smoke.fuzz_missing requires,
    but for drop: a kind, a flag, a launch or class key, or a route."""
    import chip_smoke
    launches = {k: 1 for k in ("chain_segments", "extd2_fill", "exts2_fill",
                               "ksw2_backtrack_intron",
                               *chip_smoke.FUZZ_CLASSES)}
    launches["ksw2_backtrack"] = 2   # one genomic, one intron
    if drop == "ksw2_backtrack":
        launches["ksw2_backtrack"] = 1
    routes = {k: 1 for k in chip_smoke.FUZZ_ROUTES}
    launches.pop(drop, None)
    routes.pop(drop, None)
    kinds = [k for k in F.KINDS if k != drop]
    flags = [] if drop == "-a" else ["-a"]
    return F.Campaign([_reached(0, kinds[0], flags, launches, routes)]
                      + [_reached(i, k, []) for i, k in
                         enumerate(kinds[1:], 1)])


MISSING = [("pe", "kind pe"), ("long", "kind long"),
           ("-a", "SAM output (-a)"),
           ("rmq_host_batches", "route rmq_host_batches"),
           ("host_chain_fallback", "route host_chain_fallback"),
           ("chain_segments/block_global", "class chain_segments/block_global"),
           ("extd2_fill/scratch", "class extd2_fill/scratch"),
           ("ksw2_backtrack", "ksw2_backtrack (genomic)"),
           ("exts2_fill", "exts2_fill")]


def test_the_smokes_fuzz_phase_finds_nothing_missing_in_a_full_campaign():
    import chip_smoke
    assert chip_smoke.fuzz_missing(_full_campaign()) == []


@pytest.mark.parametrize("drop,name", MISSING, ids=[m[0] for m in MISSING])
def test_the_smokes_fuzz_phase_names_what_its_seeds_did_not_reach(drop, name):
    import chip_smoke
    assert chip_smoke.fuzz_missing(_full_campaign(drop)) == [name]
