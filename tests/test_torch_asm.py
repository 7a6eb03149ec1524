"""Assembly-to-reference and HiFi alignment through the port on the CPU.

- The sim200 `-c` goldens of `-x asm5`, `asm10` and `asm20` through the
  port's host route (`cli.main --device cpu`).
- A small assembly made as chip_smoke.asm_set makes the card's (a 300
  kb reference, three contigs whose deletions and insertions are 700 bp
  to 2 kb) through the card route on the kernels' plain twins
  (`cli._run(..., device=cpu)`) at `-cx asm5 --cs --gpu-align`, byte for
  byte against the JAX package's host path on the same files: every
  batch chained on the host by RMQ (the chain wrapper never called),
  every fill equal to the oracle (chip_smoke.hold_fill_oracle), and
  among the fills one longer than 627 rows at the asm band of 150,001.
- A small HiFi set as chip_smoke.hifi_set makes the card's (eight reads
  of 15-25 kb) at `-ax map-hifi --gpu-align`, against the JAX host path
  but @PG, every batch through the chain wrapper, every fill equal to
  the oracle; the twins on the fills of a launch's suffix, cut as the
  card's hold_fill_calls cuts it, give their recorded results.
- The two generators give the same bytes for the same seed.
"""

import contextlib
import gzip
import io
import os
import re

import pytest
import torch

import chip_smoke as C
from mm2_gb_tpu import cli as jcli
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

SKIP_INF = "--max-chain-skip=2147483647"
# the small sets: the card's generators, cut in size
ASM = dict(genome_len=300_000, n_chrom=1, sv_len=(700, 2_000),
           sv_gap=(30_000, 60_000), inv_len=(1_000, 5_000),
           contig_len=(100_000, 150_000))
HIFI = dict(n_reads=8, genome_len=300_000, n_chrom=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
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


def _card_route(argv, monkeypatch):
    """The --gpu-chain --gpu-align run path (cli._run) on the CPU twins at
    -v 3, every fill launch recorded: (rc, stdout, stderr, the chain
    wrapper's calls, the recorded fill + backtrack launches)."""
    calls = []
    wrapper = chain_gpu.chain_segments

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return wrapper(*a, **kw)
    monkeypatch.setattr(chain_gpu, "chain_segments", counted)
    argv, args = cli.parse_args([SKIP_INF, "--gpu-chain", "--gpu-align",
                                 "-v", "3", *argv])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with C.recording_fills() as fcalls, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli._run(args, argv, io_, mo, torch.device("cpu"))
    return rc, out.getvalue(), err.getvalue(), calls, fcalls


def _batches(err):
    """(batches, HPC batches, RMQ batches, fills, host-routed fills) of a
    run's `[M::gpu]` lines."""
    m = re.search(r"segments in (\d+) batches.*\n\[M::gpu\] host route: "
                  r"(\d+) HPC batches, (\d+) RMQ batches", err)
    f = re.search(r"fills: (\d+) \(\d+ device, (\d+) host-routed\)", err)
    assert m and f, err[-2000:]
    return tuple(map(int, m.groups() + f.groups()))


# the card route's assembly first: the longest test of the file (~25 s
# on one core)
def test_an_assembly_through_the_card_route(tmp_path, monkeypatch):
    ref, contigs = C.asm_set(**ASM, work=str(tmp_path))
    flags = ["-cx", "asm5", "--cs"]
    rc, out, err, calls, fcalls = _card_route([*flags, ref, contigs],
                                              monkeypatch)
    assert rc == 0, err[-2000:]
    rc, want, _ = _main(jcli.main, [SKIP_INF, *flags, ref, contigs])
    assert rc == 0 and out == want
    assert out.count("\n") >= 3 and "\tcs:Z:" in out
    batches, hpc, rmq, fills, host = _batches(err)
    assert rmq == batches >= 1 and hpc == 0 and calls == []
    assert fills > 0 and host == 0
    ql, tl, w = (torch.cat([c[0][k] for c in fcalls]).long()
                 for k in (4, 5, 6))
    long = ql + tl - 1 > C.LONG_FILL_ROWS
    assert bool((long & (w == C.ASM_FILL_W)).any())
    assert bool((w == C.ASM_FILL_W).all())
    err_or, n_or, _s = C.hold_fill_oracle(fcalls)
    assert err_or == 0 and n_or == fills


def test_a_hifi_set_through_the_card_route(tmp_path, monkeypatch):
    ref, reads = C.hifi_set(**HIFI, work=str(tmp_path))
    flags = ["-ax", "map-hifi"]
    rc, out, err, calls, fcalls = _card_route([*flags, ref, reads],
                                              monkeypatch)
    assert rc == 0, err[-2000:]
    rc, want, _ = _main(jcli.main, [SKIP_INF, *flags, ref, reads])
    assert rc == 0

    def no_pg(s):
        return [line for line in s.splitlines() if not line.startswith("@PG")]
    assert no_pg(out) == no_pg(want) and out.startswith("@SQ")
    batches, hpc, rmq, fills, host = _batches(err)
    assert (hpc, rmq) == (0, 0) and len(calls) == batches >= 1
    assert fills > 0 and host == 0 and fcalls
    assert C.hold_fill_oracle(fcalls)[:2] == (0, fills)
    # the twins on a launch's fills of at most 300 rows, cut as
    # hold_fill_calls cuts them, give those fills' recorded results
    c = fcalls[0]
    fa, sc, _fp, _ba, cig, nc = c
    rows = (fa[4] + fa[5] - 1).tolist()
    k0 = next(k for k, r in enumerate(rows) if r <= 300)
    assert 0 < k0 < len(rows) and rows == sorted(rows, reverse=True)
    fs, bs, _p0, c0 = C._fill_suffix(c, k0)
    sct, pt = ksw2_gpu.extd2_fill_torch(*fs)
    cgt, nct = ksw2_gpu.ksw2_backtrack_torch(pt, *bs)
    assert torch.equal(sct, sc[k0:]) and torch.equal(nct, nc[k0:])
    assert torch.equal(cgt.to(torch.int32)[:cig.shape[0] - c0], cig[c0:])


@pytest.mark.parametrize("preset", ["asm5", "asm10", "asm20"])
def test_the_host_route_gives_the_asm_goldens(preset):
    rc, out, err = _main(cli.main, [
        "--device", "cpu", SKIP_INF, "-x", preset, "-c",
        golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    assert rc == 0, err[-2000:]
    with gzip.open(golden_path(f"sim200.{preset}.c.paf.gz"), "rt") as f:
        assert out == f.read()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_the_generators_give_the_same_bytes_for_a_seed(tmp_path):
    sets = {}
    for d in ("a", "b", "c"):
        work = str(tmp_path / d)
        os.makedirs(work)
        seed = 22 if d == "c" else 21
        sets[d] = [_read(p) for p in (*C.asm_set(**ASM, seed=seed,
                                                 work=work),
                                      C.hifi_set(**HIFI, seed=seed,
                                                 work=work)[1])]
    assert sets["a"] == sets["b"]
    assert all(x != y for x, y in zip(sets["a"], sets["c"]))
    ref, contigs, reads = sets["a"]
    assert ref.count(b">") == 1 and len(ref) == 300_000 + len(b">chr1\n\n")
    assert contigs.count(b">") in (2, 3) and reads.count(b">") == 8
