"""All-vs-all overlap (`-x ava-ont`) and the other preset families through
the port's `--gpu-chain` run path on the CPU.

`cli._run(..., device=cpu)` takes the kernels' plain twins, so the run
path that maps on the card (host sketch and seed with the overlap
filters, the chain DP on every batch, host backtrack and post-processing)
is held here against the goldens, which the JAX package's tests hold to
the reference binary:

- `-x ava-ont` on simreads against themselves and `-x map-hifi -c` on
  sim200, byte for byte, every batch through the chain wrapper (none on
  the host), and for the overlap run more segments than reads (one per
  overlapping read and strand);
- `-x ava-pb -c` (HPC sketching) and `-x asm20 -c` (RMQ chaining) route
  their one batch to the host, as the JAX package's `--tpu-chain` does,
  and never call the chain wrapper;
- `fuzz_diff.ava_order_faults`, the check chip_smoke.py's overlap phase
  and the fuzzer's `ava` kind make: no line of the golden has a query
  name after its target name, and a line with its names swapped, or a
  read against itself on the diagonal, is flagged.
"""

import gzip
import re

import pytest
import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.ops import chain_gpu
from mm2_gb_tpu_torch.tools.fuzz_diff import ava_order_faults
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

SKIP_INF = "--max-chain-skip=2147483647"
REPORT = re.compile(r"\[M::gpu\] (\d+) reads, (\d+) anchors, (\d+) segments "
                    r"in (\d+) batches \(\d+ cap-split\), (\d+) kernel "
                    r"dispatches\n\[M::gpu\] host route: (\d+) HPC batches, "
                    r"(\d+) RMQ batches")


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


def _run_on_cpu(argv, monkeypatch):
    """The --gpu-chain run path (cli._run) on the CPU twins at -v 3:
    (rc, stdout, stderr, the chain wrapper's calls)."""
    calls = []
    wrapper = chain_gpu.chain_segments

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return wrapper(*a, **kw)
    monkeypatch.setattr(chain_gpu, "chain_segments", counted)
    argv, args = cli.parse_args([SKIP_INF, "--gpu-chain", "-v", "3", *argv])
    io_, mo = O.set_preset(args.preset)
    return cli._run(args, argv, io_, mo, torch.device("cpu")), calls


def _report(err):
    """(reads, anchors, segments, batches, dispatches, HPC batches, RMQ
    batches) of the run's `[M::gpu]` lines."""
    m = REPORT.search(err)
    assert m, err[-2000:]
    return tuple(map(int, m.groups()))


# the overlap run first: the longest test of the file (~30 s on one core)
@pytest.mark.parametrize("flags,ref,golden", [
    (["-x", "ava-ont"], "simreads.fa.gz", "ava.skipinf.paf.gz"),
    (["-x", "map-hifi", "-c"], "simref.fa.gz", "sim200.map-hifi.c.paf.gz"),
], ids=["ava_ont", "map_hifi_c"])
def test_the_device_route_gives_the_golden(flags, ref, golden, capsys,
                                           monkeypatch):
    (rc, calls) = _run_on_cpu([*flags, golden_path(ref),
                               golden_path("simreads.fa.gz")], monkeypatch)
    assert rc == 0
    cap = capsys.readouterr()
    assert cap.out == _gold(golden)
    reads, anchors, segs, batches, dispatches, hpc, rmq = _report(cap.err)
    assert (hpc, rmq) == (0, 0)
    assert reads == 200 and len(calls) == dispatches == batches >= 1
    assert sum(calls) == anchors
    if "ava-ont" in flags:   # one segment per overlapping read and strand
        assert segs > reads
        assert cap.out and not ava_order_faults(cap.out)


@pytest.mark.parametrize("preset,route", [("ava-pb", (1, 0)),
                                          ("asm20", (0, 1))],
                         ids=["ava_pb_hpc", "asm20_rmq"])
def test_a_host_routed_preset_keeps_its_bytes(preset, route, capsys,
                                              monkeypatch):
    """HPC sketching (-x ava-pb) and RMQ chaining (-x asm20) chain their
    batch on the host, read by read, as the JAX package does; the chain
    wrapper is never called."""
    rc, calls = _run_on_cpu(["-x", preset, "-c", golden_path("simref.fa.gz"),
                             golden_path("simreads.fa.gz")], monkeypatch)
    assert rc == 0
    cap = capsys.readouterr()
    assert cap.out == _gold(f"sim200.{preset}.c.paf.gz")
    _reads, _anchors, segs, batches, dispatches, hpc, rmq = _report(cap.err)
    assert (hpc, rmq) == route and batches == 1
    assert segs == dispatches == 0 and calls == []


def test_the_order_check_passes_on_the_golden():
    paf = _gold("ava.skipinf.paf.gz")
    assert paf.count("\n") == 1474
    assert ava_order_faults(paf) == []


def _swap_names(line):
    f = line.split("\t")
    f[0], f[5] = f[5], f[0]
    return "\t".join(f)


def test_the_order_check_flags_a_line_with_its_names_swapped():
    lines = _gold("ava.skipinf.paf.gz").splitlines()
    k = next(i for i, line in enumerate(lines)
             if line.split("\t")[0] != line.split("\t")[5])
    lines[k] = _swap_names(lines[k])
    assert ava_order_faults("\n".join(lines) + "\n") == [lines[k]]


@pytest.mark.parametrize("q_span,t_span,flagged", [
    (("100", "5000"), ("100", "5000"), True),
    (("100", "5000"), ("7100", "12000"), False),
], ids=["diagonal", "off_diagonal"])
def test_the_order_check_on_a_read_against_itself(q_span, t_span, flagged):
    """A read against itself: on the diagonal it is what NO_DIAG drops;
    off it (a repeat inside the read) it is allowed.  Names compare as
    bytes: "r10" sorts before "r9"."""
    line = "\t".join(["r10", "20000", *q_span, "+", "r10", "20000", *t_span,
                      "4000", "4900", "0", "tp:A:S"])
    assert ava_order_faults(line + "\n") == ([line] if flagged else [])
    other = line.replace("r10\t20000\t100\t5000\t+\tr10",
                         "r10\t20000\t100\t5000\t+\tr9")
    assert ava_order_faults(other) == []
    assert ava_order_faults(_swap_names(other)) == [_swap_names(other)]
