"""The port's Python API (mm2_gb_tpu_torch.api) against the JAX package's,
and the port's MM2TPU_TIMELINE phase marks.

With device="cpu" the port's Aligner maps on the host
(models.mapper.map_frag), as the JAX package's does, each on its own
copy of the host layer: every Alignment field (cs and MD among them)
must be equal on the same inputs, as must seq, seq_names and revcomp.
Its default route, on the card, maps a read through the device pipeline;
here that route runs on the kernels' plain twins and must give the host
route's every field.
"""

import contextlib
import copy
import dataclasses
import gzip
import io
import re

import pytest
import torch

import mm2_gb_tpu.api as jmp
import mm2_gb_tpu_torch.api as mp
from tests.conftest import golden_path

SEQ_REF = ("ACGTACGTTGCAGGCTTACGGATCTGCTGCATTGCATGCAGCTAGCTAGCTGATCGATCG"
           * 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hits(aligner, reads, **kw):
    """Every read's hits as tuples of every Alignment field, and their
    str() lines."""
    out = []
    for name, seq, _qual in reads:
        for h in aligner.map(seq, **kw):
            out.append((name, dataclasses.astuple(h), str(h)))
    return out


@pytest.fixture(scope="module")
def sim200():
    """Both packages' Aligners on the sim200 reference, and its reads."""
    reads = list(mp.fastx_read(golden_path("simreads.fa.gz")))
    assert reads == list(jmp.fastx_read(golden_path("simreads.fa.gz")))
    return (mp.Aligner(golden_path("simref.fa.gz"), device="cpu"),
            jmp.Aligner(golden_path("simref.fa.gz")), reads)


@pytest.mark.parametrize("skip", ["skipinf", "default"])
def test_aligner_matches_the_jax_package(sim200, skip, monkeypatch):
    """The sim200 reads with cs and MD: at --max-chain-skip=2147483647
    (map_opt.max_chain_skip, every read) and at the presets' default
    (the first 20 reads; the host chain is slower there)."""
    a, ja, reads = sim200
    assert a.map_opt.max_chain_skip == ja.map_opt.max_chain_skip == 25
    if skip == "skipinf":
        for x in (a, ja):
            monkeypatch.setattr(x.map_opt, "max_chain_skip", 2**31 - 1)
    else:
        reads = reads[:20]
    got = _hits(a, reads, cs=True, MD=True)
    assert got == _hits(ja, reads, cs=True, MD=True)
    assert len(got) >= len(reads)
    assert all(h[1][-2] and h[1][-1] for h in got)   # cs and MD
    if skip == "skipinf":
        with gzip.open(golden_path("sim200.skipinf.cs.paf.gz"), "rt") as f:
            n_pri = sum("\ttp:A:P\t" in line for line in f)
        assert sum(h[1][9] for h in got) == n_pri   # is_primary


def test_aligner_index_views_match(sim200):
    a, ja, _reads = sim200
    assert (a.seq_names, a.k, a.w, a.n_seq, bool(a)) == (
        ja.seq_names, ja.k, ja.w, ja.n_seq, bool(ja))
    name = a.seq_names[0]
    for start, end in ((0, 100), (1000, 1100), (299_950, 400_000),
                       (300_000, 300_100), (-1, 10)):
        assert a.seq(name, start, end) == ja.seq(name, start, end)
    s = a.seq(name, 100, 200)
    assert mp.revcomp(s) == jmp.revcomp(s)
    assert mp.revcomp(mp.revcomp(s)) == s
    assert a.seq("nope") is None and ja.seq("nope") is None


def test_seq_mode_read_pair_matches_the_jax_package():
    """seq= input under the sr preset, a read pair (tests/test_api.py)."""
    r1 = SEQ_REF[100:250]
    r2 = mp.revcomp(SEQ_REF[400:550])
    got = []
    for pkg, kw in ((mp, {"device": "cpu"}), (jmp, {})):
        a = pkg.Aligner(seq=SEQ_REF, preset="sr", **kw)
        assert a.seq_names == ["N/A"]
        got.append([(dataclasses.astuple(h), str(h))
                    for h in a.map(r1, r2, cs=True, MD=True)])
    assert got[0] == got[1]
    assert {h[0][14] for h in got[0]} == {1, 2}   # read_num


def _on_the_twins(aligner, monkeypatch):
    """A copy of a host-route Aligner that takes the card's route, the
    device pipeline, with its kernels' plain twins on the CPU."""
    route = mp.Aligner._map_device
    monkeypatch.setattr(mp.Aligner, "_map_device",
                        lambda self, seq, opt, _device: route(
                            self, seq, opt, torch.device("cpu")))
    a = copy.copy(aligner)
    a.device = torch.device("cuda")
    return a


def test_the_aligner_maps_on_the_card_unless_asked(monkeypatch):
    """The default device is the card: without one the Aligner refuses,
    and names device="cpu" for the host route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.Aligner(seq=SEQ_REF)
    assert mp.Aligner(seq=SEQ_REF, device="cpu").device.type == "cpu"


def test_the_card_route_matches_the_host_route(sim200, monkeypatch):
    """The card's route on the twins against the host route, every field
    with cs and MD: the first 8 sim200 reads at
    --max-chain-skip=2147483647 (the device chain's), and reads of the
    seq= reference under sr and map-ont.  A read pair stays on the host
    route on the card."""
    a, _ja, reads = sim200
    monkeypatch.setattr(a.map_opt, "max_chain_skip", 2**31 - 1)
    card = _on_the_twins(a, monkeypatch)
    reads = reads[:8]
    got = _hits(card, reads, cs=True, MD=True)
    assert got == _hits(a, reads, cs=True, MD=True)
    assert len(got) >= len(reads)
    for preset in ("sr", "map-ont"):
        host = mp.Aligner(seq=SEQ_REF, preset=preset, device="cpu")
        card = _on_the_twins(host, monkeypatch)
        rs = [("r1", SEQ_REF[100:250], None),
              ("r2", mp.revcomp(SEQ_REF[400:550]), None),
              ("r3", SEQ_REF[300:1100], None)]
        got = _hits(card, rs, cs=True, MD=True)
        assert got == _hits(host, rs, cs=True, MD=True) and got
    r1, r2 = SEQ_REF[100:250], mp.revcomp(SEQ_REF[400:550])
    assert ([dataclasses.astuple(h) for h in card.map(r1, r2)]
            == [dataclasses.astuple(h) for h in host.map(r1, r2)])


def test_timeline_marks_in_order(monkeypatch):
    """With the marks on (MM2TPU_TIMELINE=1), the port's --gpu-chain run
    path (on the CPU twins) writes them to stderr in order, and stdout
    stays the sim200 golden."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.utils import opts as O
    from mm2_gb_tpu_torch.utils import timeline
    monkeypatch.setattr(timeline, "_ON", True)
    argv, args = cli.parse_args([
        "--max-chain-skip=2147483647", "--gpu-chain",
        golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
    with gzip.open(golden_path("sim200.skipinf.paf.gz"), "rt") as f:
        assert out.getvalue() == f.read()
    marks = re.findall(r"^\[T::\s*([0-9.]+)s\] (.+)$", err.getvalue(), re.M)
    assert [m for _t, m in marks] == ["index build start", "index built",
                                      "mapping start", "mapping done"]
    t = [float(s) for s, _m in marks]
    assert t == sorted(t)
