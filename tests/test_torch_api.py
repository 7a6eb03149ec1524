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
import sys
import threading
import time

import pytest
import torch

import mm2_gb_tpu.api as jmp
import mm2_gb_tpu_torch.api as mp
from mm2_gb_tpu_torch.models import pipeline
from mm2_gb_tpu_torch.ops import align as align_ops
from mm2_gb_tpu_torch.utils import native
from tests.conftest import golden_path

SEQ_REF = ("ACGTACGTTGCAGGCTTACGGATCTGCTGCATTGCATGCAGCTAGCTAGCTGATCGATCG"
           * 20)
WAIT_S = 120.0   # a thread's limit in the thread tests: a deadlock fails


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


def _in_thread(fn):
    """Start fn() in a daemon thread: (thread, box); box gets "out" or
    "err"."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # noqa: BLE001 -- handed to the test
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _joined(*threads):
    """Join each thread within WAIT_S; fail on one still running."""
    for t, box in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a mapping thread did not end"
        if "err" in box:
            raise box["err"]
    return [box["out"] for _t, box in threads]


class _WatchedLock(mp._RouteLock):
    """The API's route lock, telling the test when a caller had to wait
    for it."""

    def __init__(self):
        super().__init__()
        self.waited = threading.Event()

    def acquire(self, sole, timeout=None):
        if super().acquire(sole, 0):
            return True
        self.waited.set()
        if not super().acquire(sole, WAIT_S):
            raise TimeoutError("the route lock was never released")
        return True


def test_the_route_lock_is_shared_by_host_maps_alone():
    """Host maps hold the lock beside each other; a card pass waits for
    them, and a host map that comes while a card pass waits waits too;
    a card pass holds it alone."""
    lock = mp._RouteLock()
    assert lock.acquire(sole=False) and lock.acquire(sole=False, timeout=0)
    assert not lock.acquire(sole=True, timeout=0)
    card = _in_thread(lambda: lock.acquire(sole=True, timeout=WAIT_S))
    deadline = time.monotonic() + WAIT_S
    while not lock._waiting and time.monotonic() < deadline:
        time.sleep(0.001)
    assert not lock.acquire(sole=False, timeout=0)   # behind the card pass
    lock.release(sole=False)
    lock.release(sole=False)
    assert _joined(card) == [True]
    assert not lock.acquire(sole=False, timeout=0)
    assert not lock.acquire(sole=True, timeout=0)
    lock.release(sole=True)
    assert lock.acquire(sole=True, timeout=0)
    lock.release(sole=True)


def test_host_maps_run_beside_each_other(sim200, monkeypatch):
    """While one host map holds the API's route lock, another thread's
    host maps (three sim200 reads) run to their end without waiting,
    with the hits of the reads mapped alone; a card-route call waits."""
    a, _ja, reads = sim200
    card = _on_the_twins(a, monkeypatch)
    alone = (_hits(a, reads[:3]), _hits(card, reads[3:4]))
    lock = _WatchedLock()
    monkeypatch.setattr(mp, "_ROUTE_LOCK", lock)
    assert lock.acquire(sole=False)
    try:
        [got_host] = _joined(_in_thread(lambda: _hits(a, reads[:3])))
        assert not lock.waited.is_set()
        t_card = _in_thread(lambda: _hits(card, reads[3:4]))
        assert lock.waited.wait(WAIT_S)
    finally:
        lock.release(sole=False)
    assert (got_host, *_joined(t_card)) == alone


@pytest.mark.parametrize("session", ["native", "python"])
def test_a_card_route_pass_leaves_other_threads_alone(sim200, session,
                                                      monkeypatch):
    """A card-route call on the twins stopped inside its collect pass
    (before the C++ session's fill_fetch, or before the Python driver's
    end_fill_collect) while another thread maps 12 other sim200 reads on
    the host route and one more through a second card-route call: every
    read's hits (cs and MD) equal the same read mapped alone.  The other
    thread either runs to its end or waits for the API's route lock; then
    the stopped call goes on."""
    a, _ja, reads = sim200
    monkeypatch.setattr(a.map_opt, "max_chain_skip", 2**31 - 1)
    card = _on_the_twins(a, monkeypatch)
    first, host, last = reads[:1], reads[1:13], reads[13:14]
    alone = (_hits(card, first, cs=True, MD=True),
             _hits(a, host, cs=True, MD=True),
             _hits(card, last, cs=True, MD=True))
    assert all(alone)

    if session == "python":
        monkeypatch.setattr(pipeline, "_native_session", lambda opt: False)
        mod, name = align_ops, "end_fill_collect"
    else:
        assert native.available()
        mod, name = native, "fill_fetch"
    paused, release, stopped = threading.Event(), threading.Event(), []
    orig, first_call = getattr(mod, name), threading.local()

    def stop_the_first_pass(*args):
        if not stopped and getattr(first_call, "here", False):
            stopped.append(True)
            paused.set()
            release.wait(WAIT_S)
        return orig(*args)
    monkeypatch.setattr(mod, name, stop_the_first_pass)
    lock = _WatchedLock()
    monkeypatch.setattr(mp, "_ROUTE_LOCK", lock)

    def the_first_call():
        first_call.here = True
        return _hits(card, first, cs=True, MD=True)
    t1 = _in_thread(the_first_call)
    assert paused.wait(WAIT_S), "the card-route call never collected"
    t2 = _in_thread(lambda: (_hits(a, host, cs=True, MD=True),
                             _hits(card, last, cs=True, MD=True)))
    deadline = time.monotonic() + WAIT_S
    while (t2[0].is_alive() and not lock.waited.is_set()
           and time.monotonic() < deadline):
        time.sleep(0.01)
    release.set()
    got_first, (got_host, got_last) = _joined(t1, t2)
    assert got_host == alone[1]
    assert (got_first, got_last) == (alone[0], alone[2])


def test_threads_beside_the_card_route_keep_their_hits(sim200,
                                                       monkeypatch):
    """Stress: a card-route thread (two reads on the twins) beside eight
    host-route threads that map three reads each, round after round,
    until the card-route thread ends, the interpreter switching threads
    every 10 µs: every round of every thread gives its reads' hits mapped
    alone."""
    a, _ja, reads = sim200
    monkeypatch.setattr(a.map_opt, "max_chain_skip", 2**31 - 1)
    card = _on_the_twins(a, monkeypatch)
    card_reads = reads[:2]
    host_reads = [reads[2 + 3 * i:5 + 3 * i] for i in range(8)]
    alone = (_hits(card, card_reads), [_hits(a, rs) for rs in host_reads])
    done = threading.Event()

    def card_thread():
        try:
            return _hits(card, card_reads)
        finally:
            done.set()

    def host_thread(rs):
        rounds = [_hits(a, rs)]
        while not done.is_set() and len(rounds) < 200:
            rounds.append(_hits(a, rs))
        return rounds
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _joined(_in_thread(card_thread),
                      *[_in_thread(lambda rs=rs: host_thread(rs))
                        for rs in host_reads])
    finally:
        sys.setswitchinterval(interval)
    assert got[0] == alone[0]
    for rounds, want in zip(got[1:], alone[1]):
        assert all(r == want for r in rounds)


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
