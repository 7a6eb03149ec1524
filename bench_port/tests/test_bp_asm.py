"""The output check on a configuration that writes PAF and chains by RMQ
(asm5, fixtures/asm5.tiny.json): a sound run is correct, a changed RMQ
chain is caught, and so is the control."""

import threading

import numpy as np

from bench_port.tests import bp_tiny
from bench_port import control, harness
from bench_port.gen import reads
from bench_port.reference import check as ref
from bench_port.reference.mm import chain_rmq as rmq_mod
from mm2_gb_tpu_torch.models import pipeline
from mm2_gb_tpu_torch.ops import chain_rmq

SEED = 2**31 + 77


def _run():
    return harness.run(bp_tiny.fixture("asm5.tiny"), SEED, 0.5, False,
                       device="cpu")


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert {k: v["value"] for k, v in res["check"].items()} == dict.fromkeys(
        harness.LIMITS, 0)


def test_rmq_chain_altered_in_one_read(monkeypatch):
    """The first RMQ chaining of the pool's longest contig (always in the
    sample) gives its best chain a score one higher."""
    t = bp_tiny.fixture("asm5.tiny").traffic
    longest = int(reads.lengths(t["length"], t["n_reads"]).max())
    finish, chain = pipeline.finish_read, chain_rmq.chain_rmq
    mine = threading.local()

    def finish_w(index, opt, sr, *a, **kw):
        mine.on = sr.rec.length == longest
        return finish(index, opt, sr, *a, **kw)

    def altered(*a):
        u, cx, cy = chain(*a)
        if getattr(mine, "on", False):
            mine.on = False
            u = u.copy()
            u[0] += np.uint64(1 << 32)
        return u, cx, cy
    monkeypatch.setattr(pipeline, "finish_read", finish_w)
    monkeypatch.setattr(chain_rmq, "chain_rmq", altered)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["chain_differ"]["value"] == 1


def test_chains_equal_holds_rmq_reads_on_their_chains():
    u = np.array([(40 << 32) | 3], np.uint64)
    c = np.arange(3, dtype=np.uint64)
    r = dict(u=u, cx=c, cy=c)
    assert harness.chains_equal(dict(u=u, cx=c, cy=c), r)
    assert not harness.chains_equal(dict(u=u + np.uint64(1), cx=c, cy=c), r)
    # no chains recorded, or only the DP's placeholders: differs
    assert not harness.chains_equal({}, r)
    assert not harness.chains_equal(dict(f=np.zeros(3, np.int32),
                                         p=np.full(3, -1)), r)


def test_control_comes_out_not_correct_by_its_chains():
    """The reference a precision lower fails the check on the contigs'
    RMQ chains too: the longest contig's chain scores pass 32767."""
    res = control.control(bp_tiny.fixture("asm5.tiny"), 2**31 + 9)
    assert res["correct"] is False and res["chain_differ"] > 0


def test_rmq_gap_cost_in_bf16():
    """The control's RMQ score takes off the same gap cost as the frozen
    _sc_simple, computed in bfloat16: equal where bfloat16 rounds to the
    same whole number, and not everywhere."""
    rng = np.random.default_rng(3)
    cg, cs = np.float32(0.19), np.float32(0.0)
    n_diff = 0
    for _ in range(2000):
        xj, yj = (int(v) for v in rng.integers(0, 10**6, 2))
        dx, dy = (int(v) for v in rng.integers(1, 3000, 2))
        axj, ayj = xj, (19 << 32) | yj
        axi, ayi = xj + dx, (19 << 32) | (yj + dy)
        sc, exact, dd = rmq_mod._sc_simple(axi, ayi, axj, ayj, cg, cs)
        lo, exact_lo, dd_lo = ref.sc_simple_bf16(axi, ayi, axj, ayj, cg, cs)
        assert (exact_lo, dd_lo) == (exact, dd)
        d, g = np.array([dd]), np.array([min(dx, dy)])
        free = min(19, min(dx, dy))
        assert sc == free - int(ref._gap_cost32(d, g, cg, cs)[0])
        assert lo == free - int(ref._gap_cost_bf16(d, g, cg, cs)[0])
        n_diff += lo != sc
    assert n_diff > 0
