"""The check against a broken program: a run with the timed path broken
underneath must come out not correct, once for each fault a cell of this
benchmark can have.  (No cell spans chips, so there is no exchange
between chips to leave out.)"""

import torch

from bench_port.tests import bp_tiny
from bench_port import harness
from mm2_gb_tpu_torch.models import pipeline
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu

SEED = 2**31 + 41


def _run():
    return harness.run(bp_tiny.cell("hifi.sam"), SEED, 0.5, False,
                       device="cpu")


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True
    assert res["check"]["truth_off"]["value"] == 0


def test_chain_step_returns_its_state_unchanged(monkeypatch):
    """The chain kernel hands back its initial state: every anchor its
    own span and no predecessor."""
    def unchanged(x, y, rng, seg_start, seg_end, *, span, **kw):
        n = x.shape[0]
        return (torch.full((n,), span, dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(chain_gpu, "chain_segments", unchanged)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["chain_differ"]["value"] > 0


def test_half_of_each_batch_left_out(monkeypatch):
    """The finish of each batch emits the first half of its reads."""
    finish = pipeline._finish_batch

    def half(*a, **kw):
        out = finish(*a, **kw)
        return out[:len(out) // 2]
    monkeypatch.setattr(pipeline, "_finish_batch", half)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["reads_missing"]["value"] > 0


def test_chain_answer_altered_where_produced(monkeypatch):
    """The chain kernel's score of every hundredth anchor is one off."""
    segments = chain_gpu.chain_segments

    def altered(*a, **kw):
        f, p = segments(*a, **kw)
        f = f.clone()
        f[::100] += 1
        return f, p
    monkeypatch.setattr(chain_gpu, "chain_segments", altered)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["chain_differ"]["value"] > 0


def test_fill_answer_altered_where_produced(monkeypatch):
    """The fill kernel's score of every second gap fill is one off."""
    batch = ksw2_gpu.extd2_fill_batch

    def altered(*a, **kw):
        scores, cig_off, cig_blob = batch(*a, **kw)
        scores = scores.copy()
        scores[::2] += 1
        return scores, cig_off, cig_blob
    monkeypatch.setattr(ksw2_gpu, "extd2_fill_batch", altered)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["fills_differ"]["value"] > 0


def test_record_altered_where_produced(monkeypatch):
    """The finish places every second read's regions on the next
    chromosome: the records no longer lie at the reads' origins."""
    finish = pipeline.finish_read
    seen = []

    def altered(index, opt, sr, *a, **kw):
        regs = finish(index, opt, sr, *a, **kw)
        if sr.rec.name not in seen:
            seen.append(sr.rec.name)
        if seen.index(sr.rec.name) % 2:
            for r in regs:
                r.rid = (r.rid + 1) % index.n_seq
        return regs
    monkeypatch.setattr(pipeline, "finish_read", altered)
    res = _run()
    assert res["correct"] is False
    assert res["check"]["truth_off"]["value"] > 0
