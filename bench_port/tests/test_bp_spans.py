"""The readers of the program's spans (kernel_load_s, seed_cores,
finish_cores, output_s_per_gbp) on span lists made by hand, and on a
program that records none."""

from types import SimpleNamespace

import pytest

from bench_port.tests import bp_tiny  # noqa: F401
from bench_port import harness
from mm2_gb_tpu_torch.utils import timeline

READERS = ("kernel_load_s", "seed_cores", "finish_cores", "output_s_per_gbp")


def _span(name, wall_s, cpu_s=0.0):
    return SimpleNamespace(name=name, wall_s=wall_s, cpu_s=cpu_s)


SPANS = [_span("kernels.load", 1.25, 0.75),
         _span("seed.chunk", 2.0, 0.25),
         _span("seed.read", 0.5, 1.5), _span("seed.read", 0.5, 1.5),
         _span("seed.read", 0.5, 2.0),
         _span("seed.chunk", 2.0, 0.25),
         _span("finish.slices", 4.0, 0.5),
         _span("finish.read", 3.0, 2.5), _span("finish.read", 3.0, 2.5),
         _span("output.read", 0.25, 0.25), _span("output.read", 0.5, 0.5)]


def _ctx(gbp=0.25):
    return SimpleNamespace(gbp=gbp)


def _read(name, monkeypatch, spans):
    monkeypatch.setattr(timeline, "spans", lambda: list(spans))
    return harness.metric_reader(name)(_ctx())


def test_each_reader_on_spans_by_hand(monkeypatch):
    got = {n: _read(n, monkeypatch, SPANS) for n in READERS}
    assert got == {"kernel_load_s": 1.25,
                   "seed_cores": (1.5 + 1.5 + 2.0) / 4.0,
                   "finish_cores": 5.0 / 4.0,
                   "output_s_per_gbp": 0.75 / 0.25}


@pytest.mark.parametrize("name", READERS)
def test_a_reader_whose_spans_are_missing_reads_none(name, monkeypatch):
    assert _read(name, monkeypatch, []) is None
    # the spans of the other readers alone
    mine = {"kernel_load_s": {"kernels.load"},
            "seed_cores": {"seed.read", "seed.chunk"},
            "finish_cores": {"finish.read", "finish.slices"},
            "output_s_per_gbp": {"output.read"}}[name]
    for gone in mine:
        assert _read(name, monkeypatch,
                     [s for s in SPANS if s.name != gone]) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_none(name, monkeypatch):
    """A tree before the program recorded spans: no `timeline.spans`."""
    monkeypatch.delattr(timeline, "spans")
    assert harness.metric_reader(name)(_ctx()) is None


def test_the_readers_of_a_run_share_the_spans_it_kept(monkeypatch):
    """The program hands its spans out once: the run's first reader takes
    them, and every reader of the run reads them from its context."""
    kept = [list(SPANS)]
    monkeypatch.setattr(timeline, "spans",
                        lambda: kept.pop() if kept else [])
    ctx = _ctx()
    got = {n: harness.metric_reader(n)(ctx) for n in READERS}
    assert got == {"kernel_load_s": 1.25,
                   "seed_cores": (1.5 + 1.5 + 2.0) / 4.0,
                   "finish_cores": 5.0 / 4.0,
                   "output_s_per_gbp": 0.75 / 0.25}
    assert kept == [] and ctx.program_spans == SPANS


def test_no_bases_emitted_reads_no_output_time(monkeypatch):
    monkeypatch.setattr(timeline, "spans", lambda: list(SPANS))
    assert harness.metric_reader("output_s_per_gbp")(
        _ctx(0.0)) is None


def test_the_span_metrics_are_declared_for_the_cell():
    cell = harness.load_cell("hifi.sam", bp_tiny.ROOT)
    decl = {m["name"]: m for m in cell.per_layer}
    for n in READERS:
        assert decl[n]["source"] == "program_span"
        assert decl[n]["workloads"] == ["hifi.sam"]
    assert decl["kernel_load_s"]["moves"] == "setup_s"
    assert decl["output_s_per_gbp"]["layer"] == "output"
