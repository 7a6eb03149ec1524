"""The port's end-to-end bench stage (mm2_gb_tpu_torch.utils.e2ebench).

Its control flow is tested with subprocess.run faked, as
tests/test_e2ebench.py tests the JAX package's stage: the order of the
runs (one untimed run a side, then A, B, B, A), best, median and spread
from scripted walls, the byte comparison of every run (SAM without
@PG), a failed or timed-out run that ends the configuration, and a
budget that runs out.  The report parser reads what the port's own
GpuMetrics.report and timeline.mark write, so a change of their format
fails here.  Two cases run real subprocesses: the port's host route
(HOST_CMD, `python -m mm2_gb_tpu_torch --device cpu`) against itself on
the sim200 inputs, and the card side without a card beside the default
baseline.
"""

import contextlib
import io
import os
import subprocess
import sys
import types

import pytest
import torch

from mm2_gb_tpu_torch.models.pipeline import GpuMetrics
from mm2_gb_tpu_torch.utils import e2ebench as E
from mm2_gb_tpu_torch.utils import timeline
from tests.conftest import golden_path

BASE, CARD = ["BASE"], ["CARD"]
PAF = "r1\t100\t0\t100\t+\tchr\t1000\t0\t100\t100\t100\t60\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _report(fills=True):
    """What GpuMetrics.report writes for a run with these counts."""
    m = GpuMetrics(t_seed=1.25, t_range=0.5, t_pack=0.125, t_dispatch=0.25,
                   t_wait=0.75, t_kernel=0.0625, t_finish=2.5, n_reads=600,
                   n_anchors=1_000_000, n_segs=4321, n_pairs=125_000_000,
                   n_dispatch=4, n_batches=3, n_spills=2, n_host_hpc=1,
                   n_host_rmq=0, t_collect=0.375, t_table=0.0625)
    if fills:
        f = m.fills
        f.fills, f.device_fills, f.host_fills, f.chunks = 900, 890, 10, 2
        f.cells, f.fill_ms, f.backtrack_ms = 4_000_000, 40.5, 5.25
        f.batch_s, f.scratch_fills = 0.875, 3
        f.ext_fills, f.ext_host_fills, f.ext_chunks = 400, 4, 1
        f.ext_cells, f.ext_ms, f.ext_backtrack_ms = 2_000_000, 0.75, 0.5
        f.misses.update(fill=1, ext=2, splice=0)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        m.report(3)
    return m, err.getvalue()


class _FakeRun:
    """Scripted subprocess.run with its own clock: each call takes the
    next step, a wall in seconds (stdout PAF, stderr the card's report),
    a dict of CompletedProcess fields over those, or "timeout"."""

    def __init__(self, script, stderr=""):
        self.script, self.stderr = list(script), stderr
        self.calls, self.now = [], 0.0

    def clock(self):
        return self.now

    def __call__(self, argv, cwd=None, env=None, capture_output=True,
                 text=True, timeout=None):
        self.calls.append((list(argv), timeout))
        step = self.script.pop(0)
        if step == "timeout":
            self.now += timeout
            raise subprocess.TimeoutExpired(argv, timeout)
        step = step if isinstance(step, dict) else {"wall": step}
        self.now += step.get("wall", 1.0)
        card = argv[0] == CARD[0]
        return types.SimpleNamespace(
            returncode=step.get("rc", 0), stdout=step.get("stdout", PAF),
            stderr=step.get("stderr", self.stderr if card else ""))

    def sides(self):
        return ["card" if a[0] == CARD[0] else "base" for a, _t in self.calls]


def _run(monkeypatch, script, stderr="", **kw):
    fake = _FakeRun(script, stderr)
    monkeypatch.setattr(E.subprocess, "run", fake)
    monkeypatch.setattr(E.time, "perf_counter", fake.clock)
    kw.setdefault("best_of", 2)
    out = E.run_config("t", kw.pop("extra", ["--gpu-chain", "--gpu-align",
                                             "-c"]),
                       "ref.fa", "reads.fa", 600, 8, base_cmd=BASE,
                       cmd=CARD, **kw)
    return out, fake


@pytest.mark.parametrize("best_of,want", [
    (1, ["base", "card", "base", "card"]),
    (2, ["base", "card", "base", "card", "card", "base"]),
    (3, ["base", "card", "base", "card", "card", "base", "base", "card"]),
    (4, ["base", "card"] + ["base", "card", "card", "base"] * 2)])
def test_one_untimed_run_a_side_then_turns(monkeypatch, best_of, want):
    out, fake = _run(monkeypatch, [1.0] * len(want), best_of=best_of)
    assert fake.sides() == want
    assert len(out["e2e_t_walls_s"]) == len(out["e2e_t_base_walls_s"]) \
        == best_of
    assert out["e2e_t_byte_match"] is True and "e2e_t_error" not in out


def test_each_side_gets_its_flags(monkeypatch):
    """The card side gets every flag and -v 3; the baseline every flag but
    the device flags (a device flag's value too); both get
    --max-chain-skip=2147483647, -t and the inputs, in the repo root."""
    _out, fake = _run(monkeypatch, [1.0] * 6, extra=[
        "--gpu-chain", "--gpu-align", "--gpu-cfg", "cfg.json",
        "--tpu-devices=2", "-ax", "splice", "--qstrand", "-c"])
    tail = ["-t", "8", "ref.fa", "reads.fa"]
    base, card = fake.calls[0][0], fake.calls[1][0]
    assert base == ["BASE", *E.BASE_FLAGS, "-ax", "splice", "--qstrand",
                    "-c", *tail]
    assert card == ["CARD", *E.BASE_FLAGS, "--gpu-chain", "--gpu-align",
                    "--gpu-cfg", "cfg.json", "--tpu-devices=2", "-ax",
                    "splice", "--qstrand", "-c", "-v", "3", *tail]


def test_best_median_and_spread(monkeypatch):
    """Scripted walls: the untimed runs' are left out; each side's best,
    median, every wall in order and (max - min) / min; reads per second
    and the baseline's ratio at the card's best."""
    # base, card untimed; then base card card base base card
    walls = [50.0, 70.0, 10.0, 4.0, 5.0, 12.0, 11.0, 8.0]
    out, _fake = _run(monkeypatch, walls, best_of=3)
    assert out["e2e_t_walls_s"] == [4.0, 5.0, 8.0]
    assert out["e2e_t_base_walls_s"] == [10.0, 12.0, 11.0]
    assert (out["e2e_t_wall_s"], out["e2e_t_wall_median_s"]) == (4.0, 5.0)
    assert (out["e2e_t_base_wall_s"], out["e2e_t_base_wall_median_s"]) == (
        10.0, 11.0)
    assert out["e2e_t_spread"] == 1.0
    assert out["e2e_t_base_spread"] == pytest.approx(0.2)
    assert out["e2e_t_reads_s"] == 150.0
    assert out["e2e_t_vs_base"] == 2.5
    assert (out["e2e_t_threads"], out["e2e_t_n_reads"], out["e2e_t_best_of"],
            out["e2e_t_flags"]) == (8, 600, 3, "--gpu-chain --gpu-align -c")


@pytest.mark.parametrize("bad", range(6))
def test_any_run_that_differs_ends_the_configuration(monkeypatch, bad):
    """A difference in any one run (the untimed card run, a timed run of
    either side) gives byte_match false and no further run; the first
    baseline run is the reference the others are held to."""
    script = [1.0] * 6
    if bad == 0:   # the reference itself: every later run then differs
        script[0] = {"stdout": PAF.replace("60", "59")}
        bad = 1
    else:
        script[bad] = {"stdout": PAF.replace("60", "59")}
    out, fake = _run(monkeypatch, script)
    assert out["e2e_t_byte_match"] is False
    assert len(fake.calls) == bad + 1
    assert "e2e_t_error" not in out


def test_sam_is_compared_without_its_pg_line(monkeypatch):
    sam = "@HD\tVN:1.6\n@SQ\tSN:chr\tLN:1000\n@PG\tID:minimap2\tCL:{}\nr1\t0\n"
    script = [{"stdout": sam.format(i)} for i in range(6)]
    out, _fake = _run(monkeypatch, script)
    assert out["e2e_t_byte_match"] is True
    script[4] = {"stdout": sam.format(4).replace("LN:1000", "LN:999")}
    out, fake = _run(monkeypatch, script)
    assert out["e2e_t_byte_match"] is False and len(fake.calls) == 5


@pytest.mark.parametrize("how", ["exit", "timeout"])
@pytest.mark.parametrize("at", [0, 1, 4])
def test_a_failed_run_ends_the_configuration(monkeypatch, how, at):
    """A run that exits non-zero or passes its time limit: an error in
    the record, naming the side, and no further run or retry."""
    script = [1.0] * 6
    script[at] = ({"rc": 1, "stderr": "[ERROR] boom\n"} if how == "exit"
                  else "timeout")
    monkeypatch.setattr(E, "RUN_TIMEOUT_S", 30.0)
    out, fake = _run(monkeypatch, script)
    side = fake.sides()[at]
    assert len(fake.calls) == at + 1
    err = out["e2e_t_error"]
    assert err.startswith(side) and ("boom" in err if how == "exit"
                                     else "timed out after 30.0 s" in err)
    assert "e2e_t_incomplete" not in out
    assert ("e2e_t_wall_s" in out) == (at == 4)   # run 3 was the card's


def test_a_budget_that_runs_out_keeps_the_partial_record(monkeypatch):
    """The budget ends the configuration before its next run; what was
    timed stays in the record, with e2e_<tag>_incomplete."""
    left = [4.5]

    def remaining():
        left[0] -= 1.0
        return left[0]
    out, fake = _run(monkeypatch, [1.0] * 6, remaining=remaining)
    assert fake.sides() == ["base", "card", "base", "card"]
    assert out["e2e_t_incomplete"] == "the budget ran out"
    assert out["e2e_t_walls_s"] == [1.0] and out["e2e_t_base_walls_s"] == [
        1.0]
    assert out["e2e_t_byte_match"] is True and "e2e_t_error" not in out


def test_a_run_the_budget_cuts_is_no_error(monkeypatch):
    """A run's limit is the smaller of RUN_TIMEOUT_S and the budget left;
    a run the budget cuts leaves the record incomplete, not in error."""
    out, fake = _run(monkeypatch, [1.0, 1.0, "timeout"],
                     remaining=lambda: 20.0)
    assert [t for _a, t in fake.calls] == [20.0] * 3
    assert out["e2e_t_incomplete"] == "the budget ran out"
    assert "e2e_t_error" not in out and "e2e_t_wall_s" not in out


def test_the_parser_reads_what_the_report_writes():
    """GpuMetrics.report's lines, every field, and kernel_s."""
    m, text = _report()
    got = E.parse_gpu_report(text)
    f = m.fills
    assert {k: got[k] for k in (
        "reads", "anchors", "segments", "batches", "cap_split", "dispatches",
        "host_hpc_batches", "host_rmq_batches", "pairs")} == dict(
        reads=600, anchors=1_000_000, segments=4321, batches=3, cap_split=2,
        dispatches=4, host_hpc_batches=1, host_rmq_batches=0,
        pairs=125_000_000)
    assert got["chain_kernel_s"] == 0.0625
    assert got["chain_gpairs_s"] == 2.0
    assert {k: got[k] for k in ("seed_s", "range_s", "pack_s", "dispatch_s",
                                "device_wait_s", "finish_s", "host_s")} == {
        "seed_s": 1.25, "range_s": 0.5, "pack_s": 0.125, "dispatch_s": 0.25,
        "device_wait_s": 0.75, "finish_s": 2.5, "host_s": 4.375}
    assert got["pipeline_wall_s"] >= 0
    assert {k: got[k] for k in (
        "fills", "fills_device", "fills_host_routed", "fill_chunks",
        "fill_cells", "fill_kernel_ms", "backtrack_ms", "collect_s",
        "device_batch_s", "table_s", "scratch_fills", "exts", "exts_device",
        "exts_host_routed", "ext_chunks", "ext_cells", "ext_kernel_ms",
        "ext_backtrack_ms", "misses_fill", "misses_ext",
        "misses_splice")} == dict(
        fills=900, fills_device=890, fills_host_routed=10, fill_chunks=2,
        fill_cells=4_000_000, fill_kernel_ms=40.5, backtrack_ms=5.25,
        collect_s=0.375, device_batch_s=0.875, table_s=0.062,
        scratch_fills=3, exts=400, exts_device=396, exts_host_routed=4,
        ext_chunks=1, ext_cells=2_000_000, ext_kernel_ms=0.75,
        ext_backtrack_ms=0.5, misses_fill=1, misses_ext=2, misses_splice=0)
    assert got["fill_gcups"] == round(f.cells / f.fill_ms / 1e6, 3)
    assert got["ext_gcups"] == round(f.ext_cells / f.ext_ms / 1e6, 3)
    assert got["kernel_s"] == pytest.approx(0.0625 + 0.047)


def test_the_parser_reads_a_chain_only_report_and_refuses_others():
    got = E.parse_gpu_report("[M::main] x\n" + _report(fills=False)[1])
    assert "fills" not in got and got["kernel_s"] == 0.0625
    assert E.parse_gpu_report("[M::pipeline] mapped 200 sequences\n") == {}
    with pytest.raises(ValueError, match="no known form"):
        E.parse_gpu_report("[M::gpu] pairs: 12 in a new form\n")


def test_the_parser_reads_a_device_run_of_the_cli(monkeypatch):
    """The whole stderr of the CLI's `--gpu-chain -v 3` run path (on the
    CPU twins, sim200) with the phase marks on: every `[M::gpu]` line
    reads, and the counts are the run's."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.utils import opts as O
    monkeypatch.setattr(timeline, "_ON", True)
    argv, args = cli.parse_args([
        "--max-chain-skip=2147483647", "--gpu-chain", "-v", "3",
        golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
    got = E.parse_gpu_report(err.getvalue())
    assert (got["devices"], got["reads"], got["host_hpc_batches"]) == (
        1, 200, 0)
    assert got["dispatches"] >= 1 and got["pairs"] > 0
    assert got["kernel_s"] == got["chain_kernel_s"] and "fills" not in got
    assert sorted(E.parse_timeline(err.getvalue())) == [
        "cuda_startup_s", "index_s", "mapping_s", "startup_s"]


def test_the_timeline_split(monkeypatch):
    """The marks utils.timeline writes, read back as the wall's split."""
    monkeypatch.setattr(timeline, "_ON", True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for m in ("index build start", "index built", "mapping start",
                  "mapping done"):
            timeline.mark(m)
    got = E.parse_timeline(err.getvalue())
    assert sorted(got) == ["cuda_startup_s", "index_s", "mapping_s",
                           "startup_s"]
    assert got["startup_s"] > 0 and min(got.values()) >= 0
    assert E.parse_timeline("[T::   5.91s] index build start\n"
                            "[T::   6.18s] index built\n") == {
        "startup_s": 5.91, "index_s": 0.27}


def test_the_record_holds_the_best_card_runs_report(monkeypatch):
    """The card side's report and marks become fields of the record, from
    its best run, with the kernels' share of that run's wall; the
    baseline's marks too, from its best run, as base_* fields."""
    _m, text = _report()
    runs = [1.0, 1.0, 1.0, {"wall": 2.0, "stderr": "[M::gpu] odd\n"},
            {"wall": 0.5, "stderr": text + "[T::   3.50s] index build "
             "start\n"}, 1.0]
    out, _fake = _run(monkeypatch, runs)
    assert out["e2e_t_wall_s"] == 0.5 and out["e2e_t_fills"] == 900
    assert out["e2e_t_startup_s"] == 3.5
    assert out["e2e_t_kernel_share"] == pytest.approx(
        out["e2e_t_kernel_s"] / 0.5)
    assert "e2e_t_base_startup_s" not in out
    runs[2] = {"wall": 0.75, "stderr": "[T::   0.40s] index build start\n"}
    out, _fake = _run(monkeypatch, runs)
    assert out["e2e_t_base_startup_s"] == 0.4   # the baseline's best run
    assert out["e2e_t_startup_s"] == 3.5
    runs[3], runs[4] = ({"wall": 0.5, "stderr": "[M::gpu] odd\n"},
                        {"wall": 2.0, "stderr": text})   # the best: odd
    out, _fake = _run(monkeypatch, runs)
    assert "no known form" in out["e2e_t_error"]


@pytest.mark.parametrize("extra,want", [
    (["--gpu-chain"], []),
    (["--gpu-chain", "--gpu-align", "-c"], ["-c"]),
    (["--tpu-chain", "--tpu-align", "--qstrand", "-c"], ["--qstrand", "-c"]),
    (["-ax", "splice", "--gpu-chain", "--gpu-align"], ["-ax", "splice"]),
    (["--gpu-nproc", "2", "--gpu-rank=1", "--gpu-coord", "h:1", "-a"],
     ["-a"]),
    (["--gpu-profile", "d", "--tpu-cfg=c.json", "-t", "2"], ["-t", "2"])])
def test_host_flags(extra, want):
    assert E.host_flags(extra) == want


def test_the_host_path_against_itself_on_sim200():
    """Real subprocesses: the port's host route (HOST_CMD) on both sides,
    sim200 at --cs -c: every run byte-identical, each side's two walls
    recorded, and no [M::gpu] field (the host path prints none)."""
    out = E.run_config("host", ["--cs", "-c"], golden_path("simref.fa.gz"),
                       golden_path("simreads.fa.gz"), 200, 1,
                       base_cmd=E.HOST_CMD, best_of=2, cmd=E.HOST_CMD)
    assert "e2e_host_error" not in out and "e2e_host_incomplete" not in out
    assert out["e2e_host_byte_match"] is True
    assert len(out["e2e_host_walls_s"]) == len(out["e2e_host_base_walls_s"]) \
        == 2
    assert out["e2e_host_wall_s"] > 0 and "e2e_host_kernel_s" not in out
    assert out["e2e_host_base"] == ("-m mm2_gb_tpu_torch --device cpu "
                                    "--max-chain-skip=2147483647 --cs -c")
    assert out["e2e_host_base_cmd"] == (os.path.basename(sys.executable)
                                        + " -m mm2_gb_tpu_torch --device cpu")


def test_the_card_side_does_not_fall_back_to_the_cpu():
    """The card side is the port's CLI on its default device: where it
    sees no card (CUDA_VISIBLE_DEVICES empty) it exits 1, and the
    configuration ends with that error after the baseline's untimed run
    and the card side's first, with no timed run.  The baseline is the
    default, the port's host route, which runs without a card."""
    assert E.HOST_CMD == [*E.CARD_CMD, "--device", "cpu"]
    out = E.run_config("dev", ["--gpu-chain"], golden_path("simref.fa.gz"),
                       golden_path("simreads.fa.gz"), 200, best_of=1,
                       env={"CUDA_VISIBLE_DEVICES": ""})
    assert out["e2e_dev_error"].startswith("card run exited 1")
    assert "needs a CUDA device" in out["e2e_dev_error"]
    assert out["e2e_dev_base"].startswith("-m mm2_gb_tpu_torch --device cpu ")
    assert out["e2e_dev_byte_match"] is True   # the baseline's own run
    assert "e2e_dev_wall_s" not in out and "e2e_dev_base_wall_s" not in out
