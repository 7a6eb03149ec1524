"""A run end to end on the CPU through the port's plain twins at a tiny
size, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port.tests import bp_tiny
from bench_port.tests.bp_tiny import ROOT
from bench_port import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    cell = bp_tiny.cell("hifi.sam")
    res = harness.run(cell, 2**31 + 5, 0.5, bool(trace), device="cpu")
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    names = {m["name"] for m in (cell.per_layer if trace else
                                 cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        # no card: no kernel ran, so kernel_s_per_gbp has nothing to
        # read and is left out
        assert set(res["metrics"]) == {"setup_s"}
        assert res["metrics"]["setup_s"]["value"] > 0
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert res["metrics"]["window_mbp_s"]["value"] > 0
        # no card: the trace's device share and the kernels' rooflines
        # have nothing to read, and are left out
        assert "chain_roofline" not in res["metrics"]
        assert "device_idle_pct" not in res["metrics"]
    assert set(res["check"]) == set(harness.LIMITS)
    json.dumps(res)


def test_hifi_run_checks_its_fills():
    res = harness.run(bp_tiny.cell("hifi.sam"), 17, 0.5, False, device="cpu")
    assert res["correct"] is True
    assert res["check"]["fills_differ"]["value"] == 0


def _command(cwd):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "hifi.sam",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_command_refuses_in_a_bare_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_sample_is_drawn_from_the_seed_with_the_longest_done():
    lengths = [10, 50, 20, 40, 30, 60, 5, 15]
    longest, drawn = harness.candidates(lengths, 2, 2**31 + 11)
    assert longest == [5, 1, 3, 4]
    assert (longest, drawn) == harness.candidates(lengths, 2, 2**31 + 11)
    assert sorted(drawn) == [0, 2, 6, 7] and not set(drawn) & set(longest)
    # every candidate finished: the longest, then the first drawn
    assert harness.sample(longest, drawn, set(range(8)), lengths, 2) == [
        5, drawn[0]]
    # the longest never came: the longest of those that did
    done = {1, 3} | set(drawn[1:])
    assert harness.sample(longest, drawn, done, lengths, 3) == [
        1, drawn[1], drawn[2]]
    assert harness.sample(longest, drawn, set(), lengths, 3) == []
