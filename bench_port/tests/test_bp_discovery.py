"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, generator and metric is found by its name."""

import json
import os
import re

from bench_port.tests.bp_tiny import ROOT
from bench_port import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_loads_with_its_parts():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert cell.config["argv"] and cell.traffic["generator"]
        assert {m["name"] for m in cell.end_to_end} == {
            "kernel_s_per_gbp", "setup_s"}
        assert cell.per_layer
        harness.generator(cell.config["genome"]["generator"])
        harness.generator(cell.traffic["generator"])
        for m in cell.per_layer + cell.end_to_end:
            if m["name"] != "setup_s":
                assert callable(harness.metric_reader(m["name"]))
        for k in json.load(open(os.path.join(
                ROOT, {c["name"]: c for c in BENCH["configs"]}[
                    w["config"]]["file"])))["reduced"]:
            assert k in cell.config


def test_a_metric_lists_only_cells_that_report_it():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
    fill = {m["name"]: m for m in BENCH["per_layer"]}["fill_roofline"]
    assert fill["workloads"] == ["hifi.sam"]


def test_unknown_cell_is_refused():
    try:
        harness.load_cell("no.such.cell", ROOT)
    except KeyError:
        return
    raise AssertionError("an unknown cell loaded")
