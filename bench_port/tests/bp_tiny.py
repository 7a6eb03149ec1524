"""Tiny copies of the benchmark's cells, for the CPU tests: the same
configuration and traffic files, with a 1 Mbp genome of two chromosomes,
a few short reads and two host threads; and tiny cells of configurations
that BENCHMARK.json does not hold (fixtures/<name>.json)."""

from __future__ import annotations

import copy
import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402

TINY = {
    "hifi.sam": dict(n_reads=24, warm_reads=4, check_reads=3,
                     length=dict(min=4000, max=7000)),
}


def cell(name: str):
    """Cell `name` of BENCHMARK.json at the tiny size."""
    c = harness.load_cell(name, ROOT)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    c.config.update(genome_length=1_000_000, chromosomes=2)
    c.config["argv"] = [a if a != "8" else "2" for a in c.config["argv"]]
    t = dict(TINY[name])
    c.traffic["length"].update(t.pop("length"))
    c.traffic.update(t)
    return c


def fixture(name: str):
    """The cell of fixtures/<name>.json ("config" and "traffic", at the
    size they give), reporting every metric of BENCHMARK.json."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "fixtures", name + ".json")) as f:
        d = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return SimpleNamespace(
        name=name, chips=1, config_name=name, config=d["config"],
        traffic_name=name, traffic=d["traffic"],
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
