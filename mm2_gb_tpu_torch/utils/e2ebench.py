"""The end-to-end bench stage: the one place that defines how the port's
CLI is timed against a baseline command (e2e_wall_s and the fields
around it).

A configuration is a tag and the CLI flags it adds (`extra`).  Its card
side is `python -m mm2_gb_tpu_torch`, which maps on the card (the CLI's
default device; nothing here falls back to the CPU), at -v 3; its
baseline is a command prefix, by default the port's host route
(HOST_CMD, `python -m mm2_gb_tpu_torch --device cpu`, the JAX package's
host path copied verbatim), whose bytes the card side's must equal.
The record names the baseline's command (e2e_<tag>_base_cmd).  Both
run as subprocesses from the repository's root on the same reference,
reads, --max-chain-skip=2147483647 and -t; the baseline gets every flag of
`extra` but the device flags (DEVICE_FLAGS), so -c, -a, -x and
--qstrand reach both sides.

The rep policy:

- one untimed run of each side first (it pays the kernel build, the
  host kit build and the page cache), then turns A, B, B, A (A the
  baseline, B the card side) until each side has best_of timed runs;
- every run's stdout, the untimed ones too, must equal the first
  baseline run's byte for byte (SAM without its @PG line, which holds
  each side's command);
- each side's best wall, median, every wall and spread
  ((max - min) / min) go into the record; e2e_<tag>_wall_s is the card
  side's best wall, reads_s the reads per second at it and vs_base the
  baseline's best wall over it;
- a run that exits non-zero or passes RUN_TIMEOUT_S ends the
  configuration with e2e_<tag>_error, one whose bytes differ with
  byte_match false; nothing is retried.  When the budget
  (`remaining()`, seconds) runs out before or during a run, the record
  keeps what was measured and says so in e2e_<tag>_incomplete.

The card side's `[M::gpu]` lines (cli._run_gpu's and
models.pipeline.GpuMetrics.report's) and, with MM2TPU_TIMELINE=1 in
`env`, each side's phase marks (utils.timeline) become fields of the
record, from that side's best run (parse_gpu_report, parse_timeline),
with the kernels' share of the card's best wall.
"""

from __future__ import annotations

import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASE_FLAGS = ["--max-chain-skip=2147483647"]
CARD_CMD = [sys.executable, "-m", "mm2_gb_tpu_torch"]
HOST_CMD = [*CARD_CMD, "--device", "cpu"]
RUN_TIMEOUT_S = 900.0   # one run's limit (the budget may cut it sooner)
# the flags that choose the device route, and whether each takes a value
DEVICE_FLAGS = {
    **dict.fromkeys(("--gpu-chain", "--tpu-chain", "--gpu-align",
                     "--tpu-align"), False),
    **{f"--{p}-{n}": True for p in ("gpu", "tpu")
       for n in ("devices", "nproc", "rank", "coord", "profile", "cfg")}}

_NUM = r"([0-9]+(?:\.[0-9]+)?)"
# the device run's `[M::gpu]` lines, cli._run_gpu's and then
# GpuMetrics.report's: (pattern, field names), every field a number
_GPU_LINES = [
    (r"devices: (\d+) \(.*\)", "devices"),
    (r"(\d+) reads, (\d+) anchors, (\d+) segments in (\d+) batches "
     r"\((\d+) cap-split\), (\d+) kernel dispatches",
     "reads anchors segments batches cap_split dispatches"),
    (r"host route: (\d+) HPC batches, (\d+) RMQ batches",
     "host_hpc_batches host_rmq_batches"),
    (rf"pairs: (\d+); kernel {_NUM}s \({_NUM} Gpairs/s\)",
     "pairs chain_kernel_s chain_gpairs_s"),
    (rf"time: seed {_NUM}s, range {_NUM}s, pack {_NUM}s, dispatch "
     rf"{_NUM}s, device-wait {_NUM}s, finish {_NUM}s; host {_NUM}s / "
     rf"wall {_NUM}s",
     "seed_s range_s pack_s dispatch_s device_wait_s finish_s host_s "
     "pipeline_wall_s"),
    (rf"fills: (\d+) \((\d+) device, (\d+) host-routed\) in (\d+) chunks; "
     rf"(\d+) cells; fill kernel {_NUM} ms \({_NUM} GCUPS\), backtrack "
     rf"kernel {_NUM} ms; collect {_NUM}s, device batch {_NUM}s, table "
     rf"{_NUM}s; (\d+) with state in global scratch; extensions: (\d+) "
     rf"\((\d+) device, (\d+) host-routed\) in (\d+) chunks; (\d+) cells; "
     rf"ext kernel {_NUM} ms \({_NUM} GCUPS\), backtrack kernel {_NUM} ms; "
     r"real-pass misses \(aligned on the host\): (\d+) fill, (\d+) ext, "
     r"(\d+) splice",
     "fills fills_device fills_host_routed fill_chunks fill_cells "
     "fill_kernel_ms fill_gcups backtrack_ms collect_s device_batch_s "
     "table_s scratch_fills exts exts_device exts_host_routed ext_chunks "
     "ext_cells ext_kernel_ms ext_gcups ext_backtrack_ms misses_fill "
     "misses_ext misses_splice"),
]
_MARK = re.compile(r"^\[T::\s*([0-9.]+)s\] (.+)$", re.M)


def _number(s: str):
    return float(s) if "." in s else int(s)


def parse_gpu_report(stderr: str) -> dict:
    """The fields of the `[M::gpu]` lines in stderr (one run's), and
    kernel_s: the chain kernel's seconds plus the fill, backtrack and
    extension kernels' milliseconds.  A `[M::gpu]` line that none of the
    report's patterns reads raises ValueError (the format changed)."""
    out: dict = {}
    for line in stderr.splitlines():
        if not line.startswith("[M::gpu] "):
            continue
        body = line[len("[M::gpu] "):]
        for pattern, names in _GPU_LINES:
            m = re.fullmatch(pattern, body)
            if m:
                out.update(zip(names.split(), map(_number, m.groups())))
                break
        else:
            raise ValueError(f"an [M::gpu] line of no known form: {line}")
    if "chain_kernel_s" in out:
        ms = sum(out.get(k, 0.0) for k in ("fill_kernel_ms", "backtrack_ms",
                                            "ext_kernel_ms",
                                            "ext_backtrack_ms"))
        out["kernel_s"] = out["chain_kernel_s"] + ms / 1e3
    return out


def parse_timeline(stderr: str) -> dict:
    """The phase marks' split of a run (utils.timeline): start-up (the
    interpreter and imports), index build, CUDA start-up and batch caps,
    and mapping, in seconds; {} without the marks."""
    at = {m: float(t) for t, m in _MARK.findall(stderr)}
    spans = {"startup_s": (None, "index build start"),
             "index_s": ("index build start", "index built"),
             "cuda_startup_s": ("index built", "mapping start"),
             "mapping_s": ("mapping start", "mapping done")}
    return {k: round(at[b] - (at[a] if a else 0.0), 2)   # marks: 0.01 s
            for k, (a, b) in spans.items()
            if b in at and (a is None or a in at)}


def host_flags(extra: list[str]) -> list[str]:
    """extra without its device flags (DEVICE_FLAGS, and the value of one
    that takes a value): what the baseline runs."""
    out, skip = [], False
    for f in extra:
        name = f.partition("=")[0]
        if skip:
            skip = False
        elif name in DEVICE_FLAGS:
            skip = DEVICE_FLAGS[name] and "=" not in f
        else:
            out.append(f)
    return out


def _no_pg(text: str) -> str:
    """SAM text without its @PG line (it holds each side's command); any
    other output as it is."""
    if not text.startswith("@"):
        return text
    return "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith("@PG"))


def turns(best_of: int) -> list[str]:
    """The timed runs' order: A, B, B, A, ... ("base", "card") until each
    side has best_of runs."""
    order, n = [], {"base": 0, "card": 0}
    i = 0
    while min(n.values()) < best_of:
        side = ("base", "card", "card", "base")[i % 4]
        i += 1
        if n[side] < best_of:
            order.append(side)
            n[side] += 1
    return order


def _summary(walls: list[float]) -> dict:
    """best, median, every wall and the spread (max - min) / min."""
    best = min(walls)
    return {"wall_s": best, "wall_median_s": statistics.median(walls),
            "walls_s": list(walls),
            "spread": (max(walls) - best) / best if best else 0.0}


def run_config(tag: str, extra: list[str], ref: str, reads: str,
               n_reads: int, threads: int = 1, *,
               base_cmd: list[str] | None = None,
               remaining=lambda: math.inf, best_of: int = 4,
               cmd: list[str] | None = None,
               env: dict | None = None) -> dict:
    """Time one configuration, card side (cmd, default CARD_CMD, with
    extra) against the baseline (base_cmd, default HOST_CMD, with
    host_flags(extra)), under the module's rep policy: a flat dict of
    e2e_<tag>_* fields (the baseline's walls as base_*)."""
    p = f"e2e_{tag}_"
    base_cmd = base_cmd or HOST_CMD
    tail = ["-t", str(threads), ref, reads]
    argv = {"base": [*base_cmd, *BASE_FLAGS,
                     *host_flags(extra), *tail],
            "card": [*(cmd or CARD_CMD), *BASE_FLAGS, *extra, "-v", "3",
                     *tail]}
    out: dict = {p + "flags": " ".join(extra), p + "threads": threads,
                 p + "n_reads": n_reads, p + "best_of": best_of,
                 p + "base": " ".join(argv["base"][1:-len(tail)]),
                 p + "base_cmd": " ".join([os.path.basename(base_cmd[0]),
                                           *base_cmd[1:]])}
    run_env = dict(os.environ, **(env or {}))
    runs: dict = {"base": [], "card": []}   # timed runs: (wall, stderr)
    want = None
    for i, side in enumerate(["base", "card"] + turns(best_of)):
        left = remaining()
        if left <= 0:
            out[p + "incomplete"] = "the budget ran out"
            break
        t0 = time.perf_counter()
        try:
            r = subprocess.run(argv[side], cwd=ROOT, env=run_env,
                               capture_output=True, text=True,
                               timeout=min(RUN_TIMEOUT_S, left))
        except subprocess.TimeoutExpired:
            if left < RUN_TIMEOUT_S:
                out[p + "incomplete"] = "the budget ran out"
            else:
                out[p + "error"] = (f"{side} run timed out after "
                                    f"{RUN_TIMEOUT_S} s")
            break
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            out[p + "error"] = (f"{side} run exited {r.returncode}: "
                                f"{r.stderr[-400:]}")
            break
        got = _no_pg(r.stdout)
        if want is None:
            want = got
        out[p + "byte_match"] = got == want
        if got != want:
            break
        if i >= 2:
            runs[side].append((wall, r.stderr))
    for side, pre in (("card", p), ("base", p + "base_")):
        if not runs[side]:
            continue
        out.update({pre + k: v for k, v in _summary(
            [w for w, _e in runs[side]]).items()})
        best_wall, best_err = min(runs[side], key=lambda run: run[0])
        try:   # the baseline prints no [M::gpu] line: its marks alone
            fields = {**parse_gpu_report(best_err),
                      **parse_timeline(best_err)}
        except ValueError as e:
            out[p + "error"] = str(e)
            return out
        out.update({pre + k: v for k, v in fields.items()})
        if "kernel_s" in fields:
            out[pre + "kernel_share"] = fields["kernel_s"] / best_wall
    if runs["card"]:
        out[p + "reads_s"] = n_reads / out[p + "wall_s"]
        if runs["base"]:
            out[p + "vs_base"] = out[p + "base_wall_s"] / out[p + "wall_s"]
    return out

