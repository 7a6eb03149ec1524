"""Device batch configuration (the --gpu-cfg JSON).

Port of mm2_gb_tpu/utils/tpucfg.py.  The reference tunes its GPU path
with JSON configs (gpu/*.json, parsed at plmem.cu:373-451); the port's
own are `mm2_gb_tpu_torch/configs/h100_{default,below50k,over50k}.json`
(CONFIG_DIR).  This reads the same fields as the TPU package, so a
TpuConfig JSON means the same here: `max_anchors_batch` and
`max_reads_batch` (the macro-batch caps).  Absent fields keep their
defaults; TPU-only fields (`window_classes`, `lanes`, `tile`) are
ignored: the CUDA kernel has no window-width limit.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

import torch

# the port's device configs, one for each read-length class
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@dataclass
class GpuConfig:
    # macro-batch caps (max_total_n / max_read analogs, plmem.cu:473-540)
    # read by models.pipeline._acc_batches: a batch is cut (and the
    # overflow read spilled to the next one, map.c:886-922) when either
    # cap would be exceeded.  The anchor cap keeps several batches in a
    # flowcell, so the device chains batch N while the host seeds N+1
    # and finishes N-1; PERF.md has the cap sweep on the card.
    max_anchors_batch: int = 1_000_000
    max_reads_batch: int = 200_000
    # True when the JSON set a cap: derive_caps then leaves them alone
    caps_explicit: bool = False


_current = GpuConfig()


def current_config() -> GpuConfig:
    """The active config (set by apply_gpu_config; defaults otherwise)."""
    return _current


def load_gpu_config(path: str | None) -> GpuConfig:
    cfg = GpuConfig()
    if not path:
        return cfg
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        sys.stderr.write(f"[W::gpucfg] cannot read {path}: {e}; "
                         "using defaults\n")
        return cfg
    for k in ("max_anchors_batch", "max_reads_batch"):
        if k in data:
            setattr(cfg, k, int(data[k]))
    cfg.caps_explicit = ("max_anchors_batch" in data
                         or "max_reads_batch" in data)
    return cfg


def apply_gpu_config(cfg: GpuConfig) -> None:
    """Install the config for the batcher (models.pipeline)."""
    global _current
    _current = cfg


# Device bytes per batched anchor (ops/chain_gpu.dispatch_scores): the
# upload of x, y and rng (3 x int32) and the results f and p (2 x int32)
# = 20 B, plus the segment work list (2 x int32 per segment, at most one
# segment per anchor) = 8 B; x2 for the two batches in flight (batch N
# on the device while batch N-1 drains on the host).  An upper bound:
# the flowcell's measured allocator peak is about 24 B per capped anchor
# (PERF.md).
BYTES_PER_ANCHOR = 2 * (20 + 8)


# Gap fills (ops/ksw2_gpu.extd2_fill_batch, ksw2s_gpu.exts2_fill_batch)
# run in chunks whose device bytes (direction bytes plus CIGAR slots,
# p_bound + 4*(qlen+tlen) per fill) stay under this budget.  A launch
# lasts as long as its longest fill, so the fill kernels' time is about
# the sum over chunks of each one's longest fill: fewer, larger chunks
# (PERF.md has the sweep on the card, 512 MiB to 4 GiB).  The plain twin
# on the CPU holds about twice that in its state, so CPU runs take a
# smaller budget.
FILL_CHUNK_BYTES = 4 << 30
CPU_FILL_CHUNK_BYTES = 128 << 20


def fill_chunk_bytes(device: torch.device) -> int:
    """The fill chunk budget on `device`: FILL_CHUNK_BYTES, lowered to a
    quarter of the free memory when the card has less than four times
    the budget free; never raised."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_FILL_CHUNK_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    return max(1 << 20, min(FILL_CHUNK_BYTES, free // 4))


def derive_caps(device: torch.device, verbose: int = 1) -> None:
    """Lower the anchor cap to what the device's free memory holds
    (plmem_config_batch analog); never raises it.  A no-op off CUDA or
    when the config pinned the caps."""
    cfg = _current
    if cfg.caps_explicit or torch.device(device).type != "cuda":
        return
    free, _total = torch.cuda.mem_get_info(device)
    fit = free // BYTES_PER_ANCHOR
    if fit >= cfg.max_anchors_batch:
        return
    cfg.max_anchors_batch = max(1, fit)
    if verbose >= 2:
        sys.stderr.write(
            f"[W::gpucfg] {free / 2**20:.1f} MiB free on the device: "
            f"max_anchors_batch lowered to {cfg.max_anchors_batch}\n")
