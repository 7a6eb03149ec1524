"""Multi-GPU and multi-process mapping (port of
mm2_gb_tpu/parallel/mesh.py).

Chaining is embarrassingly parallel across reads, so the hot loop has no
communication between devices:

- a batch's reads are cut into contiguous shards balanced by anchor
  count (`_shard_reads`), one per device; each shard is one
  `chain_gpu.dispatch_scores` call on the device's own CUDA stream, and
  the results scatter back into the batch's global (f, p).  This takes
  the place of the JAX package's `shard_map` over the Pallas kernel
  (`sharded_chain_packed`); its lane packing and tile padding were TPU
  layout and are gone.  Given CPU devices the same functions take the
  chain twin, the counterpart of the JAX package's XLA-only
  `sharded_chain_step`.
- A list of devices may repeat one (two shards, two streams, one card)
  or name "cpu"; the default is every visible CUDA device.
- Processes (`--tpu-nproc`) each map a round-robin share of the reads
  into a shard file (cli._run_gpu_multihost) that
  tools/mergeshards.py merges; with `--tpu-coord` they meet once in a
  `torch.distributed` rendezvous (gloo) and exchange no data, as the JAX
  package's ranks exchange none.
"""

from __future__ import annotations

import numpy as np
import torch

from mm2_gb_tpu_torch.ops import chain_gpu


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> list[torch.device]:
    """The devices of a run: `devices` as given (they may repeat one, or
    name "cpu"), else every visible CUDA device; the first n_devices of
    them when given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example [\"cpu\"]) to map on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no device")
    return devs


def _streams(devices: list[torch.device]) -> list:
    """One side stream per entry of devices (None for the CPU): a device
    named twice gets two streams."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devices]


def chain_batch_multichip(devices: list, ax: np.ndarray, ay: np.ndarray,
                          read_bounds: np.ndarray, max_dist_x: int,
                          max_dist_y: int, bw: int, max_iter: int,
                          cg: float, cs: float, is_cdna: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Chain-score a macro-batch with reads sharded across the devices.

    Each device gets its contiguous, anchor-balanced shard of reads as
    one dispatch_scores call on a stream of its own; all shards are in
    flight together, then their (f, p) scatter back into the global
    arrays (p as global anchor indices, -1 for none).  One device
    reduces to the single-device path."""
    devices = make_mesh(devices=devices)
    return _dispatch_shards(
        devices, _streams(devices), ax, ay, np.asarray(read_bounds, np.int64),
        None, dict(max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
                   max_iter=max_iter, cg=cg, cs=cs, is_cdna=is_cdna)
    ).collect()


def _dispatch_shards(devices, streams, ax, ay, bounds, metrics, kw):
    """One dispatch_scores per device on its shard of the reads
    (`bounds`: the anchor offset of each read, with the total), on the
    matching stream; the ShardedScores of the batch."""
    pends = []
    if bounds[-1] > 0:
        for (r0, r1), dev, stream in zip(_shard_pairs(bounds, len(devices)),
                                         devices, streams):
            s, e = int(bounds[r0]), int(bounds[r1])
            if e > s:
                pends.append((chain_gpu.dispatch_scores(
                    ax[s:e], ay[s:e], bounds[r0:r1 + 1] - s, metrics=metrics,
                    device=dev, stream=stream, **kw), s, e))
    return ShardedScores(int(bounds[-1]), pends)


def merge_paf_shards(shards: list[list[tuple[int, str]]]) -> list[str]:
    """Deterministic merge of per-host PAF shards by global read id."""
    allrecs = [rec for shard in shards for rec in shard]
    allrecs.sort(key=lambda t: t[0])
    return [line for _, line in allrecs]


def _shard_reads(bounds: np.ndarray, n_dev: int) -> np.ndarray:
    """Contiguous read shards balanced by anchor count; returns read-index
    boundaries of length n_dev+1."""
    n_reads = bounds.shape[0] - 1
    n = int(bounds[-1])
    if n_reads <= n_dev:
        edges = np.arange(n_dev + 1)
        return np.minimum(edges, n_reads)
    targets = np.searchsorted(bounds[1:-1],
                              (np.arange(1, n_dev) * n) // n_dev) + 1
    return np.concatenate(([0], targets, [n_reads]))


def _shard_pairs(bounds: np.ndarray, n_dev: int) -> list[tuple[int, int]]:
    """(first read, end read) of each device's shard."""
    edges = _shard_reads(bounds, n_dev)
    return [(int(edges[d]), int(edges[d + 1])) for d in range(n_dev)]


class ShardedScores:
    """The in-flight chain scores of one batch's device shards, collected
    into the batch's global (f, p) like one PendingScores (p as global
    anchor indices, -1 for none)."""

    def __init__(self, n: int, pends: list):
        self.n, self.pends = n, pends   # [(PendingScores, start, end)]

    def collect(self) -> tuple[np.ndarray, np.ndarray]:
        f = np.zeros(self.n, np.int32)
        p = np.full(self.n, -1, np.int64)
        for pend, s, e in self.pends:
            fs, ps = pend.collect()
            f[s:e] = fs
            p[s:e] = np.where(ps >= 0, ps + s, -1)
        return f, p


def dispatch_batch_multichip(index, opt, seeded, devices, metrics=None,
                             streams=None):
    """Launch chain scoring for a seeded batch with reads data-parallel
    across the devices: one asynchronous dispatch_scores per device on its
    contiguous anchor-balanced shard, each on the device's own stream
    (`streams`, one per entry of devices; new ones when None).  Returns
    the state finish_batch_multichip takes."""
    from mm2_gb_tpu_torch.models.pipeline import chain_args
    if metrics is not None:
        metrics.n_batches += 1
    bounds = np.zeros(len(seeded) + 1, dtype=np.int64)
    for i, sr in enumerate(seeded):
        bounds[i + 1] = bounds[i] + sr.ax.shape[0]
    if bounds[-1] == 0:
        return seeded, bounds, ShardedScores(0, [])
    ax = np.concatenate([sr.ax for sr in seeded])
    ay = np.concatenate([sr.ay for sr in seeded])
    return seeded, bounds, _dispatch_shards(
        devices, streams if streams is not None else _streams(devices), ax,
        ay, bounds, metrics, chain_args(index, opt))


def finish_batch_multichip(index, opt, state, metrics, pool, device):
    """Collect every shard's scores and run the host finish in global
    read order, with --gpu-align fills on `device` through the same route
    choice as a single-device batch (pipeline._finish_batch); returns
    [(SeededRead, regions)]."""
    from mm2_gb_tpu_torch.models.pipeline import _finish_batch
    return _finish_batch(index, opt, state, metrics, pool, device)


def map_file_multichip(index, opt, paths, devices, metrics=None,
                       n_threads: int = 1):
    """Stream (SeededRead, regions) with reads data-parallel across the
    devices: the multi-device mapping loop.  Double-buffered like
    pipeline.map_file_gpu_records (every device scores batch N while the
    host finishes batch N-1); n_threads > 1 fans the per-read seed and
    finish out over a thread pool (ordered emit).  --gpu-align fills run
    on devices[0], so the output bytes equal a single-device run's."""
    from mm2_gb_tpu_torch.models.pipeline import GpuMetrics, stream_batches
    devices = make_mesh(devices=devices)
    metrics = metrics or GpuMetrics()
    streams = _streams(devices)
    yield from stream_batches(
        index, opt, paths, metrics, n_threads, devices[0], None,
        lambda acc: dispatch_batch_multichip(index, opt, acc, devices,
                                             metrics, streams))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: float = 600.0) -> int:
    """The rendezvous of a multi-process run: with a coordinator
    HOST:PORT and more than one process, join a torch.distributed group
    (gloo backend, tcp://HOST:PORT, world size num_processes, this rank),
    waiting at most timeout_s for the others.  The ranks exchange no data
    (each maps its own round-robin share of the reads into a shard file);
    shutdown_distributed leaves the group.  Returns this process's
    rank."""
    if coordinator is None or num_processes is None or num_processes <= 1:
        return process_id or 0
    import datetime

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def shutdown_distributed() -> None:
    """Leave the torch.distributed group of init_distributed, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
