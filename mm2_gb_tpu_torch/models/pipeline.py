"""Batched mapping pipeline with chaining on the GPU.

Port of the chain-only part of mm2_gb_tpu/models/pipeline.py (the
reference's split pipeline, map.c worker_for under __AMD_SPLIT_KERNELS__):
reads are seeded on the host, their anchors accumulated into a
macro-batch, chain-scored on the device in one launch, then backtracked
and post-processed on the host and written in input order.  RMQ
chaining (--rmq, the asm presets) is not the kernel's DP: those batches
chain on the host in finish_read, as the host path chains them.

`seed_read` and `finish_read` are copies of the JAX package's: their
module imports the TPU chain kernel, and with it JAX.

With --gpu-align (and -c), each batch's gap fills run on the device
between the readback and the host finish.  Genomic runs take
`_prefill_native`: a collect pass of the C++ aligner records every
APPROX_MAX fill, the fill and backtrack kernels solve them
(ops/ksw2_gpu.extd2_fill_batch), and the real pass reads the results
from the aligner's table.  The runs the C++ aligner does not carry
(splice presets, --qstrand, --print-aln-seq, no native kit) take
`_prefill_device`: the Python align driver records its gap fills,
extensions and splice fills in a collect pass, the kernels solve them
(extd2_fill_batch, ops/ksw2_gpu.extd2_ext_batch,
ops/ksw2s_gpu.exts2_fill_batch), and the real pass reads them from the
driver's fill cache.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from mm2_gb_tpu_torch.models import hit as hitmod
from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.models.mapper import (_chain_gaps, _dbg_chain_dump,
                                            _dbg_seed_dump, post_process)
from mm2_gb_tpu_torch.ops import align as align_ops
from mm2_gb_tpu_torch.ops import chain as chain_ops
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2, ksw2_gpu, ksw2s_gpu
from mm2_gb_tpu_torch.ops import chain_rmq as rmq_ops
from mm2_gb_tpu_torch.ops import seed as seed_ops
from mm2_gb_tpu_torch.ops.sdust import dust_minier
from mm2_gb_tpu_torch.ops.sketch import sketch
from mm2_gb_tpu_torch.utils import ksort, native, timeline
from mm2_gb_tpu_torch.utils.fastx import SeqRecord, read_batches
from mm2_gb_tpu_torch.utils.gpucfg import current_config
from mm2_gb_tpu_torch.utils.hashkit import read_order_hash
from mm2_gb_tpu_torch.utils.opts import (MapOptions, MM_F_CIGAR,
                                         MM_F_HEAP_SORT, MM_F_NO_HASH_NAME,
                                         MM_F_NO_LJOIN, MM_F_QSTRAND,
                                         MM_F_RMQ, MM_F_SPLICE, MM_F_SR,
                                         MM_F_TPU_ALIGN, MM_I_HPC)

INT32_MAX = 2**31 - 1


@dataclass
class SeededRead:
    rec: SeqRecord
    ax: np.ndarray
    ay: np.ndarray
    rep_len: int
    mini_pos: np.ndarray
    mv: np.ndarray | None = None  # retained for the max_occ re-chain
    batch: int = -1               # the accumulation batch (_acc_batches)


def seed_read(index: MinimizerIndex, opt: MapOptions, rec: SeqRecord
              ) -> SeededRead:
    """Host seeding stage (mm_map_seed analog, map.c:355-391)."""
    mm = sketch(rec.seq, index.w, index.k, 0, bool(index.flag & MM_I_HPC))
    if opt.sdust_thres > 0:  # as mapper.collect_minimizers (map.c:194-195)
        mm = dust_minier(mm, rec.seq, opt.sdust_thres)
    if opt.q_occ_frac > 0.0:
        mm = seed_ops.seed_mz_flt(mm, opt.mid_occ, opt.q_occ_frac)
    collect = (seed_ops.collect_seed_hits_heap
               if opt.flag & MM_F_HEAP_SORT else
               seed_ops.collect_seed_hits)
    ax, ay, rep_len, mini_pos = collect(
        index, opt, opt.mid_occ, mm, rec.length, rec.name)
    return SeededRead(rec, ax, ay, rep_len, mini_pos, mm)


def _chain_penalties(index: MinimizerIndex, opt: MapOptions
                     ) -> tuple[np.float32, np.float32]:
    """(chn_pen_gap, chn_pen_skip) in float32, as mm_mapopt_update
    derives them from the scales and k."""
    return (np.float32(float(np.float32(opt.chain_gap_scale)) * 0.01
                       * index.k),
            np.float32(float(np.float32(opt.chain_skip_scale)) * 0.01
                       * index.k))


def finish_read(index: MinimizerIndex, opt: MapOptions, sr: SeededRead,
                f: np.ndarray, p: np.ndarray,
                dump: bool = True) -> list[hitmod.Region]:
    """Backtrack device scores and run the standard post-chain path.
    `dump` False (the fill collect pass) writes no debug dump."""
    qlen = sr.rec.length
    chn_pen_gap, chn_pen_skip = _chain_penalties(index, opt)
    if opt.flag & MM_F_RMQ:
        # RMQ chaining (--rmq, the asm presets) is not the kernel's DP: it
        # runs here, as on the host path (mapper.chain_anchors); the batch
        # launched nothing for it (_dispatch_batch) and f, p are unused
        u, cx, cy = rmq_ops.chain_rmq(
            sr.ax, sr.ay, opt.max_gap, opt.rmq_inner_dist, opt.bw,
            opt.max_chain_skip, opt.rmq_size_cap, opt.min_cnt,
            opt.min_chain_score, chn_pen_gap, chn_pen_skip)
    else:
        max_drop = opt.bw if opt.bw < INT32_MAX else INT32_MAX
        u, v = chain_ops.chain_backtrack(f, p, opt.min_cnt,
                                         opt.min_chain_score, max_drop)
        if u.shape[0] == 0:
            u = np.empty(0, np.uint64)
            cx = cy = np.empty(0, np.uint64)
        else:
            u, cx, cy = chain_ops.compact_chains(u, v, sr.ax, sr.ay)

    # long-join rescue on the host (post_chaining_helper analog,
    # map.c:428-484 — the reference also re-chains on the CPU after GPU).
    # The OUTER condition makes the max_occ re-chain an else-if
    # (map.c:698-709): when it holds, that branch is skipped even if the
    # rescue emptied the chain set.
    ljoin = (opt.bw_long > opt.bw
             and (opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)) == 0
             and u.shape[0] > 1)
    if ljoin:
        cnt0 = int(u[0] & np.uint64(0xFFFFFFFF))
        st = int(cy[0] & np.uint64(0xFFFFFFFF))
        en = int(cy[cnt0 - 1] & np.uint64(0xFFFFFFFF))
        if (qlen - (en - st) > opt.rmq_rescue_size
                or en - st > qlen * opt.rmq_rescue_ratio):
            perm = (native.radix_perm64(cx) if native.available()
                    else ksort.radix_perm64(cx))
            cx, cy = cx[perm], cy[perm]
            u, cx, cy = rmq_ops.chain_rmq(
                cx, cy, opt.max_gap, opt.rmq_inner_dist, opt.bw_long,
                opt.max_chain_skip, opt.rmq_size_cap, opt.min_cnt,
                opt.min_chain_score, chn_pen_gap, chn_pen_skip)

    # max_occ re-chain (map.c:708-731): for a single-segment read the
    # best-chain segment-count test degenerates, so this fires only when
    # no chain survived at mid_occ.  We replicate the CPU reference (the
    # byte-match target): re-collect from the retained minimizer vector
    # with opt.max_occ and re-chain on the host.
    if (not ljoin and opt.max_occ > opt.mid_occ and sr.rep_len > 0
            and not (opt.flag & MM_F_RMQ)
            and u.shape[0] == 0 and sr.mv is not None):
        collect = (seed_ops.collect_seed_hits_heap
                   if opt.flag & MM_F_HEAP_SORT else
                   seed_ops.collect_seed_hits)
        ax2, ay2, rep_len2, mini_pos2 = collect(
            index, opt, opt.max_occ, sr.mv, qlen, sr.rec.name)
        max_gap_qry, max_gap_ref = _chain_gaps(opt, qlen)
        u, cx, cy = chain_ops.chain_dp(
            ax2, ay2, max_gap_ref, max_gap_qry, opt.bw, opt.max_chain_skip,
            opt.max_chain_iter, opt.min_cnt, opt.min_chain_score,
            chn_pen_gap, chn_pen_skip, bool(opt.flag & MM_F_SPLICE), 1)
        sr.rep_len, sr.mini_pos = rep_len2, mini_pos2

    hash_ = read_order_hash(sr.rec.name, qlen, opt.seed,
                            bool(opt.flag & MM_F_NO_HASH_NAME))
    regs = hitmod.gen_regs(hash_, qlen, u, cx, cy,
                           bool(opt.flag & MM_F_QSTRAND))
    if index.n_alt:
        hitmod.mark_alt(index, regs)
        regs = hitmod.hit_sort(regs, opt.alt_drop)
    if dump and opt.dbg_print_seed:
        _dbg_seed_dump(index, sr.ax, sr.ay, sr.rep_len)
    if dump and (opt.dbg_print_seed or opt.dbg_print_chain):
        _dbg_chain_dump(index, regs, cx, cy)
    return post_process(index, opt, qlen, 1, [qlen], regs, cx, cy,
                        sr.mini_pos, sr.rep_len, [sr.rec.seq])


@dataclass
class GpuMetrics:
    """planalyze analog (gpu/planalyze.cu:59-86, plchain.cu:258-281):
    per-stage wall time, device wait, kernel time and relaxation-pair
    counts for the device chaining path, printed at -v >= 3."""
    t_seed: float = 0.0      # host sketch+seed (mm_map_seed analog)
    t_range: float = 0.0     # range selection + cutting (plrange analog)
    t_pack: float = 0.0      # work list + pinned upload buffer
    t_dispatch: float = 0.0  # upload + launch + readback enqueue
    t_wait: float = 0.0      # blocked on device results
    t_kernel: float = 0.0    # chain kernel time (CUDA events)
    t_finish: float = 0.0    # backtrack + post + alignment (host)
    n_reads: int = 0
    n_anchors: int = 0
    n_segs: int = 0
    n_pairs: int = 0         # sum of ranges == anchor-pair relaxations
    n_dispatch: int = 0      # kernel dispatches
    n_batches: int = 0
    n_spills: int = 0        # batches cut by anchor/read caps
    n_host_hpc: int = 0      # batches chained on the host: non-uniform span
    n_host_rmq: int = 0      # batches chained on the host: RMQ chaining
    n_scanned: int = 0       # input records seen (incl. other ranks' in
    #                          a sharded run): multi-process completeness
    # --gpu-align gap fills (_prefill_native, _prefill_device)
    fills: ksw2_gpu.FillStats = None
    t_collect: float = 0.0   # the align driver's collect pass
    t_table: float = 0.0     # loading the results into its table (cache)

    def __post_init__(self):
        self.wall0 = time.perf_counter()
        if self.fills is None:
            self.fills = ksw2_gpu.FillStats()

    def report(self, verbose: int = 3) -> None:
        """The `[M::gpu]` lines at -v 3.  On the `fills:` line, `chunks`
        counts the chunks of the fill batches, each one fill-kernel launch
        and one backtrack launch: exts2_fill runs a chunk's warp-class and
        block-class fills in one launch, so chunks are the launches of
        each kernel."""
        if verbose < 3:
            return
        wall = time.perf_counter() - self.wall0
        host = self.t_seed + self.t_range + self.t_pack + self.t_finish
        rate = self.n_pairs / self.t_kernel / 1e9 if self.t_kernel else 0.0
        w = sys.stderr.write
        w(f"[M::gpu] {self.n_reads} reads, {self.n_anchors} anchors, "
          f"{self.n_segs} segments in {self.n_batches} batches "
          f"({self.n_spills} cap-split), {self.n_dispatch} kernel "
          f"dispatches\n")
        w(f"[M::gpu] host route: {self.n_host_hpc} HPC batches, "
          f"{self.n_host_rmq} RMQ batches\n")
        w(f"[M::gpu] pairs: {self.n_pairs}; kernel {self.t_kernel:.4f}s "
          f"({rate:.3f} Gpairs/s)\n")
        w(f"[M::gpu] time: seed {self.t_seed:.3f}s, "
          f"range {self.t_range:.3f}s, "
          f"pack {self.t_pack:.3f}s, dispatch {self.t_dispatch:.3f}s, "
          f"device-wait {self.t_wait:.3f}s, finish {self.t_finish:.3f}s; "
          f"host {host:.3f}s / wall {wall:.3f}s\n")
        fs = self.fills
        if fs.fills or fs.ext_fills:
            gcups = fs.cells / fs.fill_ms / 1e6 if fs.fill_ms else 0.0
            ext_gcups = fs.ext_cells / fs.ext_ms / 1e6 if fs.ext_ms else 0.0
            w(f"[M::gpu] fills: {fs.fills} ({fs.device_fills} device, "
              f"{fs.host_fills} host-routed) in {fs.chunks} chunks; "
              f"{fs.cells} cells; fill kernel {fs.fill_ms:.3f} ms "
              f"({gcups:.3f} GCUPS), backtrack kernel "
              f"{fs.backtrack_ms:.3f} ms; collect {self.t_collect:.3f}s, "
              f"device batch {fs.batch_s:.3f}s, table "
              f"{self.t_table:.3f}s; {fs.scratch_fills} with state in "
              f"global scratch; extensions: {fs.ext_fills} "
              f"({fs.ext_fills - fs.ext_host_fills} device, "
              f"{fs.ext_host_fills} host-routed) in {fs.ext_chunks} "
              f"chunks; {fs.ext_cells} cells; ext kernel "
              f"{fs.ext_ms:.3f} ms ({ext_gcups:.3f} GCUPS), backtrack "
              f"kernel {fs.ext_backtrack_ms:.3f} ms; real-pass misses "
              f"(aligned on the host): {fs.misses['fill']} fill, "
              f"{fs.misses['ext']} ext, {fs.misses['splice']} splice\n")


# accumulation batch ids, unique in the process (SeededRead.batch, spans)
_BATCH_IDS = itertools.count()


def _seed_one(index: MinimizerIndex, opt: MapOptions, rec: SeqRecord,
              batch: int) -> SeededRead:
    """seed_read in a `seed.read` span of `batch`."""
    with timeline.span("seed.read", batch):
        return seed_read(index, opt, rec)


def _acc_batches(index: MinimizerIndex, opt: MapOptions, paths: list[str],
                 metrics: GpuMetrics, pool=None,
                 shard: tuple[int, int] | None = None):
    """Seed reads and yield accumulation batches bounded by the device
    capacity caps (mm_trbuf accumulate + overflow spill, map.c:886-922,
    943-995).  Caps come from GpuConfig; mini-batch boundaries flush like
    the reference's end-of-stream kt_for hook (kthread.c:52-55).

    `pool` fans seeding out in 64-read chunks with ordered results (the
    kt_for analog for the seed stage; the native sketch/lookup kernels
    release the GIL).

    `shard=(rank, nproc)` keeps only the reads whose global index is
    owned by this process (round-robin), the multi-process split; each
    SeededRead carries its global index in rec.rid for the merge, and
    metrics.n_scanned counts every record seen.

    Each batch takes an id from _BATCH_IDS (SeededRead.batch); a chunk's
    `seed.chunk` span and its reads' `seed.read` spans carry the id of
    the batch being filled when the chunk starts."""
    cfg = current_config()
    acc: list[SeededRead] = []
    n_anch = 0
    gidx = -1
    bid = next(_BATCH_IDS)
    for batch in read_batches(paths, opt.mini_batch_size):
        mine = []
        for rec in batch:
            gidx += 1
            rec.rid = gidx
            metrics.n_scanned += 1
            if shard is not None and gidx % shard[1] != shard[0]:
                continue
            if opt.dbg_print_qname:  # QR dump (map.c:938-941)
                sys.stderr.write(f"QR\t{rec.name}\t0\t{rec.length}\n")
            mine.append(rec)
        for c0 in range(0, len(mine), 64):
            chunk = mine[c0:c0 + 64]
            with timeline.span("seed.chunk", bid) as sp:
                if pool is not None and len(chunk) > 1:
                    seeded = list(pool.map(
                        lambda r: _seed_one(index, opt, r, bid), chunk))
                else:
                    seeded = [_seed_one(index, opt, r, bid) for r in chunk]
            metrics.t_seed += sp.wall_s
            for sr in seeded:
                metrics.n_reads += 1
                metrics.n_anchors += int(sr.ax.shape[0])
                if acc and (n_anch + sr.ax.shape[0] > cfg.max_anchors_batch
                            or len(acc) >= cfg.max_reads_batch):
                    metrics.n_spills += 1
                    yield acc
                    acc, n_anch = [], 0
                    bid = next(_BATCH_IDS)
                sr.batch = bid
                acc.append(sr)
                n_anch += int(sr.ax.shape[0])
        if acc:
            yield acc
            acc, n_anch = [], 0
            bid = next(_BATCH_IDS)


def chain_args(index: MinimizerIndex, opt: MapOptions) -> dict:
    """The device chaining parameters of a batch (qlen-independent), as
    keyword arguments of chain_gpu.dispatch_scores."""
    max_gap_qry, max_gap_ref = _chain_gaps(opt, 0)
    chn_pen_gap, chn_pen_skip = _chain_penalties(index, opt)
    return dict(max_dist_x=max_gap_ref, max_dist_y=max_gap_qry, bw=opt.bw,
                max_iter=opt.max_chain_iter, cg=float(chn_pen_gap),
                cs=float(chn_pen_skip),
                is_cdna=bool(opt.flag & MM_F_SPLICE))


def _dispatch_batch(index: MinimizerIndex, opt: MapOptions,
                    acc: list[SeededRead], metrics: GpuMetrics,
                    device: torch.device, stream=None):
    """Concatenate a batch's anchors and launch device scoring (async)."""
    metrics.n_batches += 1
    bounds = np.zeros(len(acc) + 1, dtype=np.int64)
    for i, sr in enumerate(acc):
        bounds[i + 1] = bounds[i] + sr.ax.shape[0]
    if bounds[-1] == 0:
        return acc, bounds, chain_gpu.PendingScores(0)
    if opt.flag & MM_F_RMQ:   # RMQ chaining: on the host (finish_read)
        metrics.n_host_rmq += 1
        pend = chain_gpu.PendingScores(int(bounds[-1]))
        pend.collected = True
        return acc, bounds, pend
    ax = np.concatenate([sr.ax for sr in acc])
    ay = np.concatenate([sr.ay for sr in acc])
    pend = chain_gpu.dispatch_scores(ax, ay, bounds, metrics=metrics,
                                     device=device, stream=stream,
                                     **chain_args(index, opt))
    return acc, bounds, pend


def finish_slices(index: MinimizerIndex, opt: MapOptions, slices,
                  pool=None) -> list[tuple[SeededRead, list]]:
    """Run finish_read over a batch's (sr, f, p) slices with ordered
    results — on `pool` when given (the kt_for analog, kthread.c:59-82:
    per-read work fans out, output order is the input order).  Debug
    dump modes stay sequential so their stderr interleaving matches the
    reference's -t 1 requirement (main.c:209,213).  Ends the fill
    session however the pass ends (_end_fill_session).  A `finish.slices`
    span holds the pass, a `finish.read` span each read."""
    try:
        with timeline.span("finish.slices"):
            if (pool is not None and len(slices) > 1
                    and not (opt.dbg_print_seed or opt.dbg_print_chain
                             or opt.dbg_print_qname)):
                futs = [pool.submit(_finish_one, index, opt, sr, fp, pp)
                        for sr, fp, pp in slices]
                return [(sl[0], fu.result())
                        for sl, fu in zip(slices, futs)]
            return [(sr, _finish_one(index, opt, sr, fp, pp))
                    for sr, fp, pp in slices]
    finally:
        _end_fill_session()


def _finish_one(index: MinimizerIndex, opt: MapOptions, sr: SeededRead,
                f: np.ndarray, p: np.ndarray) -> list[hitmod.Region]:
    """finish_read of the real pass in a `finish.read` span."""
    with timeline.span("finish.read", sr.batch):
        return finish_read(index, opt, sr, f, p)


def _end_fill_session() -> None:
    """Close the native fill session, drop the Python fill cache and turn
    the Python driver's extension collection off, so neither aligner
    answers a later batch or run from this batch's fills."""
    align_ops.set_fill_cache(None)
    align_ops.collect_ext = False
    if native.available():
        native.fill_mode(0)   # drop any native fill table/session


def use_device_align(opt: MapOptions) -> bool:
    """The JAX pipeline's _use_device_align: --gpu-align fills run on the
    device for -c runs with dual gap costs, except -x sr (and splice runs
    whose q2 is no intron open)."""
    if not (opt.flag & MM_F_TPU_ALIGN) or not (opt.flag & MM_F_CIGAR):
        return False
    if opt.flag & MM_F_SR:
        return False
    if opt.flag & MM_F_SPLICE:  # exts2 device fills (q2 is intron open)
        return opt.q2 > opt.q + opt.e
    return not (opt.q == opt.q2 and opt.e == opt.e2)


def _native_session(opt: MapOptions) -> bool:
    """Whether the C++ aligner carries the run's fills: the JAX pipeline's
    _prefill_native declines splice, --qstrand, --print-aln-seq and the
    absence of the native kit (pipeline.py:404-408; -x sr and single gap
    costs do not reach here)."""
    return (native.available() and not opt.dbg_print_aln_seq
            and not (opt.flag & (MM_F_SPLICE | MM_F_QSTRAND)))


def _prefill_native(index: MinimizerIndex, opt: MapOptions, slices: list,
                    metrics: GpuMetrics, device: torch.device) -> None:
    """Device gap fills of one batch (the JAX pipeline's _prefill_native):
    the C++ aligner records every APPROX_MAX gap fill in a collect
    pass (and answers it with a fake), the kernels solve them, and the
    results go into the aligner's table, which the real pass
    (finish_slices) reads.  The collect pass writes no debug dump."""
    native.fill_mode(1)
    try:
        with timeline.span("fill.collect") as sp:
            for sr, fp, pp in slices:
                finish_read(index, opt, sr, fp, pp, dump=False)
            meta, qblob, tblob = native.fill_fetch()
        metrics.t_collect += sp.wall_s
        scores, cig_off, cig_blob = ksw2_gpu.extd2_fill_batch(
            meta, qblob, tblob, ksw2_gpu.fill_params(opt), device,
            stats=metrics.fills)
        with timeline.span("fill.table") as sp:
            qoff = np.zeros(meta.shape[0] + 1, np.int64)
            toff = np.zeros(meta.shape[0] + 1, np.int64)
            np.cumsum(meta[:, 0], out=qoff[1:])
            np.cumsum(meta[:, 1], out=toff[1:])
            # duplicate keys dedup C-side (first entry wins; results
            # identical)
            native.fill_table_bulk(meta, qoff, qblob, toff, tblob, scores,
                                   cig_off, cig_blob)
            native.fill_mode(2)
        metrics.t_table += sp.wall_s
    except BaseException:
        native.fill_mode(0)
        raise


def _prefill_device(index: MinimizerIndex, opt: MapOptions, slices: list,
                    metrics: GpuMetrics, device: torch.device) -> None:
    """Device fills of one batch through the Python align driver (the JAX
    pipeline's _prefill_device, pipeline.py:457-505): a collect pass
    records every gap fill ("fill"), extension ("ext") and splice fill
    ("splice") and answers each with a fake; the unique ones (by
    align._fill_key) go to the kernels, one batch call per (kind, flag,
    end bonus) -- one for all splice fills, whose batch takes per-fill
    flags; the results become the driver's fill cache, which the real
    pass (finish_slices) reads, and a miss there aligns on the host
    (counted in metrics.fills.misses).
    Extensions always go to the card here (align.collect_ext, set for
    the session; _end_fill_session turns it off).  The collect pass
    writes no debug dump."""
    try:
        with timeline.span("fill.collect") as sp:
            align_ops.collect_ext = True
            align_ops.begin_fill_collect()
            try:
                for sr, fp, pp in slices:
                    finish_read(index, opt, sr, fp, pp, dump=False)
            finally:
                fills = align_ops.end_fill_collect()
            groups: dict = {}
            for kind, qseq, tseq, w, flag, zdrop, end_bonus, junc in fills:
                key = align_ops._fill_key(qseq, tseq, w, flag, zdrop,
                                          end_bonus, junc)
                group = ("splice",) if kind == "splice" else (kind, flag,
                                                              end_bonus)
                groups.setdefault(group, {}).setdefault(
                    key, (qseq, tseq, w, flag, zdrop, junc))
        metrics.t_collect += sp.wall_s
        cache = _FillCache(metrics.fills.misses,
                           bool(opt.flag & MM_F_SPLICE))
        for group, uniq in groups.items():
            cache.update(zip(uniq, _solve_group(group, list(uniq.values()),
                                                opt, metrics, device)))
        with timeline.span("fill.table") as sp:
            align_ops.set_fill_cache(cache)
        metrics.t_table += sp.wall_s
    except BaseException:
        _end_fill_session()
        raise


class _FillCache(dict):
    """_prefill_device's results as the Python align driver's fill cache.
    A lookup that misses (a fill or extension the collect pass did not
    record, which the real pass then aligns on the host) is counted in
    `misses` by kind: "splice" in a splice run, else "fill" for
    KSW_EZ_APPROX_MAX and "ext" for the extensions."""

    def __init__(self, misses: dict, splice: bool):
        super().__init__()
        self.misses, self.splice = misses, splice
        self._lock = threading.Lock()   # finish_slices' pool reads it

    def get(self, key, default=None):
        hit = dict.get(self, key)
        if hit is not None:
            return hit
        kind = ("splice" if self.splice else
                "fill" if key[3] == ksw2.KSW_EZ_APPROX_MAX else "ext")
        with self._lock:
            self.misses[kind] += 1
        return default


def _solve_group(group: tuple, vals: list, opt: MapOptions,
                 metrics: GpuMetrics, device: torch.device) -> list:
    """The Extz results of one group of _prefill_device's unique fills,
    vals = [(qseq, tseq, w, flag, zdrop, junc)], in order."""
    def cat(xs):
        return (np.concatenate(xs).astype(np.uint8, copy=False) if xs
                else np.empty(0, np.uint8))
    qlen = np.array([len(v[0]) for v in vals], np.int64)
    tlen = np.array([len(v[1]) for v in vals], np.int64)
    w = np.array([v[2] for v in vals], np.int64)
    qblob, tblob = cat([v[0] for v in vals]), cat([v[1] for v in vals])
    if group[0] == "splice":
        jl = np.array([0 if v[5] is None else len(v[5]) for v in vals],
                      np.int64)
        scores, cig_off, cig_blob = ksw2s_gpu.exts2_fill_batch(
            np.stack([qlen, tlen, jl], 1), qblob, tblob,
            cat([v[5] for v in vals if v[5] is not None]),
            np.array([v[3] for v in vals], np.int64),
            ksw2s_gpu.splice_params(opt), device, stats=metrics.fills)
        fields = [dict(score=int(sc)) for sc in scores]
    elif group[0] == "fill":
        prm = ksw2_gpu.fill_params(opt)
        zdrop = np.array([v[4] for v in vals], np.int64)
        scores, cig_off, cig_blob = ksw2_gpu.extd2_fill_batch(
            np.stack([qlen, tlen, w, zdrop], 1), qblob, tblob, prm, device,
            group[1], stats=metrics.fills)
        # ksw2.extd2 stops with zdropped where the band collapses (after
        # its empty-side and mat-gate returns); APPROX_MAX sets no other
        # field
        wv = np.where(w < 0, np.maximum(qlen, tlen), w)
        cut = ((qlen > 0) & (tlen > 0) & (not prm.mat_gate)
               & ksw2_gpu.band_collapses(qlen, tlen, wv))
        fields = [dict(score=int(sc), zdropped=bool(c))
                  for sc, c in zip(scores, cut)]
    else:
        rows, cig_off, cig_blob = ksw2_gpu.extd2_ext_batch(
            np.stack([qlen, tlen, w], 1), qblob, tblob,
            np.array([v[4] for v in vals], np.int64),
            ksw2_gpu.fill_params(opt), group[1], group[2], device,
            stats=metrics.fills)
        fields = [{f: (bool(x) if f in ("zdropped", "reach_end") else int(x))
                   for f, x in zip(ksw2_gpu.EXT_FIELDS, row.tolist())}
                  for row in rows]
    out = []
    for k, fk in enumerate(fields):
        ez = ksw2.Extz(**fk)
        ez.cigar = cig_blob[cig_off[k]:cig_off[k + 1]]
        out.append(ez)
    return out


def _finish_batch(index: MinimizerIndex, opt: MapOptions, batch,
                  metrics: GpuMetrics, pool, device: torch.device
                  ) -> list[tuple[SeededRead, list]]:
    """Collect device scores, run the batch's device gap fills
    (--gpu-align), backtrack and post-process one batch, in a
    `finish.batch` span; metrics.t_finish takes its time less the
    readback's (`chain.readback`, metrics.t_wait)."""
    acc, bounds, pend = batch
    with timeline.span("finish.batch",
                       acc[0].batch if acc else -1) as fin:
        with timeline.span("chain.readback") as wait:
            f, p = pend.collect()
        metrics.t_wait += wait.wall_s
        slices = []
        for i, sr in enumerate(acc):
            s, e = int(bounds[i]), int(bounds[i + 1])
            fp = f[s:e]
            pp = np.where(p[s:e] >= 0, p[s:e] - s, -1)
            slices.append((sr, fp, pp))
        if use_device_align(opt):
            if _native_session(opt):
                _prefill_native(index, opt, slices, metrics, device)
            else:
                _prefill_device(index, opt, slices, metrics, device)
        out = finish_slices(index, opt, slices, pool)
    metrics.t_finish += (fin.wall_ns - wait.wall_ns) / 1e9
    return out


def map_batch_gpu(index: MinimizerIndex, opt: MapOptions,
                  records: list[SeqRecord],
                  device: torch.device | str = "cuda"
                  ) -> list[tuple[SeededRead, list]]:
    """Seed + device-chain + finish one batch of reads (synchronous)."""
    metrics = GpuMetrics()
    device = torch.device(device)
    acc = [seed_read(index, opt, rec) for rec in records]
    return _finish_batch(index, opt, _dispatch_batch(
        index, opt, acc, metrics, device), metrics, None, device)


def map_file_gpu_records(index: MinimizerIndex, opt: MapOptions,
                         paths: list[str],
                         metrics: GpuMetrics | None = None,
                         n_threads: int = 1,
                         device: torch.device | str = "cuda",
                         shard: tuple[int, int] | None = None):
    """Stream (SeededRead, regions) for query files, chaining on the GPU.

    Software-pipelined double buffering (the trbuf/stream analog,
    map.c:1017-1084 + plchain.cu:292-306): batch N is dispatched to the
    device before batch N-1's host backtrack/output runs, and the host
    seeds batch N+1 while batch N is in flight.  One dispatch worker
    keeps range selection and the upload off the main thread; every
    batch's upload, kernel and readback go on one side stream.
    n_threads > 1 also fans the per-read host seed and finish out over
    a thread pool (kt_for analog; ordered emit).  `shard=(rank, nproc)`
    maps only this process's round-robin share of the reads
    (_acc_batches)."""
    metrics = metrics or GpuMetrics()
    device = torch.device(device)
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)
    yield from stream_batches(
        index, opt, paths, metrics, n_threads, device, shard,
        lambda acc: _dispatch_batch(index, opt, acc, metrics, device,
                                    stream))


def stream_batches(index: MinimizerIndex, opt: MapOptions,
                   paths: list[str], metrics: GpuMetrics, n_threads: int,
                   device: torch.device, shard, dispatch):
    """The double-buffered batch loop of map_file_gpu_records and
    parallel.mesh.map_file_multichip: dispatch(acc) on one worker thread
    returns a batch's (acc, bounds, pending scores); the host finishes
    batch N-1 (gap fills on `device`) while batch N is in flight."""
    from concurrent.futures import ThreadPoolExecutor
    ex = ThreadPoolExecutor(max_workers=1)
    pool = (ThreadPoolExecutor(max_workers=n_threads)
            if n_threads > 1 else None)
    try:
        pending = None   # (future, batch id)
        for acc in _acc_batches(index, opt, paths, metrics, pool, shard):
            fut = ex.submit(_dispatch_one, dispatch, acc)
            if pending is not None:
                yield from _finish_batch(index, opt, _wait(*pending),
                                         metrics, pool, device)
            pending = fut, acc[0].batch
        if pending is not None:
            yield from _finish_batch(index, opt, _wait(*pending), metrics,
                                     pool, device)
    finally:
        ex.shutdown(wait=True)
        if pool is not None:
            pool.shutdown(wait=True)


def _dispatch_one(dispatch, acc: list[SeededRead]):
    """dispatch(acc) in a `dispatch.batch` span (the dispatch thread)."""
    with timeline.span("dispatch.batch", acc[0].batch):
        return dispatch(acc)


def _wait(fut, batch: int):
    """The dispatched batch, waited for in a `dispatch.wait` span."""
    with timeline.span("dispatch.wait", batch):
        return fut.result()


def map_file_gpu(index: MinimizerIndex, opt: MapOptions,
                 paths: list[str], device: torch.device | str = "cuda"):
    """Stream PAF lines for query files, chaining on the GPU."""
    from mm2_gb_tpu_torch.utils.opts import (MM_F_NO_PRINT_2ND,
                                             MM_F_PAF_NO_HIT)
    from mm2_gb_tpu_torch.utils.paf import write_paf
    for sr, regs in map_file_gpu_records(index, opt, paths, device=device):
        if regs:
            for r in regs:
                if (opt.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                yield write_paf(r, sr.rec.name, sr.rec.length, index,
                                opt.flag, sr.rep_len, sr.rec.comment,
                                sr.rec.seq)
        elif opt.flag & MM_F_PAF_NO_HIT:
            yield write_paf(None, sr.rec.name, sr.rec.length, index,
                            opt.flag, sr.rep_len)
