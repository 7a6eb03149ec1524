"""Streaming 3-stage mapping pipeline with worker threads.

The kt_pipeline / kt_for analog (kthread.c:59-169; map.c:1270-1390):
a reader thread fills fragment mini-batches, a thread pool maps
fragments concurrently (NumPy/C kernels release the GIL), and results
are written strictly in input order.  Output is byte-identical for any
thread count — ordering is by fragment index, never completion order.

Per-stage wall timers mirror the reference's mm_tbuf timers
(map.c:13-17, minimap.h:207-224) and are reported through Metrics.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from queue import Queue

from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.models.mapper import map_frag
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.fastx import SeqRecord, read_fastx


@dataclass
class Metrics:
    """Phase timers + counters (§5.1 analog of [M::...] log lines)."""
    t_read: float = 0.0
    t_map: float = 0.0
    t_write: float = 0.0
    n_seqs: int = 0
    n_bases: int = 0
    n_frags: int = 0
    wall0: float = field(default_factory=time.perf_counter)

    def report(self, verbose: int = 3) -> None:
        if verbose < 3:
            return
        wall = time.perf_counter() - self.wall0
        sys.stderr.write(
            f"[M::pipeline] mapped {self.n_seqs} sequences "
            f"({self.n_bases} bp) in {wall:.3f}s; read {self.t_read:.3f}s, "
            f"map {self.t_map:.3f}s, write {self.t_write:.3f}s\n")


def _qname_same(a: str, b: str) -> bool:
    from mm2_gb_tpu_torch.utils.sam import _qname_len
    la, lb = _qname_len(a), _qname_len(b)
    return la == lb and a[:la] == b[:lb]


#: mm_bseq_read3 stops extending a same-qname run across a batch boundary
#: once the crossing read is this long (CHECK_PAIR_THRES, bseq.c:30).
_CHECK_PAIR_THRES = 1_000_000


def _group_frags(recs: list[SeqRecord], frag_mode: bool
                 ) -> list[list[SeqRecord]]:
    """Linear qname grouping of a flat batch (map.c:1299-1304)."""
    frags, j = [], 0
    for i in range(1, len(recs) + 1):
        if i == len(recs) or not frag_mode or \
                not _qname_same(recs[i - 1].name, recs[i].name):
            frags.append(recs[j:i])
            j = i
    return frags


def read_frag_batches(paths: list[str], mo, mini_batch: int,
                      metrics: Metrics):
    """Yield lists of fragments (each a list of SeqRecords) totalling
    >= mini_batch bases, replicating the reference reader exactly:
    multiple files round-robin interleave with batch breaks at round
    boundaries (mm_bseq_read_frag2, bseq.c:131-159); a single file reads
    sequentially and, in frag mode, keeps pulling same-qname reads past
    the batch boundary while the crossing read is short
    (mm_bseq_read3, bseq.c:80-119).  Fragment grouping is linear over the
    flat batch by qname (worker_pipeline step 0, map.c:1299-1304).

    NOTE: callers own the main.c:451-458 dispatch — without
    MM_F_FRAG_MODE, multiple query files must be fed through separate
    single-file calls, never interleaved (see map_file_stream)."""
    t0 = time.perf_counter()
    frag_mode = len(paths) > 1 or bool(mo.flag & O.MM_F_FRAG_MODE)

    if len(paths) > 1:
        iters = [read_fastx(p) for p in paths]
        recs: list[SeqRecord] = []
        total = 0
        eof = False
        while not eof:
            rnd = []
            for it in iters:
                rec = next(it, None)
                if rec is not None:
                    rnd.append(rec)
            if len(rnd) < len(iters):
                if rnd:
                    sys.stderr.write("[W] query files have different number "
                                     "of records; extra records skipped.\n")
                eof = True
            else:
                recs.extend(rnd)
                total += sum(r.length for r in rnd)
            if (eof or total >= mini_batch) and recs:
                metrics.t_read += time.perf_counter() - t0
                yield _group_frags(recs, True)
                t0 = time.perf_counter()
                recs, total = [], 0
    else:
        it = read_fastx(paths[0])
        carry: SeqRecord | None = None  # fp->s analog (bseq.c:88-93)
        while True:
            recs, total = [], 0
            if carry is not None:
                recs.append(carry)
                total = carry.length
                carry = None
            crossed = False
            for rec in it:
                recs.append(rec)
                total += rec.length
                if total >= mini_batch:
                    crossed = True
                    break
            if crossed and frag_mode and \
                    recs[-1].length < _CHECK_PAIR_THRES:
                for rec in it:  # same-qname continuation (bseq.c:101-109)
                    if _qname_same(rec.name, recs[-1].name):
                        recs.append(rec)
                    else:
                        carry = rec
                        break
            if not recs:
                break
            metrics.t_read += time.perf_counter() - t0
            yield _group_frags(recs, frag_mode)
            t0 = time.perf_counter()
            if not crossed and carry is None:
                break
    metrics.t_read += time.perf_counter() - t0


def _map_one(index: MinimizerIndex, mo, frag: list[SeqRecord]):
    """Map one fragment with pe_ori revcomp/flip (worker_for, map.c:1157-1203)."""
    from mm2_gb_tpu_torch.cli import rc_record
    if mo.dbg_print_qname:  # QR dump (map.c:1165-1167); dumps force -t 1
        import sys
        sys.stderr.write(f"QR\t{frag[0].name}\t0\t{frag[0].length}\n")
    n_seg = len(frag)
    pe_flip = [n_seg == 2 and ((j == 0 and (mo.pe_ori >> 1 & 1))
                               or (j == 1 and (mo.pe_ori & 1)))
               for j in range(n_seg)]
    recs = [rc_record(r) if pe_flip[j] else r for j, r in enumerate(frag)]
    if (mo.flag & O.MM_F_INDEPEND_SEG) and n_seg > 1:
        seg_res = [map_frag(index, mo, [r.seq], r.name) for r in recs]
        seg_regs = [sr.seg_regs[0] for sr in seg_res]
        rep_lens = [sr.rep_len for sr in seg_res]
        frag_gap = seg_res[-1].frag_gap  # last segment's (map.c:1264)
    else:
        res = map_frag(index, mo, [r.seq for r in recs], recs[0].name)
        seg_regs = res.seg_regs if res.seg_regs is not None else \
            [res.regs] + [[] for _ in range(n_seg - 1)]
        rep_lens = [res.rep_len] * n_seg
        frag_gap = res.frag_gap
    for j in range(n_seg):
        if pe_flip[j]:
            ql = recs[j].length
            for r in seg_regs[j]:
                r.qs, r.qe = ql - r.qe, ql - r.qs
                r.rev = not r.rev
    return seg_regs, rep_lens, frag_gap


def map_file_stream(index: MinimizerIndex, mo, paths: list[str], out,
                    n_threads: int = 3, rg_id: str | None = None,
                    metrics: Metrics | None = None) -> Metrics:
    """Read → map (thread pool) → ordered write."""
    from mm2_gb_tpu_torch.cli import res_regs_out
    metrics = metrics or Metrics()
    if len(paths) > 1 and not (mo.flag & O.MM_F_FRAG_MODE):
        # main.c:451-455: without frag mode every query file gets its own
        # mm_map_file call — sequential, never interleaved.
        for p in paths:
            map_file_stream(index, mo, [p], out, n_threads, rg_id, metrics)
        return metrics
    is_sam = bool(mo.flag & O.MM_F_OUT_SAM)

    def write_frag(frag, seg_regs, rep_lens):
        t0 = time.perf_counter()
        for j, rec in enumerate(frag):
            res_regs_out(out, index, mo, rec, seg_regs[j], rep_lens[j],
                         is_sam, rg_id, j, len(frag), seg_regs)
            metrics.n_seqs += 1
            metrics.n_bases += rec.length
        metrics.n_frags += 1
        metrics.t_write += time.perf_counter() - t0

    if n_threads <= 1:
        for batch in read_frag_batches(paths, mo, mo.mini_batch_size,
                                       metrics):
            t0 = time.perf_counter()
            results = [_map_one(index, mo, frag) for frag in batch]
            metrics.t_map += time.perf_counter() - t0
            for frag, (seg_regs, rep_lens, _fg) in zip(batch, results):
                write_frag(frag, seg_regs, rep_lens)
        return metrics

    # two-stage overlap: map batch N in the pool while writing batch N-1
    pool = ThreadPoolExecutor(max_workers=n_threads)
    try:
        prev = None  # (batch, futures)
        for batch in read_frag_batches(paths, mo, mo.mini_batch_size,
                                       metrics):
            t0 = time.perf_counter()
            futs = [pool.submit(_map_one, index, mo, frag) for frag in batch]
            if prev is not None:
                pbatch, pfuts = prev
                for frag, fu in zip(pbatch, pfuts):
                    seg_regs, rep_lens, _fg = fu.result()
                    write_frag(frag, seg_regs, rep_lens)
            metrics.t_map += time.perf_counter() - t0
            prev = (batch, futs)
        if prev is not None:
            t0 = time.perf_counter()
            pbatch, pfuts = prev
            for frag, fu in zip(pbatch, pfuts):
                seg_regs, rep_lens, _fg = fu.result()
                write_frag(frag, seg_regs, rep_lens)
            metrics.t_map += time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True)
    return metrics
