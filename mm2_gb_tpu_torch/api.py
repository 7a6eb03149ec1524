"""mappy-compatible Python API (python/mappy.pyx analog).

Usage mirrors the reference binding (python/README.rst):

    import mm2_gb_tpu_torch.api as mp
    a = mp.Aligner("ref.fa", preset="map-ont")
    for hit in a.map(read_seq):
        print(hit.ctg, hit.r_st, hit.r_en, hit.cigar_str)
"""

from __future__ import annotations

import contextlib
import copy
import threading
from dataclasses import dataclass

import torch

from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.models.mapper import map_frag
from mm2_gb_tpu_torch.models.pipeline import map_batch_gpu
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.fastx import SeqRecord, read_fastx
from mm2_gb_tpu_torch.utils.gpucfg import derive_caps
from mm2_gb_tpu_torch.utils.sam import _revcomp_str, write_cs_or_md


class _RouteLock:
    """A reader-writer lock for the API's maps.  The card route's fill
    session is state of the whole process: the align driver's collect
    list and fill cache (ops.align) and the host kit's C++ FillSession
    (utils.native.fill_mode).  While a card-route pass holds it, any
    alignment on the host would be answered from it.  So a card-route
    pass holds the lock alone (sole=True), and host maps hold it shared,
    beside each other but never beside a card pass; a card pass that
    waits goes before host maps that come after it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0        # host maps holding the lock
        self._sole = False      # a card pass holds it
        self._waiting = 0       # card passes waiting for it

    def acquire(self, sole: bool, timeout: float | None = None) -> bool:
        """Take the lock, alone or shared; False if timeout (seconds)
        passed first."""
        with self._cond:
            if not sole:
                ok = self._cond.wait_for(
                    lambda: not (self._sole or self._waiting), timeout)
                self._shared += ok
                return ok
            self._waiting += 1
            try:
                ok = self._cond.wait_for(
                    lambda: not (self._sole or self._shared), timeout)
            finally:
                self._waiting -= 1
            self._sole = ok
            if not ok:   # host maps held back for this pass may go on
                self._cond.notify_all()
            return ok

    def release(self, sole: bool) -> None:
        with self._cond:
            if sole:
                self._sole = False
            else:
                self._shared -= 1
            self._cond.notify_all()

    @contextlib.contextmanager
    def held(self, sole: bool):
        self.acquire(sole)
        try:
            yield
        finally:
            self.release(sole)


_ROUTE_LOCK = _RouteLock()


def revcomp(seq: str) -> str:
    """Reverse complement (mappy.revcomp)."""
    return _revcomp_str(seq)


def fastx_read(fn: str, read_comment: bool = False):
    """Yield (name, seq, qual[, comment]) tuples (mappy.fastx_read)."""
    for rec in read_fastx(fn):
        if read_comment:
            yield rec.name, rec.seq, rec.qual, rec.comment
        else:
            yield rec.name, rec.seq, rec.qual


@dataclass
class Alignment:
    """One hit (mappy.Alignment, python/mappy.pyx:10-99)."""
    ctg: str
    ctg_len: int
    r_st: int
    r_en: int
    strand: int
    q_st: int
    q_en: int
    mapq: int
    cigar: list
    is_primary: bool
    mlen: int
    blen: int
    NM: int
    trans_strand: int
    read_num: int = 1
    cs: str = ""
    MD: str = ""

    @property
    def cigar_str(self) -> str:
        return "".join(f"{l}{'MIDNSHP=XB'[op]}" for l, op in self.cigar)

    def __str__(self) -> str:
        strand = "+" if self.strand > 0 else "-" if self.strand < 0 else "?"
        tp = "tp:A:P" if self.is_primary else "tp:A:S"
        ts = ("ts:A:+" if self.trans_strand > 0
              else "ts:A:-" if self.trans_strand < 0 else "ts:A:.")
        a = [str(self.q_st), str(self.q_en), strand, self.ctg,
             str(self.ctg_len), str(self.r_st), str(self.r_en),
             str(self.mlen), str(self.blen), str(self.mapq), tp, ts,
             "cg:Z:" + self.cigar_str]
        if self.cs != "":
            a.append("cs:Z:" + self.cs)
        return "\t".join(a)


class Aligner:
    """Index + mapping front end (mappy.Aligner, python/mappy.pyx:110-236).

    It maps on the card (device="cuda", the default): a single read goes
    through the port's device pipeline (models.pipeline.map_batch_gpu),
    its chain on the chain kernel and its gap fills on the fill kernels,
    as `--gpu-chain --gpu-align` maps it.  A read pair maps on the host
    (models.mapper), as the CLI maps multi-segment reads: the device
    chain takes one segment.  device="cpu" maps every read on the host,
    as the JAX package's API does.

    Threads may share Aligners.  Every map holds one lock of the process
    (_ROUTE_LOCK) while it chains and aligns, because the card route's
    fill session is state of the whole process: a card-route pass holds
    it alone, so card passes take turns and no host map runs beside one;
    host maps hold it shared and run beside each other.  The cs/MD
    strings and the Alignment objects are made outside it.  Mapping runs
    that do not go through the API (the CLI) do not take it."""

    def __init__(self, fn_idx_in: str | None = None, preset: str | None = None,
                 k: int | None = None, w: int | None = None,
                 min_cnt: int | None = None, min_chain_score: int | None = None,
                 min_dp_score: int | None = None, bw: int | None = None,
                 best_n: int | None = None, n_threads: int = 3,
                 fn_idx_out: str | None = None, max_frag_len: int | None = None,
                 extra_flags: int | None = None, seq: str | None = None,
                 scoring=None, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to "
                                   "map on the host")
            derive_caps(self.device, 0)
        io, mo = O.set_preset(preset)
        mo.flag |= O.MM_F_CIGAR  # always perform alignment
        if k is not None:
            io.k = k
        if w is not None:
            io.w = w
        if min_cnt is not None:
            mo.min_cnt = min_cnt
        if min_chain_score is not None:
            mo.min_chain_score = min_chain_score
        if min_dp_score is not None:
            mo.min_dp_max = min_dp_score
        if bw is not None:
            mo.bw = bw
        if best_n is not None:
            mo.best_n = best_n
        if max_frag_len is not None:
            mo.max_frag_len = max_frag_len
        if extra_flags is not None:
            mo.flag |= extra_flags
        if scoring is not None and len(scoring) >= 4:
            mo.a, mo.b, mo.q, mo.e = scoring[:4]
            mo.q2, mo.e2 = mo.q, mo.e
            if len(scoring) >= 6:
                mo.q2, mo.e2 = scoring[4], scoring[5]
            if len(scoring) >= 7:
                mo.sc_ambi = scoring[6]
        self.idx_opt, self.map_opt = io, mo
        self._idx = None
        if seq is not None:
            self._idx = MinimizerIndex.from_strings([seq], io, names=["N/A"])
            O.mapopt_update(mo, self._idx)
            mo.mid_occ = 1000  # don't filter high-occ seeds
        elif fn_idx_in is not None:
            if fn_idx_in.endswith(".npz"):
                self._idx = MinimizerIndex.load(fn_idx_in)
            else:
                self._idx = MinimizerIndex.from_fasta(fn_idx_in, io)
                if fn_idx_out is not None:
                    self._idx.save(fn_idx_out)
            O.mapopt_update(mo, self._idx)

    def __bool__(self) -> bool:
        return self._idx is not None

    @property
    def index(self) -> MinimizerIndex:
        return self._idx

    @property
    def k(self) -> int:
        return self._idx.k

    @property
    def w(self) -> int:
        return self._idx.w

    @property
    def n_seq(self) -> int:
        return self._idx.n_seq

    @property
    def seq_names(self) -> list[str]:
        return list(self._idx.names)

    def seq(self, name: str, start: int = 0, end: int = 0x7FFFFFFF
            ) -> str | None:
        """Retrieve a (sub)sequence from the index (mappy.Aligner.seq)."""
        if name not in self._idx.names:
            return None
        rid = self._idx.names.index(name)
        ln = int(self._idx.lens[rid])
        if start >= ln or start < 0:
            return None
        end = min(end, ln)
        codes = self._idx.get_seq(rid, start, end)
        return "".join("ACGTN"[c] for c in codes)

    def _map_device(self, seq: str, opt: O.MapOptions,
                    device: torch.device) -> list:
        """The regions of one unnamed read through the port's device
        pipeline on `device` (a card, or the CPU's plain twins of its
        kernels): the chain kernel, then the gap fills where --gpu-align
        puts them."""
        opt = copy.copy(opt)
        opt.flag |= O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN
        with _ROUTE_LOCK.held(sole=True):
            [(_sr, regs)] = map_batch_gpu(self._idx, opt,
                                          [SeqRecord(0, None, seq)], device)
        return regs

    def map(self, seq: str, seq2: str | None = None, buf=None,
            cs: bool = False, MD: bool = False,
            max_frag_len: int | None = None, extra_flags: int | None = None):
        """Yield Alignment objects for one read or read pair
        (mm_map_aux semantics, python/cmappy.h:74-106)."""
        if self._idx is None:
            return
        opt = self.map_opt
        if max_frag_len is not None or extra_flags is not None:
            opt = copy.copy(opt)
            if max_frag_len is not None:
                opt.max_frag_len = max_frag_len
            if extra_flags is not None:
                opt.flag |= extra_flags

        if seq2 is None and self.device.type == "cuda":
            seg_regs = [self._map_device(seq, opt, self.device)]
            seqs = [seq]
        elif seq2 is None:
            with _ROUTE_LOCK.held(sole=False):
                res = map_frag(self._idx, opt, [seq], None)
            seg_regs = [res.seg_regs[0]]
            seqs = [seq]
        else:
            seqs = [seq, revcomp(seq2)]
            with _ROUTE_LOCK.held(sole=False):
                res = map_frag(self._idx, opt, seqs, None)
            seg_regs = res.seg_regs
            # flip the second end back to its original strand
            for r in seg_regs[1]:
                ql = len(seq2)
                r.qs, r.qe = ql - r.qe, ql - r.qs
                r.rev = not r.rev

        for si, regs in enumerate(seg_regs):
            qs_str = seqs[0] if si == 0 else seq2
            for r in regs:
                if r.p is None:
                    continue
                cs_str = md_str = ""
                if cs:
                    cs_str = write_cs_or_md(self._idx, qs_str, r, True,
                                            False, False, False)
                if MD:
                    md_str = write_cs_or_md(self._idx, qs_str, r, True,
                                            True, False, False)
                yield Alignment(
                    ctg=self._idx.names[r.rid],
                    ctg_len=int(self._idx.lens[r.rid]),
                    r_st=r.rs, r_en=r.re,
                    strand=-1 if r.rev else 1,
                    q_st=r.qs, q_en=r.qe, mapq=r.mapq,
                    cigar=[[int(c) >> 4, int(c) & 0xF] for c in r.p.cigar],
                    is_primary=(r.id == r.parent),
                    mlen=r.mlen, blen=r.blen,
                    NM=r.blen - r.mlen + r.p.n_ambi,
                    trans_strand=(1 if r.p.trans_strand == 1
                                  else -1 if r.p.trans_strand == 2 else 0),
                    read_num=si + 1, cs=cs_str, MD=md_str)
