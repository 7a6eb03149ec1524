"""The plain reference that decides `correct`.

It maps each sampled read again on the host, in NumPy, from the genome
and the reads the benchmark made, with the frozen copies of the port's
host modules in `mm/` (minimap2 v2.24's semantics at the options the
configuration gives) and its own index (refindex.py), and returns for
each read:

- the anchors seeding makes (mm_collect_matches and the anchor sort);
- its chains over them: where the configuration chains by the DP, the
  DP's scores and predecessors at its max_chain_skip (lchain.c:169-207,
  as the card's chain kernel computes them at max_skip = infinity);
  where it chains by RMQ (MM_F_RMQ, the asm presets: the host chains
  them, no kernel runs), the chains (u, cx, cy) of the first RMQ
  chaining over the read's anchors, before the long-join rescue
  (mg_lchain_rmq, lchain.c:250-369), taken from the mapping below;
- the records minimap2 writes for it (PAF or SAM lines, as the
  configuration's flags say).

`fill` solves one recorded gap fill with the frozen ksw2.extd2.

Nothing here imports the program: the harness hands in the genome, the
reads and the configuration's argv, and reads the program's outputs
only to compare them.
"""

from __future__ import annotations

import io as _io
import os
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from bench_port.reference import refindex
from bench_port.reference.mm import chain as chain_mod
from bench_port.reference.mm import chain_rmq as rmq_mod
from bench_port.reference.mm import hit as hit_mod
from bench_port.reference.mm import ksw2
from bench_port.reference.mm import paf as paf_mod
from bench_port.reference.mm import mapper
from bench_port.reference.mm import opts as O
from bench_port.reference.mm import seed as seed_ops
from bench_port.reference.mm.fastx import SeqRecord
from bench_port.reference.mm.index import MinimizerIndex
from bench_port.reference.mm.paf import write_paf
from bench_port.reference.mm.sam import write_sam_record
from bench_port.reference.mm.sdust import dust_minier
from bench_port.reference.mm.sketch import sketch

INT32_MAX = 2**31 - 1
# argv words that choose the device or the host's threads: the
# reference maps on the host, one read at a time, whatever they say
_DEVICE_WORDS = ("--gpu-chain", "--gpu-align")


def options(argv: list[str]) -> tuple[O.IndexOptions, O.MapOptions]:
    """(index options, map options) of a configuration's argv: -x PRESET,
    then -a, -c, --cs, --max-chain-skip=N as main.c applies them; -t N
    and the device words are taken and ignored, any other word raises."""
    preset, flags, i = None, 0, 0
    mo_skip = None
    while i < len(argv):
        a = argv[i]
        if a == "-x":
            preset, i = argv[i + 1], i + 2
            continue
        if a == "-t":
            i += 2
            continue
        if a == "-a":
            flags |= O.MM_F_CIGAR | O.MM_F_OUT_SAM
        elif a == "-c":
            flags |= O.MM_F_CIGAR | O.MM_F_OUT_CG
        elif a == "--cs":
            flags |= O.MM_F_OUT_CS | O.MM_F_CIGAR
        elif a.startswith("--max-chain-skip="):
            mo_skip = int(a.split("=", 1)[1])
        elif a not in _DEVICE_WORDS:
            raise ValueError(f"the reference does not take {a!r}")
        i += 1
    io, mo = O.set_preset(preset)
    mo.flag |= flags
    if mo_skip is not None:
        mo.max_chain_skip = mo_skip
    return io, mo


def chain_penalties(index: MinimizerIndex, mo: O.MapOptions):
    """(chn_pen_gap, chn_pen_skip) as mm_mapopt_update derives them
    (the port's models/pipeline._chain_penalties at the frozen commit)."""
    return (np.float32(float(np.float32(mo.chain_gap_scale)) * 0.01
                       * index.k),
            np.float32(float(np.float32(mo.chain_skip_scale)) * 0.01
                       * index.k))


def records(index, mo, rec: SeqRecord, regs, rep_len: int) -> str:
    """The read's lines, as the port's cli.res_regs_out writes them at
    the frozen commit (one segment, no read group)."""
    out = _io.StringIO()
    is_sam = bool(mo.flag & O.MM_F_OUT_SAM)
    if regs:
        for j, r in enumerate(regs):
            if (mo.flag & O.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                continue
            if is_sam:
                out.write(write_sam_record(index, rec, j, regs, mo.flag,
                                           rep_len, None, 0, 1, [regs])
                          + "\n")
            else:
                out.write(write_paf(r, rec.name, rec.length, index, mo.flag,
                                    rep_len, rec.comment, rec.seq) + "\n")
    elif is_sam and not (mo.flag & O.MM_F_SAM_HIT_ONLY):
        out.write(write_sam_record(index, rec, -1, regs, mo.flag, rep_len,
                                   None, 0, 1, [regs]) + "\n")
    elif mo.flag & O.MM_F_PAF_NO_HIT:
        out.write(write_paf(None, rec.name, rec.length, index, mo.flag,
                            rep_len) + "\n")
    return out.getvalue()


def map_read(index: MinimizerIndex, mo: O.MapOptions, name: str, seq: str
             ) -> dict:
    """{"ax", "ay", "lines"} of one read, with "f", "p" (the DP's) or,
    under MM_F_RMQ, "u", "cx", "cy" (the RMQ chains'), and "seconds":
    the time of the chaining and of the whole mapping."""
    mm = sketch(seq, index.w, index.k, 0, bool(index.flag & O.MM_I_HPC))
    if mo.sdust_thres > 0:
        mm = dust_minier(mm, seq, mo.sdust_thres)
    if mo.q_occ_frac > 0.0:
        mm = seed_ops.seed_mz_flt(mm, mo.mid_occ, mo.q_occ_frac)
    collect = (seed_ops.collect_seed_hits_heap
               if mo.flag & O.MM_F_HEAP_SORT else seed_ops.collect_seed_hits)
    ax, ay, _rep, _pos = collect(index, mo, mo.mid_occ, mm, len(seq), name)
    out = dict(ax=ax, ay=ay)
    t0 = time.perf_counter()
    if mo.flag & O.MM_F_RMQ:
        res, t_chain = _map_recording_rmq(index, mo, seq, name, out)
    else:
        gap_q, gap_r = mapper._chain_gaps(mo, 0)
        cg, cs = chain_penalties(index, mo)
        f, p = chain_mod._chain_dp_scores(
            ax, ay, max(gap_r, mo.bw), max(gap_q, mo.bw), mo.bw,
            mo.max_chain_skip, mo.max_chain_iter, cg, cs,
            bool(mo.flag & O.MM_F_SPLICE), 1)
        out.update(f=np.asarray(f, np.int32), p=np.asarray(p, np.int64))
        t_chain = time.perf_counter() - t0
        res = mapper.map_frag(index, mo, [seq], name)
    out["seconds"] = dict(chain=t_chain, all=time.perf_counter() - t0)
    out["lines"] = records(index, mo, SeqRecord(0, name, seq), res.regs,
                           res.rep_len)
    return out


def _map_recording_rmq(index, mo, seq: str, name: str, out: dict):
    """map_frag of one read, with out's "u", "cx", "cy" set from its
    first chain_rmq call: mapper.chain_anchors' chaining of the read's
    own anchors with mapper.py:101-105's arguments, before the long-join
    rescue calls it again.  Returns (map_frag's result, the seconds of
    its chain_rmq calls)."""
    chain = rmq_mod.chain_rmq
    took = []

    def first(*a):
        t = time.perf_counter()
        got = chain(*a)
        if not took:
            out.update(u=got[0], cx=got[1], cy=got[2])
        took.append(time.perf_counter() - t)
        return got
    rmq_mod.chain_rmq = first
    try:
        res = mapper.map_frag(index, mo, [seq], name)
    finally:
        rmq_mod.chain_rmq = chain
    if not took:   # map_frag returned before chaining (an empty read)
        out.update(u=_EMPTY, cx=_EMPTY, cy=_EMPTY)
    return res, sum(took)


_EMPTY = np.empty(0, np.uint64)


def fill(mo: O.MapOptions, q: np.ndarray, t: np.ndarray, w: int, zdrop: int,
         flag: int) -> tuple[int, np.ndarray]:
    """(score, CIGAR words) of one gap fill (mm_align_pair's extd2 call
    for a fill between anchors, align.c:744-758: end bonus -1)."""
    mat = ksw2.gen_simple_mat(5, mo.a, mo.b, mo.sc_ambi)
    ez = ksw2.extd2(q, t, mat, mo.q, mo.e, mo.q2, mo.e2, int(w), int(zdrop),
                    -1, int(flag))
    return int(ez.score), np.asarray(ez.cigar, np.uint32)


# ------------------------------------------------------------- the control

_SC32 = chain_mod.comput_sc_vec


def bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    held in float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + (((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _gap_cost32(dd, dg, cg, cs):
    """comput_sc_vec's single-segment gap cost, cg * dd + cs * dg +
    mg_log2(dd + 1) / 2 in float32, truncated to int32."""
    f = np.float32
    lin = (cg * dd.astype(f) + cs * dg.astype(f)).astype(f)
    lg = np.where(dd >= 1, chain_mod.mg_log2((dd + 1).astype(f)), f(0))
    return (lin + f(0.5) * lg.astype(f)).astype(f).astype(np.int32)


def _gap_cost_bf16(dd, dg, cg, cs):
    """The same cost with every operand and every result in bfloat16."""
    f = np.float32
    lin = bf16(bf16(bf16(cg) * bf16(dd.astype(f)))
               + bf16(bf16(cs) * bf16(dg.astype(f))))
    lg = np.where(dd >= 1, bf16(chain_mod.mg_log2(bf16((dd + 1).astype(f)))),
                  f(0))
    return bf16(lin + bf16(f(0.5) * lg)).astype(np.int32)


def comput_sc_bf16(axi, ayi, axj, ayj, max_dist_x, max_dist_y, bw, cg, cs,
                   is_cdna, n_seg):
    """The control's chain score: the frozen comput_sc_vec with its gap
    cost in bfloat16 instead of float32, the precision below the one
    minimap2 and the chain kernel compute it in."""
    sc = _SC32(axi, ayi, axj, ayj, max_dist_x, max_dist_y, bw, cg, cs,
               is_cdna, n_seg)
    if is_cdna or n_seg > 1:
        return sc
    dq = (np.int64(np.uint64(ayi) & np.uint64(0xFFFFFFFF)).astype(np.int32)
          - (ayj & np.uint64(0xFFFFFFFF)).astype(np.int32))
    with np.errstate(over="ignore"):
        dr = (np.uint64(axi) - axj).astype(np.uint32).astype(np.int32)
    dd = np.abs(dr - dq)
    dg = np.minimum(dr, dq)
    q_span = ((ayj >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    need = ((dd != 0) | (dg > q_span)) & (sc != np.int32(chain_mod.INT32_MIN))
    with np.errstate(over="ignore", invalid="ignore"):
        adj = _gap_cost32(dd, dg, cg, cs) - _gap_cost_bf16(dd, dg, cg, cs)
    return np.where(need, sc + adj, sc).astype(np.int32)


_SC_RMQ32 = rmq_mod._sc_simple


def sc_simple_bf16(axi: int, ayi: int, axj: int, ayj: int, cg, cs):
    """The control's RMQ chain score: the frozen _sc_simple
    (comput_sc_simple, lchain.c:230-248) with its gap cost, cg * dd +
    cs * dg + mg_log2(dd + 1) / 2, computed as _gap_cost_bf16 computes
    the DP's, in bfloat16 instead of float32."""
    sc, exact, dd = _SC_RMQ32(axi, ayi, axj, ayj, cg, cs)
    dq = ((ayi & 0xFFFFFFFF) - (ayj & 0xFFFFFFFF) + 2**31) % 2**32 - 2**31
    dr = ((axi - axj) + 2**31) % 2**32 - 2**31
    q_span = (ayj >> 32) & 0xFF
    dg = min(dr, dq)
    if dd or dq > q_span:
        # the frozen cost is what it took off the gap-free score
        cost = min(q_span, dg) - sc
        with np.errstate(over="ignore", invalid="ignore"):
            low = _gap_cost_bf16(np.array([dd]), np.array([dg]), cg, cs)
        sc += cost - int(low[0])
    return sc, exact, dd


_BT_RMQ32 = rmq_mod.chain_backtrack


def chain_backtrack_i16(f, p, min_cnt, min_sc, max_drop):
    """The frozen chain_backtrack as the RMQ chaining calls it, over the
    chain scores held in int16 (wrapping as a cast to int16 does) where
    minimap2 holds them in int32."""
    return _BT_RMQ32(f.astype(np.int16).astype(np.int32), p, min_cnt,
                     min_sc, max_drop)


_DP32 = chain_mod._chain_dp_scores


def chain_dp_scores_i16(ax, ay, max_dist_x, max_dist_y, bw, max_skip,
                        max_iter, chn_pen_gap, chn_pen_skip, is_cdna, n_seg):
    """The frozen _chain_dp_scores (its max_skip = infinity branch) with
    the chain scores held in int16, wrapping as int16 arithmetic does,
    where minimap2 and the chain kernel hold them in int32."""
    if max_skip < INT32_MAX:
        raise ValueError("the int16 control takes max_skip = infinity")
    n = ax.shape[0]
    cg, cs = np.float32(chn_pen_gap), np.float32(chn_pen_skip)
    f = np.zeros(n, dtype=np.int16)
    p = np.full(n, -1, dtype=np.int64)
    hi_bits = ax & np.uint64(0xFFFFFFFF00000000)
    sub = np.where(ax >= np.uint64(max_dist_x), ax - np.uint64(max_dist_x),
                   np.uint64(0))
    st_all = np.searchsorted(ax, np.maximum(hi_bits, sub), side="left")
    q_span_all = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    i16 = chain_mod.INT32_MIN

    def wrap(x):
        return int(np.array(x, np.int64).astype(np.int16))
    max_ii = -1
    for i in range(n):
        st = int(st_all[i])
        if i - st > max_iter:
            st = i - max_iter
        max_f, max_j, end_j = int(q_span_all[i]), -1, st - 1
        if st < i:
            sc = chain_mod.comput_sc_vec(ax[i], ay[i], ax[st:i], ay[st:i],
                                         max_dist_x, max_dist_y, bw, cg, cs,
                                         is_cdna, n_seg)
            valid = sc != i16
            tot = np.where(valid, (sc.astype(np.int64) + f[st:i])
                           .astype(np.int16).astype(np.int64), i16)
            best = int(tot.max(initial=i16))
            if best > max_f:
                max_f = best
                max_j = st + int(np.nonzero(tot == best)[0][-1])
        if max_ii < 0 or int(ax[i] - ax[max_ii]) > max_dist_x:
            max_ii = -1
            if st < i:
                fw = f[st:i]
                best_f = int(fw.max(initial=-(2**15)))
                max_ii = st + int(np.nonzero(fw == best_f)[0][-1])
        if 0 <= max_ii < end_j:
            tmp = int(chain_mod.comput_sc_vec(
                ax[i], ay[i], ax[max_ii:max_ii + 1], ay[max_ii:max_ii + 1],
                max_dist_x, max_dist_y, bw, cg, cs, is_cdna, n_seg)[0])
            if tmp != i16 and max_f < wrap(tmp + int(f[max_ii])):
                max_f = wrap(tmp + int(f[max_ii]))
                max_j = max_ii
        f[i] = wrap(max_f)
        p[i] = max_j
        if max_ii < 0 or (int(ax[i] - ax[max_ii]) <= max_dist_x
                          and f[max_ii] < f[i]):
            max_ii = i
    return f.astype(np.int32), p


_EST_ERR = hit_mod.est_err
_IDENTITY = paf_mod._event_identity


def est_err_bf16(index, qlen, regs, ax, ay, mini_pos):
    """esterr.c's divergence (dv) rounded to bfloat16."""
    _EST_ERR(index, qlen, regs, ax, ay, mini_pos)
    for r in regs:
        if r.div > 0:
            r.div = float(bf16(np.float32(r.div)))


def event_identity_bf16(r):
    """align.c's event identity (1 - de) rounded to bfloat16."""
    x = _IDENTITY(r)
    return float(bf16(np.float32(x))) if np.isfinite(x) else x


def use_control(kind: str | None) -> None:
    """Put the reference in the control's place, or back (None).  The
    control "lower" computes in the precision below the one minimap2 and
    the port compute in: the chain scores in int16 where they are int32
    (the DP's through its recursion, RMQ's as its backtrack reads them),
    and the chain gap cost (the DP's and RMQ's) and the divergence
    estimates dv and de in bfloat16 where they are float32."""
    on = kind == "lower"
    if kind not in (None, "lower"):
        raise ValueError(f"no control {kind!r}")
    chain_mod.comput_sc_vec = comput_sc_bf16 if on else _SC32
    rmq_mod._sc_simple = sc_simple_bf16 if on else _SC_RMQ32
    rmq_mod.chain_backtrack = chain_backtrack_i16 if on else _BT_RMQ32
    chain_mod._chain_dp_scores = chain_dp_scores_i16 if on else _DP32
    hit_mod.est_err = est_err_bf16 if on else _EST_ERR
    paf_mod._event_identity = event_identity_bf16 if on else _IDENTITY


# ---------------------------------------------------------------- the pool

_W = {}


def _init(arrays: dict, k: int, w: int, flag: int, names: list, argv: list,
          control=None) -> None:
    index = MinimizerIndex(k, w, flag, names, arrays["lens"],
                           arrays["offsets"], arrays["seq_codes"],
                           arrays["occ_hash"], arrays["occ_pos"])
    io, mo = options(argv)
    O.mapopt_update(mo, index)
    use_control(control)
    _W.update(index=index, mo=mo)


def _map(name: str, seq: str) -> tuple[str, dict]:
    return name, map_read(_W["index"], _W["mo"], name, seq)


def index_and_options(chroms, argv):
    """(the reference's index of chroms, its map options)."""
    io, mo = options(argv)
    index = refindex.build(chroms, io)
    O.mapopt_update(mo, index)
    return index, mo


def map_reads(index: MinimizerIndex, argv: list[str], reads: list,
              workers: int | None = None, control: str | None = None
              ) -> dict:
    """{name: map_read(...)} of reads [(name, seq)], in `workers`
    processes (spawned, the index handed to each), longest first;
    `control` names the control (use_control) to map with instead."""
    workers = max(1, min(workers or os.cpu_count() or 1, len(reads)))
    reads = sorted(reads, key=lambda r: -len(r[1]))
    arrays = dict(lens=index.lens, offsets=index.offsets,
                  seq_codes=index.seq_codes, occ_hash=index.occ_hash,
                  occ_pos=index.occ_pos)
    init = (arrays, index.k, index.w, index.flag, index.names, argv, control)
    if workers == 1:
        try:
            _init(*init)
            return dict(_map(n, s) for n, s in reads)
        finally:
            use_control(None)
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn"),
                             initializer=_init, initargs=init) as ex:
        futs = [ex.submit(_map, n, s) for n, s in reads]
        return dict(fu.result() for fu in futs)
