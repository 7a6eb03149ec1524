#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (mm2_gb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
a CUDA build of PyTorch.  Phases (any failure exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   mm2_gb_tpu_torch/csrc (into build/kernels);
2. the chain kernel against its plain PyTorch twin on the card and
   against the port's host oracle (`chain_scores_host`, the reference DP
   at max_skip = inf), exact (tolerance 0: all outputs are integers), on
   small, dense, multi-segment, repeat, wide-window and is_cdna
   workloads; the kernel's mg_log2 against the twin's bit for bit; the
   gap-fill kernels (extd2_fill, ksw2_backtrack) against their twins and
   against ksw2.extd2 (score and CIGAR, exact) on seeded fill workloads:
   five presets' penalties, RIGHT and REV_CIGAR on and off, N bases,
   indel-rich and unrelated pairs, bands from 16 to the whole matrix,
   the q/e swap, pairs to 5 kb, and the host routes (collapse, mat gate);
3. end to end through the CLI entry point, `--gpu-chain
   --max-chain-skip=2147483647`: byte-identical to the sim200 goldens
   (with and without --cs -c, and with --gpu-align for --cs -c and
   -x map-hifi -c); on a 600-read draw of the bench flowcell (the bench
   has 1200 reads; half, for the time limit) byte-identical to
   the host path (`python -m mm2_gb_tpu`, same -t, in a subprocess),
   with kernel launches > 0 and no batch chained on the host; then
   `--gpu-align -c` on the flowcell byte-identical to the host path's
   -c, with fill and backtrack launches > 0;
   Then the splice slice: the exts2 fill kernel and the backtrack's
   intron mode against their twins and ksw2_splice.exts2 on seeded
   splice workloads (every flag variant, BED junction bytes, a junction
   bonus that wraps int8, N bases, unrelated pairs, tlen to ~25 kb, the
   global-scratch ring, the mat gate); `--gpu-chain --gpu-align -x
   splice -c` byte-identical to the splice40 (with and without
   --junc-bed) and sim200 -G 8000 goldens; the 1000-read cDNA set at
   `-ax splice -t 8` identical to the host path, every fill on the
   device;
4. every kernel launch of those flowcell and cDNA runs, on the inputs it
   was given, against its twin, exact, and both timed (CUDA events).  A
   fill launch is re-run on its recorded operands and must reproduce the
   recorded direction bytes (by fingerprint) before the twins are held
   against it; the cDNA run's splice launches, and the splice
   workloads' launches under the same options, are held against one
   twin run over all of their fills.

The line before the last is a JSON object with each kernel's launches on
the main path, its error against the twin and both times; the last line
is {"ok": true, "device": {...}}.  Generated inputs and the kernel build
go under build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")
N_READS = 600       # bench flowcell: 4 Mbp reference, 10-100 kb reads
                    # (at half the bench's 1200 reads, for the time limit)
N_CDNA = 1000       # cDNA set: 10 Mbp reference, spliced reads
THREADS = 8
SKIP_INF = "--max-chain-skip=2147483647"
KERNEL_REPS = 3


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def phase1():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    from mm2_gb_tpu_torch.utils import kernels
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build {time.perf_counter() - t0:.2f} s "
        f"({kernels.BUILD_DIR})")


def synthetic_anchors(n, seed, step_hi=12, jitter=6):
    import numpy as np
    rng = np.random.default_rng(seed)
    rpos = np.cumsum(rng.integers(1, step_hi, n))
    qpos = rpos + rng.integers(-jitter, jitter + 1, n)
    qpos = np.maximum.accumulate(np.maximum(qpos, 1))
    return (rpos.astype(np.uint64),
            (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64))


def workloads():
    """Analogs of tests/test_chain_tpu.py:39-74, a window wider than the
    TPU kernel's largest (5120), and an is_cdna case."""
    import numpy as np
    cg = float(np.float32(float(np.float32(0.8)) * 0.01 * 15))
    base = dict(max_dist_x=5000, max_dist_y=5000, bw=500, max_iter=5000,
                cg=cg, cs=0.0, is_cdna=False)
    yield "small_segments", *synthetic_anchors(50, 0), base
    yield "medium_dense", *synthetic_anchors(500, 1, step_hi=6), base
    chunks, off = [], 0
    for s in range(5):
        ax, ay = synthetic_anchors(80, s + 2)
        chunks.append((ax + np.uint64(off), ay))
        off += int(ax[-1]) + 50000
    yield ("multi_segment_gaps", np.concatenate([c[0] for c in chunks]),
           np.concatenate([c[1] for c in chunks]), base)
    r = np.random.default_rng(7)
    rpos = (np.sort(r.integers(0, 3000, 900)).astype(np.uint64)
            + np.arange(900, dtype=np.uint64))
    qpos = (rpos + r.integers(-200, 200, 900).astype(np.int64)).clip(1)
    yield ("dense_repeat", rpos,
           (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64), base)
    yield ("wide_window", *synthetic_anchors(6000, 9, step_hi=2),
           dict(base, max_dist_x=50000, max_dist_y=50000, max_iter=40000))
    yield ("is_cdna", *synthetic_anchors(2000, 11, step_hi=40, jitter=300),
           dict(base, max_dist_y=2000, cs=float(np.float32(0.3)),
                is_cdna=True))


def kernel_operands(ax, ay, read_bounds, a, device):
    """Kernel operands of a batch, prepared as dispatch_scores does."""
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    mdx, mdy = max(a["max_dist_x"], a["bw"]), max(a["max_dist_y"], a["bw"])
    rng = G.compute_ranges(ax, read_bounds, mdx, a["max_iter"])
    starts, ends = G.segment_work(G.cut_segments(rng))

    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
    ops = (t(ax & np.uint64(0xFFFFFFFF)), t(ay & np.uint64(0xFFFFFFFF)),
           t(rng), t(starts), t(ends))
    kw = dict(span=int((ay[0] >> np.uint64(32)) & np.uint64(0xFF)),
              max_dist_x=mdx, max_dist_y=mdy, bw=a["bw"], cg=a["cg"],
              cs=a["cs"], is_cdna=a["is_cdna"])
    return ops, kw, int(rng.sum(dtype=np.int64))


def _max_err(a, b) -> int:
    """Largest |a - b| of two integer tensors (0 when empty or equal;
    2**31 when their shapes differ)."""
    import torch
    if a.shape != b.shape:
        return 2**31
    if a.numel() == 0 or torch.equal(a, b):
        return 0
    return int((a.long() - b.long()).abs().max().item())


def phase2():
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    dev = torch.device("cuda")
    err = 0
    for name, ax, ay, a in workloads():
        bounds = np.array([0, ax.shape[0]], np.int64)
        ops, kw, _ = kernel_operands(ax, ay, bounds, a, dev)
        fk, pk = G.chain_segments(*ops, **kw)
        ft, pt = G.chain_segments_torch(*ops, **kw)
        torch.cuda.synchronize()
        e = max(_max_err(fk, ft), _max_err(pk, pt))
        err = max(err, e)
        fd, pd = G.chain_scores_device(
            ax, ay, bounds, a["max_dist_x"], a["max_dist_y"], a["bw"],
            a["max_iter"], a["cg"], a["cs"], is_cdna=a["is_cdna"],
            device=dev)
        fo, po = G.chain_scores_host(
            ax, ay, a["max_dist_x"], a["max_dist_y"], a["bw"],
            a["max_iter"], a["cg"], a["cs"], a["is_cdna"])
        ok = np.array_equal(fd, fo) and np.array_equal(pd, po)
        log(f"chain {name}: n={ax.shape[0]} widest range "
            f"{int(ops[2].max())} kernel==twin max_abs_err={e} "
            f"kernel==oracle {ok}")
        if e or not ok:
            fail(f"chain workload {name} disagrees")

    dd = np.concatenate([np.arange(1, 4096),
                         np.random.default_rng(0).integers(1, 2**24, 5000)])
    x = torch.from_numpy((dd + 1).astype(np.float32))
    got = G.mg_log2_kernel(x.to(dev)).cpu()
    want = G.mg_log2_f32(x)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("mg_log2 kernel differs from the twin's bit pattern")
    log(f"mg_log2 kernel == twin on {x.shape[0]} values (dd to 2^24)")
    return err


FILL_PRESETS = (None, "map-hifi", "asm10", "asm5", "sr")
FILL_W = (-1, 16, 51, 200, 751, 30001)


def _pack_fills(pairs, ws):
    """(meta, qblob, tblob) of (q, t) pairs, as native.fill_fetch gives."""
    import numpy as np
    meta = np.array([[len(q), len(t), w, 400] for (q, t), w in zip(pairs, ws)],
                    np.int64).reshape(-1, 4)
    cat = (lambda xs: np.concatenate(xs).astype(np.uint8) if xs
           else np.empty(0, np.uint8))
    return meta, cat([q for q, _ in pairs]), cat([t for _, t in pairs])


def fill_pairs(rng, n, min_len, max_len):
    """Seeded gap-fill pairs of min_len..max_len bp: related pairs
    (substitution- and indel-rich, some N bases), unrelated pairs and
    band-collapse shapes (very unequal lengths under narrow bands)."""
    import numpy as np

    def mutate(t, sub, indel, n_rate):
        out, k = [], 0
        while k < len(t):
            u = rng.random()
            if u < indel / 2:
                k += int(rng.integers(1, 6))              # deletion
            elif u < indel:
                out.extend(rng.integers(0, 4, int(rng.integers(1, 6))))
            else:
                out.append(int(rng.integers(0, 4)) if rng.random() < sub
                           else int(t[k]))
                k += 1
        q = np.array(out, np.uint8)
        q[rng.random(q.shape[0]) < n_rate] = 4
        return q

    pairs, ws = [], []
    for k in range(n):
        kind = k % 6
        L = int(rng.integers(min_len, max_len + 1))
        t = rng.integers(0, 4, L).astype(np.uint8)
        if kind == 0:
            q = mutate(t, 0.05, 0.02, 0.0)
        elif kind == 1:                                   # indel-rich
            q = mutate(t, 0.03, 0.15, 0.0)
        elif kind == 2:                                   # N bases
            q = mutate(t, 0.05, 0.03, 0.05)
            t[rng.random(L) < 0.03] = 4
        elif kind == 3:                                   # unrelated
            q = rng.integers(0, 4, int(rng.integers(min_len, max_len + 1))
                             ).astype(np.uint8)
        elif kind == 4:                                   # collapse shape
            q = t[:max(1, L // 8)].copy()
        else:
            q = mutate(t, 0.1, 0.05, 0.01)
        if q.shape[0] == 0:
            q = np.zeros(1, np.uint8)
        pairs.append((q, t))
        ws.append(int(FILL_W[k % len(FILL_W)]) if kind != 4
                  else int(rng.integers(0, 17)))
    return pairs, ws


def fill_workloads(n_pairs=96, max_len=600, long_len=5000):
    """(name, meta, qblob, tblob, params, flag) of the fill checks: pairs
    of 1..max_len bp under the penalties of five presets, each with RIGHT
    and REV_CIGAR on and off; the q/e swap case (q+e > q2+e2); pairs of
    max_len..long_len bp (state in global scratch past ~4.5 kb); a matrix
    that fails the mat gate."""
    import numpy as np
    from mm2_gb_tpu.ops import ksw2
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    rng = np.random.default_rng(2718)
    am, right, rev = (ksw2.KSW_EZ_APPROX_MAX, ksw2.KSW_EZ_RIGHT,
                      ksw2.KSW_EZ_REV_CIGAR)
    for preset in FILL_PRESETS:
        _io, mo = O.set_preset(preset)
        prm = K.fill_params(mo)
        for flag in (am, am | right, am | rev, am | right | rev):
            pairs, ws = fill_pairs(rng, n_pairs, 1, max_len)
            yield (f"{preset or 'map-ont'}/{flag:#x}",
                   *_pack_fills(pairs, ws), prm, flag)
    mat = ksw2.gen_simple_mat(5, 2, 4, 1)
    for flag in (am, am | right):
        pairs, ws = fill_pairs(rng, n_pairs, 1, max_len)
        yield (f"qe_swap/{flag:#x}", *_pack_fills(pairs, ws),
               K.fill_params_from(mat, 24, 1, 4, 2), flag)
    _io, mo = O.set_preset(None)
    pairs, ws = fill_pairs(rng, 12, max_len, long_len)
    t = rng.integers(0, 4, long_len).astype(np.uint8)
    q = t.copy()
    q[rng.random(long_len) < 0.05] = 1
    pairs.append((q, t))
    ws.append(-1)
    yield "long", *_pack_fills(pairs, ws), K.fill_params(mo), am
    pairs, ws = fill_pairs(rng, max(8, n_pairs // 8), 1, max_len)
    yield ("mat_gate", *_pack_fills(pairs, ws),
           K.fill_params_from(ksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1),
           am)


def fill_oracle(meta, qblob, tblob, prm, flag):
    """ksw2.extd2 of every fill: (scores, cig_off, cig_blob)."""
    import numpy as np
    from mm2_gb_tpu.ops import ksw2
    n = meta.shape[0]
    qo = np.concatenate([[0], np.cumsum(meta[:, 0])])
    to = np.concatenate([[0], np.cumsum(meta[:, 1])])
    scores, cigs = np.zeros(n, np.int32), []
    for k in range(n):
        ez = ksw2.extd2(qblob[qo[k]:qo[k + 1]], tblob[to[k]:to[k + 1]],
                        prm.mat, prm.q, prm.e, prm.q2, prm.e2,
                        int(meta[k, 2]), -1, 0, flag)
        scores[k] = ez.score
        cigs.append(ez.cigar)
    off = np.concatenate([[0], np.cumsum([c.shape[0] for c in cigs])])
    return scores, off, (np.concatenate(cigs).astype(np.uint32) if cigs
                         else np.empty(0, np.uint32))


def fill_result_err(got, want) -> int:
    """Largest difference between two (scores, cig_off, cig_blob): score
    and word differences, or 2**31 when the CIGAR lengths differ."""
    import numpy as np
    if (got[0].shape != want[0].shape
            or not np.array_equal(got[1], want[1])):
        return 2**31
    e = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))
    w = np.abs(got[2].astype(np.int64) - want[2].astype(np.int64))
    return int(max(e.max(initial=0), w.max(initial=0)))


@contextlib.contextmanager
def recording_fills():
    """Record every extd2_fill and ksw2_backtrack call made inside (the
    wrappers still count their launches): a list of [fill args, score,
    fingerprint of p, backtrack args without p, cig, n_cig].  A flowcell
    run's direction bytes (about 0.5 GB a launch) are not kept."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    calls, fill, bt = [], K.extd2_fill, K.ksw2_backtrack

    def rec_fill(*a):
        sc, p = fill(*a)
        calls.append([a, sc, _fingerprint(p)])
        return sc, p

    def rec_bt(*a):
        cig, nc = bt(*a)
        calls[-1] += [a[1:], cig, nc]
        return cig, nc
    K.extd2_fill, K.ksw2_backtrack = rec_fill, rec_bt
    try:
        yield calls
    finally:
        K.extd2_fill, K.ksw2_backtrack = fill, bt


def _fingerprint(p):
    """Two sums over a direction-byte buffer (int64 and int32 views)."""
    import torch
    n8 = p.shape[0] // 8 * 8
    return (int(p[:n8].view(torch.int64).sum()),
            int(p[:p.shape[0] // 4 * 4].view(torch.int32).sum()),
            int(p[n8:].sum()))


def _timed(fn, *args):
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def hold_fill_calls(calls, label, verbose=True):
    """Each recorded fill + backtrack launch against the twins on its own
    inputs: the fill kernel is run again on the recorded operands (its p
    must match the recorded fingerprint), the fill twin must equal it,
    and both backtracks on that p must equal the recorded words.
    Returns (max_abs_err, fill ms, fill twin ms, backtrack ms, twin ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    err, fms, fpl, bms, bpl = 0, 0.0, 0.0, 0.0, 0.0
    for i, (fa, sc, fp, ba, cig, nc) in enumerate(calls):
        (sck, pk), tk = _timed(K.extd2_fill, *fa)
        same_p = _fingerprint(pk) == fp
        (sct, pt), tt = _timed(K.extd2_fill_torch, *fa)
        e = max(_max_err(sck, sc), _max_err(sct, sc), _max_err(pt, pk),
                0 if same_p else 2**31)
        (cgk, nck), tb = _timed(K.ksw2_backtrack, pk, *ba)
        (cgt, nct), tbt = _timed(K.ksw2_backtrack_torch, pk, *ba)
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc), _max_err(cgt, cig),
                _max_err(nct, nc))
        if verbose:
            log(f"{label} launch {i}: {fa[4].shape[0]} fills, "
                f"{int((fa[4].long() * fa[5].long()).sum())} cells; fill "
                f"{tk:.3f} ms (twin {tt:.3f} ms), backtrack {tb:.3f} ms "
                f"(twin {tbt:.3f} ms); max_abs_err {e}")
        err = max(err, e)
        fms, fpl, bms, bpl = fms + tk, fpl + tt, bms + tb, bpl + tbt
    return err, fms, fpl, bms, bpl


def phase2_fills():
    """The fill and backtrack kernels against their twins and ksw2.extd2
    (the native kit here) on the fill workloads; exact."""
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    dev = torch.device("cuda")
    err = 0
    for name, meta, qb, tb, prm, flag in fill_workloads():
        st = K.FillStats()
        with recording_fills() as calls:
            got = K.extd2_fill_batch(meta, qb, tb, prm, dev, flag, st)
        e_or = fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag))
        e_tw = hold_fill_calls(calls, name, verbose=False)[0]
        log(f"fill {name}: {st.fills} fills ({st.host_fills} host-routed), "
            f"{len(calls)} launches; kernel==twin max_abs_err={e_tw}, "
            f"batch==ksw2.extd2 max_abs_err={e_or}")
        if e_or or e_tw:
            fail(f"fill workload {name} disagrees")
        if name == "mat_gate" and st.host_fills != st.fills:
            fail("the mat gate did not route every fill to the host")
        if name != "mat_gate" and not (0 < st.host_fills < st.fills):
            fail(f"fill workload {name}: no collapse case on the host")
        err = max(err, e_tw)
    return err


# the splice flag variants of tests/test_ksw2_tpu.py:204-210, RIGHT with
# REV_CIGAR, the splice preset's own set and no splice bits at all
SPLICE_VARIANTS = (0x100, 0x100 | 0x400, 0x100 | 0x02, 0x100 | 0x200 | 0x400,
                   0x100 | 0x80, 0x100 | 0x02 | 0x80,
                   0x100 | 0x200 | 0x400 | 0x02 | 0x80, 0)


def _mutate_splice(rng, s, sub, indel):
    """s with substitutions and 1-bp indels at the given rates."""
    import numpy as np
    u = rng.random(s.shape[0])
    out = np.where(u < sub, rng.integers(0, 4, s.shape[0]), s).astype(np.uint8)
    keep = (u < sub) | (u >= sub + indel / 2)
    ins = (u >= sub + indel / 2) & (u < sub + indel)
    rep = keep.astype(np.int64) + ins
    out = np.repeat(out, rep)
    ends = np.cumsum(rep)[ins] - 1       # the inserted copy: a new base
    out[ends] = rng.integers(0, 4, ends.shape[0])
    return out if out.shape[0] else np.zeros(1, np.uint8)


def splice_pairs(rng, n, max_intron, min_intron=60, max_exons=3):
    """Seeded splice gap fills (q, t, flag, junc): a query of 1-3 exons
    against a target with introns (log-uniform min_intron..max_intron,
    GT..AG, or GA..TG under KSW_EZ_REV_CIGAR) between them.  Fill k takes
    flag variant k % 8 and kind (k // 8) % 6: spliced; with N bases;
    an unrelated query; a leading target stretch (a long tail deletion,
    which the backtrack turns into N); indel-rich; one exon, no intron.
    Odd fills carry random BED junction bytes."""
    import numpy as np
    out = []
    for k in range(n):
        flag = 0x08 | SPLICE_VARIANTS[k % len(SPLICE_VARIANTS)]
        kind = (k // len(SPLICE_VARIANTS)) % 6
        rc = bool(flag & 0x80)
        exons = [rng.integers(0, 4, int(rng.integers(20, 300)))
                 .astype(np.uint8)
                 for _ in range(1 if kind == 5 else
                                int(rng.integers(1, max_exons + 1)))]
        parts = []
        for i, ex in enumerate(exons):
            parts.append(ex)
            if i + 1 < len(exons):
                ln = int(np.exp(rng.uniform(np.log(min_intron),
                                            np.log(max_intron))))
                intr = rng.integers(0, 4, max(ln, 4)).astype(np.uint8)
                intr[:2] = (2, 0) if rc else (2, 3)
                intr[-2:] = (3, 2) if rc else (0, 2)
                parts.append(intr)
        if kind == 3:
            parts.insert(0, rng.integers(0, 4, int(rng.integers(20, 400)))
                         .astype(np.uint8))
        t = np.concatenate(parts)
        q = np.concatenate(exons)
        if kind == 2:
            q = rng.integers(0, 4, q.shape[0]).astype(np.uint8)
        else:
            q = _mutate_splice(rng, q, 0.03 if kind == 4 else 0.05,
                               0.08 if kind == 4 else 0.01)
        if kind == 1:
            q[rng.random(q.shape[0]) < 0.03] = 4
            t[rng.random(t.shape[0]) < 0.03] = 4
        junc = (rng.integers(0, 16, t.shape[0]).astype(np.uint8) if k % 2
                else None)
        out.append((q, t, flag, junc))
    return out


def _pack_splice(fills):
    """(meta, qblob, tblob, jblob, flags) of (q, t, flag, junc) fills, as
    the pipeline's splice collect pass packs them."""
    import numpy as np
    cat = (lambda xs: np.concatenate(xs).astype(np.uint8) if xs
           else np.empty(0, np.uint8))
    meta = np.array([[len(q), len(t), 0 if j is None else len(j)]
                     for q, t, _f, j in fills], np.int64).reshape(-1, 3)
    return (meta, cat([q for q, _t, _f, _j in fills]),
            cat([t for _q, t, _f, _j in fills]),
            cat([j for _q, _t, _f, j in fills if j is not None]),
            np.array([f for _q, _t, f, _j in fills], np.int64))


def splice_workloads(n_pairs=48, max_intron=2000, long_intron=24_000,
                     n_long=6):
    """(name, meta, qblob, tblob, jblob, flags, params) of the splice fill
    checks: every flag variant and fill kind under the splice and
    splice:hq presets; a junction bonus of 130, which wraps int8; an odd
    non-canonical cost (C-truncated flank score), with a ~2.5 kb query
    (its state ring in global scratch); fills with introns of
    long_intron / 5 to long_intron and one of long_intron (tlen ~25 kb
    at the default); a matrix that fails the mat gate."""
    import numpy as np
    from mm2_gb_tpu.ops import ksw2
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    rng = np.random.default_rng(31337)
    _io, mo = O.set_preset("splice")
    prm = KS.splice_params(mo)
    yield "splice", *_pack_splice(splice_pairs(rng, n_pairs, max_intron)), prm
    # the other options' workloads check scoring, not length
    _io, hq = O.set_preset("splice:hq")
    yield ("splice:hq", *_pack_splice(splice_pairs(rng, n_pairs,
                                                   max_intron // 2)),
           KS.splice_params(hq))
    mat = ksw2.gen_simple_mat(5, mo.a, mo.b, mo.sc_ambi)
    yield ("junc_wrap", *_pack_splice(splice_pairs(rng, n_pairs // 2,
                                                   max_intron // 2)),
           KS.splice_params_from(mat, 2, 1, 32, 9, 130))
    fills = splice_pairs(rng, n_pairs // 2, max_intron // 2)
    t = rng.integers(0, 4, 2600).astype(np.uint8)
    fills.append((_mutate_splice(rng, t[40:], 0.05, 0.01), t, 0x08 | 0x100,
                  None))
    yield ("noncan_odd", *_pack_splice(fills),
           KS.splice_params_from(mat, 2, 1, 32, 15, 9))
    fills = splice_pairs(rng, n_long, long_intron, long_intron // 5, 2)
    ex = rng.integers(0, 4, (2, 250)).astype(np.uint8)
    intron = rng.integers(0, 4, long_intron).astype(np.uint8)
    intron[:2], intron[-2:] = (2, 3), (0, 2)
    t = np.concatenate([ex[0], intron, ex[1]])   # the longest tlen
    fills.append((_mutate_splice(rng, ex.reshape(-1), 0.05, 0.01), t,
                  0x08 | 0x100 | 0x200 | 0x400,
                  rng.integers(0, 16, t.shape[0]).astype(np.uint8)))
    yield "long", *_pack_splice(fills), prm
    yield ("mat_gate", *_pack_splice(splice_pairs(rng, 8, max_intron)),
           KS.splice_params_from(ksw2.gen_simple_mat(5, 1, 40, 1), 2, 1, 32,
                                 9, 9))


def splice_oracle(meta, qblob, tblob, jblob, flags, prm):
    """ksw2_splice.exts2 of every fill: (scores, cig_off, cig_blob)."""
    import numpy as np
    from mm2_gb_tpu.ops import ksw2_splice
    n = meta.shape[0]
    qo, to, jo = (np.concatenate([[0], np.cumsum(meta[:, c])])
                  for c in range(3))
    scores, cigs = np.zeros(n, np.int32), []
    for k in range(n):
        ez = ksw2_splice.exts2(
            qblob[qo[k]:qo[k + 1]], tblob[to[k]:to[k + 1]], prm.mat, prm.q,
            prm.e, prm.q2, prm.noncan, -1, prm.junc_bonus, int(flags[k]),
            jblob[jo[k]:jo[k + 1]] if meta[k, 2] else None)
        scores[k] = ez.score
        cigs.append(ez.cigar)
    off = np.concatenate([[0], np.cumsum([c.shape[0] for c in cigs])])
    return scores, off, (np.concatenate(cigs).astype(np.uint32) if cigs
                         else np.empty(0, np.uint32))


@contextlib.contextmanager
def recording_splice():
    """Record every exts2_fill and intron ksw2_backtrack call made by
    exts2_fill_batch inside (the wrappers still count their launches): a
    list of [fill args, score, fingerprint of p, backtrack args without
    p, cig, n_cig]."""
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    calls, fill, bt = [], KS.exts2_fill, KS.ksw2_backtrack

    def rec_fill(*a):
        sc, p = fill(*a)
        calls.append([a, sc, _fingerprint(p)])
        return sc, p

    def rec_bt(*a):
        cig, nc = bt(*a)
        calls[-1] += [a[1:], cig, nc]
        return cig, nc
    KS.exts2_fill, KS.ksw2_backtrack = rec_fill, rec_bt
    try:
        yield calls
    finally:
        KS.exts2_fill, KS.ksw2_backtrack = fill, bt


def _merge_splice_calls(calls):
    """One operand set holding every recorded launch's fills (blobs
    concatenated, offsets shifted): (fill args, backtrack args without p,
    per-launch (fill, p, word) bases)."""
    import torch

    def blob(i):
        parts, base, size = [], {}, 0
        for c in calls:
            b = c[0][i]
            key = (b.data_ptr(), b.numel())
            if key not in base:
                base[key] = size
                parts.append(b)
                size += b.numel()
        return torch.cat(parts), [base[(c[0][i].data_ptr(), c[0][i].numel())]
                                  for c in calls]
    (qb, qbase), (tb, tbase), (jb, jbase) = blob(0), blob(1), blob(2)
    cols = {k: [] for k in ("qo", "to", "jo", "ql", "tl", "fl", "po", "w",
                            "co", "rev")}
    bases, fbase, pbase, cbase = [], 0, 0, 0
    for c, qb0, tb0, jb0 in zip(calls, qbase, tbase, jbase):
        (_q, _t, _j, qo, to, jo, ql, tl, fl, po, p_total, _prm) = c[0]
        _po, _ql, _tl, w, co, rev, _mil = c[3]
        cols["qo"].append(qo + qb0)
        cols["to"].append(to + tb0)
        cols["jo"].append(torch.where(jo >= 0, jo + jb0, jo))
        cols["po"].append(po + pbase)
        cols["co"].append(co[:-1] + cbase)
        for k, v in (("ql", ql), ("tl", tl), ("fl", fl), ("w", w),
                     ("rev", rev)):
            cols[k].append(v)
        bases.append((fbase, pbase, cbase))
        fbase, pbase, cbase = (fbase + ql.shape[0], pbase + p_total,
                               cbase + int(co[-1]))
    m = {k: torch.cat(v) for k, v in cols.items()}
    co = torch.cat([m["co"], m["co"].new_tensor([cbase])])
    prm = calls[0][0][-1]
    return ((qb, tb, jb, m["qo"], m["to"], m["jo"], m["ql"], m["tl"],
             m["fl"], m["po"], pbase, prm),
            (m["po"], m["ql"], m["tl"], m["w"], co, m["rev"],
             prm.long_thres), bases)


def hold_splice_calls(calls, label, verbose=True, extra=()):
    """Each recorded exts2_fill + intron backtrack launch (of calls, then
    of extra, launches made under the same options) against the twins.
    The twins step one row of the longest fill at a time, so the fills of
    all launches go through one run of each (per-fill results do not
    depend on the company a fill keeps); then each launch's kernel is
    re-run on its recorded operands, its p must match the recorded
    fingerprint and its slice of the twin's p, its scores the twin's, and
    both backtracks on it the recorded words.  Returns (max_abs_err, fill
    ms and backtrack ms summed over calls' launches, and the twins' ms of
    the one run: fill ms, fill twin ms, backtrack ms, backtrack twin
    ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    n_timed = len(calls)
    calls = list(calls) + list(extra)
    if not calls:
        return 0, 0.0, 0.0, 0.0, 0.0
    fa_all, ba_all, bases = _merge_splice_calls(calls)
    (sc_t, p_t), fpl = _timed(KS.exts2_fill_torch, *fa_all)
    (cg_t, nc_t), bpl = _timed(K.ksw2_backtrack_torch, p_t, *ba_all)
    err, fms, bms = 0, 0.0, 0.0
    for i, ((fa, sc, fp, ba, cig, nc), (f0, p0, c0)) in enumerate(
            zip(calls, bases)):
        n, p_total, n_words = fa[6].shape[0], fa[10], cig.shape[0]
        (sck, pk), tk = _timed(KS.exts2_fill, *fa)
        e = max(_max_err(sck, sc), _max_err(sc_t[f0:f0 + n], sc),
                _max_err(p_t[p0:p0 + p_total], pk),
                0 if _fingerprint(pk) == fp else 2**31)
        (cgk, nck), tb = _timed(K.ksw2_backtrack, pk, *ba)
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc),
                _max_err(cg_t[c0:c0 + n_words], cig),
                _max_err(nc_t[f0:f0 + n], nc))
        del pk
        if verbose and i < n_timed:
            log(f"{label} launch {i}: {n} fills, "
                f"{int((fa[6].long() * fa[7].long()).sum())} cells; fill "
                f"{tk:.3f} ms, backtrack {tb:.3f} ms; max_abs_err {e}")
        err = max(err, e)
        if i < n_timed:
            fms, bms = fms + tk, bms + tb
    if verbose:
        log(f"{label}: {n_timed} launches ({len(calls) - n_timed} more of "
            f"the splice workloads held with them, max_abs_err {err}), "
            f"{sc_t.shape[0]} fills; twins (one run over all of them) fill "
            f"{fpl:.3f} ms, backtrack {bpl:.3f} ms")
    return err, fms, fpl, bms, bpl


def _params_key(prm):
    """The values of a SpliceParams (its matrix is an array)."""
    return (prm.mat.tobytes(), prm.q, prm.e, prm.q2, prm.noncan,
            prm.junc_bonus)


def phase2_splice():
    """The exts2 fill kernel and the intron backtrack against their twins
    and ksw2_splice.exts2 (the native kit here) on the splice workloads;
    exact.  The launches under the splice preset's options are held
    against the twins later, in the main-path run's twin run (their
    longest fill is as long as the main path's); returns (max_abs_err
    against the twins of the others, those launches)."""
    import torch
    from mm2_gb_tpu.utils import opts as O
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    dev = torch.device("cuda")
    later = _params_key(KS.splice_params(O.set_preset("splice")[1]))
    err, groups = 0, {}   # launches by option set: one twin run each
    for name, meta, qb, tb, jb, fl, prm in splice_workloads():
        st = KS.FillStats()
        with recording_splice() as calls:
            got = KS.exts2_fill_batch(meta, qb, tb, jb, fl, prm, dev, st)
        e_or = fill_result_err(got, splice_oracle(meta, qb, tb, jb, fl, prm))
        log(f"splice {name}: {st.fills} fills ({st.host_fills} host-routed, "
            f"{st.scratch_fills} with the ring in global scratch), longest "
            f"tlen {int(meta[:, 1].max())}, {len(calls)} launches; "
            f"batch==ksw2_splice.exts2 max_abs_err={e_or}")
        if e_or:
            fail(f"splice workload {name} disagrees with the oracle")
        if name == "mat_gate" and st.host_fills != st.fills:
            fail("the mat gate did not route every splice fill to the host")
        if name != "mat_gate" and st.host_fills:
            fail(f"splice workload {name}: fills on the host")
        if name == "noncan_odd" and not st.scratch_fills:
            fail("no splice fill took the global-scratch ring")
        groups.setdefault(_params_key(prm), []).extend(calls)
    out = [0, 0.0, 0.0, 0.0, 0.0]
    for key, calls in groups.items():
        if key != later:
            r = hold_splice_calls(calls, "splice workloads", verbose=False)
            out = [max(out[0], r[0])] + [a + b for a, b in zip(out[1:],
                                                                r[1:])]
            err = max(err, r[0])
    log(f"splice workloads of other options: kernel==twin "
        f"max_abs_err={err}; fill {out[1]:.3f} ms (twin {out[2]:.3f} ms), "
        f"backtrack {out[3]:.3f} ms (twin {out[4]:.3f} ms)")
    if err:
        fail("a splice workload launch differs from the twins")
    return err, groups.get(later, [])


def _cli(main, argv):
    """Run a CLI entry point in this process; (rc, stdout, stderr, wall)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _host(args, what):
    """Run the JAX package's host side in a subprocess: stdout."""
    p = subprocess.run([sys.executable, *args], cwd=REPO, text=True,
                       capture_output=True, timeout=600)
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-3000:])
        fail(what)
    return p.stdout


def flowcell():
    """(ref, reads) of the bench flowcell, generated from its seeds."""
    out = _host(["-c", "import sys\n"
                 "from mm2_gb_tpu.utils.simulate import materialize_flowcell"
                 "\nprint(*materialize_flowcell(int(sys.argv[1]), "
                 "sys.argv[2]), sep='\\n')", str(N_READS), WORK],
                "generating the flowcell")
    return out.split()


def phase3():
    """End to end; returns the chain-only flowcell run's launches and the
    chain kernel calls it made, as (args, kwargs, f, p), then the
    --gpu-align flowcell run's fill and backtrack launches and its
    recorded fill calls."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    gold = os.path.join(REPO, "tests", "golden")
    for flags, golden in (([], "sim200.skipinf.paf.gz"),
                          (["--cs", "-c"], "sim200.skipinf.cs.paf.gz"),
                          (["--gpu-align", "--cs", "-c"],
                           "sim200.skipinf.cs.paf.gz"),
                          (["--gpu-align", "-x", "map-hifi", "-c"],
                           "sim200.map-hifi.c.paf.gz")):
        G.launches = K.fill_launches = K.backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", SKIP_INF, *flags,
            os.path.join(gold, "simref.fa.gz"),
            os.path.join(gold, "simreads.fa.gz")])
        with gzip.open(os.path.join(gold, golden), "rt") as f:
            same = out == f.read()
        align = "--gpu-align" in flags
        log(f"sim200 {' '.join(flags) or '(default)'}: rc {rc}, "
            f"{wall:.2f} s, chain launches {G.launches}, fill launches "
            f"{K.fill_launches}, backtrack launches {K.backtrack_launches}, "
            f"byte-identical {same}")
        if (rc != 0 or not same or G.launches == 0
                or align and (K.fill_launches == 0
                              or K.backtrack_launches == 0)):
            sys.stderr.write(err[-3000:])
            fail(f"sim200 {golden}")

    ref, reads = flowcell()
    t0 = time.perf_counter()
    host_out = _host(["-m", "mm2_gb_tpu", SKIP_INF, "-t", str(THREADS), ref,
                      reads], "host path on the flowcell")
    log(f"flowcell host path (-t {THREADS}, subprocess): "
        f"{time.perf_counter() - t0:.3f} s, {host_out.count(chr(10))} lines")

    # keep every kernel call of the main path for phase 4; the wrapper
    # itself still counts the launches
    calls, chain_segments = [], G.chain_segments

    def recorded(*args, **kw):
        f, p = chain_segments(*args, **kw)
        calls.append((args, kw, f, p))
        return f, p
    G.chain_segments = recorded
    try:
        G.launches = 0           # the chain path's run counted in the JSON
        rc, out, err, gpu_wall = _cli(cli.main, [
            "--gpu-chain", SKIP_INF, "-t", str(THREADS), ref, reads])
        launches = G.launches
    finally:
        G.chain_segments = chain_segments
    sys.stderr.write(err)
    if rc != 0:
        fail("--gpu-chain on the flowcell")
    m = re.search(r"host route: (\d+) HPC batches", err)
    if m is None:
        fail("no device metrics report from the --gpu-chain run")
    host_routed = int(m.group(1))
    same = out == host_out
    log(f"flowcell --gpu-chain (-t {THREADS}, in process): {gpu_wall:.3f} s, "
        f"launches {launches}, host-routed batches {host_routed}, "
        f"byte-identical to host path {same}")
    if not same or launches == 0 or host_routed != 0:
        fail("flowcell --gpu-chain run")

    # this slice's path: device gap fills behind --gpu-chain --gpu-align -c
    t0 = time.perf_counter()
    host_c = _host(["-m", "mm2_gb_tpu", SKIP_INF, "-c", "-t", str(THREADS),
                    ref, reads], "host path -c on the flowcell")
    log(f"flowcell host path -c (-t {THREADS}, subprocess): "
        f"{time.perf_counter() - t0:.3f} s, {host_c.count(chr(10))} lines")
    with recording_fills() as fcalls:
        G.launches = K.fill_launches = K.backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "-c", "-t", str(THREADS),
            "-v", "3", ref, reads])
        align_launches = (K.fill_launches, K.backtrack_launches)
    sys.stderr.write(err)
    m = re.search(r"fills: (\d+) \((\d+) device, (\d+) host-routed\)", err)
    if rc != 0 or m is None:
        fail("--gpu-chain --gpu-align -c on the flowcell")
    same = out == host_c
    log(f"flowcell --gpu-chain --gpu-align -c (-t {THREADS}, in process): "
        f"{wall:.3f} s, fills {m.group(1)} ({m.group(3)} host-routed), fill "
        f"launches {align_launches[0]}, backtrack launches "
        f"{align_launches[1]}, chain launches {G.launches}, byte-identical "
        f"to host path {same}")
    if not same or min(align_launches) == 0:
        fail("flowcell --gpu-align run")
    return launches, calls, align_launches, fcalls


def cdna_set(n_reads=N_CDNA, genome_len=10_000_000, max_intron=20_000,
             seed=11, work=WORK):
    """(ref, reads) FASTA paths of the seeded cDNA set, written once under
    work: a random reference with genes of 3-12 exons (60-600 bp) and
    GT..AG introns log-uniform from 100 bp to max_intron, and reads from
    random starts in the first half of a transcript to its end, with 5%
    substitutions and 3% indels, half reverse-complemented (the scale-up
    of tools/fuzz_diff.py::make_splice)."""
    import numpy as np
    ref_p = os.path.join(work, f"cdna{n_reads}_ref.fa")
    reads_p = os.path.join(work, f"cdna{n_reads}_reads.fa")
    if os.path.exists(ref_p) and os.path.exists(reads_p):
        return ref_p, reads_p
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    genes, pos = [], 1000
    while True:
        n_ex = int(rng.integers(3, 13))
        ex_len = rng.integers(60, 601, n_ex)
        in_len = np.exp(rng.uniform(np.log(100), np.log(max_intron),
                                    n_ex - 1)).astype(np.int64)
        if pos + ex_len.sum() + in_len.sum() + 1000 > genome_len:
            break
        exons = []
        for i in range(n_ex):
            exons.append((pos, pos + int(ex_len[i])))
            pos += int(ex_len[i])
            if i + 1 < n_ex:
                g[pos:pos + 2] = (2, 3)
                pos += int(in_len[i])
                g[pos - 2:pos] = (0, 2)
        genes.append(exons)
        pos += int(rng.integers(1000, 20_000))
    comp = np.array([3, 2, 1, 0], np.uint8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(reads_p + ".tmp", "wb") as f:
        for i in range(n_reads):
            tx = np.concatenate([g[a:b] for a, b in
                                 genes[int(rng.integers(len(genes)))]])
            r = _mutate_splice(rng, tx[int(rng.integers(tx.shape[0] // 2)):],
                               0.05, 0.03)
            if rng.random() < 0.5:
                r = comp[r[::-1]]
            f.write(b">tx%d\n%s\n" % (i, lut[r].tobytes()))
    with open(ref_p + ".tmp", "wb") as f:
        f.write(b">chr1\n" + lut[g].tobytes() + b"\n")
    os.replace(reads_p + ".tmp", reads_p)
    os.replace(ref_p + ".tmp", ref_p)
    return ref_p, reads_p


def _no_pg(sam):
    """SAM text without its @PG line (it holds each side's command)."""
    return "".join(line for line in sam.splitlines(keepends=True)
                   if not line.startswith("@PG"))


def phase3_splice():
    """The splice slice end to end, `--gpu-chain --gpu-align -x splice`:
    byte-identical to the splice40 goldens (with and without --junc-bed)
    and the sim200 -G 8000 golden; on the cDNA set, `-ax splice -t 8`
    identical to the host path (`python -m mm2_gb_tpu`, a subprocess; all
    but the @PG line, which holds each side's command), with exts2 and
    intron backtrack launches > 0 and no fill on the host.  Returns the
    cDNA run's (fill, backtrack) launches and its recorded splice calls."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    gold = os.path.join(REPO, "tests", "golden")
    for flags, ref, query, golden in (
            (["-c"], "splice_genome.fa.gz", "splice_reads.fa.gz",
             "splice40.skipinf.c.paf.gz"),
            (["--junc-bed", os.path.join(gold, "splice.bed.gz"), "-c"],
             "splice_genome.fa.gz", "splice_reads.fa.gz",
             "splice40.juncbed.c.paf.gz"),
            (["-G", "8000", "-c"], "simref.fa.gz", "simreads.fa.gz",
             "sim200.splice-G8k.c.paf.gz")):
        G.launches = KS.fill_launches = K.backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "-x", "splice", *flags,
            os.path.join(gold, ref), os.path.join(gold, query)])
        with gzip.open(os.path.join(gold, golden), "rt") as f:
            same = out == f.read()
        log(f"{golden}: rc {rc}, {wall:.2f} s, chain launches {G.launches}, "
            f"exts2 launches {KS.fill_launches}, backtrack launches "
            f"{K.backtrack_launches}, byte-identical {same}")
        if (rc != 0 or not same or G.launches == 0 or KS.fill_launches == 0
                or K.backtrack_launches == 0):
            sys.stderr.write(err[-3000:])
            fail(f"splice golden {golden}")

    ref, reads = cdna_set()
    t0 = time.perf_counter()
    host_sam = _host(["-m", "mm2_gb_tpu", SKIP_INF, "-ax", "splice", "-t",
                      str(THREADS), ref, reads], "host path on the cDNA set")
    log(f"cDNA host path -ax splice (-t {THREADS}, subprocess): "
        f"{time.perf_counter() - t0:.3f} s, {host_sam.count(chr(10))} lines")
    with recording_splice() as calls:
        G.launches = KS.fill_launches = K.backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "-ax", "splice", "-t",
            str(THREADS), "-v", "3", ref, reads])
        launches = (KS.fill_launches, K.backtrack_launches)
    sys.stderr.write(err)
    m = re.search(r"fills: (\d+) \((\d+) device, (\d+) host-routed\)", err)
    if rc != 0 or m is None:
        fail("--gpu-chain --gpu-align -ax splice on the cDNA set")
    same = _no_pg(out) == _no_pg(host_sam)
    log(f"cDNA --gpu-chain --gpu-align -ax splice (-t {THREADS}, in "
        f"process): {wall:.3f} s, fills {m.group(1)} ({m.group(3)} "
        f"host-routed), exts2 launches {launches[0]}, backtrack launches "
        f"{launches[1]}, chain launches {G.launches}, identical to the host "
        f"path but @PG {same}")
    if not same or min(launches) == 0 or int(m.group(3)) != 0:
        fail("cDNA --gpu-align -ax splice run")
    return launches, calls


def phase4(calls):
    """Each main-path kernel call against the twin on its own inputs;
    (max_abs_err, kernel ms, twin ms) summed over the calls."""
    import torch
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    torch.cuda.synchronize()

    def timed(fn, args, kw):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = fn(*args, **kw)
        t1.record()
        torch.cuda.synchronize()
        return out, t0.elapsed_time(t1)

    err, ms, plain_ms = 0, 0.0, 0.0
    for i, (args, kw, f, p) in enumerate(calls):
        (ft, pt), t_plain = timed(G.chain_segments_torch, args, kw)
        e = max(_max_err(f, ft), _max_err(p, pt))
        t_kern = sorted(timed(G.chain_segments, args, kw)[1]
                        for _ in range(KERNEL_REPS))[KERNEL_REPS // 2]
        pairs = int(args[2].sum(dtype=torch.int64))
        lens = args[4] - args[3]
        log(f"main-path launch {i}: {args[0].shape[0]} anchors, "
            f"{lens.shape[0]} work segments (longest "
            f"{int(lens.max()) if lens.numel() else 0}), {pairs} pairs; "
            f"kernel {t_kern:.3f} ms (median of {KERNEL_REPS}), twin "
            f"{t_plain:.3f} ms; max_abs_err {e}")
        if e:
            fail(f"main-path launch {i}: kernel differs from the twin")
        err, ms, plain_ms = max(err, e), ms + t_kern, plain_ms + t_plain
    return err, ms, plain_ms


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "mm2_gb_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(WORK, exist_ok=True)
    phase1()
    err = phase2()
    fill_err = phase2_fills()
    splice_err, splice_later = phase2_splice()
    launches, calls, (n_fill, n_bt), fcalls = phase3()
    (n_sfill, n_sbt), scalls = phase3_splice()
    e, ms, plain_ms = phase4(calls)
    fe, fms, fpl, bms, bpl = hold_fill_calls(fcalls, "main-path fill")
    if fe:
        fail("a main-path fill or backtrack launch differs from its twin")
    if _params_key(scalls[0][0][-1]) != _params_key(splice_later[0][0][-1]):
        fail("the cDNA run's options differ from the splice preset's")
    se, sfms, sfpl, sbms, sbpl = hold_splice_calls(
        scalls, "main-path splice", extra=splice_later)
    if se:
        fail("a main-path or splice workload launch differs from its twins")
    if "jax" in sys.modules:
        fail("jax was imported")
    src = "mm2_gb_tpu_torch/csrc/extd2_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "chain_segments", "route": "cuda",
         "source": "mm2_gb_tpu_torch/csrc/chain_kernel.cu",
         "replaces": "mm2_gb_tpu/ops/chain_tpu.py:222",
         "launches": launches, "max_abs_err": max(err, e),
         "ms": ms, "plain_ms": plain_ms},
        {"name": "extd2_fill", "route": "cuda", "source": src,
         "replaces": "mm2_gb_tpu/ops/ksw2_tpu.py:359",
         "launches": n_fill, "max_abs_err": max(fill_err, fe),
         "ms": fms, "plain_ms": fpl},
        {"name": "ksw2_backtrack", "route": "cuda", "source": src,
         "replaces": "mm2_gb_tpu/ops/ksw2_tpu.py:1472",
         "launches": n_bt, "max_abs_err": max(fill_err, fe),
         "ms": bms, "plain_ms": bpl},
        {"name": "exts2_fill", "route": "cuda",
         "source": "mm2_gb_tpu_torch/csrc/exts2_kernel.cu",
         "replaces": "mm2_gb_tpu/ops/ksw2_tpu.py:951",
         "launches": n_sfill, "max_abs_err": max(splice_err, se),
         "ms": sfms, "plain_ms": sfpl},
        {"name": "ksw2_backtrack_intron", "route": "cuda", "source": src,
         "replaces": "mm2_gb_tpu/ops/ksw2_tpu.py:1472",
         "launches": n_sbt, "max_abs_err": max(splice_err, se),
         "ms": sbms, "plain_ms": sbpl}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
