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
   -x map-hifi -c); on the 1200-read bench flowcell byte-identical to
   the host path (`python -m mm2_gb_tpu`, same -t, in a subprocess),
   with kernel launches > 0 and no batch chained on the host; then
   `--gpu-align -c` on the flowcell byte-identical to the host path's
   -c, with fill and backtrack launches > 0;
4. every kernel launch of those two flowcell runs, on the inputs it was
   given, against its twin, exact, and both timed (CUDA events).  A fill
   launch is re-run on its recorded operands and must reproduce the
   recorded direction bytes (by fingerprint) before the twins are held
   against it.

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
N_READS = 1200      # bench flowcell: 4 Mbp reference, 10-100 kb reads
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
    launches, calls, (n_fill, n_bt), fcalls = phase3()
    e, ms, plain_ms = phase4(calls)
    fe, fms, fpl, bms, bpl = hold_fill_calls(fcalls, "main-path fill")
    if fe:
        fail("a main-path fill or backtrack launch differs from its twin")
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
         "ms": bms, "plain_ms": bpl}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
