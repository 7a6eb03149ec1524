#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (mm2_gb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the smoke, below
    python3 chip_smoke.py --walls    # --qstrand walls: port vs host path
    python3 chip_smoke.py --scale-walls  # two devices, two ranks vs one
    python3 chip_smoke.py --e2e      # the e2e bench stage: every config
    python3 chip_smoke.py --ultralong  # the ultra-long mapping phase alone
    python3 chip_smoke.py --ava      # the all-vs-all overlap phase alone
    python3 chip_smoke.py --asm      # the assembly phase alone
    python3 chip_smoke.py --hifi     # the HiFi phase alone
    python3 chip_smoke.py --cfg-sweep  # max_anchors_batch sweep, two sets
    python3 chip_smoke.py --dp-turns [PARENT]  # DP kernel launches, turns
    python3 chip_smoke.py --dp-probe [PARENT]  # DP kernels, fixed shapes
    python3 chip_smoke.py --fuzz N SEED0      # the fuzz campaign alone
    python3 chip_smoke.py --fuzz-asan K SEED0  # genomic -c seeds, asan kit
    python3 chip_smoke.py --fuzz-ava N SEED0   # ava seeds: none may be empty
    python3 chip_smoke.py --fuzz-asm N SEED0   # asm seeds: none may be empty

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
a CUDA build of PyTorch.  Phases (any failure exits non-zero):

1. the card's name and power limit; build the CUDA kernels from
   mm2_gb_tpu_torch/csrc (into build/kernels);
2. the chain kernel against its plain PyTorch twin on the card and
   against the port's host oracle (`chain_scores_host`, the reference DP
   at max_skip = inf), exact (tolerance 0: all outputs are integers), on
   small, dense, multi-segment, repeat, wide-window and is_cdna
   workloads, one whose segments fall in every class of the kernel's
   launch (a warp, a group of warps, the block with the window in its
   ring or in global memory), equal totals spread over a block's warps
   and gap differences across 2^24; the kernel's mg_log2 against the
   twin's bit for bit; the gap-fill kernels (extd2_fill, ksw2_backtrack)
   against their twins and against ksw2.extd2 (score and CIGAR, exact)
   on seeded fill workloads: five presets' penalties, RIGHT and
   REV_CIGAR on and off, N bases, indel-rich and unrelated pairs, bands
   from 16 to the whole matrix, the q/e swap, pairs to 5 kb and one of 7
   kb (the fill kernel's state in global scratch), warp- and block-class
   fills in one launch, and the host routes (collapse, mat gate); one
   launch in which queries of 4,000 to 72,000 bases beside targets of at
   most 512 take blocks (one from global scratch) beside warp-class
   fills, against ksw2.extd2;
3. end to end through the CLI entry point, `--gpu-chain
   --max-chain-skip=2147483647`: byte-identical to the sim200 goldens
   (with and without --cs -c, and with --gpu-align for --cs -c and
   -x map-hifi -c); on a 600-read draw of the bench flowcell (the bench
   has 1200 reads; half, for the time limit) byte-identical to
   the port's host route (PORT_HOST, same -t, in a subprocess),
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
   Then the extension slice: the extd2_ext kernel and the backtrack from
   its per-fill starts against their twins and the port's ksw2.extd2 on
   seeded extension workloads (five presets' penalties, both flag
   forms, Z-drop, reach_end, N bases, the q/e swap, state in global
   scratch, the host routes, one launch of warp- and block-class
   extensions with a Z-drop beside running warps and row maxima tied
   across rank classes); `--gpu-chain --gpu-align --qstrand -c`
   byte-identical to the sim200 qstrand golden (no real-pass miss of
   the device results) and the no-native-kit route to the sim200 --cs
   -c golden; on a draw of the bench flowcell `--qstrand -c -t 8`
   identical to the host path, with extension launches > 0 and no
   real-pass miss.  The genomic -c runs need the port's host
   kit: the smoke fails if it did not build;
   Then the splice extensions (the exts2 kernel's extension mode, the
   JAX package's track_h branch, and the intron backtrack from its
   per-fill starts) against their twins and ksw2_splice.exts2 on seeded
   read ends across introns (both strands, FLANK, BED junctions,
   EXTZ_ONLY with and without RIGHT|REV_CIGAR, Z-drop hits, N bases,
   unrelated pairs, tlen to a few kb, the global-scratch ring, one
   launch of warp- and block-class extensions), and on
   every splice extension the cDNA run's align driver ran on the host
   (at least 100), in one exts2_ext_batch;
   Then the scale-out paths on the flowcell draw: two devices
   [cuda:0, cuda:0] (one stream each) at --gpu-chain and --gpu-align -c
   byte-identical to one device; two --tpu-nproc ranks merged by the
   port's mergeshards byte-identical to one process (PAF; SAM but @PG);
   per-part device mapping of multi-part indexes against the sim200 and
   multi3 goldens; a --tpu-profile trace that names the chain kernel;
   Then the host modules: `MM2TPU_TIMELINE=1 python -m mm2_gb_tpu_torch
   --gpu-chain --gpu-align -c` on the flowcell in a subprocess, its
   stdout equal to the in-process run's, its phase marks printed beside
   the card's name and power limit; the Python API on the card on
   the flowcell's first 100 reads, each primary hit equal to the card's
   -c PAF line and to the host route's, then the same reads from two
   threads through one card Aligner, each thread's hits equal to the
   single thread's; the port's paftools `stat` on that PAF and
   `sam2paf` on the cDNA run's SAM; the e2e bench stage
   (mm2_gb_tpu_torch/utils/e2ebench.py) on the flowcell at --gpu-chain,
   one untimed run a side and two timed runs a side in turns beside the
   port's host route (PORT_HOST, a subprocess), every
   output byte-identical, its record a JSON line;
   Then the over50k path (phase3_ultralong): the ultra-long set
   (simulate.materialize_ultralong: 40 reads of 100-300 kb over an 8 Mbp
   reference with planted tandem arrays) at `-x map-ont --gpu-chain
   --gpu-cfg mm2_gb_tpu_torch/configs/h100_over50k.json` and its first 12
   reads at `--gpu-align -c`, each byte-identical to the port's host
   route, with at least one segment whose window is read from global
   memory (block_global); every chain launch of both runs equal to the
   host oracle (chain_scores_host) read by read, the longest
   block_global segment to the twin alone, the -c run's fill and
   backtrack launches to the twins;
   Then all-vs-all overlap (phase3_ava): the flowcell's 600 reads
   against themselves at `-x ava-ont --gpu-chain` byte-identical to the
   port's host route, the PAF not empty and no line breaking the
   overlap filters (a query name after its target name, a read against
   itself on the diagonal), every batch chained by the kernel (none on
   the host), every launch equal to the host oracle and to its re-run,
   the smallest launch to the twin;
   Then assembly to reference (phase3_asm): the contigs of asm_set()
   (a 16 Mbp genome in four chromosomes; deletions and insertions of 50
   bp to 8 kb every 50-150 kb, inversions, 0.1% substitutions; about 20
   contigs of 0.2-2 Mbp) at `-cx asm5 --cs --gpu-chain --gpu-align`
   byte-identical to the port's host route, every chain batch chained
   on the host by RMQ (no chain launch), and at least one device gap
   fill longer than 627 rows at the asm band w = 150,001; and HiFi
   mapping (phase3_hifi): 1,600 reads of 15-25 kb from that genome
   (hifi_set(), HiFi's error rates) at `-ax map-hifi --gpu-chain
   --gpu-align`, identical to the host route but @PG, every batch
   chained by the kernel, every chain launch equal to the host oracle
   and its re-run, the smallest to the twin.  In both, every fill equals
   the oracle (the host kit's ksw_extd2: score and CIGAR), every fill
   and backtrack launch its re-run, and the launch of fewest fills the
   twins (its fills of at most TWIN_ROWS rows);
4. every kernel launch of those flowcell, cDNA and --qstrand runs, on
   the inputs it was given, re-run and held against its recorded result
   and against its twin, exact, and both timed (CUDA events; a kernel's
   are the pair its wrapper records right around the launch).  For the
   time limit the twins skip the longest inputs: of the chain launches
   they take the first and the last, of the splice launches those whose
   fills have at most SPLICE_TWIN_ROWS rows, and of the seeded
   workloads' launches (whose results are also held against the
   oracles) those with at most TWIN_ROWS; of the seeded gap-fill
   workloads, those of the map-ont penalties and the q/e swap.  A fill
   launch is re-run on its recorded operands and
   must reproduce the recorded direction bytes (by fingerprint) before
   the twins are held against it; the cDNA run's splice launches (with
   the splice workloads' launches under the same options) and the
   --qstrand run's extension launches and the cDNA run's splice
   extensions are each held against one twin run over all of their
   fills.
5. the differential campaign of mm2_gb_tpu_torch.tools.fuzz_diff on
   FUZZ_SEEDS, the fewest of its seeds 1000-1063 that reach all that
   the 64 did (`--fuzz N SEED0` runs the whole campaign): every seed's
   `--gpu-chain` run (with `--gpu-align` where its flags align) in this
   process byte-identical to the port's host route in a subprocess,
   both exiting 0; and, between them, the chain kernel, the genomic and
   splice fill kernels and the backtrack in its genomic and intron modes
   launched through the CLI, every launch class of the chain and fill
   kernels, every kind the seeds draw, frag mode's host chaining, an
   HPC and an RMQ batch on the host, and SAM output (fuzz_missing); its
   counts are a JSON line of their own.

The line before the last is a JSON object with each kernel's launches on
its path, its error against the twin, both times and the least time the
card could take for the same work; the last line is {"ok": true,
"device": {...}}.  The smoke fails if JAX or any module of the JAX
package was imported, and it starts no child that runs or imports the
JAX package (_host refuses one): every host-side run is the port's host
route, `python -m mm2_gb_tpu_torch --device cpu` (PORT_HOST, a verbatim
copy of the JAX package's host path, which the CPU tests hold to the
JAX package's bytes), so the smoke runs where only the port is.
Generated inputs and the kernel build go under build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import gzip
import inspect
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "smoke")
N_READS = 600       # bench flowcell: 4 Mbp reference, 10-100 kb reads
                    # (at half the bench's 1200 reads, for the time limit)
N_CDNA = 1000       # cDNA set: 10 Mbp reference, spliced reads
N_QSTRAND = 600     # the bench flowcell's draw for the --qstrand walls
                    # (half the bench's 1200 reads, as N_READS)
N_QSTRAND_CHECK = 200   # the smoke's --qstrand run (the time limit)
# the main-path splice launches whose longest fill has more rows than
# this are held against their recorded results, not the twins (a twin
# row costs ~7 ms of Python dispatch; the cDNA set's fills reach 25,000);
# the seeded workloads' launches past TWIN_ROWS likewise (their results
# are held against the oracle as well)
SPLICE_TWIN_ROWS = 6000
TWIN_ROWS = 3000
THREADS = 8
SKIP_INF = "--max-chain-skip=2147483647"
# the port's CLI as a subprocess (after the interpreter)
PORT = ["-m", "mm2_gb_tpu_torch", SKIP_INF, "-t", str(THREADS)]
# the port's host route: every card-side run's reference and e2e baseline
PORT_HOST = [sys.executable, "-m", "mm2_gb_tpu_torch", "--device", "cpu"]
KERNEL_REPS = 3
CARD = ""           # the card's name and power limit (phase 1)
N_API = 100         # the flowcell's reads the Python API maps
N_ULTRALONG = 40    # the ultra-long set: 8 Mbp repeat-rich reference,
                    # 100-300 kb reads (the over50k configuration's case)
N_ULTRALONG_C = 12  # its first reads, mapped with --gpu-align -c
N_HIFI = 1600       # the HiFi set: 15-25 kb reads of the 16 Mbp genome, 2x


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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD, flush=True)
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
    TPU kernel's largest (5120), an is_cdna case, and the chain kernel's
    classes, ties and float limits (class_anchors, tie_anchors,
    far_anchors)."""
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
    yield ("every_class", *class_anchors(),
           dict(base, max_dist_x=50000, max_dist_y=50000, max_iter=40000))
    yield "ties_across_warps", *tie_anchors(), dict(base, bw=5000, cg=0.0)
    yield ("dd_2p24", *far_anchors(),
           dict(base, max_dist_x=2**25, max_dist_y=2**25, bw=2**26, cg=0.0))


def class_anchors():
    """One read whose segments fall in every class of the chain kernel
    (chain_gpu.segment_shape at max_dist_x 50,000 and max_iter 40,000):
    short ones of 2 to 256 anchors (a warp), mid ones of 257 to 1024 (a
    group of four warps), long ones with the window in the block's ring
    (1,025 and 2,000 anchors; 5,000 anchors ~40 bp apart, widest range
    ~1,250), and one of 4,500 dense anchors whose widest range (~4,500)
    is past the ring, which reads its window from global memory."""
    import numpy as np
    xs, ys, off = [], [], 0
    for k, (n, step) in enumerate(((2, 12), (30, 12), (256, 12), (257, 12),
                                   (700, 12), (1024, 12), (1025, 12),
                                   (2000, 12), (5000, 80), (4500, 2))):
        ax, ay = synthetic_anchors(n, 100 + k, step_hi=step)
        xs.append(ax + np.uint64(off))
        ys.append(ay + np.uint64(off))
        off += int(ax[-1]) + 100_000
    return np.concatenate(xs), np.concatenate(ys)


def tie_anchors():
    """Equal totals spread over the warps of a block: 1,500 anchors on an
    anti-diagonal (no pair among them is valid, so each keeps f = span),
    then 10 more on it (no pair among them either), each of which sees
    ~200 of the first at a gap difference dd in [255, 1022], where at
    cg = 0 the penalty int(0.5 * mg_log2(dd + 1)) is 4 for all: the
    largest i must win."""
    import numpy as np
    k = np.arange(1500)
    rpos = np.concatenate([1000 + k, 3300 + 7 * np.arange(10)])
    qpos = np.concatenate([100_000 - k, 98_800 - 7 * np.arange(10)])
    return (rpos.astype(np.uint64),
            (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64))


def far_anchors():
    """200 anchors ~2^24 apart on the reference and 1,000 on the query:
    the gap difference dd of neighbours straddles 2^24 (where dd + 1
    rounds as a float32) and that of anchors two apart 2^25; at cg = 0
    the penalty is int(0.5 * mg_log2(dd + 1)), 11 to 12 a link."""
    import numpy as np
    rng = np.random.default_rng(24)
    step = (2**24 + 1000 + rng.integers(-8, 9, 200)).astype(np.int64)
    rpos = np.cumsum(step) - step[0] + 1
    qpos = 1000 * np.arange(1, 201)
    return (rpos.astype(np.uint64),
            (np.uint64(15) << np.uint64(32)) | qpos.astype(np.uint64))


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


def fill_workloads(n_pairs=96, max_len=600, long_len=5000, huge_len=0):
    """(name, meta, qblob, tblob, params, flag) of the fill checks: pairs
    of 1..max_len bp under the penalties of five presets, each with RIGHT
    and REV_CIGAR on and off; the q/e swap case (q+e > q2+e2); pairs of
    max_len..long_len bp and, when huge_len, one of huge_len bp (the
    fill kernel's state in global scratch past ~6 kb); a matrix that
    fails the mat gate."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
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
    for n in (long_len, huge_len) if huge_len else (long_len,):
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = t.copy()
        q[rng.random(n) < 0.05] = 1
        pairs.append((q, t))
        ws.append(-1)
    yield "long", *_pack_fills(pairs, ws), K.fill_params(mo), am
    pairs, ws = fill_pairs(rng, max(8, n_pairs // 8), 1, max_len)
    yield ("mat_gate", *_pack_fills(pairs, ws),
           K.fill_params_from(ksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1),
           am)


def long_query_mix(rng, n_short=40):
    """(pairs, ws) of gap fills for one launch in which queries of tens
    of kb meet narrow targets: n_short fill_pairs of 20-400 bp (warp
    class); a 4,000 x 512 and a 24,500 x 500 fill under the flowcell's
    band (30001) whose state passes a warp's share of FILL_SMEM_MAX
    (ksw2_gpu.WARP_FILL_MAX), so each takes a block though it is not
    among the launch's longest; a 72,000 x 300 fill over the whole
    matrix, the launch's longest, whose state passes FILL_SMEM_MAX
    (global scratch).  Each long query holds its target's bases in
    order, apart from 5% substitutions, among random bases."""
    import numpy as np
    pairs, ws = fill_pairs(rng, n_short, 20, 400)
    for ql, tl, w in ((4_000, 512, 30001), (24_500, 500, 30001),
                      (72_000, 300, -1)):
        t = rng.integers(0, 4, tl).astype(np.uint8)
        q = rng.integers(0, 4, ql).astype(np.uint8)
        at = np.sort(rng.choice(ql, tl, replace=False))
        q[at] = np.where(rng.random(tl) < 0.05, rng.integers(0, 4, tl), t)
        pairs.append((q, t))
        ws.append(w)
    return pairs, ws


def insertion_reads(work, inserts, seed=7):
    """(ref, reads) FASTA paths under work: a random reference of 40 kb
    plus the largest insert, and a read for each insert length, 10 kb of
    the reference with 2% substitutions, that many random bases, then
    the next 10 kb likewise.  The long join bridges the insert, whose
    gap fill has the insert's bases as its query beside a target of a
    few hundred (align.c's long-join band, max(qgap, tgap))."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = acgt[rng.integers(0, 4, 40_000 + max(inserts))]

    def mut(s):
        s = s.copy()
        m = rng.random(s.shape[0]) < 0.02
        s[m] = acgt[rng.integers(0, 4, int(m.sum()))]
        return s
    tag = "_".join(str(n) for n in inserts)
    ref_p = os.path.join(work, f"ins{tag}_ref.fa")
    reads_p = os.path.join(work, f"ins{tag}_reads.fa")
    with open(ref_p, "w") as f:
        f.write(">ref\n" + ref.tobytes().decode() + "\n")
    with open(reads_p, "w") as f:
        for i, n in enumerate(inserts):
            st = 2_000 + 3_000 * i
            read = np.concatenate([mut(ref[st:st + 10_000]),
                                   acgt[rng.integers(0, 4, n)],
                                   mut(ref[st + 10_000:st + 20_000])])
            f.write(f">ins{n}\n" + read.tobytes().decode() + "\n")
    return ref_p, reads_p


def insertion_run(inserts, extra, device, work=WORK):
    """Map insertion_reads(work, inserts) with -c and the extra options at
    --max-chain-skip=2147483647, in this process: on the port's device
    path on `device` (--gpu-chain --gpu-align) and on its host path.
    Returns the two runs' (rc, stdout, stderr, wall) and the (qlen, tlen,
    FillShape) of every ksw2_gpu.fill_shape call of the device run."""
    import numpy as np
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import opts as O
    ref, reads = insertion_reads(work, inserts)
    shapes, fill_shape = [], K.fill_shape

    def recorded(ql, tl):
        sh = fill_shape(ql, tl)
        shapes.append((np.asarray(ql).copy(), np.asarray(tl).copy(), sh))
        return sh

    def run(flags):
        argv, args = cli.parse_args([*flags, "-c", SKIP_INF, *extra, ref,
                                     reads])
        io_, mo = O.set_preset(args.preset)
        return _cli(lambda _argv: cli._run(args, argv, io_, mo, device),
                    None)
    K.fill_shape = recorded
    try:
        dev = run(["--gpu-chain", "--gpu-align"])
    finally:
        K.fill_shape = fill_shape
    return dev, run([]), shapes


def warp_rule_shape(ql, tl):
    """extd2_fill's launch shape under the rule before WARP_FILL_MAX: a
    warp for every fill of at most WARP_LANES target lanes, whatever its
    query."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    return K.class_shape(K.fill_bytes(ql, tl), ql + tl - 1,
                         (tl + 15) // 16 * 16 <= K.WARP_LANES,
                         K.FILL_SMEM_MAX)


def fill_oracle(meta, qblob, tblob, prm, flag, extd2=None):
    """extd2 (the port's ksw2.extd2 unless given) of every fill: (scores,
    cig_off, cig_blob)."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    extd2 = extd2 or ksw2.extd2
    n = meta.shape[0]
    qo = np.concatenate([[0], np.cumsum(meta[:, 0])])
    to = np.concatenate([[0], np.cumsum(meta[:, 1])])
    scores, cigs = np.zeros(n, np.int32), []
    for k in range(n):
        ez = extd2(qblob[qo[k]:qo[k + 1]], tblob[to[k]:to[k + 1]],
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

    def rec_fill(*a, **kw):
        sc, p = fill(*a, **kw)
        calls.append([a, sc, _fingerprint(p)])
        return sc, p

    def rec_bt(*a, **kw):
        cig, nc = bt(*a, **kw)
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
    """A plain version's call and its time (CUDA events around it)."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _timed_launch(fn, *args, **kw):
    """A kernel wrapper's call and the time of its kernel alone: the CUDA
    events the wrapper records right around the launch, after its host
    work (launch shape, allocations)."""
    import torch
    ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = fn(*args, events=ev, **kw)
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def _fill_suffix(c, k0):
    """The recorded extd2_fill + backtrack launch c cut to its fills k0
    and after: (fill args, backtrack args without p, the suffix's first
    p byte and first CIGAR slot), its p regions and CIGAR slots
    re-based.  The fills of a launch lie longest first, so those of at
    most n rows are such a suffix."""
    (qb, tb, qo, to, ql, tl, w, po, p_total, prm, right) = c[0]
    _po, _ql, _tl, _w, co, rev = c[3]
    p0 = int(po[k0]) if k0 < po.shape[0] else p_total
    c0 = int(co[k0])
    return ((qb, tb, qo[k0:], to[k0:], ql[k0:], tl[k0:], w[k0:],
             po[k0:] - p0, p_total - p0, prm, right),
            (po[k0:] - p0, ql[k0:], tl[k0:], w[k0:], co[k0:] - c0, rev),
            p0, c0)


def hold_fill_calls(calls, label, verbose=True, twin=None, max_rows=None):
    """Each recorded fill + backtrack launch against the twins on its own
    inputs: the fill kernel is run again on the recorded operands (its p
    must match the recorded fingerprint), the fill twin must equal it,
    and both backtracks on that p must equal the recorded words.  twin:
    the launches (indices) that go through the twins, all by default;
    the others are held against their recorded results alone.  With
    max_rows, only the fills of at most that many rows (qlen + tlen - 1)
    go through the twins (their state and time grow with the longest
    one's); the longer ones are held against their recorded results.
    Returns (max_abs_err, fill ms, fill twin ms, backtrack ms, twin ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    err, fms, fpl, bms, bpl = 0, 0.0, 0.0, 0.0, 0.0
    for i, (fa, sc, fp, ba, cig, nc) in enumerate(calls):
        (sck, pk), tk = _timed_launch(K.extd2_fill, *fa)
        e = max(_max_err(sck, sc), 0 if _fingerprint(pk) == fp else 2**31)
        (cgk, nck), tb = _timed_launch(K.ksw2_backtrack, pk, *ba)
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc))
        rows = (fa[4] + fa[5] - 1).cpu()
        over = ((rows > max_rows).nonzero() if max_rows is not None
                else [])
        k0 = int(over[-1]) + 1 if len(over) else 0
        tt = tbt = 0.0
        held = 0
        if (twin is None or i in twin) and k0 < rows.shape[0]:
            fs, bs, p0, c0 = _fill_suffix(calls[i], k0)
            (sct, pt), tt = _timed(K.extd2_fill_torch, *fs)
            (cgt, nct), tbt = _timed(K.ksw2_backtrack_torch, pt, *bs)
            e = max(e, _max_err(sct, sc[k0:]), _max_err(pt, pk[p0:]),
                    _max_err(cgt, cig[c0:]), _max_err(nct, nc[k0:]))
            held = rows.shape[0] - k0
        del pk
        if verbose:
            n_rows, steps = _longest(calls[i])
            log(f"{label} launch {i}: {fa[4].shape[0]} fills, "
                f"{int((fa[4].long() * fa[5].long()).sum())} cells; fill "
                f"{tk:.3f} ms (twin {tt:.3f} ms), {n_rows} rows of the "
                f"longest fill, {tk * 1e3 / n_rows:.4f} µs per row; "
                f"backtrack {tb:.3f} ms (twin {tbt:.3f} ms), {steps} steps "
                f"of the longest walk, {tb * 1e3 / max(steps, 1):.4f} µs per "
                f"step; {held} fills held against the twins; max_abs_err {e}")
        err = max(err, e)
        fms, fpl, bms, bpl = fms + tk, fpl + tt, bms + tb, bpl + tbt
    return err, fms, fpl, bms, bpl


def hold_fill_oracle(calls):
    """Every fill of the recorded fill + backtrack launches against the
    oracle, the host kit's ksw_extd2 (ksw2.extd2's native path, called
    here on the recorded blobs in place) under the launch's flags, on
    THREADS threads: its score and its CIGAR words equal to the recorded
    ones; tolerance 0.  (max_abs_err, fills held, seconds)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import native
    t0 = time.perf_counter()
    i32, ptr = ctypes.c_int32, ctypes.c_void_p
    # mmt_ksw_extd2 (native.ksw_extd2) taking its buffers as addresses
    extd2 = ctypes.CFUNCTYPE(ctypes.c_int64, ptr, i32, ptr, i32, ptr,
                             *[i32] * 9, ptr, ptr, ctypes.c_int64)(
        ctypes.cast(native._load().mmt_ksw_extd2, ptr).value)

    def one(h, ks):
        (qb, tb, mat, qo, to, ql, tl, w, sc, words, off, prm, flag) = h
        cap = max(ql[k] + tl[k] for k in ks) + 4
        ez, cig = np.zeros(10, np.int32), np.empty(cap, np.uint32)
        qa, ta, ma, ea, ca = (a.ctypes.data for a in (qb, tb, mat, ez, cig))
        q, e1, q2, e2 = prm.q, prm.e, prm.q2, prm.e2
        e = 0
        for k in ks:
            n = extd2(qa + qo[k], ql[k], ta + to[k], tl[k], ma, 5, q, e1, q2,
                      e2, w[k], -1, 0, flag, ea, ca, ql[k] + tl[k] + 4)
            want = words[off[k]:off[k + 1]]
            if n != want.shape[0]:
                e = 2**31
            elif ez[0] != sc[k] or not np.array_equal(cig[:n], want):
                e = max(e, abs(int(ez[0]) - sc[k]), int(np.abs(
                    cig[:n].astype(np.int64) - want).max(initial=0)))
        return e
    futs, n = [], 0
    with ThreadPoolExecutor(max_workers=THREADS) as ex:
        for fa, sc, _fp, ba, cig, nc in calls:
            qb, tb = (np.ascontiguousarray(t.cpu().numpy(), np.uint8)
                      for t in fa[:2])
            cols = [t.cpu().tolist() for t in (*fa[2:7], sc)]
            prm, right, rev = fa[9], fa[10], ba[5]
            flag = (K.APPROX_MAX | (ksw2.KSW_EZ_RIGHT if right else 0)
                    | (ksw2.KSW_EZ_REV_CIGAR if rev else 0))
            words = K.chunk_words(cig, nc, ba[4])
            off = np.concatenate([[0], np.cumsum(nc.cpu().numpy(),
                                                 dtype=np.int64)])
            h = (qb, tb, np.ascontiguousarray(prm.mat, np.int8), *cols,
                 words, off, prm, flag)
            for ks in np.array_split(np.arange(len(cols[2])), 4 * THREADS):
                if ks.shape[0]:
                    futs.append(ex.submit(one, h, ks.tolist()))
            n += len(cols[2])
        err = max((fu.result() for fu in futs), default=0)
    return err, n, time.perf_counter() - t0


def phase2_fills():
    """The fill and backtrack kernels against their twins and ksw2.extd2
    (the native kit here) on the fill workloads; exact."""
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    dev = torch.device("cuda")
    err = 0
    for name, meta, qb, tb, prm, flag in fill_workloads(huge_len=7000):
        st = K.FillStats()
        with recording_fills() as calls:
            got = K.extd2_fill_batch(meta, qb, tb, prm, dev, flag, st)
        e_or = fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag))
        # for the time limit the twins re-check the map-ont penalties and
        # the q/e swap (every main-path launch meets them too); every
        # workload meets ksw2.extd2
        twin = name.startswith(("map-ont/", "qe_swap/"))
        e_tw = hold_fill_calls(calls, name, verbose=False)[0] if twin else 0
        log(f"fill {name}: {st.fills} fills ({st.host_fills} host-routed), "
            f"{len(calls)} launches; kernel==twin max_abs_err="
            f"{e_tw if twin else 'not run'}, batch==ksw2.extd2 "
            f"max_abs_err={e_or}")
        if e_or or e_tw:
            fail(f"fill workload {name} disagrees")
        if name == "mat_gate" and st.host_fills != st.fills:
            fail("the mat gate did not route every fill to the host")
        if name != "mat_gate" and not (0 < st.host_fills < st.fills):
            fail(f"fill workload {name}: no collapse case on the host")
        if name == "long" and not st.scratch_fills:
            fail("no fill took the global-scratch state")
        err = max(err, e_tw)
    return err


def phase2_long_query():
    """The gap-fill kernel on long_query_mix's launch, under RIGHT and
    without: the long-query fills take blocks (one from global scratch),
    the short ones warps, and the batch equals ksw2.extd2 (the native
    kit), exact.  The twins are not run: their row loop would step the
    longest fill's 72,299 rows.  Returns the max_abs_err."""
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import opts as O
    dev = torch.device("cuda")
    prm = K.fill_params(O.set_preset(None)[1])
    err = 0
    for right in (0, ksw2.KSW_EZ_RIGHT):
        flag = ksw2.KSW_EZ_APPROX_MAX | right
        meta, qb, tb = _pack_fills(*long_query_mix(
            np.random.default_rng(2024 + right)))
        st = K.FillStats()
        with recording_fills() as calls:
            got = K.extd2_fill_batch(meta, qb, tb, prm, dev, flag, st)
        e = fill_result_err(got, fill_oracle(meta, qb, tb, prm, flag))
        if len(calls) != 1:
            fail(f"long-query fills: {len(calls)} launches, not one")
        fa, _sc, fp = calls[0][:3]
        (_sck, pk), tk = _timed_launch(K.extd2_fill, *fa)
        e = max(e, 0 if _fingerprint(pk) == fp else 2**31)
        ql, tl = fa[4].cpu().numpy(), fa[5].cpu().numpy()
        sh = K.fill_shape(ql, tl)
        block = np.isin(np.arange(ql.shape[0]), sh.work[:sh.n_block])
        long = ql >= 4_000
        log(f"long-query fills {flag:#x}: {ql.shape[0]} fills in one "
            f"launch, {sh.n_block} blocks ({int(long.sum())} long queries, "
            f"{st.scratch_fills} in scratch) and {sh.n_warp} warps, smem "
            f"{sh.smem} B, warp stride {sh.warp_stride} B; fill {tk:.3f} ms "
            f"for {int(ql.max() + tl[ql.argmax()] - 1)} rows of the longest; "
            f"batch==ksw2.extd2 max_abs_err={e}")
        if e or long.sum() != 3 or not block[long].all() \
                or sh.n_warp == 0 or st.scratch_fills == 0:
            fail("the long-query gap fills")
        err = max(err, e)
    return err


# the align driver's two extension flag forms: EXTZ_ONLY (the right
# extension, the inversion fill) and EXTZ_ONLY|RIGHT|REV_CIGAR (the left)
EXT_FLAGS = (0x40, 0x40 | 0x02 | 0x80)
EXT_BONUS = (-1, 10, 0, 200)


def _pack_ext(pairs, ws):
    """(meta, qblob, tblob) of (q, t) extension pairs: meta [qlen, tlen,
    w], as the pipeline's Python collect pass packs them."""
    meta, qb, tb = _pack_fills(pairs, ws)
    return meta[:, :3].copy(), qb, tb


def ext_workloads(n_pairs=96, max_len=400, long_len=3400):
    """(name, meta, qblob, tblob, zdrop, params, flag, end_bonus) of the
    extension checks: fill_pairs's pairs (related, indel-rich, N bases,
    unrelated, band-collapse shapes) under five presets' penalties in
    both flag forms, Z-drop off, tight and at the presets' values, end
    bonuses from -1 to 200 (reach_end); the q/e swap; pairs with tlen
    past 3.2 kb (state in global scratch), one of them unrelated (an
    early Z-drop); a matrix that fails the mat gate."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(1618)
    k = 0
    for preset in FILL_PRESETS:
        _io, mo = O.set_preset(preset)
        for flag in EXT_FLAGS:
            pairs, ws = fill_pairs(rng, n_pairs, 1, max_len)
            zd = rng.choice([-1, 20, mo.zdrop, mo.zdrop_inv], len(pairs))
            yield (f"{preset or 'map-ont'}/{flag:#x}", *_pack_ext(pairs, ws),
                   zd, K.fill_params(mo), flag, EXT_BONUS[k % 4])
            k += 1
    pairs, ws = fill_pairs(rng, n_pairs, 1, max_len)
    yield ("qe_swap", *_pack_ext(pairs, ws),
           rng.choice([-1, 50, 400], len(pairs)),
           K.fill_params_from(ksw2.gen_simple_mat(5, 2, 4, 1), 24, 1, 4, 2),
           EXT_FLAGS[1], 10)
    _io, mo = O.set_preset(None)
    t = rng.integers(0, 4, long_len).astype(np.uint8)
    q = t[:400].copy()
    q[rng.random(400) < 0.05] = 4
    pairs = [(q, t), (rng.integers(0, 4, 1500).astype(np.uint8), t.copy())]
    yield ("long", *_pack_ext(pairs, [-1, -1]), np.array([400, 100]),
           K.fill_params(mo), EXT_FLAGS[0], 10)
    pairs, ws = fill_pairs(rng, 12, 1, max_len)
    yield ("mat_gate", *_pack_ext(pairs, ws), np.full(12, 400),
           K.fill_params_from(ksw2.gen_simple_mat(5, 2, 40, 1), 4, 2, 24, 1),
           EXT_FLAGS[0], -1)


def ext_class_mix(seed, flag):
    """(meta, qblob, tblob, zdrop, params, flag, end_bonus) of one
    extension launch over both of extd2_ext's classes: sixteen warp-class
    read ends of ~150 against ~300 bases (band 751, Z-drop 400), two of
    them with an unrelated tail under a Z-drop of 40, so that they drop
    while the rest of their block of warps runs on; periodic and
    one-base pairs, whose H rows tie across the row maximum's rank
    classes; N bases; block-class ones past WARP_LANES lanes (the whole
    matrix), one of them unrelated (a block's Z-drop); end bonus 10
    (reach_end starts)."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(seed)
    pairs, ws, zd = [], [], []
    for k in range(16):
        t = rng.integers(0, 4, int(rng.integers(280, 320))).astype(np.uint8)
        q = _mutate_splice(rng, t[:int(rng.integers(140, 160))], 0.03, 0.01)
        if k in (3, 12):
            q[30:] = rng.integers(0, 4, q.shape[0] - 30)
        if k % 5 == 1:
            q[rng.random(q.shape[0]) < 0.05] = 4
        pairs.append((q, t))
        ws.append(751)
        zd.append(40 if k in (3, 12) else 400)
    unit = np.array([0, 1, 2, 3], np.uint8)
    for q, t in ((np.tile(unit, 30), np.tile(unit, 70)),
                 (np.tile(unit[:2], 45), np.tile(unit[:2], 120)),
                 (np.full(40, 1, np.uint8), np.full(100, 1, np.uint8)),
                 (np.tile(unit, 20), np.tile(unit[::-1], 60))):
        pairs.append((q, t))
        ws.append(751)
        zd.append(400)
    for ql, tl, related in ((300, 600, True), (500, 900, True),
                            (700, 1500, True), (400, 700, False)):
        t = rng.integers(0, 4, tl).astype(np.uint8)
        q = (_mutate_splice(rng, t[:ql], 0.04, 0.02) if related
             else rng.integers(0, 4, ql).astype(np.uint8))
        pairs.append((q, t))
        ws.append(-1)
        zd.append(400 if related else 100)
    meta, qb, tb = _pack_ext(pairs, ws)
    return (meta, qb, tb, np.array(zd), K.fill_params(O.set_preset(None)[1]),
            flag, 10)


def ext_oracle(meta, qblob, tblob, zdrop, prm, flag, end_bonus):
    """The port's ksw2.extd2 of every extension: (fields [n, 10], cig_off,
    cig_blob)."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    n = meta.shape[0]
    qo = np.concatenate([[0], np.cumsum(meta[:, 0])])
    to = np.concatenate([[0], np.cumsum(meta[:, 1])])
    fields, cigs = np.zeros((n, len(K.EXT_FIELDS)), np.int32), []
    for k in range(n):
        ez = ksw2.extd2(qblob[qo[k]:qo[k + 1]], tblob[to[k]:to[k + 1]],
                        prm.mat, prm.q, prm.e, prm.q2, prm.e2,
                        int(meta[k, 2]), int(zdrop[k]), end_bonus, flag)
        fields[k] = [int(getattr(ez, f)) for f in K.EXT_FIELDS]
        cigs.append(ez.cigar)
    off = np.concatenate([[0], np.cumsum([c.shape[0] for c in cigs])])
    return fields, off, (np.concatenate(cigs).astype(np.uint32) if cigs
                         else np.empty(0, np.uint32))


@contextlib.contextmanager
def recording_ext():
    """Record every extd2_ext call made inside and the ksw2_backtrack call
    from its starts (the wrappers still count their launches): a list of
    [ext args, ext, fingerprint of p, backtrack args without p, cig,
    n_cig].  Backtracks without starts (gap fills) pass through."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    calls, ext, bt = [], K.extd2_ext, K.ksw2_backtrack

    def rec_ext(*a, **kw):
        e, p = ext(*a, **kw)
        calls.append([a, e, _fingerprint(p)])
        return e, p

    def rec_bt(*a, starts=None, **kw):
        cig, nc = bt(*a, starts=starts, **kw)
        if starts is not None:
            calls[-1] += [a[1:], cig, nc]
        return cig, nc
    K.extd2_ext, K.ksw2_backtrack = rec_ext, rec_bt
    try:
        yield calls
    finally:
        K.extd2_ext, K.ksw2_backtrack = ext, bt


def _merge_ext_calls(calls):
    """One operand set holding the fills of recorded extension launches
    that share their KSW_EZ_RIGHT flag and end bonus (blobs concatenated,
    offsets shifted): (ext args, backtrack args without p, per-launch
    (fill, p, word) bases)."""
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
    (qb, qbase), (tb, tbase) = blob(0), blob(1)
    cols = {k: [] for k in ("qo", "to", "ql", "tl", "w", "zd", "po", "co")}
    bases, fbase, pbase, cbase = [], 0, 0, 0
    for c, qb0, tb0 in zip(calls, qbase, tbase):
        (_q, _t, qo, to, ql, tl, w, zd, po, p_total, _prm, _r, _eb) = c[0]
        co = c[3][4]
        for k, v in (("qo", qo + qb0), ("to", to + tb0), ("ql", ql),
                     ("tl", tl), ("w", w), ("zd", zd), ("po", po + pbase),
                     ("co", co[:-1] + cbase)):
            cols[k].append(v)
        bases.append((fbase, pbase, cbase))
        fbase, pbase, cbase = (fbase + ql.shape[0], pbase + p_total,
                               cbase + int(co[-1]))
    m = {k: torch.cat(v) for k, v in cols.items()}
    co = torch.cat([m["co"], m["co"].new_tensor([cbase])])
    prm, right, eb = calls[0][0][10:13]
    return ((qb, tb, m["qo"], m["to"], m["ql"], m["tl"], m["w"], m["zd"],
             m["po"], pbase, prm, right, eb),
            (m["po"], m["ql"], m["tl"], m["w"], co, calls[0][3][5]), bases)


def hold_ext_calls(calls, label, verbose=True, max_rows=None):
    """Recorded extd2_ext + backtrack launches of one option set against
    the twins: one run of each twin over the fills of all launches with
    the same KSW_EZ_RIGHT flag and end bonus (per-fill results do not
    depend on the company a fill keeps), then each launch re-run on its
    recorded operands: its p must match the recorded fingerprint and its
    slice of the twin's p, its ext rows the recorded and the twin's, and
    both backtracks from its starts the recorded words.  With max_rows,
    launches whose longest fill has more rows (qlen + tlen) are re-run
    and held against their recorded results alone.  Returns
    (max_abs_err, ext ms and backtrack ms summed over the launches, the
    twins' ms summed over their runs: ext ms, ext twin ms, backtrack ms,
    backtrack twin ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    if not calls:
        return 0, 0.0, 0.0, 0.0, 0.0
    groups = {}
    for i, c in enumerate(calls):
        if max_rows is None or int((c[0][4] + c[0][5]).max()) <= max_rows:
            groups.setdefault((bool(c[0][11]), int(c[0][12])), []).append(i)
    twin, fpl, bpl = {}, 0.0, 0.0
    for idx in groups.values():
        fa_all, ba_all, bases = _merge_ext_calls([calls[i] for i in idx])
        (e_t, p_t), t_e = _timed(K.extd2_ext_torch, *fa_all)
        (cg_t, nc_t), t_b = _timed(
            lambda *a: K.ksw2_backtrack_torch(*a, starts=e_t[:, 10:]), p_t,
            *ba_all)
        fpl, bpl = fpl + t_e, bpl + t_b
        for i, (f0, p0, c0) in zip(idx, bases):
            fa, cig = calls[i][0], calls[i][4]
            n = fa[4].shape[0]
            twin[i] = (e_t[f0:f0 + n], p_t[p0:p0 + fa[9]],
                       cg_t[c0:c0 + cig.shape[0]], nc_t[f0:f0 + n])
    err, fms, bms = 0, 0.0, 0.0
    for i, (fa, ek0, fp, ba, cig, nc) in enumerate(calls):
        (ek, pk), tk = _timed_launch(K.extd2_ext, *fa)
        e = max(_max_err(ek, ek0), 0 if _fingerprint(pk) == fp else 2**31)
        (cgk, nck), tb = _timed_launch(K.ksw2_backtrack, pk, *ba,
                                       starts=ek[:, 10:])
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc))
        if i in twin:
            e_t, p_t, cg_t, nc_t = twin[i]
            e = max(e, _max_err(e_t, ek0), _max_err(p_t, pk),
                    _max_err(cg_t, cig), _max_err(nc_t, nc))
        del pk
        if verbose:
            log(f"{label} launch {i}: {fa[4].shape[0]} extensions, "
                f"{int((fa[4].long() * fa[5].long()).sum())} cells; ext "
                f"{tk:.3f} ms, backtrack {tb:.3f} ms; max_abs_err {e}")
        err = max(err, e)
        fms, bms = fms + tk, bms + tb
    if verbose:
        log(f"{label}: {len(calls)} launches, "
            f"{sum(c[0][4].shape[0] for c in calls)} extensions; twins "
            f"({len(groups)} runs, one per RIGHT flag and end bonus) ext "
            f"{fpl:.3f} ms, backtrack {bpl:.3f} ms")
    return err, fms, fpl, bms, bpl


def ext_result_err(got, want) -> int:
    """Largest difference between two (fields, cig_off, cig_blob), or
    2**31 when their shapes or CIGAR lengths differ."""
    import numpy as np
    if got[0].shape != want[0].shape or not np.array_equal(got[1], want[1]):
        return 2**31
    d = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))
    w = np.abs(got[2].astype(np.int64) - want[2].astype(np.int64))
    return int(max(d.max(initial=0), w.max(initial=0)))


def phase2_ext():
    """The extd2_ext kernel and the backtrack from its starts against
    their twins and the port's ksw2.extd2 (the native kit here) on the
    extension workloads and, in both flag forms, on one launch of both
    kernel classes (ext_class_mix); exact.  The launches of one option
    set go through one twin run."""
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    dev = torch.device("cuda")
    err, groups = 0, {}
    mixes = [(f"mix/{'right' if r else 'default'}",
              *ext_class_mix(808, 0x40 | (0x82 if r else 0)))
             for r in (False, True)]
    for name, meta, qb, tb, zd, prm, flag, eb in [*ext_workloads(), *mixes]:
        st = K.FillStats()
        with recording_ext() as calls:
            got = K.extd2_ext_batch(meta, qb, tb, zd, prm, flag, eb, dev, st)
        e_or = ext_result_err(got, ext_oracle(meta, qb, tb, zd, prm, flag,
                                              eb))
        log(f"ext {name}: {st.ext_fills} extensions ({st.ext_host_fills} "
            f"host-routed, {st.scratch_fills} with state in global "
            f"scratch), {int(got[0][:, 8].sum())} Z-dropped, "
            f"{int(got[0][:, 9].sum())} reach the end, {len(calls)} "
            f"launches; batch==ksw2.extd2 max_abs_err={e_or}")
        if e_or:
            fail(f"ext workload {name} disagrees with the oracle")
        if name == "mat_gate" and st.ext_host_fills != st.ext_fills:
            fail("the mat gate did not route every extension to the host")
        if name == "long" and not st.scratch_fills:
            fail("no extension took the global-scratch state")
        if name.endswith(f"/{EXT_FLAGS[0]:#x}") and not (
                0 < st.ext_host_fills < st.ext_fills):
            fail(f"ext workload {name}: no collapse case on the host")
        groups.setdefault(_prm_key(prm), []).extend(calls)
    out = [0, 0.0, 0.0, 0.0, 0.0]
    for calls in groups.values():
        r = hold_ext_calls(calls, "ext workloads", verbose=False,
                           max_rows=TWIN_ROWS)
        out = [max(out[0], r[0])] + [a + b for a, b in zip(out[1:], r[1:])]
    err = out[0]
    log(f"ext workloads: kernel==twin max_abs_err={err}; ext "
        f"{out[1]:.3f} ms (twin {out[2]:.3f} ms), backtrack {out[3]:.3f} ms "
        f"(twin {out[4]:.3f} ms)")
    if err:
        fail("an ext workload launch differs from the twins")
    return err


def _prm_key(prm):
    """The values of a FillParams (its matrix is an array)."""
    return (prm.mat.tobytes(), prm.q, prm.e, prm.q2, prm.e2)


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
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.utils import opts as O
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


def splice_oracle(meta, qblob, tblob, jblob, flags, prm, exts2=None):
    """exts2 (the port's ksw2_splice.exts2 unless given) of every fill:
    (scores, cig_off, cig_blob)."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2_splice
    exts2 = exts2 or ksw2_splice.exts2
    n = meta.shape[0]
    qo, to, jo = (np.concatenate([[0], np.cumsum(meta[:, c])])
                  for c in range(3))
    scores, cigs = np.zeros(n, np.int32), []
    for k in range(n):
        ez = exts2(
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

    def rec_fill(*a, **kw):
        sc, p = fill(*a, **kw)
        calls.append([a, sc, _fingerprint(p)])
        return sc, p

    def rec_bt(*a, **kw):
        cig, nc = bt(*a, **kw)
        calls[-1] += [a[1:], cig, nc]
        return cig, nc
    KS.exts2_fill, KS.ksw2_backtrack = rec_fill, rec_bt
    try:
        yield calls
    finally:
        KS.exts2_fill, KS.ksw2_backtrack = fill, bt


def _merge_splice_calls(calls, ext=False):
    """One operand set holding every recorded launch's fills (blobs
    concatenated, offsets shifted): (fill args, backtrack args without p,
    per-launch (fill, p, word) bases).  ext: exts2_ext calls, whose
    operands carry the per-fill Z-drop."""
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
    cols = {k: [] for k in ("qo", "to", "jo", "ql", "tl", "fl", "zd", "po",
                            "w", "co", "rev")}
    bases, fbase, pbase, cbase = [], 0, 0, 0
    for c, qb0, tb0, jb0 in zip(calls, qbase, tbase, jbase):
        if ext:
            (_q, _t, _j, qo, to, jo, ql, tl, fl, zd, po, p_total,
             _prm) = c[0]
            cols["zd"].append(zd)
        else:
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
    m = {k: torch.cat(v) for k, v in cols.items() if v}
    co = torch.cat([m["co"], m["co"].new_tensor([cbase])])
    prm = calls[0][0][-1]
    return ((qb, tb, jb, m["qo"], m["to"], m["jo"], m["ql"], m["tl"],
             m["fl"], *([m["zd"]] if ext else []), m["po"], pbase, prm),
            (m["po"], m["ql"], m["tl"], m["w"], co, m["rev"],
             prm.long_thres), bases)


def _splice_suffix(c, k0):
    """The recorded exts2_fill + backtrack launch c cut to its fills k0
    and after (fill args and backtrack args, p regions and CIGAR slots
    re-based), as _merge_splice_calls takes it; the fills of a launch lie
    longest first, so those of at most n rows are such a suffix."""
    (qb, tb, jb, qo, to, jo, ql, tl, fl, po, p_total, prm) = c[0]
    _po, _ql, _tl, w, co, rev, mil = c[3]
    p0 = int(po[k0]) if k0 < po.shape[0] else p_total
    po_s = po[k0:] - p0
    return [(qb, tb, jb, qo[k0:], to[k0:], jo[k0:], ql[k0:], tl[k0:],
             fl[k0:], po_s, p_total - p0, prm), None, None,
            (po_s, ql[k0:], tl[k0:], w[k0:], co[k0:] - co[k0], rev[k0:],
             mil)]


def _longest(c):
    """(rows of the longest fill, steps of the longest walk) of a recorded
    fill + backtrack launch."""
    fa, ba, cig, nc = c[0], c[3], c[4], c[5]
    ql, tl = (fa[6], fa[7]) if len(fa) == 12 else (fa[4], fa[5])
    return (int((ql.long() + tl.long() - 1).max()),
            int(_walk_steps(cig, nc, ba[4]).max()))


def hold_splice_calls(calls, label, verbose=True, extra=(), max_rows=None):
    """Each recorded exts2_fill + intron backtrack launch (of calls, then
    of extra, launches made under the same options) against the twins.
    The twins step one row of the longest fill at a time, so the fills of
    all launches go through one run of each (per-fill results do not
    depend on the company a fill keeps); then each launch's kernel is
    re-run on its recorded operands, its p must match the recorded
    fingerprint, its scores, p regions and CIGAR slots those of the twin
    run, and both backtracks on it the recorded words.  With max_rows,
    only the fills of at most that many rows (qlen + tlen) go through the
    twins (their cost is the longest one's rows), whichever launch they
    are in; the others are held against their recorded results alone.
    Returns (max_abs_err, fill ms and backtrack ms summed over calls'
    launches, and the twins' ms of the one run: fill ms, fill twin ms,
    backtrack ms, backtrack twin ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    n_timed = len(calls)
    calls = list(calls) + list(extra)
    if not calls:
        return 0, 0.0, 0.0, 0.0, 0.0
    first = {}   # launch -> its first fill the twins hold
    for i, c in enumerate(calls):
        rows = (c[0][6] + c[0][7]).cpu()
        over = (rows > max_rows).nonzero() if max_rows is not None else []
        k0 = int(over[-1]) + 1 if len(over) else 0
        if k0 < rows.shape[0]:
            first[i] = k0
    twin = {}
    fpl = bpl = 0.0
    if first:
        fa_all, ba_all, bases = _merge_splice_calls(
            [_splice_suffix(calls[i], k0) for i, k0 in first.items()])
        (sc_t, p_t), fpl = _timed(KS.exts2_fill_torch, *fa_all)
        (cg_t, nc_t), bpl = _timed(K.ksw2_backtrack_torch, p_t, *ba_all)
        for (i, k0), (f0, p0, c0) in zip(first.items(), bases):
            fa, ba = calls[i][0], calls[i][3]
            n, co = fa[6].shape[0] - k0, ba[4]
            pb = fa[10] - (int(fa[9][k0]) if k0 < fa[9].shape[0] else 0)
            cb = int(co[-1] - co[k0])
            twin[i] = (sc_t[f0:f0 + n], p_t[p0:p0 + pb], cg_t[c0:c0 + cb],
                       nc_t[f0:f0 + n])
    err, fms, bms = 0, 0.0, 0.0
    for i, (fa, sc, fp, ba, cig, nc) in enumerate(calls):
        n = fa[6].shape[0]
        (sck, pk), tk = _timed_launch(KS.exts2_fill, *fa)
        e = max(_max_err(sck, sc), 0 if _fingerprint(pk) == fp else 2**31)
        (cgk, nck), tb = _timed_launch(K.ksw2_backtrack, pk, *ba)
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc))
        if i in twin:
            k0, co = first[i], ba[4]
            p0 = int(fa[9][k0]) if k0 < n else fa[10]
            sc_t, p_t, cg_t, nc_t = twin[i]
            e = max(e, _max_err(sc_t, sc[k0:]), _max_err(p_t, pk[p0:]),
                    _max_err(cg_t, cig[int(co[k0]):]),
                    _max_err(nc_t, nc[k0:]))
        del pk
        if verbose and i < n_timed:
            rows, steps = _longest(calls[i])
            log(f"{label} launch {i}: {n} fills, "
                f"{int((fa[6].long() * fa[7].long()).sum())} cells; fill "
                f"{tk:.3f} ms, {rows} rows of the longest fill, "
                f"{tk * 1e3 / rows:.4f} µs per row; backtrack {tb:.3f} ms, "
                f"{steps} steps of the longest walk, "
                f"{tb * 1e3 / max(steps, 1):.4f} µs per step; max_abs_err "
                f"{e}" + ("" if i not in twin else
                          f" ({n - first[i]} fills held against the twins)"))
        err = max(err, e)
        if i < n_timed:
            fms, bms = fms + tk, bms + tb
    if verbose:
        n_twin = sum(calls[i][0][6].shape[0] - k0 for i, k0 in first.items())
        log(f"{label}: {n_timed} launches ({len(calls) - n_timed} more of "
            f"the splice workloads held with them, max_abs_err {err}); "
            f"twins (one run over {n_twin} fills of {len(first)} launches"
            + ("" if max_rows is None else
               f", every fill of at most {max_rows} rows")
            + f") fill {fpl:.3f} ms, backtrack {bpl:.3f} ms")
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
    from mm2_gb_tpu_torch.utils import opts as O
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
            r = hold_splice_calls(calls, "splice workloads", verbose=False,
                                  max_rows=TWIN_ROWS)
            out = [max(out[0], r[0])] + [a + b for a, b in zip(out[1:],
                                                                r[1:])]
            err = max(err, r[0])
    log(f"splice workloads of other options: kernel==twin "
        f"max_abs_err={err}; fill {out[1]:.3f} ms (twin {out[2]:.3f} ms), "
        f"backtrack {out[3]:.3f} ms (twin {out[4]:.3f} ms)")
    if err:
        fail("a splice workload launch differs from the twins")
    return err, groups.get(later, [])


# splice extension flags: the fills' splice variants (RIGHT and REV_CIGAR
# among them) without APPROX_MAX, KSW_EZ_EXTZ_ONLY on two in three
SPLICE_EXT_ZDROP = (200, 100, 40, -1)


def splice_ext_pairs(rng, n, max_intron, min_intron=60, q_min=20):
    """Seeded splice extensions (q, t, flag, junc, zdrop): a read end
    that runs from an exon across 1-2 introns (GT..AG, or GA..TG under
    KSW_EZ_REV_CIGAR) into the next exon, against the target from the
    anchor on, which goes on past the read's last base.  Extension k
    takes splice variant k % 8, KSW_EZ_EXTZ_ONLY unless k % 3 == 2, a
    Z-drop from SPLICE_EXT_ZDROP and kind (k // 8) % 6: spliced; with N
    bases; an unrelated query; a query whose tail is unrelated (a Z-drop
    hit at the tight Z-drops); indel-rich; one exon, no intron.  Odd
    extensions carry random BED junction bytes."""
    import numpy as np
    out = []
    for k in range(n):
        flag = SPLICE_VARIANTS[k % len(SPLICE_VARIANTS)] | (
            0x40 if k % 3 != 2 else 0)
        kind = (k // len(SPLICE_VARIANTS)) % 6
        rc = bool(flag & 0x80)
        exons = [rng.integers(0, 4, int(rng.integers(q_min, 300)))
                 .astype(np.uint8)
                 for _ in range(1 if kind == 5 else int(rng.integers(2, 4)))]
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
        parts.append(rng.integers(0, 4, int(rng.integers(1, 300)))
                     .astype(np.uint8))       # the target past the read
        t = np.concatenate(parts)
        q = np.concatenate(exons)
        # the read ends inside its last exon
        q = q[:max(1, q.shape[0] - int(rng.integers(0, exons[-1].shape[0])))]
        if kind == 2:
            q = rng.integers(0, 4, q.shape[0]).astype(np.uint8)
        else:
            q = _mutate_splice(rng, q, 0.03 if kind == 4 else 0.05,
                               0.08 if kind == 4 else 0.01)
        if kind == 3:
            h = min(exons[0].shape[0] // 2, q.shape[0])
            q[h:] = rng.integers(0, 4, q.shape[0] - h)
        if kind == 1:
            q[rng.random(q.shape[0]) < 0.03] = 4
            t[rng.random(t.shape[0]) < 0.03] = 4
        junc = (rng.integers(0, 16, t.shape[0]).astype(np.uint8) if k % 2
                else None)
        out.append((q, t, flag, junc,
                    SPLICE_EXT_ZDROP[(k // 3) % len(SPLICE_EXT_ZDROP)]))
    return out


def _pack_splice_ext(exts):
    """(meta, qblob, tblob, jblob, flags, zdrop) of (q, t, flag, junc,
    zdrop) extensions."""
    import numpy as np
    return (*_pack_splice([e[:4] for e in exts]),
            np.array([e[4] for e in exts], np.int64))


def splice_ext_workloads(n_pairs=24, max_intron=1000, long_intron=1000,
                         scratch=True):
    """(name, meta, qblob, tblob, jblob, flags, zdrop, params) of the
    splice extension checks: splice_ext_pairs under the splice and
    splice:hq presets; a junction bonus of 130, which wraps int8; targets
    past long_intron (tlen to a few kb); with `scratch`, a 1 kb read end
    across an intron (its state ring past the shared-memory cap, in global
    scratch); a matrix that fails the mat gate."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(4242)
    _io, mo = O.set_preset("splice")
    prm = KS.splice_params(mo)
    yield ("splice", *_pack_splice_ext(splice_ext_pairs(rng, n_pairs,
                                                        max_intron)), prm)
    _io, hq = O.set_preset("splice:hq")
    yield ("splice:hq", *_pack_splice_ext(splice_ext_pairs(
        rng, n_pairs, max_intron // 2)), KS.splice_params(hq))
    mat = ksw2.gen_simple_mat(5, mo.a, mo.b, mo.sc_ambi)
    yield ("junc_wrap", *_pack_splice_ext(splice_ext_pairs(
        rng, n_pairs // 2, max_intron // 2)),
        KS.splice_params_from(mat, 2, 1, 32, 9, 130))
    exts = splice_ext_pairs(rng, 8, long_intron, long_intron // 2)
    if scratch:
        ex = rng.integers(0, 4, (2, 520)).astype(np.uint8)
        intron = rng.integers(0, 4, 300).astype(np.uint8)
        intron[:2], intron[-2:] = (2, 3), (0, 2)
        t = np.concatenate([ex[0], intron, ex[1], ex[0][:100]])
        exts.append((_mutate_splice(rng, ex.reshape(-1), 0.05, 0.01),
                     t, 0x40 | 0x100, None, 200))
    yield "long", *_pack_splice_ext(exts), prm
    yield ("mat_gate", *_pack_splice_ext(splice_ext_pairs(rng, 8, 300)),
           KS.splice_params_from(ksw2.gen_simple_mat(5, 1, 40, 1), 2, 1, 32,
                                 9, 9))


def splice_ext_class_mix(seed):
    """(meta, qblob, tblob, jblob, flags, zdrop, params) of one splice
    extension launch over both of exts2_ext's classes: splice_ext_pairs'
    read ends across introns (every splice variant, RIGHT|REV_CIGAR,
    EXTZ_ONLY on two in three, BED junctions, N bases, unrelated tails
    under tight Z-drops), two in three of them cut to warp-class read
    ends (min(qlen, tlen) at most 176) and the rest blocks; and periodic
    and one-base pairs, whose H rows tie across the row maximum's rank
    classes."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import opts as O
    rng = np.random.default_rng(seed)
    exts = splice_ext_pairs(rng, 48, 600)
    for k in range(32):   # read ends cut short enough for a warp
        q, t, flag, junc, zdrop = exts[k]
        exts[k] = (q[:int(rng.integers(40, 170))].copy(), t, flag, junc,
                   zdrop)
    unit = np.array([0, 1, 2, 3], np.uint8)
    for k, (q, t) in enumerate(((np.tile(unit, 30), np.tile(unit, 70)),
                                (np.tile(unit[:2], 45),
                                 np.tile(unit[:2], 120)),
                                (np.full(40, 1, np.uint8),
                                 np.full(100, 1, np.uint8)))):
        exts.append((q, t, SPLICE_VARIANTS[2 * k] | 0x40, None, 200))
    return (*_pack_splice_ext(exts),
            KS.splice_params(O.set_preset("splice")[1]))


def splice_ext_oracle(meta, qblob, tblob, jblob, flags, zdrop, prm,
                      exts2=None):
    """exts2 (the port's ksw2_splice.exts2 unless given) of every
    extension: (fields [n, 10], cig_off, cig_blob)."""
    import numpy as np
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2_splice
    exts2 = exts2 or ksw2_splice.exts2
    n = meta.shape[0]
    qo, to, jo = (np.concatenate([[0], np.cumsum(meta[:, c])])
                  for c in range(3))
    fields, cigs = np.zeros((n, len(K.EXT_FIELDS)), np.int32), []
    for k in range(n):
        ez = exts2(
            qblob[qo[k]:qo[k + 1]], tblob[to[k]:to[k + 1]], prm.mat, prm.q,
            prm.e, prm.q2, prm.noncan, int(zdrop[k]), prm.junc_bonus,
            int(flags[k]), jblob[jo[k]:jo[k + 1]] if meta[k, 2] else None)
        fields[k] = [int(getattr(ez, f)) for f in K.EXT_FIELDS]
        cigs.append(ez.cigar)
    off = np.concatenate([[0], np.cumsum([c.shape[0] for c in cigs])])
    return fields, off, (np.concatenate(cigs).astype(np.uint32) if cigs
                         else np.empty(0, np.uint32))


@contextlib.contextmanager
def recording_splice_ext():
    """Record every exts2_ext call made by exts2_ext_batch inside and the
    backtrack from its starts (the wrappers still count their launches):
    a list of [ext args, ext, fingerprint of p, backtrack args without p,
    cig, n_cig]."""
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    calls, ext, bt = [], KS.exts2_ext, KS.ksw2_backtrack

    def rec_ext(*a, **kw):
        e, p = ext(*a, **kw)
        calls.append([a, e, _fingerprint(p)])
        return e, p

    def rec_bt(*a, **kw):
        cig, nc = bt(*a, **kw)
        calls[-1] += [a[1:], cig, nc]
        return cig, nc
    KS.exts2_ext, KS.ksw2_backtrack = rec_ext, rec_bt
    try:
        yield calls
    finally:
        KS.exts2_ext, KS.ksw2_backtrack = ext, bt


def hold_splice_ext_calls(calls, label, verbose=True, max_rows=None):
    """Recorded exts2_ext + backtrack launches of one option set against
    the twins: one run of each twin over the extensions of all launches
    (the twins take per-fill flags and Z-drops), then each launch re-run
    on its recorded operands: its p must match the recorded fingerprint
    and its slice of the twin's p, its ext rows the recorded and the
    twin's, and both backtracks from its starts the recorded words.  With
    max_rows, launches whose longest extension has more rows are re-run
    and held against their recorded results alone.  Returns (max_abs_err,
    ext ms and backtrack ms summed over the launches, the twins' ms: ext
    ms, ext twin ms, backtrack ms, backtrack twin ms)."""
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    if not calls:
        return 0, 0.0, 0.0, 0.0, 0.0
    held = [i for i, c in enumerate(calls)
            if max_rows is None or int((c[0][6] + c[0][7]).max()) <= max_rows]
    twin, fpl, bpl = {}, 0.0, 0.0
    if held:
        fa_all, ba_all, bases = _merge_splice_calls([calls[i] for i in held],
                                                    ext=True)
        (e_t, p_t), fpl = _timed(KS.exts2_ext_torch, *fa_all)
        (cg_t, nc_t), bpl = _timed(
            lambda *a: K.ksw2_backtrack_torch(*a, starts=e_t[:, 10:]), p_t,
            *ba_all)
        for i, (f0, p0, c0) in zip(held, bases):
            fa, cig = calls[i][0], calls[i][4]
            n = fa[6].shape[0]
            twin[i] = (e_t[f0:f0 + n], p_t[p0:p0 + fa[11]],
                       cg_t[c0:c0 + cig.shape[0]], nc_t[f0:f0 + n])
    err, fms, bms = 0, 0.0, 0.0
    for i, (fa, ek0, fp, ba, cig, nc) in enumerate(calls):
        n = fa[6].shape[0]
        (ek, pk), tk = _timed_launch(KS.exts2_ext, *fa)
        e = max(_max_err(ek, ek0), 0 if _fingerprint(pk) == fp else 2**31)
        (cgk, nck), tb = _timed_launch(K.ksw2_backtrack, pk, *ba,
                                       starts=ek[:, 10:])
        e = max(e, _max_err(cgk, cig), _max_err(nck, nc))
        if i in twin:
            e_t, p_t, cg_t, nc_t = twin[i]
            e = max(e, _max_err(e_t, ek0), _max_err(p_t, pk),
                    _max_err(cg_t, cig), _max_err(nc_t, nc))
        del pk
        if verbose:
            log(f"{label} launch {i}: {n} extensions, "
                f"{int((fa[6].long() * fa[7].long()).sum())} cells; ext "
                f"{tk:.3f} ms, backtrack {tb:.3f} ms; max_abs_err {e}")
        err = max(err, e)
        fms, bms = fms + tk, bms + tb
    if verbose:
        log(f"{label}: {len(calls)} launches, "
            f"{sum(calls[i][0][6].shape[0] for i in held)} extensions through "
            f"the twins (one run) ext {fpl:.3f} ms, backtrack {bpl:.3f} ms")
    return err, fms, fpl, bms, bpl


def phase2_splice_ext():
    """The exts2 kernel's extension mode and the intron backtrack from its
    starts against their twins and ksw2_splice.exts2 (the native kit
    here) on the splice extension workloads and on one launch of both
    kernel classes (splice_ext_class_mix); exact.  The launches of one
    option set go through one twin run."""
    import torch
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    dev = torch.device("cuda")
    groups = {}
    for name, meta, qb, tb, jb, fl, zd, prm in [
            *splice_ext_workloads(), ("mix", *splice_ext_class_mix(909))]:
        st = KS.FillStats()
        with recording_splice_ext() as calls:
            got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, dev, st)
        e_or = ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl,
                                                     zd, prm))
        log(f"splice ext {name}: {st.ext_fills} extensions "
            f"({st.ext_host_fills} host-routed, {st.scratch_fills} with the "
            f"ring in global scratch), {int(got[0][:, 8].sum())} Z-dropped, "
            f"longest tlen {int(meta[:, 1].max())}, {len(calls)} launches; "
            f"batch==ksw2_splice.exts2 max_abs_err={e_or}")
        if e_or:
            fail(f"splice ext workload {name} disagrees with the oracle")
        if name == "mat_gate" and st.ext_host_fills != st.ext_fills:
            fail("the mat gate did not route every splice extension to the "
                 "host")
        if name != "mat_gate" and st.ext_host_fills:
            fail(f"splice ext workload {name}: extensions on the host")
        if name == "long" and not st.scratch_fills:
            fail("no splice extension took the global-scratch ring")
        if name == "splice" and not got[0][:, 8].any():
            fail("no splice extension hit its Z-drop")
        groups.setdefault(_params_key(prm), []).extend(calls)
    out = [0, 0.0, 0.0, 0.0, 0.0]
    for calls in groups.values():
        r = hold_splice_ext_calls(calls, "splice ext workloads",
                                  verbose=False, max_rows=TWIN_ROWS)
        out = [max(out[0], r[0])] + [a + b for a, b in zip(out[1:], r[1:])]
    log(f"splice ext workloads: kernel==twin max_abs_err={out[0]}; ext "
        f"{out[1]:.3f} ms (twin {out[2]:.3f} ms), backtrack {out[3]:.3f} ms "
        f"(twin {out[4]:.3f} ms)")
    if out[0]:
        fail("a splice ext workload launch differs from the twins")
    return out[0]


def _cli(main, argv):
    """Run a CLI entry point in this process; (rc, stdout, stderr, wall)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


# a -c script's import of the JAX package (not of mm2_gb_tpu_torch)
_JAX_IMPORT = re.compile(r"(?:^|[\s;])(?:import|from)\s+mm2_gb_tpu(?!\w)")


def _host(args, what):
    """Run Python with args in a subprocess (the port's host route,
    PORT_HOST, or a module of the port): stdout.  An argv that names the
    JAX package as a module to run (-m) or imports it in a -c script
    fails the smoke: the card's machine need not have it."""
    for flag, val in zip(args, args[1:]):
        if (flag == "-m" and val.partition(".")[0] == "mm2_gb_tpu"
                or flag == "-c" and _JAX_IMPORT.search(val)):
            fail(f"{what}: the run would start the JAX package")
    p = subprocess.run([sys.executable, *args], cwd=REPO, text=True,
                       capture_output=True, timeout=600)
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-3000:])
        fail(what)
    return p.stdout


def flowcell(n_reads=N_READS):
    """(ref, reads) of the bench flowcell's first n_reads reads, generated
    from its seeds (written once under WORK)."""
    from mm2_gb_tpu_torch.utils.simulate import materialize_flowcell
    return materialize_flowcell(n_reads, WORK)


def phase3():
    """End to end; returns the chain-only flowcell run's launches and the
    chain kernel calls it made, as (args, kwargs, f, p), then the
    --gpu-align flowcell run's fill and backtrack launches and its
    recorded fill calls, and the two runs' outputs (equal to the host
    path's) and walls."""
    import numpy as np
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
    host_out = _host([*PORT_HOST[1:], SKIP_INF, "-t", str(THREADS), ref,
                      reads], "host path on the flowcell")
    log(f"flowcell host path (-t {THREADS}, subprocess): "
        f"{time.perf_counter() - t0:.3f} s, {host_out.count(chr(10))} lines")

    # keep every kernel call of the main path for phase 4; the wrapper
    # itself still counts the launches
    with recording_chain() as batches:
        G.launches = 0           # the chain path's run counted in the JSON
        rc, out, err, gpu_wall = _cli(cli.main, [
            "--gpu-chain", SKIP_INF, "-t", str(THREADS), ref, reads])
        launches = G.launches
    calls = [c for _b, c in batches if c is not None]
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
    host_c = _host([*PORT_HOST[1:], SKIP_INF, "-c", "-t", str(THREADS),
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
    ql, tl = (np.concatenate([c[0][k].cpu().numpy() for c in fcalls])
              for k in (4, 5))
    moved = ((K.fill_bytes(ql, tl) > K.WARP_FILL_MAX)
             & ((tl + 15) // 16 * 16 <= K.WARP_LANES))
    log(f"flowcell -c fills narrow enough for a warp whose state passes "
        f"WARP_FILL_MAX (a block for their query): {int(moved.sum())} of "
        f"{ql.shape[0]}; longest query {int(ql.max())}")
    return (launches, calls, align_launches, fcalls,
            {"chain": (host_out, gpu_wall), "align": (host_c, wall)})


TIMELINE_MARKS = ("index build start", "index built", "mapping start",
                  "mapping done", "exit")


def phase3_timeline(paf):
    """`MM2TPU_TIMELINE=1 python -m mm2_gb_tpu_torch --gpu-chain
    --gpu-align -c -t 8` on the flowcell in a subprocess: its stdout
    must equal the in-process run's (paf), and its stderr must hold the
    phase marks in order.  Prints the seconds since the process started
    at each mark beside the card's name and power limit, and the wall's
    split into start-up (interpreter, imports), index build, CUDA
    start-up and batch caps, mapping and exit."""
    ref, reads = flowcell()
    env = dict(os.environ, MM2TPU_TIMELINE="1")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, *PORT, "--gpu-chain", "--gpu-align",
                        "-c", ref, reads], cwd=REPO, env=env, text=True,
                       capture_output=True, timeout=600)
    wall = time.perf_counter() - t0
    marks = re.findall(r"^\[T::\s*([0-9.]+)s\] (.+)$", p.stderr, re.M)
    got = [m for _t, m in marks]
    at = {m: float(t) for t, m in marks}
    if p.returncode != 0 or got != list(TIMELINE_MARKS):
        sys.stderr.write(p.stderr[-3000:])
        fail(f"timeline run: rc {p.returncode}, marks {got}")
    same = p.stdout == paf
    print("timeline (" + CARD + "): " + ", ".join(
        f"{m} {at[m]:.2f} s" for m in TIMELINE_MARKS) + "; split: start-up "
        f"{at['index build start']:.2f} s, index build "
        f"{at['index built'] - at['index build start']:.2f} s, CUDA "
        f"start-up and caps {at['mapping start'] - at['index built']:.2f} "
        f"s, mapping {at['mapping done'] - at['mapping start']:.2f} s, exit "
        f"{at['exit'] - at['mapping done']:.2f} s; wall {wall:.2f} s; "
        f"stdout byte-identical to the in-process run {same}", flush=True)
    if not same:
        fail("the timeline run's stdout differs from the in-process run's")


def phase3_api(paf, n_reads=N_API):
    """The Python API (mm2_gb_tpu_torch.api) on the card, on the
    flowcell's first n_reads reads: each read maps through the device
    pipeline (the chain, fill and backtrack kernels, whose counts must
    grow), and its primary hits (ctg, r_st, r_en, strand, q_st, q_en,
    mapq, NM, mlen, blen, CIGAR) must equal its tp:A:P and tp:A:I lines
    of the card's --gpu-align -c PAF (paf).  The host route
    (device="cpu", the JAX package's host path) maps the same reads for
    its time.  Then two threads map the same reads through the one card
    Aligner at once; each thread's hits must equal the single thread's.
    Then four threads map a quarter of the reads each on the host route,
    under the API's route lock and under a plain lock in its place, for
    the lock's cost; every hit must equal the single thread's."""
    from concurrent.futures import ThreadPoolExecutor

    import mm2_gb_tpu_torch.api as mp
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    want = {}
    for line in paf.splitlines():
        t = line.split("\t")
        tags = {x[:2]: x[5:] for x in t[12:]}
        if tags["tp"] in ("P", "I"):
            want.setdefault(t[0], []).append((
                t[5], int(t[7]), int(t[8]), 1 if t[4] == "+" else -1,
                int(t[2]), int(t[3]), int(t[11]), int(tags["NM"]),
                int(t[9]), int(t[10]), tags["cg"]))
    reads = []
    for name, seq, _qual in mp.fastx_read(flowcell()[1]):
        if len(reads) == n_reads:
            break
        reads.append((name, seq))

    def map_all(a, reads=reads):
        return {name: [(h.ctg, h.r_st, h.r_en, h.strand, h.q_st, h.q_en,
                        h.mapq, h.NM, h.mlen, h.blen, h.cigar_str)
                       for h in a.map(seq) if h.is_primary]
                for name, seq in reads}
    walls = {}
    for device in ("cuda", "cpu"):
        a = mp.Aligner(flowcell()[0], preset="map-ont", device=device)
        a.map_opt.max_chain_skip = 2**31 - 1
        G.launches = K.fill_launches = K.backtrack_launches = 0
        t0 = time.perf_counter()
        got = map_all(a)
        walls[device] = time.perf_counter() - t0
        counts = (G.launches, K.fill_launches, K.backtrack_launches)
        if device == "cuda":
            on_card, card_counts, card = got, counts, a
        elif any(counts):
            fail(f"the API's host route launched kernels: {counts}")
    bad = [n for n, _s in reads if on_card[n] != want.get(n, [])]
    for n in bad[:3]:
        log(f"API {n}: {on_card[n][:2]} against the PAF's "
            f"{want.get(n, [])[:2]}")
    n_hits = sum(map(len, on_card.values()))
    host_bad = sum(got[n] != on_card[n] for n, _s in reads)
    # two threads through the one card Aligner: its maps take turns
    # under the API's route lock, and each thread's hits must be the
    # single thread's
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(map_all, card) for _ in range(2)]
        two = [f.result(timeout=600) for f in futs]
    walls["two"] = time.perf_counter() - t0
    two_bad = sum(g[n] != on_card[n] for g in two for n, _s in reads)
    # four host-route threads, a quarter of the reads each, under the
    # API's route lock (host maps share it) and under a plain lock in
    # its place (they take turns), in turns A, B, B, A: the lock's cost
    host_walls, host_bad_threads = {"route": [], "plain": []}, 0
    route_lock = mp._ROUTE_LOCK
    plain = types.SimpleNamespace(held=lambda sole, lk=threading.Lock(): lk)
    for name in ("route", "plain", "plain", "route"):
        mp._ROUTE_LOCK = route_lock if name == "route" else plain
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(max_workers=4) as ex:
                part = [ex.submit(map_all, a, reads[i::4]) for i in range(4)]
                parts = [f.result(timeout=600) for f in part]
        finally:
            mp._ROUTE_LOCK = route_lock
        host_walls[name].append(time.perf_counter() - t0)
        host_bad_threads += sum(g[n] != got[n] for g in parts for n in g)
    log(f"API on the card ({CARD}): {len(reads)} reads, {n_hits} primary "
        f"hits, {walls['cuda']:.2f} s (host route {walls['cpu']:.2f} s); "
        f"chain, fill, backtrack launches {card_counts}; reads whose hits "
        f"differ from the card's -c PAF: {len(bad)}, from the host "
        f"route: {host_bad}; two threads through one card Aligner "
        f"{walls['two']:.2f} s, reads whose hits differ from the single "
        f"thread's: {two_bad} of {2 * len(reads)}")
    log(f"API host route, four threads over the {len(reads)} reads "
        f"(turns A, B, B, A): under the route lock "
        f"{', '.join(f'{w:.3f}' for w in host_walls['route'])} s, under a "
        f"plain lock {', '.join(f'{w:.3f}' for w in host_walls['plain'])} "
        f"s; reads whose hits differ from one thread's: {host_bad_threads}")
    if (bad or host_bad or two_bad or host_bad_threads
            or n_hits < len(reads) or min(card_counts) == 0):
        fail("the Python API on the card")


def phase3_long_inserts(inserts=(30_000, 61_000),
                        extra=("-r", "500,80000", "-v", "3")):
    """--gpu-chain --gpu-align -c with a wide long join (-r 500,80000) on
    reads with a 30 kb and a 61 kb insert (insertion_run): the long
    joins make gap fills of ~30,200 and ~61,200 query bases beside ~200
    target bases in one launch, the first of which would take a warp by
    its width alone and put the launch past the shared memory a block
    may have.  The run must equal the host path, with fill launches, and
    every launch within the block's and FILL_SMEM_MAX's rule.  Prints
    the fill kernel's time from the run's `[M::gpu] fills:` line."""
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    K.fill_launches = K.backtrack_launches = 0
    dev, host, shapes = insertion_run(inserts, list(extra),
                                      torch.device("cuda"))
    counts = (K.fill_launches, K.backtrack_launches)
    ok = all(sh.smem <= 232_448 and K.FILL_WARPS * sh.warp_stride
             <= K.FILL_SMEM_MAX for _q, _t, sh in shapes)
    old = max(warp_rule_shape(q, t).smem for q, t, _sh in shapes)
    widest = max((int(q[i]), int(t[i])) for q, t, _sh in shapes
                 for i in range(q.shape[0])
                 if (t[i] + 15) // 16 * 16 <= K.WARP_LANES)
    same = dev[1] == host[1]
    smem = max(sh.smem for _q, _t, sh in shapes)
    kms = re.search(r"fill kernel ([0-9.]+) ms", dev[2])
    log(f"long inserts {' '.join(extra)} ({'+'.join(map(str, inserts))} "
        f"bp): rc {dev[0]}/{host[0]}, {dev[3]:.2f} s on the card, fill and "
        f"backtrack launches {counts}, fill kernel "
        f"{kms.group(1) if kms else None} ms; the narrow fill of the longest query "
        f"{widest[0]} x {widest[1]}; largest smem {smem} B (by width "
        f"alone {old} B); byte-identical to the host path {same}")
    if dev[0] or host[0] or not same or not ok or min(counts) == 0:
        sys.stderr.write(dev[2][-3000:])
        fail("the long-insert mapping run")


def ultralong(n_reads=N_ULTRALONG):
    """(ref, reads) FASTA paths of the ultra-long set's first n_reads
    reads (simulate.materialize_ultralong: seeds 11 and 12, an 8 Mbp
    reference with 60 planted tandem arrays and N_ULTRALONG reads of
    100-300 kb), written once under WORK."""
    from mm2_gb_tpu_torch.utils.simulate import materialize_ultralong
    ref, reads = materialize_ultralong(N_ULTRALONG, WORK)
    if n_reads == N_ULTRALONG:
        return ref, reads
    path = os.path.join(os.path.dirname(reads), f"reads{n_reads}.fa")
    if not os.path.exists(path):
        with open(reads) as f:   # a header line and a sequence line a read
            lines = f.read().split("\n")[:2 * n_reads]
        with open(path + ".tmp", "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(path + ".tmp", path)
    return ref, path


ORACLE_KEYS = ("max_dist_x", "max_dist_y", "bw", "max_iter", "cg", "cs",
               "is_cdna")


@contextlib.contextmanager
def recording_chain():
    """Record every batch that dispatch_scores chains inside, and the
    chain_segments launch it made (the wrapper still counts it): a list
    of [(ax, ay, read bounds, the oracle's parameters), (args, kw, f, p)
    or None for a batch without a launch].  The batches are dispatched
    from one worker thread, one after another."""
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    batches, dispatch, chain = [], G.dispatch_scores, G.chain_segments

    def rec_chain(*a, **kw):
        f, p = chain(*a, **kw)
        batches[-1][1] = (a, kw, f, p)
        return f, p

    def rec_dispatch(ax, ay, bounds, **kw):
        batches.append([(ax, ay, bounds, {k: kw[k] for k in ORACLE_KEYS}),
                        None])
        return dispatch(ax, ay, bounds, **kw)
    G.dispatch_scores, G.chain_segments = rec_dispatch, rec_chain
    try:
        yield batches
    finally:
        G.dispatch_scores, G.chain_segments = dispatch, chain


def hold_chain_oracle(batches):
    """Each recorded batch's chain launch against the host oracle
    (chain_gpu.chain_scores_host, the port's native chain_dp at max_skip
    = 2**31 - 1), read by read, on THREADS threads: f equal, and p (a
    distance, 0 for none) equal to the oracle's predecessor turned into
    a distance; tolerance 0.  (max_abs_err, anchors held, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def one(ax, ay, prm, f, p):
        fo, po = G.chain_scores_host(ax, ay, *(prm[k] for k in ORACLE_KEYS))
        d = np.where(po >= 0, np.arange(po.shape[0]) - po, 0)
        return max(int(np.abs(f - fo).max(initial=0)),
                   int(np.abs(p - d).max(initial=0)))
    futs, n = [], 0
    with ThreadPoolExecutor(max_workers=THREADS) as ex:
        for (ax, ay, rb, prm), call in batches:
            if call is None:
                continue
            f, p = (t.cpu().numpy().astype(np.int64) for t in call[2:4])
            for s, e in zip(rb[:-1].tolist(), rb[1:].tolist()):
                if e > s:
                    futs.append(ex.submit(one, ax[s:e], ay[s:e], prm,
                                          f[s:e], p[s:e]))
            n += int(rb[-1])
        err = max((fu.result() for fu in futs), default=0)
    return err, n, time.perf_counter() - t0


def hold_longest_global(calls):
    """The longest segment of the recorded chain launches that read its
    window from global memory (block_global), alone: the twin
    (chain_segments_torch) on the host's copy of the launch's operands
    (its one serial step an anchor costs less there than on the card's
    stream), and the kernel in a launch of that segment alone, both
    against the launch's recorded (f, p) over the segment; exact.
    Returns (max_abs_err, anchors, widest range, twin s, kernel ms)."""
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    best = None
    for i, (_args, kw, _f, _p) in enumerate(calls):
        sh = kw["shape"]
        w = sh.work[:sh.n_long].cpu().numpy()
        g = w[w[:, 3] == 0]
        if g.shape[0]:
            k = int(np.argmax(g[:, 1] - g[:, 0]))
            if best is None or g[k, 1] - g[k, 0] > best[0]:
                best = (int(g[k, 1] - g[k, 0]), i, g[k])
    if best is None:
        fail("no block_global segment among the recorded chain launches")
    n, i, (s, e, wide, _ring) = best
    args, kw, f, p = calls[i]
    prm = {k: v for k, v in kw.items() if k not in ("events", "shape")}

    def seg(dev):
        return (torch.tensor([s], dtype=torch.int32, device=dev),
                torch.tensor([e], dtype=torch.int32, device=dev))
    host = [a.cpu() for a in args[:3]]
    t0 = time.perf_counter()
    ft, pt = G.chain_segments_torch(*host, *seg("cpu"), **prm)
    t_twin = time.perf_counter() - t0
    ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
    fk, pk = G.chain_segments(*args[:3], *seg(args[0].device), events=ev,
                              **prm)
    torch.cuda.synchronize()
    fr, pr = f[s:e].cpu(), p[s:e].cpu()
    err = max(_max_err(ft[s:e], fr), _max_err(pt[s:e], pr),
              _max_err(fk[s:e].cpu(), fr), _max_err(pk[s:e].cpu(), pr))
    return err, n, int(wide), t_twin, ev[0].elapsed_time(ev[1])


def _gpu_fields(err, what):
    """The -v 3 `[M::gpu]` fields of a run's stderr (e2ebench's parser)."""
    from mm2_gb_tpu_torch.utils import e2ebench
    fields = e2ebench.parse_gpu_report(err)
    if "anchors" not in fields:
        sys.stderr.write(err[-3000:])
        fail(f"no device metrics report from {what}")
    return fields


def card_chain_run(label, flags, ref, reads, card_flags=(), rmq=False):
    """One `--gpu-chain` run on the card through cli.main in this process
    (flags and card_flags, -t THREADS -v 3, ref, reads) against the
    port's host route (PORT_HOST, a subprocess) at flags, byte for byte
    (SAM but its @PG line), with every chain batch and launch recorded
    (recording_chain), and every fill and backtrack launch where the
    flags align with --gpu-align (recording_fills).  Logs the run's
    reads, anchors, segments, batches, launches, host-routed batches,
    work segments per class, chain kernel time and pairs, the
    allocator's peak per anchor of the largest batch and both walls,
    beside the card's name and power limit.  Fails if the run exits
    non-zero or differs from the host route, and, unless rmq, if it
    launched no chain kernel or launched without recording, or if a
    batch went to the host (HPC or RMQ); with rmq (RMQ chaining, --rmq
    or an asm preset) if a batch did not go to the host by RMQ or a
    chain kernel was launched.  A --gpu-cfg among card_flags holds for
    this run alone.  Returns a namespace: out, host_s, wall, m (the
    `-v 3` report), batches, calls (the recorded chain launches [(args,
    kw, f, p)]), classes (work segments per class), peak (allocator
    bytes above what was held before the run), big (the largest
    batch's anchors, 0 without a launch), launches, fcalls (the
    recorded fill + backtrack launches), fill_classes (their fills per
    class: warp, block, scratch), fill_launches and
    backtrack_launches."""
    from collections import Counter
    from types import SimpleNamespace

    import torch
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import e2ebench, gpucfg
    t0 = time.perf_counter()
    host = _host([*PORT_HOST[1:], SKIP_INF, *flags, "-t", str(THREADS),
                  ref, reads], f"host path on {label}")
    host_s = time.perf_counter() - t0
    # --gpu-cfg installs its caps for the process: restored after the run
    saved = gpucfg.current_config()
    classes0 = Counter(G.launch_classes)
    fclasses0 = Counter(K.launch_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # earlier phases' tensors
    try:
        with recording_chain() as batches, recording_fills() as fcalls:
            G.launches = K.fill_launches = K.backtrack_launches = 0
            rc, out, err, wall = _cli(cli.main, [
                "--gpu-chain", SKIP_INF, *flags, *card_flags, "-t",
                str(THREADS), "-v", "3", ref, reads])
            launches = G.launches
            fills = (K.fill_launches, K.backtrack_launches)
    finally:
        gpucfg.apply_gpu_config(saved)
    peak = torch.cuda.max_memory_allocated() - held
    classes = {c: n for (k, c), n in (G.launch_classes - classes0).items()
               if k == "chain_segments"}
    fill_classes = {c: n for (k, c), n in (K.launch_classes
                                           - fclasses0).items()
                    if k == "extd2_fill"}
    if rc != 0:
        sys.stderr.write(err[-3000:])
        fail(f"--gpu-chain on {label}")
    m = _gpu_fields(err, f"the --gpu-chain run on {label}")
    calls = [c for _b, c in batches if c is not None]
    big = max((b[0][0].shape[0] for b in batches), default=0)
    same = e2ebench._no_pg(out) == e2ebench._no_pg(host)
    log(f"{label} --gpu-chain ({CARD}; -t {THREADS}, in process): "
        f"{wall:.3f} s (host route {host_s:.3f} s, a subprocess, "
        f"{host.count(chr(10))} lines), {m['reads']} reads, "
        f"{m['anchors']} anchors, {m['segments']} segments "
        f"({m['segments'] / max(m['reads'], 1):.1f} per read) in "
        f"{m['batches']} chain batches ({m['cap_split']} cap-split, largest "
        f"launched {big} anchors), launches {launches}, host-routed batches "
        f"{m['host_hpc_batches']} HPC, {m['host_rmq_batches']} RMQ; work "
        f"segments per class "
        + ", ".join(f"{c} {classes.get(c, 0)}" for c in
                    ("warp", "group", "block", "block_global"))
        + f"; chain kernel {m['chain_kernel_s'] * 1e3:.3f} ms over "
        f"{m['pairs']} pairs ({m['chain_gpairs_s']:.3f} Gpairs/s); "
        f"allocator peak {peak} B above what was held before the run"
        + (f" ({peak / big:.1f} B per anchor of the largest batch; "
           f"BYTES_PER_ANCHOR {gpucfg.BYTES_PER_ANCHOR})" if big else "")
        + f"; fill and backtrack "
        f"launches {fills}; byte-identical to the host path"
        f"{' but @PG' if out.startswith('@') else ''} {same}")
    if rmq:
        bad = (launches or calls or m["host_hpc_batches"]
               or m["host_rmq_batches"] != m["batches"])
    else:
        bad = (launches == 0 or len(calls) != launches
               or m["host_hpc_batches"] or m["host_rmq_batches"])
    if not same or bad or len(fcalls) != fills[0]:
        fail(f"the --gpu-chain run on {label}")
    return SimpleNamespace(out=out, host_s=host_s, wall=wall, m=m,
                           batches=batches, calls=calls, classes=classes,
                           peak=peak, big=big, launches=launches,
                           fcalls=fcalls, fill_classes=fill_classes,
                           fill_launches=fills[0],
                           backtrack_launches=fills[1])


def phase3_ultralong():
    """The over50k path: the ultra-long set (ultralong()) mapped on the
    card, against the port's host route (PORT_HOST, a subprocess) at the
    same flags, byte for byte:

    - all N_ULTRALONG reads at `-x map-ont --gpu-chain -t 8 --gpu-cfg
      configs/h100_over50k.json -v 3` (card_chain_run); at least one
      segment of the run must read its window from global memory
      (block_global);
    - the first N_ULTRALONG_C reads at `--gpu-chain --gpu-align -c`.

    Every chain launch of both runs is held against the host oracle
    (hold_chain_oracle) and re-run on its recorded operands
    (hold_chain_calls); the longest block_global segment against the
    twin alone (hold_longest_global); the -c run's fill and backtrack
    launches against the twins (hold_fill_calls).  Prints the anchors,
    batches, segments per class, the longest segment's anchors and
    widest range, each launch's ms, pairs and rate, spills, the
    allocator's peak, and the -c run's fills, cells, scratch and
    host-routed fills and largest fill shapes, beside the card's name
    and power limit, and the chain launches' record as a JSON line.
    Returns {"chain": (launches, the recorded launches [(args, kw, f,
    p)], max_abs_err, kernel ms), "fills": the recorded fill launches, "fill": (launches,
    max_abs_err, ms, twin ms), "backtrack": (launches, ms, twin ms)}."""
    import numpy as np
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import gpucfg
    ref, reads = ultralong()
    reads_c = ultralong(N_ULTRALONG_C)[1]
    cfg = os.path.join(gpucfg.CONFIG_DIR, "h100_over50k.json")
    r = card_chain_run("ultra-long -x map-ont --gpu-cfg h100_over50k.json",
                       ["-x", "map-ont"], ref, reads, ["--gpu-cfg", cfg])
    launches, batches, calls, classes = (r.launches, r.batches, r.calls,
                                         r.classes)
    t0 = time.perf_counter()
    host_c = _host([*PORT_HOST[1:], SKIP_INF, "-c", "-t", str(THREADS),
                    ref, reads_c], "host path -c on the ultra-long set")
    log(f"ultra-long host path -c (-t {THREADS}, subprocess): "
        f"{N_ULTRALONG_C} reads {time.perf_counter() - t0:.3f} s, "
        f"{host_c.count(chr(10))} lines")

    ql = tl = np.zeros(0, np.int64)
    G.launches = K.fill_launches = K.backtrack_launches = 0
    with recording_fills() as fcalls, recording_chain() as cbatches:
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "-c", "-t", str(THREADS),
            "-v", "3", ref, reads_c])
        counts = (G.launches, K.fill_launches, K.backtrack_launches)
    if rc != 0:
        sys.stderr.write(err[-3000:])
        fail("--gpu-chain --gpu-align -c on the ultra-long set")
    fm = _gpu_fields(err, "the ultra-long -c run")
    if fcalls:
        ql, tl = (np.concatenate([c[0][k].cpu().numpy() for c in fcalls])
                  .astype(np.int64) for k in (4, 5))
    top = np.argsort(-(ql + tl), kind="stable")[:3]
    narrow = np.nonzero((tl + 15) // 16 * 16 <= K.WARP_LANES)[0]
    nq = (int(narrow[np.argmax(ql[narrow])]) if narrow.shape[0] else None)
    need = K.fill_bytes(ql, tl)
    same = out == host_c
    log(f"ultra-long {N_ULTRALONG_C} reads --gpu-chain --gpu-align -c "
        f"({CARD}; -t {THREADS}, in process): {wall:.3f} s, "
        f"{fm['anchors']} anchors in {fm['batches']} chain batches; fills "
        f"{fm.get('fills', 0)} ({fm.get('fills_host_routed', 0)} "
        f"host-routed), {fm.get('fill_cells', 0)} cells, "
        f"{fm.get('scratch_fills', 0)} with state in global scratch, fill "
        f"kernel {fm.get('fill_kernel_ms', 0.0)} ms, backtrack kernel "
        f"{fm.get('backtrack_ms', 0.0)} ms, collect "
        f"{fm.get('collect_s', 0.0)} s; chain, fill, backtrack launches "
        f"{counts}; largest fills (query x target) "
        + ", ".join(f"{int(ql[k])} x {int(tl[k])}" for k in top)
        + ("" if nq is None else
           f"; the narrow fill of the longest query {int(ql[nq])} x "
           f"{int(tl[nq])}")
        + f"; fills past WARP_FILL_MAX {int((need > K.WARP_FILL_MAX).sum())},"
        f" past FILL_SMEM_MAX {int((need > K.FILL_SMEM_MAX).sum())}; "
        f"byte-identical to the host path {same}")
    ccalls = [c for _b, c in cbatches if c is not None]
    if (not same or min(counts) == 0 or fm.get("fills_host_routed")
            or len(ccalls) != counts[0] or len(fcalls) != counts[1]):
        fail("the ultra-long --gpu-align -c run")

    e_or, n_or, t_or = hold_chain_oracle(batches + cbatches)
    log(f"ultra-long chain launches == chain_scores_host: {len(calls)} + "
        f"{len(ccalls)} launches, {n_or} anchors, max_abs_err {e_or} "
        f"({t_or:.1f} s on {THREADS} threads)")
    calls += ccalls
    e_k, ms, _ = hold_chain_calls(calls, "ultra-long")
    b_ms, b_by = chain_bound(calls)
    log(f"ultra-long chain launches ({CARD}): kernel {ms:.3f} ms over "
        f"{len(calls)} launches (median of {KERNEL_REPS} each); bound "
        f"{b_ms:.4f} ms by {b_by}")
    if not classes.get("block_global"):
        fail("no segment of the ultra-long --gpu-chain run read its window "
             "from global memory (block_global); the widest ranges are in "
             "the launch lines above")
    e_tw, n_tw, wide, t_tw, k_tw = hold_longest_global(calls)
    log(f"ultra-long longest block_global segment ({CARD}): {n_tw} anchors, "
        f"widest range {wide}; twin on the host {t_tw:.1f} s, kernel on it "
        f"alone {k_tw:.3f} ms ({k_tw * 1e3 / n_tw:.4f} µs per step); "
        f"max_abs_err {e_tw}")
    fe, fms, fpl, bms, bpl = hold_fill_calls(fcalls, "ultra-long fill")
    err = max(e_or, e_k, e_tw)
    # the ultra-long chain launches alone, beside the kernels line's
    # chain_segments entry that sums them with the flowcell's
    print(json.dumps({"ultralong_chain": {
        "card": CARD, "launches": len(calls), "max_abs_err": err, "ms": ms,
        "bound_ms": b_ms, "bound_by": b_by, "longest_global_anchors": n_tw,
        "longest_global_ms": k_tw, "longest_global_twin_host_s": t_tw}}),
        flush=True)
    if err or fe:
        fail("an ultra-long chain or fill launch differs from the oracle, "
             "its twin or its recorded result")
    return dict(chain=(launches + counts[0], calls, err, ms), fills=fcalls,
                fill=(counts[1], fe, fms, fpl), backtrack=(counts[2], bms, bpl))


AVA_FLAGS = ["-x", "ava-ont"]   # the overlap run: reads against themselves


def phase3_ava():
    """All-vs-all overlap on the card: the flowcell's N_READS reads
    (flowcell()) as both target and query at `-x ava-ont --gpu-chain -t
    8 -v 3` through cli.main in this process, against the port's host
    route (PORT_HOST, a subprocess) at the same flags, byte for byte
    (card_chain_run).  The run fails if the PAF is empty, if a line breaks the overlap
    filters (fuzz_diff.ava_order_faults: a query name after its target
    name, or a read against itself on the diagonal), if a batch went to
    the host (HPC or RMQ) or took no chain launch, or if a launch
    differs from the host oracle (hold_chain_oracle) or from its re-run
    on its recorded operands (hold_chain_calls, KERNEL_REPS each); the
    twin runs on the smallest launch alone.  Prints the anchors,
    batches, segments (per read and per class), the longest segment and
    widest range, each launch's ms, pairs and rate, the launches' ms
    beside their bound, the allocator's peak per anchor of the largest
    batch, PAF lines and distinct read pairs and both walls, beside the
    card's name and power limit, and the launches' record as a JSON
    line.  Returns (launches, the recorded launches [(args, kw, f, p)],
    max_abs_err, kernel ms, twin ms)."""
    from mm2_gb_tpu_torch.tools import fuzz_diff as F
    _ref, reads = flowcell()
    r = card_chain_run("the flowcell's reads against themselves, -x ava-ont",
                       AVA_FLAGS, reads, reads)
    m, batches, calls = r.m, r.batches, r.calls
    longest, widest = longest_widest(calls)
    lines = r.out.splitlines()
    pairs = {tuple(line.split("\t")[0:6:5]) for line in lines}
    faults = F.ava_order_faults(r.out)
    log(f"ava: longest segment {longest} anchors, widest range {widest}; "
        f"{len(lines)} PAF lines, {len(pairs)} distinct read pairs, "
        f"{len(faults)} breaking the overlap filters; stages (-v 3): "
        + ", ".join(f"{k[:-2].replace('_', '-')} {m[k]:.3f} s" for k in (
            "seed_s", "range_s", "pack_s", "dispatch_s", "device_wait_s",
            "finish_s", "pipeline_wall_s")))
    if faults:
        log("first line that breaks the overlap filters: " + faults[0])
    if not lines or faults or r.launches != m["batches"]:
        fail("the -x ava-ont --gpu-chain run")

    e_or, n_or, t_or = hold_chain_oracle(batches)
    log(f"ava chain launches == chain_scores_host: {len(calls)} launches, "
        f"{n_or} anchors, max_abs_err {e_or} ({t_or:.1f} s on {THREADS} "
        f"threads)")
    small = min(range(len(calls)), key=lambda i: calls[i][0][0].shape[0])
    e_k, ms, plain_ms = hold_chain_calls(calls, "ava", {small})
    b_ms, b_by = chain_bound(calls)
    log(f"ava chain launches ({CARD}): kernel {ms:.3f} ms over "
        f"{len(calls)} launches (median of {KERNEL_REPS} each); bound "
        f"{b_ms:.4f} ms by {b_by}; twin on launch {small} {plain_ms:.3f} ms")
    err = max(e_or, e_k)
    print(json.dumps({"ava_chain": {
        "card": CARD, "launches": len(calls), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "anchors": m["anchors"], "segments": m["segments"],
        "pairs": m["pairs"], "classes": r.classes,
        "longest_anchors": longest, "widest_range": widest,
        "paf_lines": len(lines), "read_pairs": len(pairs), "wall_s": r.wall,
        "host_wall_s": r.host_s}}),
        flush=True)
    if err:
        fail("an ava chain launch differs from the oracle, its twin or its "
             "recorded result")
    return r.launches, calls, err, ms, plain_ms


ASM_FLAGS = ["-cx", "asm5", "--cs"]   # contigs against their reference
HIFI_FLAGS = ["-ax", "map-hifi"]      # PacBio HiFi reads, SAM
# the longest gap fill the card had run before the assembly phase (the
# ultra-long -c run's), which phase3_asm must pass on the card
LONG_FILL_ROWS = 627
ASM_FILL_W = 150_001   # an asm preset's gap-fill band: bw_long * 1.5 + 1


def hold_align_run(tag, r):
    """The fill and backtrack launches of a card_chain_run r made with
    --gpu-align: every fill against the oracle (hold_fill_oracle), every
    launch re-run on its recorded operands (hold_fill_calls), the twins
    on the launch of fewest fills, for its fills of at most TWIN_ROWS
    rows.  Logs the fills on the device and on the host, per class (warp,
    block, scratch), chunks, real-pass misses, the longest fill's rows,
    cells and band, the widest band, the fills longer than
    LONG_FILL_ROWS (and of those at ASM_FILL_W), the in-run kernel times
    and the re-runs' beside dp_bound and walk_bound, with the longest
    walk, beside the card's name and power limit.  Fails without a
    device fill or on a launch that differs from the oracle, its twins
    or its recorded result.  Returns a dict of those numbers, with
    "fcalls" (the recorded launches), "err", "fill_ms", "fill_plain_ms",
    "bt_ms", "bt_plain_ms"."""
    import numpy as np
    m, fcalls = r.m, r.fcalls
    if not fcalls or not m.get("fills_device"):
        fail(f"no device fill in the {tag} run")
    ql, tl, w = (np.concatenate([c[0][k].cpu().numpy() for c in fcalls])
                 .astype(np.int64) for k in (4, 5, 6))
    rows = ql + tl - 1
    top = int(np.argmax(rows))
    long = rows > LONG_FILL_ROWS
    e_or, n_or, t_or = hold_fill_oracle(fcalls)
    log(f"{tag} fills == ksw2.extd2 (the host kit): {n_or} fills of "
        f"{len(fcalls)} launches, max_abs_err {e_or} ({t_or:.1f} s on "
        f"{THREADS} threads)")
    small = min(range(len(fcalls)), key=lambda i: fcalls[i][0][4].shape[0])
    fe, fms, fpl, bms, bpl = hold_fill_calls(
        fcalls, f"{tag} fill", twin={small}, max_rows=TWIN_ROWS)
    f_ms, f_by = dp_bound([c[0][4:7] for c in fcalls], OPS_PER["fill"], 4)
    b_ms, b_by = walk_bound([c[4:6] for c in fcalls])
    steps = max(_longest(c)[1] for c in fcalls)
    out = {"card": CARD, "fills": m["fills"],
           "device_fills": m["fills_device"],
           "host_fills": m["fills_host_routed"], "classes": r.fill_classes,
           "chunks": m["fill_chunks"], "misses": m["misses_fill"],
           "cells": int((ql * tl).sum()), "longest_rows": int(rows[top]),
           "longest_cells": int(ql[top] * tl[top]),
           "longest_w": int(w[top]), "widest_w": int(w.max()),
           "fills_past_627_rows": int(long.sum()),
           "fills_past_627_rows_at_asm_w": int((long & (w == ASM_FILL_W))
                                               .sum()),
           "run_fill_ms": m["fill_kernel_ms"], "run_bt_ms": m["backtrack_ms"],
           "launches": len(fcalls), "fill_ms": fms, "fill_plain_ms": fpl,
           "fill_bound_ms": f_ms, "fill_bound_by": f_by, "bt_ms": bms,
           "bt_plain_ms": bpl, "bt_bound_ms": b_ms, "bt_bound_by": b_by,
           "longest_walk": steps, "err": max(e_or, fe),
           "peak_bytes": r.peak, "wall_s": r.wall, "host_wall_s": r.host_s}
    log(f"{tag} fills ({CARD}): {m['fills']} ({m['fills_device']} device, "
        f"{m['fills_host_routed']} host-routed) in {m['fill_chunks']} chunks "
        f"of {len(fcalls)} launches; per class "
        + ", ".join(f"{c} {r.fill_classes.get(c, 0)}"
                    for c in ("warp", "block", "scratch"))
        + f"; {out['cells']} cells; the longest fill {rows[top]} rows "
        f"({ql[top]} x {tl[top]}, {out['longest_cells']} cells, w "
        f"{w[top]}), the widest w {out['widest_w']}; {int(long.sum())} fills "
        f"past {LONG_FILL_ROWS} rows ({out['fills_past_627_rows_at_asm_w']} "
        f"at w {ASM_FILL_W}); real-pass misses {m['misses_fill']}; in the "
        f"run fill kernel {m['fill_kernel_ms']} ms, backtrack "
        f"{m['backtrack_ms']} ms; re-run alone fill {fms:.3f} ms (bound "
        f"{f_ms:.4f} ms by {f_by}; twin on launch {small} {fpl:.3f} ms), "
        f"backtrack {bms:.3f} ms (bound {b_ms:.5f} ms by {b_by}, the longest "
        f"walk {steps} steps; twin {bpl:.3f} ms); max_abs_err {out['err']}")
    if out["err"]:
        fail(f"a {tag} fill or backtrack launch differs from the oracle, "
             "its twins or its recorded result")
    return {**out, "fcalls": fcalls}


def phase3_asm():
    """Assembly to reference on the card: the contigs of asm_set() (16
    Mbp in four chromosomes, SVs, inversions and asm5's divergence) at
    `-cx asm5 --cs --gpu-chain --gpu-align -t 8 -v 3` through cli.main
    in this process against the port's host route (PORT_HOST, a
    subprocess) at `-cx asm5 --cs`, byte for byte (card_chain_run with
    rmq: every chain batch must go to the host by RMQ, and no chain
    kernel may launch).  Every fill and backtrack launch is held
    against the oracle, its re-run and, on the launch of fewest fills,
    the twins (hold_align_run).  Fails also without a device fill longer
    than LONG_FILL_ROWS rows at the asm band ASM_FILL_W.  Prints the
    contigs and the numbers of hold_align_run as an `asm_align` JSON
    line.  Returns hold_align_run's dict, with "fill_launches" and
    "bt_launches" of the run."""
    ref, contigs = asm_set()
    r = card_chain_run("asm contigs -cx asm5 --cs --gpu-align", ASM_FLAGS,
                       ref, contigs, ["--gpu-align"], rmq=True)
    a = hold_align_run("asm", r)
    a.update(contigs=r.m["reads"], fill_launches=r.fill_launches,
             bt_launches=r.backtrack_launches)
    print(json.dumps({"asm_align": {k: v for k, v in a.items()
                                    if k != "fcalls"}}), flush=True)
    if not a["fills_past_627_rows_at_asm_w"]:
        fail(f"no device fill of the asm run was longer than "
             f"{LONG_FILL_ROWS} rows at w {ASM_FILL_W}")
    return a


def phase3_hifi():
    """HiFi mapping on the card: the N_HIFI reads of hifi_set() at `-ax
    map-hifi --gpu-chain --gpu-align -t 8 -v 3` through cli.main in this
    process against the port's host route (PORT_HOST, a subprocess) at
    `-ax map-hifi`, the SAM but its @PG line (card_chain_run: every
    batch chained by the kernel, none on the host).  Every chain launch
    is held against the host oracle (hold_chain_oracle) and its re-runs
    (hold_chain_calls), the smallest against the twin too; every fill
    and backtrack launch as in phase3_asm (hold_align_run).  Prints the
    chain classes, anchors, segments and pairs, the longest segment and
    widest range, the launches' ms beside their bound, and the fills, as
    a `hifi_align` JSON line.  Returns hold_align_run's dict, with
    "fill_launches", "bt_launches" and "chain": (launches, the recorded
    launches [(args, kw, f, p)], max_abs_err, kernel ms, twin ms)."""
    ref, reads = hifi_set()
    r = card_chain_run(f"HiFi {N_HIFI} reads -ax map-hifi --gpu-align",
                       HIFI_FLAGS, ref, reads, ["--gpu-align"])
    calls = r.calls
    longest, widest = longest_widest(calls)
    e_or, n_or, t_or = hold_chain_oracle(r.batches)
    log(f"hifi chain launches == chain_scores_host: {len(calls)} launches, "
        f"{n_or} anchors, max_abs_err {e_or} ({t_or:.1f} s on {THREADS} "
        f"threads)")
    small = min(range(len(calls)), key=lambda i: calls[i][0][0].shape[0])
    e_k, ms, plain_ms = hold_chain_calls(calls, "hifi", {small})
    b_ms, b_by = chain_bound(calls)
    log(f"hifi chain launches ({CARD}): kernel {ms:.3f} ms over "
        f"{len(calls)} launches (median of {KERNEL_REPS} each); bound "
        f"{b_ms:.4f} ms by {b_by}; twin on launch {small} {plain_ms:.3f} ms; "
        f"longest segment {longest} anchors, widest range {widest}")
    if e_or or e_k:
        fail("a hifi chain launch differs from the oracle, its twin or its "
             "recorded result")
    a = hold_align_run("hifi", r)
    a.update(reads=r.m["reads"], fill_launches=r.fill_launches,
             bt_launches=r.backtrack_launches,
             chain=(r.launches, calls, max(e_or, e_k), ms, plain_ms))
    print(json.dumps({"hifi_align": {
        **{k: v for k, v in a.items() if k not in ("fcalls", "chain")},
        "chain_launches": len(calls), "chain_ms": ms,
        "chain_plain_ms": plain_ms, "chain_bound_ms": b_ms,
        "chain_bound_by": b_by, "anchors": r.m["anchors"],
        "segments": r.m["segments"], "pairs": r.m["pairs"],
        "chain_classes": r.classes, "longest_anchors": longest,
        "widest_range": widest}}), flush=True)
    return a


def phase3_tools(paf):
    """The port's paftools (`python -m mm2_gb_tpu_torch.tools.paftools`)
    on the card's outputs: `stat` on the flowcell -c PAF, whose mapped
    sequences must be the PAF's distinct query names, and `sam2paf` on
    the cDNA run's SAM, a PAF line for each mapped record."""
    path = os.path.join(WORK, "flowcell_gpu.c.paf")
    with open(path, "w") as f:
        f.write(paf)
    tool = ["-m", "mm2_gb_tpu_torch.tools.paftools"]
    out = _host([*tool, "stat", path], "paftools stat")
    m = re.search(r"^Number of mapped sequences: (\d+)$", out, re.M)
    names = len({line.split("\t", 1)[0] for line in paf.splitlines()})
    sam = os.path.join(WORK, "cdna_gpu.sam")
    conv = _host([*tool, "sam2paf", sam], "paftools sam2paf")
    with open(sam) as f:
        mapped = sum(1 for line in f if not line.startswith("@")
                     and not int(line.split("\t")[1]) & 4)
    log(f"paftools stat: {m.group(1) if m else None} mapped sequences "
        f"(the PAF's query names: {names}); sam2paf: {conv.count(chr(10))} "
        f"lines for {mapped} mapped SAM records")
    if m is None or int(m.group(1)) != names or conv.count("\n") != mapped:
        fail("paftools on the card's outputs")


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


def _write_fasta(path, records):
    """Write [(name, seq)] to path through a temporary file, one line a
    sequence; path is returned."""
    with open(path + ".tmp", "w") as f:
        f.writelines(f">{name}\n{seq}\n" for name, seq in records)
    os.replace(path + ".tmp", path)
    return path


def _genome(genome_len, n_chrom, seed, work):
    """The path of the seeded genome's FASTA the assembly and HiFi sets
    share, and a function that returns its chromosomes (names and
    sequences: n_chrom random chromosomes of genome_len // n_chrom bases,
    simulate.random_reference at seeds seed*100 + c) and writes the
    FASTA under work if it is not there."""
    from mm2_gb_tpu_torch.utils import simulate
    path = os.path.join(work, f"genome{genome_len}_{n_chrom}_{seed}.fa")

    made = []

    def chroms():
        if not made:
            made.extend((f"chr{c + 1}", simulate.random_reference(
                genome_len // n_chrom, seed=seed * 100 + c))
                for c in range(n_chrom))
            if not os.path.exists(path):
                _write_fasta(path, made)
        return made
    if not os.path.exists(path):
        chroms()
    return path, chroms


def _log_uniform(rng, lo, hi):
    import numpy as np
    return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def asm_set(genome_len=16_000_000, n_chrom=4,
            sv_len=(50, 8_000), sv_gap=(50_000, 150_000),
            inv_len=(1_000, 20_000), contig_len=(200_000, 2_000_000),
            seed=21, work=WORK):
    """(ref, contigs) FASTA paths of the seeded assembly set, written once
    under work: a genome of n_chrom random chromosomes (_genome), and an
    assembly made from each chromosome, in this order, by
    - deletions and insertions (random bases), one of the two at random,
      of sv_len bases (log-uniform), every sv_gap bases (uniform);
    - about one inversion of inv_len bases (log-uniform) per Mbp;
    - 0.1% substitutions and 0.02% one-base indels
      (simulate.simulate_read over the whole chromosome);
    cut into contigs of contig_len bases (log-uniform; a tail shorter
    than contig_len[0] joins its contig), half of them
    reverse-complemented, named tig<k>_<chromosome>_<start>_<length><strand>.
    At the defaults: 16 Mbp in four chromosomes and about 20 contigs of
    0.2-2 Mbp, the divergence asm5 is meant for."""
    import numpy as np
    from mm2_gb_tpu_torch.utils import simulate
    from mm2_gb_tpu_torch.utils.fastx import revcomp
    ref, chroms = _genome(genome_len, n_chrom, seed, work)
    key = "_".join(map(str, (genome_len, n_chrom, *sv_len, *sv_gap,
                             *inv_len, *contig_len, seed)))
    path = os.path.join(work, f"asm{key}.fa")
    if not os.path.exists(path):
        contigs = []
        for c, (name, chrom) in enumerate(chroms()):
            rng = np.random.default_rng(seed * 100 + 50 + c)
            parts, pos = [], 0
            while True:
                nxt = pos + int(rng.integers(sv_gap[0], sv_gap[1] + 1))
                n = _log_uniform(rng, *sv_len)
                if nxt + n >= len(chrom):
                    break
                parts.append(chrom[pos:nxt])
                if rng.random() < 0.5:    # a deletion of n bases
                    pos = nxt + n
                else:                     # an insertion of n bases
                    parts.append(simulate.random_reference(
                        n, seed=int(rng.integers(2**31))))
                    pos = nxt
            seq = "".join(parts) + chrom[pos:]
            for _ in range(round(len(chrom) * 1e-6)):
                n = _log_uniform(rng, *inv_len)
                s = int(rng.integers(0, len(seq) - n))
                seq = seq[:s] + revcomp(seq[s:s + n]) + seq[s + n:]
            seq = simulate.simulate_read(
                seq, 0, len(seq), sub_rate=0.001, ins_rate=0.0001,
                del_rate=0.0001, seed=seed * 100 + 60 + c)
            start = 0
            while start < len(seq):
                rest = len(seq) - start
                n = _log_uniform(rng, *contig_len)
                if rest - n < contig_len[0]:
                    n = rest if rest <= contig_len[1] else rest - contig_len[0]
                rev = bool(rng.random() < 0.5)
                piece = seq[start:start + n]
                contigs.append((f"tig{len(contigs)}_{name}_{start}_{n}"
                                f"{'-' if rev else '+'}",
                                revcomp(piece) if rev else piece))
                start += n
        _write_fasta(path, contigs)
    return ref, path


def hifi_set(n_reads=N_HIFI, genome_len=16_000_000, n_chrom=4,
             read_len=(15_000, 25_000), seed=21, work=WORK):
    """(ref, reads) FASTA paths of the seeded HiFi set, written once under
    work: the genome asm_set starts from (_genome) and n_reads reads of
    read_len bases (uniform), as many from each chromosome
    (simulate.simulate_readset, seeds seed*100 + 70 + c), with 0.1%
    substitutions, 0.05% insertions and 0.05% deletions (HiFi's
    Q27-Q30), half of them reverse-complemented, each name prefixed with
    its chromosome's.  At the defaults, 1,600 reads of 15-25 kb, about
    32 Mbp (2x)."""
    from mm2_gb_tpu_torch.utils import simulate
    ref, chroms = _genome(genome_len, n_chrom, seed, work)
    path = os.path.join(work, "hifi" + "_".join(map(str, (
        n_reads, genome_len, n_chrom, *read_len, seed))) + ".fa")
    if not os.path.exists(path):
        reads = []
        for c, (name, chrom) in enumerate(chroms()):
            n = n_reads // n_chrom + (c < n_reads % n_chrom)
            reads += [(f"{name}_{r}", s) for r, s in simulate.simulate_readset(
                chrom, n, *read_len, seed=seed * 100 + 70 + c,
                sub_rate=0.001, ins_rate=0.0005, del_rate=0.0005)]
        _write_fasta(path, reads)
    return ref, path


def phase3_splice():
    """The splice slice end to end, `--gpu-chain --gpu-align -x splice`:
    byte-identical to the splice40 goldens (with and without --junc-bed)
    and the sim200 -G 8000 golden; on the cDNA set, `-ax splice -t 8`
    identical to the host route (PORT_HOST, a subprocess; all
    but the @PG line, which holds each side's command), with exts2 and
    intron backtrack launches > 0 and no fill on the host.  Returns the
    cDNA run's (fill, backtrack) launches, its recorded splice calls and
    the splice extensions its align driver ran on the host."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import e2ebench
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
    host_sam = _host([*PORT_HOST[1:], SKIP_INF, "-ax", "splice", "-t",
                      str(THREADS), ref, reads], "host path on the cDNA set")
    log(f"cDNA host path -ax splice (-t {THREADS}, subprocess): "
        f"{time.perf_counter() - t0:.3f} s, {host_sam.count(chr(10))} lines")
    with recording_splice() as calls, recording_splice_exts() as exts:
        G.launches = KS.fill_launches = K.backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "-ax", "splice", "-t",
            str(THREADS), "-v", "3", ref, reads])
        launches = (KS.fill_launches, K.backtrack_launches)
    sys.stderr.write(err)
    m = re.search(r"fills: (\d+) \((\d+) device, (\d+) host-routed\)", err)
    if rc != 0 or m is None:
        fail("--gpu-chain --gpu-align -ax splice on the cDNA set")
    same = e2ebench._no_pg(out) == e2ebench._no_pg(host_sam)
    log(f"cDNA --gpu-chain --gpu-align -ax splice (-t {THREADS}, in "
        f"process): {wall:.3f} s, fills {m.group(1)} ({m.group(3)} "
        f"host-routed), exts2 launches {launches[0]}, backtrack launches "
        f"{launches[1]}, chain launches {G.launches}, identical to the host "
        f"path but @PG {same}")
    if not same or min(launches) == 0 or int(m.group(3)) != 0:
        fail("cDNA --gpu-align -ax splice run")
    with open(os.path.join(WORK, "cdna_gpu.sam"), "w") as f:
        f.write(out)   # for phase3_tools
    return launches, calls, exts


@contextlib.contextmanager
def recording_splice_exts():
    """Record every call of the port's ksw2_splice.exts2 without
    KSW_EZ_APPROX_MAX made inside (the Python align driver's splice
    extensions, which it runs on the host with the native kit): a list of
    (q, t, flag, junc, zdrop, options, Extz)."""
    from mm2_gb_tpu_torch.ops import ksw2_splice
    calls, exts2 = [], ksw2_splice.exts2

    def rec(qseq, tseq, mat, q, e, q2, noncan, zdrop, junc_bonus, flag,
            junc=None, m=5):
        ez = exts2(qseq, tseq, mat, q, e, q2, noncan, zdrop, junc_bonus,
                   flag, junc, m)
        if not flag & 0x08:
            calls.append((qseq.copy(), tseq.copy(), flag,
                          None if junc is None else junc.copy(), zdrop,
                          (bytes(mat), q, e, q2, noncan, junc_bonus), ez))
        return ez
    ksw2_splice.exts2 = rec
    try:
        yield calls
    finally:
        ksw2_splice.exts2 = exts2


def phase3_splice_ext(exts):
    """The cDNA run's splice extensions (recorded by phase3_splice) in one
    exts2_ext_batch on the card: every Extz field and the CIGAR equal the
    native exts2's results the align driver got; then every launch
    against the twins (one run over all of them).  Fails on fewer than
    100 extensions.  Returns (max_abs_err, (ext, backtrack) launches, the
    recorded launches, ext ms, twin ms, backtrack ms, twin ms)."""
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import opts as O
    prm = KS.splice_params(O.set_preset("splice")[1])
    if len(exts) < 100:
        fail(f"only {len(exts)} splice extensions recorded from the cDNA run")
    if {c[5] for c in exts} != {(prm.mat.tobytes(), prm.q, prm.e, prm.q2,
                                 prm.noncan, prm.junc_bonus)}:
        fail("the cDNA run's splice extensions ran under other options")
    meta, qb, tb, jb, fl, zd = _pack_splice_ext([c[:5] for c in exts])
    want_f = np.array([[int(getattr(c[6], f)) for f in K.EXT_FIELDS]
                       for c in exts], np.int32)
    cigs = [c[6].cigar for c in exts]
    want = (want_f, np.concatenate([[0], np.cumsum([len(c) for c in cigs])]),
            np.concatenate(cigs).astype(np.uint32))
    st = KS.FillStats()
    with recording_splice_ext() as calls:
        KS.ext_launches = K.start_backtrack_launches = 0
        t0 = time.perf_counter()
        got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm,
                                 torch.device("cuda"), st)
        wall = time.perf_counter() - t0
        launches = (KS.ext_launches, K.start_backtrack_launches)
    e_or = ext_result_err(got, want)
    log(f"cDNA splice extensions: {meta.shape[0]} ({st.ext_host_fills} "
        f"host-routed), {int((meta[:, 0] * meta[:, 1]).sum())} cells, "
        f"longest qlen {int(meta[:, 0].max())} tlen {int(meta[:, 1].max())}, "
        f"flags {sorted({int(f) for f in fl})}, "
        f"{int(got[0][:, 8].sum())} Z-dropped; one exts2_ext_batch "
        f"{wall:.3f} s, {launches[0]} ext launches, {launches[1]} backtrack "
        f"launches; ==native exts2 max_abs_err={e_or}")
    if e_or or st.ext_host_fills or min(launches) == 0:
        fail("the cDNA run's splice extensions on the card")
    r = hold_splice_ext_calls(calls, "cDNA splice ext")
    if r[0]:
        fail("a cDNA splice extension launch differs from the twins")
    return max(e_or, r[0]), launches, calls, *r[1:]


def splice_ext_bound(calls):
    """Bound of exts2_ext launches [(args, ext, ...)]: each base and
    junction byte read once, one direction byte per cell of the rows the
    kernel ran (to the row of the maximum where a fill Z-dropped, a lower
    bound of its drop row) written once, 48 bytes of results per fill;
    OPS_PER["splice_ext"] operations per cell."""
    import numpy as np
    nbytes = ops = 0
    for c in calls:
        ql, tl = c[0][6].cpu().numpy(), c[0][7].cpu().numpy()
        ext = c[1].cpu().numpy()
        rows = np.where(ext[:, 8] > 0, ext[:, 2] + ext[:, 3] + 1, ql + tl - 1)
        cells = 0
        for q, t, n in zip(ql.tolist(), tl.tolist(), rows.tolist()):
            r = np.arange(n)
            cells += int((np.minimum(t - 1, r) - np.maximum(0, r - q + 1)
                          + 1).sum())
        nbytes += int(ql.sum()) + 2 * int(tl.sum()) + cells + 48 * ql.shape[0]
        ops += cells * OPS_PER["splice_ext"]
    return _bound(nbytes, ops)


def _two_ranks(args, name):
    """Two concurrent `--tpu-nproc 2` rank subprocesses of the port on the
    CLI arguments args into WORK/name, then its mergeshards: (merged
    output, rank 0's stderr, wall of both)."""
    pre = os.path.join(WORK, name)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mm2_gb_tpu_torch", "--tpu-nproc", "2",
         "--tpu-rank", str(r), "-o", pre, *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        sys.stderr.write("".join(e[-2000:] for e in errs))
        fail(f"a rank of the {name} run")
    merged = _host(["-m", "mm2_gb_tpu_torch.tools.mergeshards", pre, "2"],
                   f"mergeshards of the {name} ranks")
    return merged, errs[0], time.perf_counter() - t0


def two_ranks_main(args):
    """`python3 chip_smoke.py --two-ranks ARGS`: the port's CLI on ARGS as
    two concurrent ranks and their mergeshards, as one command (the card
    side of --scale-walls' e2ebench configuration): the merged output on
    stdout, rank 0's stderr on stderr."""
    merged, err, _wall = _two_ranks(args, "walls_ranks")
    sys.stderr.write(err)
    sys.stdout.write(merged)
    return 0


def phase3_scale(single):
    """The scale-out paths on the card, on the N_READS-read flowcell draw
    (single: phase3's {"chain": (output, wall), "align": ...}, each equal
    to the host path's):
    - several devices: `--gpu-chain --tpu-devices 2` (and with
      `--gpu-align -c`) with the devices [cuda:0, cuda:0] (this machine
      has one card): byte-identical, chain launches on two streams;
    - ranks: two concurrent `--tpu-nproc 2 --tpu-rank r -o PRE`
      subprocesses of the port, then its mergeshards: byte-identical to a
      single-process subprocess (PAF), and at -a to the single-process SAM
      but @PG, with the header once;
    - per-part device mapping: the sim200 -I 120k --split-prefix golden
      (with and without --gpu-align) and the multi3 -I 20k goldens (with
      and without --split-prefix), chain launches > 0;
    - --tpu-profile: a trace file that names the chain kernel."""
    import torch
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import e2ebench
    ref, reads = flowcell()
    chain_segments, run_devices = G.chain_segments, cli.run_devices
    for name, flags in (("chain", []), ("align", ["--gpu-align", "-c"])):
        streams = set()

        def on_stream(*a, **kw):
            streams.add(torch.cuda.current_stream().cuda_stream)
            return chain_segments(*a, **kw)
        G.chain_segments = on_stream
        cli.run_devices = lambda n, d: [torch.device("cuda", 0)] * 2
        try:
            G.launches = K.fill_launches = 0
            rc, out, err, wall = _cli(cli.main, [
                "--gpu-chain", SKIP_INF, "--tpu-devices", "2", *flags, "-t",
                str(THREADS), "-v", "3", ref, reads])
        finally:
            G.chain_segments, cli.run_devices = chain_segments, run_devices
        same = out == single[name][0]
        log(f"flowcell --tpu-devices 2 on [cuda:0, cuda:0] {' '.join(flags)} "
            f"(-t {THREADS}, in process): {wall:.3f} s (one device "
            f"{single[name][1]:.3f} s), chain launches {G.launches} on "
            f"{len(streams)} streams, fill launches {K.fill_launches}, "
            f"byte-identical to one device {same}")
        if (rc != 0 or not same or len(streams) < 2
                or "devices: 2 (cuda:0, cuda:0)" not in err):
            sys.stderr.write(err[-3000:])
            fail(f"flowcell multi-device run {name}")

    t0 = time.perf_counter()
    single_p = _host([*PORT, ref, reads], "single-process port run")
    w1 = time.perf_counter() - t0
    if single_p != single["chain"][0]:
        fail("the single-process subprocess differs from the in-process run")
    rc_, sam, err, sam_wall = _cli(cli.main, ["--gpu-chain", SKIP_INF, "-a",
                                              "-t", str(THREADS), ref, reads])
    if rc_ != 0:
        fail("the single-process -a run")
    for name, flags, want in (("PAF", [], single_p), ("SAM", ["-a"], sam)):
        merged, _err, w2 = _two_ranks(
            [SKIP_INF, "-t", str(THREADS), *flags, ref, reads],
            f"ranks_{name}")
        same = (merged == want if name == "PAF" else
                e2ebench._no_pg(merged) == e2ebench._no_pg(want)
                and merged.count("\n@PG\t") == 1 and merged.startswith("@"))
        log(f"flowcell two ranks {name} (-t {THREADS} each, concurrent "
            f"subprocesses): {w2:.3f} s (single process "
            f"{w1 if name == 'PAF' else sam_wall:.3f} s, "
            f"{'subprocess' if name == 'PAF' else 'in process'}), merged "
            f"byte-identical to the single process {same}")
        if not same:
            fail(f"the merged {name} ranks differ from the single process")

    gold = os.path.join(REPO, "tests", "golden")
    for flags, ref_, query, golden in (
            (["-c", "-I", "120k", "--split-prefix", "SP"], "simref.fa.gz",
             "simreads.fa.gz", "sim200.split120k.c.paf.gz"),
            (["--gpu-align", "-c", "-I", "120k", "--split-prefix", "SP"],
             "simref.fa.gz", "simreads.fa.gz", "sim200.split120k.c.paf.gz"),
            (["-c", "-I", "20k"], "multi3.fa.gz", "multi3_q.fa.gz",
             "multi3.noI.c.paf.gz"),
            (["-c", "-I", "20k", "--split-prefix", "SP"], "multi3.fa.gz",
             "multi3_q.fa.gz", "multi3.split.c.paf.gz")):
        flags = [os.path.join(WORK, "sp") if f == "SP" else f for f in flags]
        G.launches = K.fill_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", SKIP_INF, *flags, os.path.join(gold, ref_),
            os.path.join(gold, query)])
        with gzip.open(os.path.join(gold, golden), "rt") as f:
            same = out == f.read()
        log(f"per-part {golden} {' '.join(flags)}: rc {rc}, {wall:.2f} s, chain launches {G.launches}, fill "
            f"launches {K.fill_launches}, byte-identical {same}")
        if (rc != 0 or not same or G.launches == 0 or "falling back" in err
                or "--gpu-align" in flags and K.fill_launches == 0):
            sys.stderr.write(err[-3000:])
            fail(f"per-part device mapping {golden}")

    prof = os.path.join(WORK, "profile")
    rc, out, err, wall = _cli(cli.main, [
        "--gpu-chain", SKIP_INF, "--tpu-profile", prof,
        os.path.join(gold, "simref.fa.gz"),
        os.path.join(gold, "simreads.fa.gz")])
    trace = os.path.join(prof, "trace.json")
    named = (os.path.exists(trace)
             and "chain_segments_kernel" in open(trace).read())
    log(f"sim200 --tpu-profile: rc {rc}, {wall:.2f} s, trace "
        f"{os.path.getsize(trace) if os.path.exists(trace) else 0} bytes, "
        f"names the chain kernel {named}")
    with gzip.open(os.path.join(gold, "sim200.skipinf.paf.gz"), "rt") as f:
        if rc != 0 or not named or out != f.read():
            fail("--tpu-profile")


def _fills_line(err, what):
    """(gap fills, their host-routed, extensions, their host-routed, and
    the real pass's misses: fills, extensions, splice fills) of a run's
    `[M::gpu] fills:` line."""
    m = re.search(r"fills: (\d+) \(\d+ device, (\d+) host-routed\).*"
                  r"extensions: (\d+) \(\d+ device, (\d+) host-routed\).*"
                  r"misses \(aligned on the host\): (\d+) fill, (\d+) ext, "
                  r"(\d+) splice", err)
    if m is None:
        sys.stderr.write(err[-3000:])
        fail(f"no fills line from {what}")
    return tuple(int(g) for g in m.groups())


def phase3_qstrand():
    """This slice's path, the Python fill session with device extensions,
    `--gpu-chain --gpu-align -c`: `--qstrand` byte-identical to the sim200
    qstrand golden; the no-native-kit route (the whole host layer in
    NumPy) byte-identical to the sim200 --cs -c golden; `--qstrand -c
    -t 8` on a draw of the bench
    flowcell identical to the host route (PORT_HOST, a subprocess),
    with extension launches > 0, no gap fill on the host and
    no miss of the device results in the real pass.  Returns the flowcell run's (ext, backtrack-from-starts) launches and
    its recorded extension calls."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import native
    gold = os.path.join(REPO, "tests", "golden")
    simref = os.path.join(gold, "simref.fa.gz")
    G.launches = K.fill_launches = K.ext_launches = 0
    rc, out, err, wall = _cli(cli.main, [
        "--gpu-chain", "--gpu-align", SKIP_INF, "--qstrand", "-c", "-v", "3",
        simref, os.path.join(gold, "simreads.fa.gz")])
    with gzip.open(os.path.join(gold, "sim200.qstrand.c.paf.gz"), "rt") as f:
        same = out == f.read()
    n = _fills_line(err, "sim200 --qstrand")
    log(f"sim200 --gpu-align --qstrand -c: rc {rc}, {wall:.2f} s, chain "
        f"launches {G.launches}, fill launches {K.fill_launches}, ext "
        f"launches {K.ext_launches}, fills {n[0]} ({n[1]} host-routed), "
        f"extensions {n[2]} ({n[3]} host-routed), real-pass misses {n[4:]} "
        f"(fill, ext, splice), byte-identical {same}")
    if (rc != 0 or not same or min(G.launches, K.fill_launches,
                                   K.ext_launches) == 0 or n[1] or any(n[4:])):
        fail("sim200 --qstrand golden")

    available, native.available = native.available, lambda: False
    try:
        K.ext_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "--cs", "-c", "-v", "3",
            simref, os.path.join(gold, "simreads.fa.gz")])
    finally:
        native.available = available
    with gzip.open(os.path.join(gold, "sim200.skipinf.cs.paf.gz"), "rt") as f:
        same = out == f.read()
    n = _fills_line(err, "the no-native-kit run")
    log(f"sim200 with no native kit, --gpu-align --cs -c: rc {rc}, "
        f"{wall:.2f} s, ext launches {K.ext_launches}, fills {n[0]}, "
        f"extensions {n[2]}, byte-identical {same}")
    if rc != 0 or not same or K.ext_launches == 0:
        fail("the no-native-kit route")

    ref, reads = flowcell(N_QSTRAND_CHECK)
    t0 = time.perf_counter()
    host_q = _host([*PORT_HOST[1:], SKIP_INF, "--qstrand", "-c", "-t",
                    str(THREADS), ref, reads], "host path --qstrand -c")
    log(f"flowcell ({N_QSTRAND_CHECK} reads) host path --qstrand -c (-t "
        f"{THREADS}, subprocess): {time.perf_counter() - t0:.3f} s, "
        f"{host_q.count(chr(10))} lines")
    with recording_ext() as calls:
        G.launches = K.fill_launches = 0
        K.ext_launches = K.start_backtrack_launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", "--gpu-align", SKIP_INF, "--qstrand", "-c", "-t",
            str(THREADS), "-v", "3", ref, reads])
        launches = (K.ext_launches, K.start_backtrack_launches)
    sys.stderr.write(err)
    if rc != 0:
        fail("--gpu-chain --gpu-align --qstrand -c on the flowcell")
    n = _fills_line(err, "the flowcell --qstrand run")
    same = out == host_q
    log(f"flowcell --gpu-chain --gpu-align --qstrand -c (-t {THREADS}, in "
        f"process): {wall:.3f} s, fills {n[0]} ({n[1]} host-routed), "
        f"extensions {n[2]} ({n[3]} host-routed), real-pass misses (aligned "
        f"on the host) {n[4]} fill, {n[5]} ext, {n[6]} splice, ext launches "
        f"{launches[0]}, ext backtrack launches {launches[1]}, fill "
        f"launches {K.fill_launches}, chain launches {G.launches}, "
        f"byte-identical to host path {same}")
    if not same or min(launches) == 0 or n[1] or any(n[4:]):
        fail("flowcell --gpu-align --qstrand run")
    return launches, calls


def phase4(calls):
    """Each main-path kernel call re-run on its own inputs and held
    against its recorded (f, p); the first and the last also against the
    twin (a twin run costs ~20 s, the longest segment's ~10,000 steps).
    (max_abs_err, kernel ms summed over the calls, twin ms summed over
    the twin runs)."""
    return hold_chain_calls(calls, "main-path", {0, len(calls) - 1})


def launch_shape(call):
    """The work segments of a recorded chain_segments call (args, kw, f,
    p): the launch's own shape, or the one segment_shape gives its
    operands (a call made without one)."""
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    args, kw = call[0], call[1]
    return kw.get("shape") or G.segment_shape(
        args[3].cpu().numpy(), args[4].cpu().numpy(), args[2].cpu().numpy())


def longest_widest(calls):
    """(the longest segment's anchors, the widest range) over recorded
    chain_segments calls."""
    import torch
    works = [torch.as_tensor(launch_shape(c).work).cpu().numpy()
             for c in calls]
    return (max(int((w[:, 1] - w[:, 0]).max(initial=0)) for w in works),
            max(int(w[:, 2].max(initial=0)) for w in works))


def hold_chain_calls(calls, label, twin=()):
    """Each recorded chain_segments call (args, kw, f, p) re-run
    KERNEL_REPS times on its own inputs and held against its recorded
    (f, p); those whose index is in twin also against the twin over the
    whole launch.  Prints each launch's anchors, work segments by class,
    the longest segment's anchors and widest range, pairs (sum(rng)), the
    kernel's median ms, Gpairs/s, and µs per step of the longest segment
    (its anchors are the launch's serial steps).  (max_abs_err, kernel ms
    summed over the calls, twin ms summed over the twin runs)."""
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
        # the kernel with the launch's own shape; the twin takes the
        # chain parameters alone
        kw = {k: v for k, v in kw.items() if k != "events"}
        runs = [timed(G.chain_segments, args, kw) for _ in range(KERNEL_REPS)]
        t_kern = sorted(t for _out, t in runs)[KERNEL_REPS // 2]
        e = max(max(_max_err(fk, f), _max_err(pk, p))
                for (fk, pk), _t in runs)
        msg = ""
        if i in twin:
            (ft, pt), t_plain = timed(
                G.chain_segments_torch, args,
                {k: v for k, v in kw.items() if k != "shape"})
            e = max(e, _max_err(f, ft), _max_err(p, pt))
            plain_ms += t_plain
            msg = f", twin {t_plain:.3f} ms"
        pairs = int(args[2].sum(dtype=torch.int64))
        sh = launch_shape(calls[i])
        w0 = ([int(v) for v in sh.work[0].tolist()] if sh.work.shape[0]
              else [0, 0, 0, 1])
        steps = w0[1] - w0[0]
        log(f"{label} launch {i}: {args[0].shape[0]} anchors, "
            f"{args[3].shape[0]} work segments (warp {sh.n_short}, group "
            f"{sh.n_mid}, block {sh.n_long}, block_global {sh.n_global}; "
            f"longest {steps} anchors, widest range {w0[2]}, "
            f"{'ring' if w0[3] else 'global memory'}), {pairs} pairs; "
            f"kernel {t_kern:.3f} ms (median of {KERNEL_REPS}), "
            f"{pairs / max(t_kern, 1e-9) / 1e6:.3f} Gpairs/s, "
            f"{t_kern * 1e3 / max(steps, 1):.4f} µs per step of the longest "
            f"segment{msg}; max_abs_err {e}")
        if e:
            fail(f"{label} launch {i}: kernel differs from the twin or its "
                 "recorded result")
        err, ms = max(err, e), ms + t_kern
    return err, ms, plain_ms


# the card's peaks (H100 SXM data sheet):
# HBM bytes per second, and float32 operations per second outside the
# tensor cores, against which the DPs' int8/int32 scalar operations are
# counted (no faster rate applies to them, so the bound stays a bound)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# scalar operations per unit of work, counted from the kernels' inner
# loops: a chain pair (pair_total and the reduction), a DP cell of the
# fill, the extension (plus the H row and its key), the splice fill
# (plus the site scores) and the splice extension (plus the H row and
# its key), a backtrack step
OPS_PER = {"chain": 40, "fill": 50, "ext": 56, "splice": 56,
           "splice_ext": 62, "step": 20}


def _bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for moving nbytes
    and doing ops on the card."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def band_cells(ql, tl, w):
    """In-band DP cells of each fill, sum over rows r of en0 - st0 + 1
    (ksw2._row_window): qlen * tlen when the band holds the whole
    matrix (w >= max(qlen, tlen)), else counted row by row."""
    import numpy as np
    ql, tl, w = (np.asarray(a, np.int64) for a in (ql, tl, w))
    w = np.where(w < 0, np.maximum(ql, tl), w)
    cells = ql * tl
    for k in np.nonzero(w < np.maximum(ql, tl))[0].tolist():
        r = np.arange(ql[k] + tl[k] - 1)
        st0 = np.maximum(np.maximum(0, r - ql[k] + 1), (r - w[k] + 1) >> 1)
        en0 = np.minimum(np.minimum(tl[k] - 1, r), (r + w[k]) >> 1)
        cells[k] = int(np.maximum(en0 - st0 + 1, 0).sum())
    return cells


def dp_bound(launches, ops_per_cell, out_per_fill, junction=False):
    """Bound of DP launches [(qlen, tlen, w or None: unbanded)]: each
    base read once (the junction bytes too where given), one direction
    byte per in-band cell written once, out_per_fill bytes of results
    per fill; ops_per_cell operations per cell."""
    nbytes = ops = 0
    for ql, tl, w in launches:
        ql, tl = ql.cpu().numpy(), tl.cpu().numpy()
        cells = int(band_cells(ql, tl, -1 if w is None else w.cpu().numpy())
                    .sum())
        nbytes += (int(ql.sum()) + int(tl.sum()) * (2 if junction else 1)
                   + cells + out_per_fill * ql.shape[0])
        ops += cells * ops_per_cell
    return _bound(nbytes, ops)


def walk_bound(launches):
    """Bound of backtrack launches [(cig, n_cig)]: one direction byte read
    per step of the walk (the unit ops of the CIGAR words), the words and
    counts written once."""
    nbytes = ops = 0
    for cig, nc in launches:
        steps = int((cig.long() >> 4).sum())
        nbytes += steps + 4 * (int(nc.sum()) + nc.shape[0])
        ops += steps * OPS_PER["step"]
    return _bound(nbytes, ops)


def chain_bound(calls):
    """Bound of chain launches [(args, kw, f, p)]: x, y and the range of
    each anchor read once and the segment bounds, f and p written once;
    OPS_PER["chain"] operations per pair."""
    import torch
    nbytes = ops = 0
    for args, _kw, _f, _p in calls:
        n, n_seg = args[0].shape[0], args[3].shape[0]
        nbytes += 20 * n + 8 * n_seg
        ops += int(args[2].sum(dtype=torch.int64)) * OPS_PER["chain"]
    return _bound(nbytes, ops)


def require_host_kit():
    """Fail unless the port's host kit built and loaded: without it the
    genomic -c runs take the NumPy host layer and the Python fill
    session, another and much slower path."""
    from mm2_gb_tpu_torch.utils import native
    if not native.available():
        fail("the port's host kit did not build or load (see the warning "
             "above)")
    log(f"host kit {native._lib_path()}")


E2E_BEST_OF = 5     # --e2e: timed runs a side (e2e_configs)
E2E_BUDGET_S = 1500.0   # --e2e after phase1; run it with a longer limit


def e2e_config(tag, extra, ref, reads, n_reads, best_of, **kw):
    """One configuration of the e2e bench stage (utils/e2ebench.py) at
    -t THREADS: its record as a JSON line beside the card's name and
    power limit, a summary line, and the record.  It fails on a run
    that failed, differed in bytes or did not fit the budget."""
    from mm2_gb_tpu_torch.utils import e2ebench
    rec = e2ebench.run_config(tag, extra, ref, reads, n_reads, THREADS,
                              best_of=best_of, **kw)
    print(json.dumps({"card": CARD, **rec}), flush=True)
    p = f"e2e_{tag}_"
    if p + "wall_s" in rec:
        share = rec.get(p + "kernel_share")
        log(f"e2e {tag} ({' '.join(extra)}, {n_reads} reads, -t {THREADS}, "
            f"{CARD}): best {rec[p + 'wall_s']:.3f} s, median "
            f"{rec[p + 'wall_median_s']:.3f} s, spread "
            f"{rec[p + 'spread'] * 100:.1f}%; baseline best "
            f"{rec.get(p + 'base_wall_s', 0.0):.3f} s, median "
            f"{rec.get(p + 'base_wall_median_s', 0.0):.3f} s, spread "
            f"{rec.get(p + 'base_spread', 0.0) * 100:.1f}%; byte_match "
            f"{rec[p + 'byte_match']}"
            + ("" if share is None else f"; kernels {share * 100:.2f}% of "
               "the wall"))
    if (p + "error" in rec or p + "incomplete" in rec
            or rec.get(p + "byte_match") is not True):
        fail(f"e2e {tag}: " + rec.get(p + "error", rec.get(
            p + "incomplete", "the outputs differ")))
    return rec


def walls():
    """`python3 chip_smoke.py --walls`: the wall of `--gpu-chain
    --gpu-align --qstrand -c -t 8` on the N_QSTRAND-read flowcell draw
    beside the port's host route (PORT_HOST) at the same flags, through
    the e2e bench stage (one untimed run a side, then turns host, card,
    card, host; every output byte-compared; the kernels' share of the
    card's best wall from its -v 3 lines; the host kit built first)."""
    phase1()
    require_host_kit()
    ref, reads = flowcell(N_QSTRAND)
    e2e_config("qstrand", ["--gpu-chain", "--gpu-align", "--qstrand", "-c"],
               ref, reads, N_QSTRAND, 2, base_cmd=PORT_HOST)


def scale_walls():
    """`python3 chip_smoke.py --scale-walls`: the scale-out walls on the
    N_READS-read flowcell draw, every output byte-compared:
    - in process, `--gpu-chain` and `--gpu-chain --gpu-align -c` on one
      device against `--tpu-devices 2` over [cuda:0, cuda:0], in turns
      A, B, B, A after one untimed in-process run (the process's first
      mapping run pays one-time costs);
    - through the e2e bench stage, one `--gpu-chain` subprocess against
      two concurrent `--tpu-nproc 2` rank subprocesses and the port's
      mergeshards (`--two-ranks`; each subprocess pays its interpreter
      start, imports, CUDA start and index build)."""
    import torch
    from mm2_gb_tpu_torch import cli
    phase1()
    require_host_kit()
    ref, reads = flowcell()
    base = ["--gpu-chain", SKIP_INF, "-t", str(THREADS), ref, reads]
    if _cli(cli.main, base)[0] != 0:
        fail("the untimed first run")
    run_devices = cli.run_devices
    for flags in ([], ["--gpu-align", "-c"]):
        outs = []
        for n_dev in (1, 2, 2, 1):
            cli.run_devices = lambda n, d: [torch.device("cuda", 0)] * 2
            try:
                rc, out, err, wall = _cli(cli.main, [
                    "--tpu-devices", str(n_dev), *flags, *base])
            finally:
                cli.run_devices = run_devices
            if rc != 0:
                sys.stderr.write(err[-3000:])
                fail(f"the {n_dev}-device run")
            outs.append(out)
            log(f"flowcell --gpu-chain {' '.join(flags)} on {n_dev} "
                f"device{'s' if n_dev > 1 else ''} (-t {THREADS}, in "
                f"process): wall {wall:.3f} s")
        if any(o != outs[0] for o in outs):
            fail("the device walls' outputs differ")
    e2e_config("ranks", ["--gpu-chain"], ref, reads, N_READS, 2,
               base_cmd=[sys.executable, "-m", "mm2_gb_tpu_torch"],
               cmd=[sys.executable, os.path.join(REPO, "chip_smoke.py"),
                    "--two-ranks"])


def e2e_configs():
    """The configurations of PERF.md section 4 for the e2e bench stage:
    (tag, flags, ref, reads, reads' count, timed runs a side).  The
    sixth, ava, maps the flowcell's reads against themselves (all-vs-all
    overlap), two timed runs a side: its runs are the longest.  The
    seventh and eighth, hifi and asm, are the flags of phase3_hifi and
    phase3_asm on hifi_set() and asm_set(), three timed runs a side
    (their walls, 10-20 s a run, keep --e2e within E2E_BUDGET_S)."""
    from mm2_gb_tpu_torch.utils import gpucfg
    fc = flowcell()
    asm = asm_set()
    with open(asm[1]) as f:
        n_contigs = sum(line.startswith(">") for line in f)
    align = ["--gpu-chain", "--gpu-align"]
    return [("chain", ["--gpu-chain"], *fc, N_READS, E2E_BEST_OF),
            ("align", ["--gpu-chain", "--gpu-align", "-c"], *fc, N_READS,
             E2E_BEST_OF),
            ("qstrand", ["--gpu-chain", "--gpu-align", "--qstrand", "-c"],
             *flowcell(N_QSTRAND_CHECK), N_QSTRAND_CHECK, E2E_BEST_OF),
            ("cdna", ["-ax", "splice", "--gpu-chain", "--gpu-align"],
             *cdna_set(), N_CDNA, E2E_BEST_OF),
            ("ultralong", ["--gpu-chain", "--gpu-cfg", os.path.join(
                gpucfg.CONFIG_DIR, "h100_over50k.json")], *ultralong(),
             N_ULTRALONG, E2E_BEST_OF),
            ("ava", [*AVA_FLAGS, "--gpu-chain"], fc[1], fc[1], N_READS, 2),
            ("hifi", [*HIFI_FLAGS, *align], *hifi_set(), N_HIFI, 3),
            ("asm", [*ASM_FLAGS, *align], *asm, n_contigs, 3)]


def e2e_all():
    """`python3 chip_smoke.py --e2e`: every configuration of e2e_configs
    through the e2e bench stage at -t 8 beside the port's host route
    (PORT_HOST, a subprocess), at its timed runs a side, the phase marks
    on (MM2TPU_TIMELINE=1): one JSON line each."""
    phase1()
    require_host_kit()
    end = time.perf_counter() + E2E_BUDGET_S
    for tag, extra, ref, reads, n, best_of in e2e_configs():
        e2e_config(tag, extra, ref, reads, n, best_of, base_cmd=PORT_HOST,
                   remaining=lambda: end - time.perf_counter(),
                   env={"MM2TPU_TIMELINE": "1"})


def phase3_e2e():
    """The e2e bench stage on the flowcell at --gpu-chain, two timed runs
    a side beside the port's host route (PORT_HOST, a subprocess):
    byte-identical, and its record a JSON line."""
    e2e_config("chain", ["--gpu-chain"], *flowcell(), N_READS, 2,
               base_cmd=PORT_HOST, env={"MM2TPU_TIMELINE": "1"})


SWEEP_CAPS = (250_000, 500_000, 1_000_000, 4_000_000, 16_000_000)
SWEEP_RUNS = 5      # --cfg-sweep: timed runs a cap, after one untimed


def cfg_sweep():
    """`python3 chip_smoke.py --cfg-sweep`: the walls of `--gpu-chain -t 8
    -v 3` in process (cli.main: index build and mapping, without the
    interpreter's and the imports' start-up) at each max_anchors_batch of
    SWEEP_CAPS (a --gpu-cfg JSON each, max_reads_batch 200,000), on the
    N_READS-read flowcell (10-100 kb reads, the below50k class) and on
    the ultra-long set (100-300 kb, over50k).  Per set, one untimed round
    over the caps, then SWEEP_RUNS rounds, each in the caps' order
    rotated by one; every output byte-compared with the first.  Prints
    each cap's best, median and spread beside its batches, chain kernel
    seconds and allocator peak, and a JSON line a set."""
    import statistics

    import torch
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    from mm2_gb_tpu_torch.utils import e2ebench, gpucfg
    phase1()
    require_host_kit()
    saved = gpucfg.current_config()
    paths = {}
    for cap in SWEEP_CAPS:
        paths[cap] = os.path.join(WORK, f"sweep_{cap}.json")
        with open(paths[cap], "w") as f:
            json.dump({"max_anchors_batch": cap,
                       "max_reads_batch": 200_000}, f)
    dispatch, sizes = G.dispatch_scores, []

    def sized(ax, *a, **kw):   # each batch's anchors
        sizes.append(ax.shape[0])
        return dispatch(ax, *a, **kw)
    G.dispatch_scores = sized
    try:
        for tag, (ref, reads), n in (("flowcell", flowcell(), N_READS),
                                     ("ultralong", ultralong(), N_ULTRALONG)):
            walls = {cap: [] for cap in SWEEP_CAPS}
            info, first = {}, None
            for r in range(SWEEP_RUNS + 1):
                k = r % len(SWEEP_CAPS)
                for cap in SWEEP_CAPS[k:] + SWEEP_CAPS[:k]:
                    sizes.clear()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    held = torch.cuda.memory_allocated()
                    rc, out, err, wall = _cli(cli.main, [
                        "--gpu-chain", SKIP_INF, "-t", str(THREADS),
                        "--gpu-cfg", paths[cap], "-v", "3", ref, reads])
                    gpucfg.apply_gpu_config(saved)
                    if rc != 0:
                        sys.stderr.write(err[-3000:])
                        fail(f"--cfg-sweep {tag} at {cap} anchors")
                    first = out if first is None else first
                    if out != first:
                        fail(f"--cfg-sweep {tag}: the output at {cap} "
                             "anchors differs")
                    m = _gpu_fields(err, f"the {tag} sweep")
                    if r:
                        walls[cap].append(wall)
                        info.setdefault(cap, []).append(
                            m["chain_kernel_s"])
                    info[cap, "batches"] = m["batches"]
                    info[cap, "largest"] = max(sizes)
                    info[cap, "peak"] = (torch.cuda.max_memory_allocated()
                                         - held)
            rec = {}
            for cap in SWEEP_CAPS:
                s = rec[cap] = {**e2ebench._summary(walls[cap]),
                                "batches": info[cap, "batches"],
                                "largest_batch": info[cap, "largest"],
                                "chain_kernel_s": statistics.median(info[cap]),
                                "peak_bytes": info[cap, "peak"]}
                log(f"cfg sweep {tag} ({n} reads, --gpu-chain -t {THREADS}, "
                    f"in process, {CARD}): max_anchors_batch {cap}: best "
                    f"{s['wall_s']:.3f} s, median {s['wall_median_s']:.3f} s, "
                    f"spread {s['spread'] * 100:.1f}%; "
                    f"{info[cap, 'batches']} batches (largest "
                    f"{info[cap, 'largest']} anchors), chain kernel "
                    f"{s['chain_kernel_s']:.4f} s, allocator peak "
                    f"{info[cap, 'peak']} B "
                    f"({info[cap, 'peak'] / info[cap, 'largest']:.1f} B per "
                    f"anchor of the largest batch)")
            print(json.dumps({"card": CARD, "sweep": tag, "reads": n,
                              "caps": rec}), flush=True)
    finally:
        G.dispatch_scores = dispatch
        gpucfg.apply_gpu_config(saved)


def _walk_steps(cig, n_cig, cig_off):
    """Steps of each fill's backtrack walk: the unit ops of its words."""
    import torch
    m = n_cig.shape[0]
    slot = torch.repeat_interleave(torch.arange(m, device=cig.device),
                                   cig_off[1:] - cig_off[:-1])
    used = (torch.arange(cig.shape[0], device=cig.device)
            - cig_off[:-1][slot] < n_cig[slot])
    steps = torch.zeros(m, dtype=torch.int64, device=cig.device)
    steps.index_add_(0, slot, torch.where(used, cig.long() >> 4, 0))
    return steps


def chain_launch_shape(rng, seg_start, seg_end):
    """(work segments, the longest one's anchors, its pairs: sum(rng)
    over it) of a chain launch's operands."""
    import torch
    lens = (seg_end - seg_start).long()
    if lens.numel() == 0:
        return 0, 0, 0
    k = int(lens.argmax())
    s, e = int(seg_start[k]), int(seg_end[k])
    return lens.shape[0], e - s, int(rng[s:e].sum(dtype=torch.int64))


def dp_launches(root, budget, cdna, fc, qfc):
    """`chip_smoke.py --dp-launches ROOT BUDGET ...` (a subprocess of
    dp_turns): the port found under ROOT maps the cDNA set at `-ax splice
    --gpu-align`, the flowcell at `--gpu-align -c` and the flowcell's
    N_QSTRAND_CHECK-read draw at `--gpu-align --qstrand -c`, each once,
    then solves the splice extensions the cDNA run's align driver ran on
    the host in one exts2_ext_batch.  Every exts2_fill, extd2_fill,
    extd2_ext, exts2_ext and backtrack launch is reported: its fills, the
    longest fill's rows (qlen + tlen - 1) or the longest walk (steps), the
    launch's ms (the CUDA events its wrapper records right around the
    launch) and the µs per row or step, and for the extension kernels
    their cells and widest min(qlen, tlen); and every chain_segments
    launch: its anchors, work segments, the longest segment's anchors and
    pairs, ms, and µs per step (anchor) of the longest segment.  BUDGET
    replaces gpucfg.FILL_CHUNK_BYTES (bytes; "-": the tree's own).  The
    last line is a JSON object of the launches and each output's sha256
    (the splice extensions': of their fields and CIGAR words)."""
    import hashlib
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import gpucfg
    from mm2_gb_tpu_torch.utils import opts as O
    if not cli.__file__.startswith(os.path.abspath(root)):
        fail(f"imported the port from {cli.__file__}, not {root}")
    if budget != "-":
        gpucfg.FILL_CHUNK_BYTES = int(budget)
    # built and loaded before the runs, so that no launch's time holds it
    # (a tree whose chain wrapper takes no events is timed around its call)
    from mm2_gb_tpu_torch.utils import kernels
    kernels.library()
    recs = []

    def wrap(mod, name, kind, ql_at):
        fn = getattr(mod, name)

        def rec(*a, **kw):
            out = fn(*a, **kw)
            if kind in ("fill", "ext"):
                ql, tl = a[ql_at].long(), a[ql_at + 1].long()
                rows = int((ql + tl - 1).max())
                recs.append([kind, name, ql.shape[0], rows, kw["events"],
                             [int(torch.minimum(ql, tl).max()),
                              int((ql * tl).sum())]])
                if kind == "ext":   # re-run alone after the run
                    recs[-1][5].append((fn, a))
            else:
                steps = _walk_steps(out[0], out[1], a[5])
                recs.append([kind, name, a[2].shape[0], int(steps.max()),
                             kw["events"], int(steps.sum())])
            return out
        setattr(mod, name, rec)
        return lambda: setattr(mod, name, fn)
    def wrap_chain():
        from mm2_gb_tpu_torch.ops import chain_gpu as G
        fn = G.chain_segments
        own = "events" in inspect.signature(fn).parameters

        def rec(*a, **kw):
            if own:
                out = fn(*a, **kw)
                ev = kw["events"]
            else:   # a tree whose wrapper takes no events: around its call
                ev = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
            recs.append(["chain", "chain_segments", a[0].shape[0], a[2:5],
                         ev, None])
            return out
        G.chain_segments = rec
        return lambda: setattr(G, "chain_segments", fn)
    undo = [wrap(KS, "exts2_fill", "fill", 6), wrap(KS, "exts2_ext", "ext", 6),
            wrap(KS, "ksw2_backtrack", "walk", 0),
            wrap(K, "extd2_fill", "fill", 4), wrap(K, "extd2_ext", "ext", 4),
            wrap(K, "ksw2_backtrack", "walk", 0), wrap_chain()]
    runs = {}

    def report(what, first, sha, wall):
        torch.cuda.synchronize()
        runs[what] = {"sha256": sha, "wall_s": wall, "launches": []}
        for kind, name, n, longest, ev, extra in recs[first:]:
            ms = ev[0].elapsed_time(ev[1])
            if kind == "chain":
                segs, longest, pairs = chain_launch_shape(*longest)
                runs[what]["launches"].append(
                    [name, n, longest, ms, [segs, pairs]])
                log(f"{what} {name}: {n} anchors, {segs} work segments, "
                    f"the longest {longest} anchors and {pairs} pairs, "
                    f"{ms:.3f} ms, {ms * 1e3 / max(longest, 1):.4f} µs "
                    "per step of the longest segment")
                continue
            if kind == "ext":
                # the launch again on its own operands, in a quiet process:
                # in the run, the events also hold the host's delays
                # between them (the -t 8 threads share the interpreter)
                fn, a = extra.pop()
                extra.append(sorted(_timed_launch(fn, *a)[1]
                                    for _ in range(3))[1])
            runs[what]["launches"].append([name, n, longest, ms, extra])
            if kind in ("fill", "ext"):
                log(f"{what} {name}: {n} fills, {extra[1]} cells, {longest} "
                    f"rows of the longest fill, {ms:.3f} ms, "
                    f"{ms * 1e3 / max(longest, 1):.4f} µs per row, widest "
                    f"min(qlen, tlen) {extra[0]}" + (
                        f"; alone {extra[2]:.3f} ms (median of 3), "
                        f"{extra[2] * 1e3 / max(longest, 1):.4f} µs per row"
                        if kind == "ext" else ""))
            else:
                log(f"{what} {name}: {n} fills, {longest} steps of the "
                    f"longest walk, {ms:.3f} ms, "
                    f"{ms * 1e3 / max(longest, 1):.4f} µs per step, {extra} "
                    "steps in all")
    try:
        for what, flags, (ref, reads) in (
                ("cdna", ["-ax", "splice"], cdna), ("flowcell", ["-c"], fc),
                ("qstrand", ["--qstrand", "-c"], qfc)):
            first = len(recs)
            with recording_splice_exts() as exts:
                rc, out, err, wall = _cli(cli.main, [
                    "--gpu-chain", "--gpu-align", SKIP_INF, *flags, "-t",
                    str(THREADS), "-v", "3", ref, reads])
            if rc != 0:
                sys.stderr.write(err[-3000:])
                fail(f"{what} run under {root}")
            for line in err.splitlines():
                if line.startswith("[M::gpu] fills:"):
                    log(f"{what}: {line}")
            report(what, first, hashlib.sha256(out.encode()).hexdigest(),
                   wall)
            if what == "cdna":
                sexts = exts
        # the cDNA run's host-side splice extensions, in an order that does
        # not depend on its threads
        sexts = sorted(sexts, key=lambda c: (
            c[0].shape[0], c[1].shape[0], c[0].tobytes(), c[1].tobytes(),
            c[2], c[4], b"" if c[3] is None else c[3].tobytes()))
        prm = KS.splice_params(O.set_preset("splice")[1])
        first = len(recs)
        t0 = time.perf_counter()
        got = KS.exts2_ext_batch(*_pack_splice_ext([c[:5] for c in sexts]),
                                 prm, torch.device("cuda"))
        wall = time.perf_counter() - t0
        report("splice_ext", first, hashlib.sha256(b"".join(
            np.ascontiguousarray(a).tobytes() for a in got)).hexdigest(),
            wall)
        log(f"splice_ext: {len(sexts)} extensions of the cDNA run")
    finally:
        for u in undo:
            u()
    print(json.dumps(runs), flush=True)


# the genomic fill probe's shapes (qlen, tlen): the hifi.sam cell's common
# gap fills and its longest (548 rows), at map-hifi's gap-fill band
# (int(bw * 1.5 + 1)), alone and n to a launch
FILL_PROBE_SHAPES = ((150, 150), (213, 213), (274, 274), (275, 274))
FILL_PROBE_COUNTS = (1, 132, 1056, 4224)
FILL_PROBE_W = 751


def fill_probe(root):
    """`chip_smoke.py --fill-probe ROOT` (a subprocess of dp_probe): the
    genomic fill kernel (extd2_fill, the default tie rule) of the port
    found under ROOT on seeded HiFi-like fills (1% substitutions) of each
    FILL_PROBE_SHAPES shape, FILL_PROBE_COUNTS to a launch: the launch's
    ms (the events its wrapper records right around the launch, median of
    5), µs per row, GCUPS.  The last line is a JSON list of [qlen, tlen,
    n, ms, sha256 of the scores and direction bytes]."""
    import hashlib
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.utils import kernels
    from mm2_gb_tpu_torch.utils import opts as O
    if not K.__file__.startswith(os.path.abspath(root)):
        fail(f"imported the port from {K.__file__}, not {root}")
    kernels.library()
    dev = torch.device("cuda")
    prm = K.fill_params(O.set_preset("map-hifi")[1])
    rng = np.random.default_rng(19)
    out = []
    for ql, tl in FILL_PROBE_SHAPES:
        for n in FILL_PROBE_COUNTS:
            t = rng.integers(0, 4, (n, max(ql, tl))).astype(np.uint8)
            q = t[:, :ql].copy()
            t = t[:, :tl].copy()
            sub = rng.random(q.shape) < 0.01
            q[sub] = rng.integers(0, 4, int(sub.sum()))
            ar = np.arange(n)
            pb = int(K.p_bound(np.array([ql]), np.array([tl]),
                               np.array([FILL_PROBE_W]))[0])
            i64 = (lambda x: torch.tensor(x, dtype=torch.int64, device=dev))
            i32 = (lambda x: torch.full((n,), x, dtype=torch.int32,
                                        device=dev))
            ops = (torch.from_numpy(q.reshape(-1)).to(dev),
                   torch.from_numpy(t.reshape(-1)).to(dev), i64(ar * ql),
                   i64(ar * tl), i32(ql), i32(tl), i32(FILL_PROBE_W),
                   i64(ar * pb), pb * n, prm, False)
            runs = [_timed_launch(K.extd2_fill, *ops) for _ in range(5)]
            ms = sorted(r[1] for r in runs)[2]
            sc, p = runs[0][0]
            sha = hashlib.sha256(sc.cpu().numpy().tobytes()
                                 + p.cpu().numpy().tobytes()).hexdigest()
            rows = ql + tl - 1
            log(f"fill probe {n} x ({ql} x {tl}): {ms:.4f} ms, "
                f"{ms * 1e3 / rows:.4f} µs per row, "
                f"{n * ql * tl / ms / 1e6:.3f} GCUPS")
            out.append([ql, tl, n, ms, sha])
            del runs, sc, p
    print(json.dumps(out), flush=True)


def fill_probe_turns(parent):
    """fill_probe of this tree, and of the checkout PARENT when given, in
    turns parent, this, this, parent, each in its own subprocess (each
    tree builds its kernels under its own build/): per shape and count
    the median ms of each tree's turns, the ratio, and whether every
    turn's scores and direction bytes are identical."""
    import statistics
    turns = [parent, REPO, REPO, parent] if parent else [REPO]
    got = []
    for root in turns:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--fill-probe", root], cwd=REPO, text=True,
                           capture_output=True, timeout=900)
        lines = p.stdout.strip().splitlines()
        print("\n".join(f"[{'parent' if root == parent else 'this'}] {ln}"
                        for ln in lines[:-1]), flush=True)
        if p.returncode != 0:
            sys.stderr.write(p.stderr[-3000:])
            fail(f"the fill probe of {root}")
        got.append((root, json.loads(lines[-1])))
    for i, (ql, tl, n, _ms, _sha) in enumerate(got[0][1]):
        med = {who: statistics.median(g[i][3] for root, g in got
                                      if root == who)
               for who in ([parent] if parent else []) + [REPO]}
        this = med[REPO]
        line = (f"fill probe {n} x ({ql} x {tl}): this {this:.4f} ms, "
                f"{this * 1e3 / (ql + tl - 1):.4f} µs per row, "
                f"{n * ql * tl / this / 1e6:.3f} GCUPS")
        if parent:
            line += (f"; parent {med[parent]:.4f} ms, "
                     f"{n * ql * tl / med[parent] / 1e6:.3f} GCUPS; "
                     f"this / parent {this / med[parent]:.4f}")
        log(line)
    same = all(g[i][4] == got[0][1][i][4] for _root, g in got
               for i in range(len(g)))
    log(f"fill probe: every turn's scores and direction bytes identical: "
        f"{same}")
    if not same:
        fail("the fill probe's turns differ")


def dp_probe(parent=None):
    """`python3 chip_smoke.py --dp-probe [PARENT]`: first the genomic fill
    kernel at the hifi.sam cell's shapes (fill_probe_turns: this tree, and
    PARENT in turns when given), then the splice fill kernel and the
    intron backtrack on seeded random fills of fixed shape (qlen x tlen,
    junction bytes on), one fill alone and n copies in one launch, each
    timed with the events the wrappers record right around the launch
    (median of 3): µs per row of a fill (per step of a walk) alone, and
    how it grows with the fills that share the card.  Then the two
    extension kernels on seeded related extensions of the flowcell's and
    the cDNA set's widest shapes, alone and n to a launch, each as a warp
    (its class) and forced to a block: whether a block runs a short
    extension's row faster than a warp (ksw2_gpu.ext_shape)."""
    import numpy as np
    import torch
    from mm2_gb_tpu_torch.ops import ksw2_gpu as K
    from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
    from mm2_gb_tpu_torch.utils import opts as O
    phase1()
    fill_probe_turns(parent)
    dev = torch.device("cuda")
    prm = KS.splice_params(O.set_preset("splice")[1])
    rng = np.random.default_rng(7)
    for ql, tl, n in ((30, 20000, 1), (150, 20000, 1), (170, 20000, 1),
                      (180, 20000, 1), (600, 20000, 1), (1500, 20000, 1),
                      (150, 5000, 132), (150, 5000, 1056),
                      (150, 5000, 4224), (600, 5000, 132),
                      (600, 5000, 528), (600, 5000, 2112)):
        q = torch.from_numpy(rng.integers(0, 4, ql * n).astype(np.uint8))
        t = torch.from_numpy(rng.integers(0, 4, tl * n).astype(np.uint8))
        j = torch.from_numpy(rng.integers(0, 16, tl * n).astype(np.uint8))
        i64 = (lambda x: torch.tensor(x, dtype=torch.int64, device=dev))
        i32 = (lambda x: torch.full((n,), x, dtype=torch.int32, device=dev))
        pb = int(K.p_bound(np.array([ql]), np.array([tl]),
                           np.array([ql + tl]))[0])
        ar = np.arange(n)
        ops = (q.to(dev), t.to(dev), j.to(dev), i64(ar * ql), i64(ar * tl),
               i64(ar * tl), i32(ql), i32(tl), i32(0x08 | 0x100 | 0x400),
               i64(ar * pb), pb * n, prm)
        fms, bms = [], []
        for _ in range(3):
            (sc, p), tk = _timed_launch(KS.exts2_fill, *ops)
            co = i64(np.arange(n + 1) * (ql + tl))
            (cg, nc), tb = _timed_launch(
                K.ksw2_backtrack, p, ops[9], ops[6], ops[7], i32(ql + tl), co,
                False, prm.long_thres)
            fms.append(tk)
            bms.append(tb)
            del p
        tk, tb = sorted(fms)[1], sorted(bms)[1]
        steps = int(_walk_steps(cg, nc, co).max())
        log(f"probe {n} x ({ql} x {tl}): fill {tk:.3f} ms, "
            f"{tk * 1e3 / (ql + tl - 1):.4f} µs per row, "
            f"{n * ql * tl / tk / 1e6:.3f} GCUPS; backtrack {tb:.3f} ms, "
            f"{steps} steps, {tb * 1e3 / steps:.4f} µs per step")
    kprm = K.fill_params(O.set_preset(None)[1])
    warp_lanes, warp_ring = K.WARP_LANES, KS.WARP_RING
    for ql, tl, n in ((106, 210, 1), (139, 276, 1), (106, 210, 200),
                      (139, 276, 4000)):
        t = rng.integers(0, 4, (n, tl)).astype(np.uint8)
        q = t[:, :ql].copy()
        sub = rng.random(q.shape) < 0.05
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        i64 = (lambda x: torch.tensor(x, dtype=torch.int64, device=dev))
        i32 = (lambda x: torch.full((n,), x, dtype=torch.int32, device=dev))
        pb = int(K.p_bound(np.array([ql]), np.array([tl]),
                           np.array([751]))[0])
        ar = np.arange(n)
        qd, td = (torch.from_numpy(x.reshape(-1)).to(dev) for x in (q, t))
        for cls in ("warp", "block"):
            K.WARP_LANES, KS.WARP_RING = ((warp_lanes, warp_ring)
                                          if cls == "warp" else (0, 0))
            try:
                xs = [_timed_launch(K.extd2_ext, qd, td, i64(ar * ql),
                                    i64(ar * tl), i32(ql), i32(tl), i32(751),
                                    i32(-1), i64(ar * pb), pb * n, kprm,
                                    False, 10)[1] for _ in range(3)]
                ss = [_timed_launch(KS.exts2_ext, qd, td,
                                    torch.zeros(1, dtype=torch.uint8,
                                                device=dev),
                                    i64(ar * ql), i64(ar * tl),
                                    i64(np.full(n, -1)), i32(ql), i32(tl),
                                    i32(0x40 | 0x100), i32(-1), i64(ar * pb),
                                    pb * n, prm)[1] for _ in range(3)]
            finally:
                K.WARP_LANES, KS.WARP_RING = warp_lanes, warp_ring
            tx, ts = sorted(xs)[1], sorted(ss)[1]
            log(f"probe ext {n} x ({ql} x {tl}) as a {cls}: extd2_ext "
                f"{tx:.3f} ms, {tx * 1e3 / (ql + tl - 1):.4f} µs per row; "
                f"exts2_ext {ts:.3f} ms, {ts * 1e3 / (ql + tl - 1):.4f} µs "
                "per row")


def dp_turns(parent):
    """`python3 chip_smoke.py --dp-turns [PARENT]`: the DP kernels'
    per-launch times of this tree, and of the checkout PARENT when given,
    each tree in its own subprocess (dp_launches; each builds its own
    kernels and host kit under its build/), in turns parent, this, this,
    parent; then this tree at chunk budgets of 512 MiB, 2 GiB and 4 GiB.
    Sums per kernel (the extension kernels' also alone) and the equality
    of every run's output (the cDNA SAM, the flowcell PAFs, the splice
    extensions' fields and CIGARs) are printed at the end."""
    phase1()
    cdna, fc, qfc = cdna_set(), flowcell(), flowcell(N_QSTRAND_CHECK)
    me = REPO
    turns = ([(parent, "-"), (me, "-"), (me, "-"), (parent, "-")] if parent
             else [(me, "-")])
    turns += [(me, str(b << 20)) for b in (512, 2048, 4096)]
    results = []
    for root, budget in turns:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--dp-launches", root, budget, *cdna, *fc, *qfc],
                           cwd=REPO, text=True, capture_output=True,
                           timeout=900)
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if p.returncode != 0:
            sys.stderr.write(p.stderr[-3000:])
            fail(f"the dp-launches run of {root}")
        runs = json.loads(lines[-1])
        results.append(runs)
        for what, r in runs.items():
            sums = {}
            for name, _n, _l, ms, x in r["launches"]:
                c, s, a = sums.get(name, (0, 0.0, None))
                if name in ("extd2_ext", "exts2_ext"):
                    a = (a or 0.0) + x[2]
                sums[name] = (c + 1, s + ms, a)
            log(f"turn {root} budget {budget} {what}: wall "
                f"{r['wall_s']:.3f} s; " + "; ".join(
                    f"{k} {c} launches {s:.3f} ms"
                    + (f" ({a:.3f} ms alone)" if a is not None else "")
                    for k, (c, s, a) in sorted(sums.items())))
    same = all(r[w]["sha256"] == results[0][w]["sha256"]
               for r in results for w in r)
    log(f"every turn's cDNA SAM, flowcell PAFs and splice extensions "
        f"identical: {same}")
    if not same:
        fail("the turns' outputs differ")


# the differential campaign's seeds in the smoke (phase5_fuzz): the
# fewest of the campaign's seeds 1000-1063 that reach, between them,
# all that the 64 reached on the card (fuzz_missing): every kernel it
# requires and every launch class of the chain and fill kernels, every
# kind, each host route and SAM output.  Seeds and flags are fixed by
# make_workload: 1001 `-x splice:hq -c` (the splice fill, the intron
# backtrack), 1002 `-D -c` (every chain class, block_global too), 1013
# pe `-x sr -a` (frag mode's host chaining, SAM), 1020 `-x asm20 -c`
# (an RMQ batch on the host), 1025 a multi-part index through
# --split-prefix, 1036 `-f 0.0002,5000` (the re-chain after the
# device), 1043 long `-r 500,80000 -c`, 1058 `-a --MD`, 1063 `-x map-pb
# -c` (an HPC batch on the host, a fill with its state in scratch).
# The 64 seeds took 145-198 s of the smoke; `--fuzz 64 1000` keeps them
FUZZ_SEEDS = (1001, 1002, 1013, 1020, 1025, 1036, 1043, 1058, 1063)
FUZZ_ROUTES = ("host_chain_fallback", "hpc_host_batches", "rmq_host_batches")
FUZZ_CLASSES = tuple(
    [f"chain_segments/{c}" for c in ("warp", "group", "block",
                                     "block_global")]
    + [f"extd2_fill/{c}" for c in ("warp", "block", "scratch")]
    + [f"exts2_fill/{c}" for c in ("warp", "block")])
# ASan inside a CUDA process: CUDA maps memory in ASan's shadow
# gap, and the interpreter's allocations live until exit
FUZZ_ASAN_OPTIONS = "protect_shadow_gap=0:detect_leaks=0"


def fuzz_campaign(seeds, kind=None):
    """The port's differential campaign (mm2_gb_tpu_torch.tools.fuzz_diff)
    on the card: each seed's `--gpu-chain` run (with `--gpu-align` where
    its flags align) in this process against the port's host route in a
    subprocess, byte for byte; kind: fuzz_diff's kind= (every seed of
    that kind).  Returns the campaign and its wall."""
    import torch
    from mm2_gb_tpu_torch.tools import fuzz_diff as F
    t0 = time.perf_counter()
    c = F.campaign(seeds, torch.device("cuda"), kind=kind)
    return c, time.perf_counter() - t0


def fuzz_missing(c):
    """What phase5_fuzz requires of the campaign c and c did not reach:
    the chain kernel, the genomic and the splice fill kernels and the
    backtrack in its genomic and its intron mode launched through the
    CLI; every kind a seed draws; the host routes (FUZZ_ROUTES); the
    chain and fill kernels' launch classes (FUZZ_CLASSES); and SAM
    output (-a)."""
    from mm2_gb_tpu_torch.tools import fuzz_diff as F
    t = c.totals()
    k = t["launches"]
    need = {"chain_segments": k.get("chain_segments", 0),
            "extd2_fill": k.get("extd2_fill", 0),
            "exts2_fill": k.get("exts2_fill", 0),
            "ksw2_backtrack (genomic)": k.get("ksw2_backtrack", 0)
            - k.get("ksw2_backtrack_intron", 0),
            "ksw2_backtrack (intron)": k.get("ksw2_backtrack_intron", 0),
            **{f"kind {x}": t["kinds"].get(x, 0) for x in F.KINDS},
            **{f"route {x}": t["routes"].get(x, 0) for x in FUZZ_ROUTES},
            **{f"class {x}": t["classes"].get(x, 0) for x in FUZZ_CLASSES},
            "SAM output (-a)": sum("-a" in r.w.flags for r in c.results)}
    return [name for name, v in need.items() if v <= 0]


def phase5_fuzz(seeds=FUZZ_SEEDS):
    """The campaign on seeds.  Fails on any divergence, non-zero exit
    or exception, and on anything fuzz_missing finds the campaign did
    not reach.  Prints the campaign's counts as a JSON line.  The launch
    counters are set to 0 before the campaign and must equal the sum of
    its seeds' launches after it."""
    from mm2_gb_tpu_torch.tools import fuzz_diff as F
    for m, a in F.COUNTERS.values():
        setattr(m, a, 0)
    c, wall = fuzz_campaign(seeds)
    t = c.totals()
    read = {k: getattr(m, a) for k, (m, a) in F.COUNTERS.items()}
    if read != {k: t["launches"].get(k, 0) for k in F.COUNTERS}:
        fail(f"the fuzz campaign's launch counters {read} differ from its "
             f"seeds' launches {t['launches']}")
    log(c.summary().replace("\n", "\n[smoke] "))
    log(f"fuzz campaign ({CARD}): seeds {list(seeds)}, {t['matched']} of "
        f"{t['seeds']} byte-identical to the host path, {wall:.1f} s")
    print(json.dumps({"fuzz": {"card": CARD, "seeds": list(seeds),
                               "wall_s": round(wall, 3), **t}}), flush=True)
    if c.failed:
        fail(f"fuzz seeds {[r.w.seed for r in c.failed]} differ from the "
             "host path")
    missing = fuzz_missing(c)
    if missing:
        fail(f"the fuzz campaign reached no {', '.join(missing)}")
    return t


def fuzz_only(n, seed0, kind=None):
    """`python3 chip_smoke.py --fuzz N SEED0`: the campaign alone, for
    longer runs, with each seed's kind, flags, launches, launch classes
    and host routes as a JSON line (what FUZZ_SEEDS is chosen from);
    exits 1 on any FAIL.  `--fuzz-ava N SEED0` and `--fuzz-asm N SEED0`
    give every seed fuzz_diff's kind "ava" (reads against themselves at
    -x ava-*) or "asm" (contigs against their reference at -x asm*),
    whose seeds also fail when both outputs are empty."""
    phase1()
    c, wall = fuzz_campaign(range(seed0, seed0 + n), kind)
    t = c.totals()
    print(c.summary(), flush=True)
    print(json.dumps({"fuzz_seeds": [{
        "seed": r.w.seed, "kind": r.w.kind, "threads": r.w.threads,
        "flags": [f for f in r.w.flags if not f.startswith(r.w.work)],
        "ok": r.ok, "seconds": round(r.seconds, 3),
        "launches": dict(r.launches), "routes": {
            k: v for k, v in r.routes.items() if v}} for r in c.results]}),
        flush=True)
    print(json.dumps({"fuzz": {"card": CARD, "seed0": seed0, "kind": kind,
                               "wall_s": round(wall, 3), **t}}),
          flush=True)
    return 1 if c.failed else 0


def fuzz_asan(k, seed0):
    """`python3 chip_smoke.py --fuzz-asan K SEED0`: the first K genomic
    seeds from seed0 on whose flags take -c without --qstrand (the C++
    fill session's collect pass feeding the fill kernels), mapped with
    `--gpu-chain --gpu-align` in a child that loads the port's asan
    host kit (MM2TPU_NATIVE_LIB, LD_PRELOAD of libasan, ASan's options
    for a CUDA process) beside the CUDA kernels, against the host path.
    Prints the child's summary and any AddressSanitizer report; exits 1
    on a FAIL or a report."""
    from mm2_gb_tpu_torch.tools import fuzz_diff as F
    from mm2_gb_tpu_torch.utils import native
    phase1()
    lib = native.build_sanitized("asan")
    if lib is None:
        fail("the asan build of the host kit failed")
    runtime = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    seeds, seed = [], seed0
    while len(seeds) < k:
        if F.draw_kind(seed) == "genomic":
            w = F.make_workload(seed)
            if "-c" in w.flags and "--qstrand" not in w.flags:
                seeds.append(seed)
        seed += 1
    log(f"asan fuzz seeds {seeds} ({lib}, LD_PRELOAD={runtime}, "
        f"ASAN_OPTIONS={FUZZ_ASAN_OPTIONS})")
    code = ("import sys, torch\n"
            "from mm2_gb_tpu_torch.tools import fuzz_diff as F\n"
            "from mm2_gb_tpu_torch.utils import native\n"
            "assert native.available(), 'the asan host kit did not load'\n"
            "c = F.campaign([int(s) for s in sys.argv[1:]], "
            "torch.device('cuda'))\n"
            "print(c.summary())\n"
            "print('native library', native._lib_path())\n"
            "sys.exit(1 if c.failed else 0)\n")
    env = dict(os.environ, MM2TPU_NATIVE_LIB=lib, LD_PRELOAD=runtime,
               ASAN_OPTIONS=FUZZ_ASAN_OPTIONS)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code, *map(str, seeds)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=3000)
    print(p.stdout, flush=True)
    report = "AddressSanitizer" in p.stderr
    if report or p.returncode != 0:
        print(p.stderr[-20000:], flush=True)
    log(f"asan fuzz ({CARD}): rc {p.returncode}, AddressSanitizer report "
        f"{report}, {time.perf_counter() - t0:.1f} s")
    return 1 if report or p.returncode != 0 else 0


def main() -> int:
    if sys.argv[1:2] == ["--dp-launches"]:
        root, budget, *paths = sys.argv[2:]
        dp_launches(root, budget, paths[:2], paths[2:4], paths[4:])
        return 0
    if not os.path.isdir(os.path.join(REPO, "mm2_gb_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--two-ranks"]:   # a subprocess of --scale-walls
        os.makedirs(WORK, exist_ok=True)
        return two_ranks_main(sys.argv[2:])
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
    if sys.argv[1:] == ["--walls"]:
        walls()
        return 0
    if sys.argv[1:] == ["--e2e"]:
        e2e_all()
        return 0
    if sys.argv[1:] == ["--scale-walls"]:
        scale_walls()
        return 0
    if sys.argv[1:2] == ["--fill-probe"] and len(sys.argv) == 3:
        fill_probe(os.path.abspath(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--dp-probe"] and len(sys.argv) <= 3:
        dp_probe(os.path.abspath(sys.argv[2]) if len(sys.argv) == 3
                 else None)
        return 0
    if sys.argv[1:] == ["--cfg-sweep"]:
        cfg_sweep()
        return 0
    alone = {"--ultralong": phase3_ultralong, "--ava": phase3_ava,
             "--asm": phase3_asm, "--hifi": phase3_hifi}
    if sys.argv[1:] in [[k] for k in alone]:
        phase1()
        require_host_kit()
        alone[sys.argv[1]]()
        return 0
    if (sys.argv[1:2] in (["--fuzz"], ["--fuzz-asan"], ["--fuzz-ava"],
                          ["--fuzz-asm"]) and len(sys.argv) == 4):
        n, seed0 = int(sys.argv[2]), int(sys.argv[3])
        if sys.argv[1] in ("--fuzz-ava", "--fuzz-asm"):
            return fuzz_only(n, seed0, sys.argv[1][len("--fuzz-"):])
        return (fuzz_only if sys.argv[1] == "--fuzz" else fuzz_asan)(n,
                                                                      seed0)
    if sys.argv[1:2] == ["--dp-turns"] and len(sys.argv) <= 3:
        dp_turns(os.path.abspath(sys.argv[2]) if len(sys.argv) == 3
                 else None)
        return 0
    t_start = time.perf_counter()

    def timed(fn, *args, **kw):   # each phase's wall, for the time limit
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s (smoke "
            f"{time.perf_counter() - t_start:.1f} s)")
        return out
    timed(phase1)
    err = timed(phase2)
    fill_err = max(timed(phase2_fills), timed(phase2_long_query))
    splice_err, splice_later = timed(phase2_splice)
    ext_err = timed(phase2_ext)
    sext_err = timed(phase2_splice_ext)
    require_host_kit()
    launches, calls, (n_fill, n_bt), fcalls, single = timed(phase3)
    (n_sfill, n_sbt), scalls, sexts = timed(phase3_splice)
    ce, (n_sx, n_sxb), ccalls, cms, cpl, cbms, cbpl = timed(
        phase3_splice_ext, sexts)
    (n_ext, n_ebt), ecalls = timed(phase3_qstrand)
    timed(phase3_scale, single)
    timed(phase3_timeline, single["align"][0])
    timed(phase3_api, single["align"][0])
    timed(phase3_long_inserts)
    ul = timed(phase3_ultralong)
    ava_launches, ava_calls, ava_err, ava_ms, ava_plain = timed(phase3_ava)
    asm = timed(phase3_asm)
    hifi = timed(phase3_hifi)
    timed(phase3_tools, single["align"][0])
    timed(phase3_e2e)
    e, ms, plain_ms = timed(phase4, calls)
    fe, fms, fpl, bms, bpl = timed(hold_fill_calls, fcalls, "main-path fill")
    if fe:
        fail("a main-path fill or backtrack launch differs from its twin")
    # the kernels line's chain and fill entries: the flowcell's launches
    # and the ultra-long runs' (and the chain's, the overlap run's), each
    # summed over all
    ul_launches, ul_calls, ul_err, ul_ms = ul["chain"]
    ul_fcalls, (ul_fill, ul_fe, ul_fms, ul_fpl) = ul["fills"], ul["fill"]
    ul_bt, ul_bms, ul_bpl = ul["backtrack"]
    # and the assembly and HiFi runs' fills, and the HiFi run's chains
    hf_launches, hf_calls, hf_err, hf_ms, hf_plain = hifi["chain"]
    al = (asm, hifi)
    al_fcalls = asm["fcalls"] + hifi["fcalls"]
    if _params_key(scalls[0][0][-1]) != _params_key(splice_later[0][0][-1]):
        fail("the cDNA run's options differ from the splice preset's")
    se, sfms, sfpl, sbms, sbpl = timed(
        hold_splice_calls, scalls, "main-path splice", extra=splice_later,
        max_rows=SPLICE_TWIN_ROWS)
    n_held = sum(int((c[0][6] + c[0][7] <= SPLICE_TWIN_ROWS).sum())
                 for c in scalls)
    log(f"main-path splice fills held against the twins: {n_held} of "
        f"{sum(c[0][6].shape[0] for c in scalls)}")
    if se:
        fail("a main-path or splice workload launch differs from its twins")
    xe, xms, xpl, xbms, xbpl = timed(hold_ext_calls, ecalls, "main-path ext")
    if xe:
        fail("a main-path extension launch differs from its twins")
    timed(phase5_fuzz)
    if "jax" in sys.modules:
        fail("jax was imported")
    if any(m == "mm2_gb_tpu" or m.startswith("mm2_gb_tpu.")
           for m in sys.modules):
        fail("a module of the JAX package was imported")
    src = "mm2_gb_tpu_torch/csrc/extd2_kernel.cu"

    def entry(name, source, replaces, n, e, t, t_plain, bound):
        b_ms, b_by = bound
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": e,
                "ms": t, "plain_ms": t_plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}
    print(json.dumps({"kernels": [
        entry("chain_segments", "mm2_gb_tpu_torch/csrc/chain_kernel.cu",
              "mm2_gb_tpu/ops/chain_tpu.py:222",
              launches + ul_launches + ava_launches + hf_launches,
              max(err, e, ul_err, ava_err, hf_err),
              ms + ul_ms + ava_ms + hf_ms, plain_ms + ava_plain + hf_plain,
              chain_bound(calls + ul_calls + ava_calls + hf_calls)),
        entry("extd2_fill", src, "mm2_gb_tpu/ops/ksw2_tpu.py:359",
              n_fill + ul_fill + sum(a["fill_launches"] for a in al),
              max(fill_err, fe, ul_fe, *(a["err"] for a in al)),
              fms + ul_fms + sum(a["fill_ms"] for a in al),
              fpl + ul_fpl + sum(a["fill_plain_ms"] for a in al),
              dp_bound([c[0][4:7] for c in fcalls + ul_fcalls + al_fcalls],
                       OPS_PER["fill"], 4)),
        entry("ksw2_backtrack", src, "mm2_gb_tpu/ops/ksw2_tpu.py:1472",
              n_bt + ul_bt + sum(a["bt_launches"] for a in al),
              max(fill_err, fe, ul_fe, *(a["err"] for a in al)),
              bms + ul_bms + sum(a["bt_ms"] for a in al),
              bpl + ul_bpl + sum(a["bt_plain_ms"] for a in al),
              walk_bound([c[4:6] for c in fcalls + ul_fcalls + al_fcalls])),
        entry("exts2_fill", "mm2_gb_tpu_torch/csrc/exts2_kernel.cu",
              "mm2_gb_tpu/ops/ksw2_tpu.py:951", n_sfill,
              max(splice_err, se), sfms, sfpl, dp_bound(
                  [(c[0][6], c[0][7], None) for c in scalls],
                  OPS_PER["splice"], 4, junction=True)),
        entry("ksw2_backtrack_intron", src, "mm2_gb_tpu/ops/ksw2_tpu.py:1472",
              n_sbt, max(splice_err, se), sbms, sbpl,
              walk_bound([c[4:6] for c in scalls])),
        entry("extd2_ext", src, "mm2_gb_tpu/ops/ksw2_tpu.py:550", n_ext,
              max(ext_err, xe), xms, xpl, dp_bound(
                  [c[0][4:7] for c in ecalls], OPS_PER["ext"], 48)),
        entry("ksw2_backtrack_ext", src, "mm2_gb_tpu/ops/ksw2_tpu.py:1552",
              n_ebt, max(ext_err, xe), xbms, xbpl,
              walk_bound([c[4:6] for c in ecalls])),
        entry("exts2_ext", "mm2_gb_tpu_torch/csrc/exts2_kernel.cu",
              "mm2_gb_tpu/ops/ksw2_tpu.py:1133", n_sx, max(sext_err, ce),
              cms, cpl, splice_ext_bound(ccalls)),
        entry("ksw2_backtrack_splice_ext", src,
              "mm2_gb_tpu/ops/ksw2_tpu.py:1552", n_sxb, max(sext_err, ce),
              cbms, cbpl, walk_bound([c[4:6] for c in ccalls]))]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
