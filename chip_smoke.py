#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (mm2_gb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU, nvcc and
a CUDA build of PyTorch.  Phases (any failure exits non-zero):

1. the card's name and power limit; build the CUDA chain kernel from
   mm2_gb_tpu_torch/csrc (into build/kernels);
2. the kernel against its plain PyTorch twin on the card and against the
   port's host oracle (`chain_scores_host`, the reference DP at
   max_skip = inf), exact (tolerance 0: all outputs are integers), on
   small, dense, multi-segment, repeat, wide-window and is_cdna
   workloads; the kernel's mg_log2 against the twin's bit for bit;
3. end to end through the CLI entry point: `--gpu-chain
   --max-chain-skip=2147483647` byte-identical to the sim200 goldens
   (with and without --cs -c), and on the 1200-read bench flowcell
   byte-identical to the host path (`python -m mm2_gb_tpu`, same -t, in
   a subprocess), with kernel launches > 0 and no batch chained on the
   host;
4. every kernel launch of that flowcell run, on the inputs it was given:
   its f and p against the twin's, exact, and both timed (CUDA events).

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
    """Largest |a - b| of two integer tensors (0 when empty)."""
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


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
    """End to end; returns the flowcell run's launches and the chain
    kernel calls it made, as (args, kwargs, f, p)."""
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.ops import chain_gpu as G
    gold = os.path.join(REPO, "tests", "golden")
    for flags, golden in (([], "sim200.skipinf.paf.gz"),
                          (["--cs", "-c"], "sim200.skipinf.cs.paf.gz")):
        G.launches = 0
        rc, out, err, wall = _cli(cli.main, [
            "--gpu-chain", SKIP_INF, *flags,
            os.path.join(gold, "simref.fa.gz"),
            os.path.join(gold, "simreads.fa.gz")])
        with gzip.open(os.path.join(gold, golden), "rt") as f:
            same = out == f.read()
        log(f"sim200 {' '.join(flags) or '(default)'}: rc {rc}, "
            f"{wall:.2f} s, launches {G.launches}, byte-identical {same}")
        if rc != 0 or not same or G.launches == 0:
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
        G.launches = 0           # the main path run counted in the JSON
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
    launches, calls = phase3()
    e, ms, plain_ms = phase4(calls)
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "chain_segments", "route": "cuda",
        "source": "mm2_gb_tpu_torch/csrc/chain_kernel.cu",
        "replaces": "mm2_gb_tpu/ops/chain_tpu.py:222",
        "launches": launches, "max_abs_err": max(err, e),
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
