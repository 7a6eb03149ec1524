"""The port's benchmark: one cell, one seed, one run.

A run has three parts.

- Set-up (`setup`, all of it in `setup_s`): import torch and the port,
  start CUDA; make the genome and the read pool from the seed (the
  configuration's genome generator, the traffic mix's read generator);
  build the port's MinimizerIndex; gpucfg.derive_caps and the kernel
  library's load; map a warm slice of the pool.
- The window (`window`): the port's streaming entry as cli._run_gpu
  drives it, models.pipeline.map_file_gpu_records over the pool file
  with a GpuMetrics of the harness's own, every (read, regions) through
  cli.res_regs_out into a sink that counts them, holds each read's first
  records to the read's origin (reference/truth.py), keeps a hash of
  them to compare later passes with, and keeps the records, anchors and
  chain arrays of the sample's candidates alone; at the end of a pass
  the entry starts again, as a pipeline maps file after file, until
  --seconds are up and the batch being emitted is out.
- The check (`check`): the plain reference (reference/check.py) maps a
  sample of the finished reads again and solves the sampled gap fills;
  every number compared is printed beside its limit.

Wrappers put around five of the program's functions record what the
check and the traced metrics read, and time nothing:
pipeline.finish_read (the chain scores and predecessors of the
sample's candidates), chain_rmq.chain_rmq (under MM_F_RMQ the host
chains each read in its finish_read, the chain kernel runs for none:
the chains of the first call inside a candidate's finish_read),
pipeline._finish_batch (which reads the batch being emitted holds),
ksw2_gpu.extd2_fill_batch (sampled gap fills; in a traced run every
batch's fill shapes) and, in a traced run, chain_gpu.dispatch_scores
(each batch's anchors, for the chain roofline).
"""

from __future__ import annotations

import gc
import importlib.util
import io
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "mm2_gb_tpu")
# the numbers the check compares and their limits: every one is an exact
# comparison, so every limit is 0
LIMITS = {"reads_missing": 0, "anchors_differ": 0, "chain_differ": 0,
          "records_differ": 0, "repeats_differ": 0, "fills_differ": 0,
          "truth_off": 0}
FILLS_PER_BATCH = 4
FILLS_MAX = 64


def log(msg: str) -> None:
    sys.stderr.write(f"[bench_port] {msg}\n")
    sys.stderr.flush()


def process_age() -> float:
    """Seconds since this process started (/proc/self/stat's start time
    against /proc/uptime, to the kernel's clock tick)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's, Flax's or the
    JAX package's (mm2_gb_tpu_torch is the port, not mm2_gb_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_module(path: str):
    """The module in file `path` (names may hold '.' and '-')."""
    name = "bench_port_part_" + "".join(
        c if c.isalnum() else "_" for c in os.path.relpath(path, BENCH))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ discovery

def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """Cell `name` of root/BENCHMARK.json: its configuration (the
    configuration's file), its traffic mix (traffic/<mix>.json) and the
    metrics it reports, each end-to-end and per-layer metric whose
    `workloads` lists the cell or that has no `workloads`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    centry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, centry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def metric_reader(name: str):
    """metrics/<name>.py's read(ctx)."""
    return load_module(os.path.join(BENCH, "metrics", name + ".py")).read


def generator(name: str):
    """gen/<name>.py's make."""
    return load_module(os.path.join(BENCH, "gen", name + ".py")).make


# --------------------------------------------------------------- set-up

def _write_fasta(path: str, reads) -> str:
    with open(path, "w") as f:
        f.writelines(f">{n}\n{s}\n" for n, s in reads)
    return path


def argv_of(cell) -> list[str]:
    """The CLI words the cell maps with: the configuration's argv, and
    --gpu-cfg with the port's device config the configuration names."""
    cfg = cell.config.get("gpu_cfg")
    words = list(cell.config["argv"])
    if cfg:
        from mm2_gb_tpu_torch.utils.gpucfg import CONFIG_DIR
        words += ["--gpu-cfg", os.path.join(CONFIG_DIR, cfg)]
    return words


def setup(cell, seed: int, device: str, workdir: str) -> SimpleNamespace:
    """Everything before the window (see the module's docstring)."""
    st = SimpleNamespace(cell=cell, seed=seed, clock={})
    import torch
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.models import pipeline
    from mm2_gb_tpu_torch.models.index import MinimizerIndex
    from mm2_gb_tpu_torch.utils import opts as O
    from mm2_gb_tpu_torch.utils.fastx import SeqRecord
    from mm2_gb_tpu_torch.utils.gpucfg import derive_caps
    st.device = torch.device(device)
    if st.device.type == "cuda":
        st.device = torch.device("cuda", st.device.index or 0)
        torch.cuda.init()
        torch.cuda.set_device(st.device)
    st.clock["startup_s"] = process_age()

    t = time.perf_counter()
    gcfg = dict(cell.config["genome"], length=cell.config["genome_length"],
                chromosomes=cell.config["chromosomes"])
    st.chroms, _shares = generator(gcfg["generator"])(gcfg, seed)
    st.pool = generator(cell.traffic["generator"])(cell.traffic, st.chroms,
                                                   seed)
    st.pool_path = _write_fasta(os.path.join(workdir, "pool.fa"), st.pool)
    n_warm = int(cell.traffic["warm_reads"])
    st.warm_path = _write_fasta(os.path.join(workdir, "warm.fa"),
                                st.pool[:n_warm])
    st.clock["gen_s"] = time.perf_counter() - t

    _argv, args = cli.parse_args(argv_of(cell) + ["genome.fa",
                                                  st.pool_path])
    args.tpu_chain = True   # the port's main: --device cuda implies it
    io_, mo = O.set_preset(args.preset)
    cli.apply_overrides(args, io_, mo)
    O.check_opt(io_, mo)
    st.mo, st.threads, st.is_sam = mo, args.threads, bool(
        mo.flag & O.MM_F_OUT_SAM)

    t = time.perf_counter()
    st.index = MinimizerIndex.build(
        [SeqRecord(i, n, s) for i, (n, s) in enumerate(st.chroms)], io_)
    O.mapopt_update(mo, st.index)
    st.clock["index_s"] = time.perf_counter() - t

    t = time.perf_counter()
    derive_caps(st.device, 0)
    if st.device.type == "cuda":
        from mm2_gb_tpu_torch.utils import kernels
        kernels.library()
    st.clock["startup_s"] += time.perf_counter() - t

    t = time.perf_counter()
    sink = io.StringIO()
    for sr, regs in pipeline.map_file_gpu_records(
            st.index, mo, [st.warm_path], pipeline.GpuMetrics(), st.threads,
            st.device):
        cli.res_regs_out(sink, st.index, mo, sr.rec, regs, sr.rep_len,
                         st.is_sam, None, 0, 1, [regs])
    if st.device.type == "cuda":
        torch.cuda.synchronize()
    st.clock["warm_s"] = time.perf_counter() - t
    return st


def candidates(lengths: list[int], n: int, seed: int
               ) -> tuple[list[int], list[int]]:
    """The pool positions whose outputs the window keeps for a check of
    n reads: the 2n longest reads of the pool, and 4n others in an order
    drawn from the seed."""
    longest = np.argsort(-np.asarray(lengths), kind="stable")[:2 * n]
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64,
                                                        0xC0DE]))
    skip = set(longest.tolist())
    drawn = [i for i in rng.permutation(len(lengths)).tolist()
             if i not in skip]
    return longest.tolist(), drawn[:4 * n]


def sample(longest: list[int], drawn: list[int], done, lengths: list[int],
           n: int) -> list[int]:
    """The pool positions the check compares: of the candidates the
    window finished (`done`), the longest, and the first n - 1 others in
    the drawn order."""
    got = [i for i in longest + drawn if i in done]
    if not got:
        return []
    first = max(got, key=lambda i: lengths[i])
    return [first] + [i for i in drawn if i in done and i != first][:n - 1]


# -------------------------------------------------------------- wrappers

class Patches:
    """Replace module attributes for the window; restore them after."""

    def __init__(self):
        self.saved = []

    def put(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def restore(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()


def _install(st, cap, trace: bool, patches: Patches) -> None:
    from mm2_gb_tpu_torch.models import pipeline
    from mm2_gb_tpu_torch.ops import chain_gpu, chain_rmq, ksw2_gpu
    finish_read = pipeline.finish_read
    rmq = chain_rmq.chain_rmq
    finish_batch = pipeline._finish_batch
    fill_batch = ksw2_gpu.extd2_fill_batch
    dispatch = chain_gpu.dispatch_scores
    rng = np.random.default_rng(np.random.SeedSequence([st.seed % 2**64,
                                                        0xF111]))

    # the candidate whose finish_read runs on this thread, or None
    # (finish_slices runs them on the pool)
    mine = threading.local()

    def finish_read_w(index, opt, sr, f, p, dump=True):
        name = sr.rec.name
        mine.name = name if cap.pos[name] in cap.keep else None
        if mine.name:
            cap.fp.setdefault(name, (f, p))
        return finish_read(index, opt, sr, f, p, dump)

    def rmq_w(*a, **kw):
        out = rmq(*a, **kw)
        if getattr(mine, "name", None):
            cap.rmq.setdefault(mine.name, out)
        return out

    def finish_batch_w(index, opt, batch, *a, **kw):
        cap.batch_max = max([-1] + [cap.pos[sr.rec.name]
                                    for sr in batch[0]])
        out = finish_batch(index, opt, batch, *a, **kw)
        cap.batch_left = len(out)
        return out

    def fill_batch_w(meta, qblob, tblob, *a, **kw):
        out = fill_batch(meta, qblob, tblob, *a, **kw)
        flag = a[2] if len(a) > 2 else kw.get("flag", ksw2_gpu.APPROX_MAX)
        m = np.asarray(meta, np.int64).reshape(-1, 4)
        if trace:
            cap.fill_metas.append(m)
        if len(cap.fills) < FILLS_MAX and m.shape[0]:
            scores, cig_off, cig_blob = out
            qoff = np.concatenate([[0], np.cumsum(m[:, 0])])
            toff = np.concatenate([[0], np.cumsum(m[:, 1])])
            for i in rng.choice(m.shape[0], min(FILLS_PER_BATCH, m.shape[0]),
                                replace=False).tolist():
                cap.fills.append(dict(
                    q=np.array(qblob[qoff[i]:qoff[i + 1]], np.uint8),
                    t=np.array(tblob[toff[i]:toff[i + 1]], np.uint8),
                    w=int(m[i, 2]), zdrop=int(m[i, 3]), flag=int(flag),
                    score=int(scores[i]),
                    cigar=np.array(cig_blob[cig_off[i]:cig_off[i + 1]],
                                   np.uint32)))
        return out

    def dispatch_w(ax, ay, read_bounds, max_dist_x, max_dist_y, bw,
                   max_iter, *a, **kw):
        pend = dispatch(ax, ay, read_bounds, max_dist_x, max_dist_y, bw,
                        max_iter, *a, **kw)
        cap.chain_calls.append((pend, ax, read_bounds, max(max_dist_x, bw),
                                max_iter))
        return pend

    patches.put(pipeline, "finish_read", finish_read_w)
    patches.put(chain_rmq, "chain_rmq", rmq_w)
    patches.put(pipeline, "_finish_batch", finish_batch_w)
    patches.put(ksw2_gpu, "extd2_fill_batch", fill_batch_w)
    if trace:
        patches.put(chain_gpu, "dispatch_scores", dispatch_w)
        _annotate(patches)


def _annotate(patches: Patches) -> None:
    """Host spans for the traced run, named after the layers: what the
    host was doing while the device was idle."""
    from torch.profiler import record_function
    from mm2_gb_tpu_torch.models import pipeline
    from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu

    def span(name, fn):
        def w(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return w
    for mod, attr, name in (
            (pipeline, "seed_read", "seed"),
            (pipeline, "_finish_batch", "finish"),
            (pipeline, "_prefill_native", "fill collect"),
            (ksw2_gpu, "extd2_fill_batch", "fill batch"),
            (chain_gpu, "dispatch_scores", "range, cut, upload")):
        patches.put(mod, attr, span(name, getattr(mod, attr)))
    collect = chain_gpu.PendingScores.collect
    patches.put(chain_gpu.PendingScores, "collect", span("readback",
                                                         collect))


# --------------------------------------------------------------- window

def window(st, seconds: float, trace: bool) -> SimpleNamespace:
    """Map the pool, pass after pass, for `seconds` (see the module's
    docstring); returns what was emitted and what was recorded."""
    import torch
    from mm2_gb_tpu_torch import cli
    from mm2_gb_tpu_torch.models import pipeline
    from bench_port.reference import truth
    mo, index = st.mo, st.index
    cap = SimpleNamespace(fp={}, rmq={}, keep=set(st.longest + st.drawn),
                          fills=[], fill_metas=[], chain_calls=[],
                          batch_left=0, batch_max=-1,
                          pos={n: i for i, (n, _) in enumerate(st.pool)})
    n_pool = len(st.pool)
    # kept: the candidates' (lines, ax, ay) by pool position; hashes: each
    # position's first lines, to hold later passes to them
    out = SimpleNamespace(kept={}, hashes=[None] * n_pool, repeats_differ=0,
                          truth_off=0, reads=0, bases=0, passes=0,
                          batches=0, skipped=0)
    nxt = 0   # the pool index the next emission should have
    last_p = -1
    metrics = pipeline.GpuMetrics()
    patches = Patches()
    _install(st, cap, trace, patches)
    prof = None
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if st.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        t_prof = time.perf_counter()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        t_last = t0
        done = False
        while not done:
            gen = pipeline.map_file_gpu_records(index, mo, [st.pool_path],
                                                metrics, st.threads,
                                                st.device)
            try:
                for sr, regs in gen:
                    name = sr.rec.name
                    buf = io.StringIO()
                    cli.res_regs_out(buf, index, mo, sr.rec, regs,
                                     sr.rep_len, st.is_sam, None, 0, 1,
                                     [regs])
                    text = buf.getvalue()
                    p = cap.pos[name]
                    if out.hashes[p] is None:
                        out.hashes[p] = hash(text)
                        out.truth_off += truth.off(name, text, st.is_sam)
                        if p in cap.keep:
                            out.kept[p] = (text, sr.ax, sr.ay)
                    elif out.hashes[p] != hash(text):
                        out.repeats_differ += 1
                    out.reads += 1
                    out.bases += sr.rec.length
                    # the pipeline emits in input order: a read it
                    # skipped is missing
                    out.skipped += (p - nxt) % n_pool
                    nxt, last_p = (p + 1) % n_pool, p
                    t_last = time.perf_counter()
                    cap.batch_left -= 1
                    if cap.batch_left <= 0:
                        out.batches += 1
                        if t_last >= deadline:
                            done = True
                            break
                else:
                    out.passes += 1
            finally:
                gen.close()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        if st.device.type == "cuda":
            torch.cuda.synchronize()
        if prof is not None:
            t_stop = time.perf_counter()
            prof.stop()
    finally:
        patches.restore()
    # the reads of the last finished batch that were never emitted
    out.skipped += max(0, cap.batch_max - last_p)
    out.seconds = t_last - t0
    out.metrics = metrics
    out.cap = cap
    out.cpu_s = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    out.trace = None
    if prof is not None:
        out.trace = read_trace(prof, st.device, t_stop - t_prof, st.workdir)
        if out.trace.busy_s == 0 and st.device.type == "cuda":
            # the profiler's trace shows no device time: the kernels' CUDA
            # events instead
            f = metrics.fills
            out.trace.busy_s = metrics.t_kernel + (f.fill_ms
                                                   + f.backtrack_ms) / 1e3
    return out


def read_trace(prof, device, window_s: float, workdir: str):
    """busy_s (the union of the device's kernels, copies and sets),
    window_s, the device operations that took most time and the longest
    idle gaps, each named by the host spans that covered its middle."""
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", cat)))
        elif cat == "user_annotation":
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]))
    if device.type != "cuda" or not dev:
        return SimpleNamespace(busy_s=0.0, window_s=window_s, device_ops=[],
                               idle_gaps=[])
    dev.sort()
    busy = 0.0
    gaps = []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:10]:
        mid = (s + e) / 2
        what = sorted({n for hs, he, n in host if hs <= mid <= he})
        named.append(["+".join(what) or "host: other", (e - s) / 1e6])
    return SimpleNamespace(busy_s=busy / 1e6, window_s=window_s,
                           device_ops=[[n, v] for n, v in ops],
                           idle_gaps=named)


# ---------------------------------------------------------------- check

def chains_equal(p: dict, r: dict) -> bool:
    """Whether the program's chaining of a read (`p`) is the reference's
    (`r`): the RMQ chains (u, cx, cy) where the reference chained by RMQ,
    else the DP's scores and predecessors (f, p); a key the program never
    gave differs."""
    keys = ("u", "cx", "cy") if "u" in r else ("f", "p")
    return all(np.array_equal(p.get(k), r[k]) for k in keys)


def compare(reads: list[str], prog: dict, ref: dict) -> dict:
    """The counts of reads whose anchors, chains (chains_equal) or
    records differ between the program (`prog`: name -> {"ax", "ay",
    "lines"} and "f", "p" or "u", "cx", "cy", a key missing where the
    program never gave it) and the reference."""
    n = dict(anchors_differ=0, chain_differ=0, records_differ=0)
    for name in reads:
        p, r = prog[name], ref[name]
        if not (np.array_equal(p.get("ax"), r["ax"])
                and np.array_equal(p.get("ay"), r["ay"])):
            n["anchors_differ"] += 1
        if not chains_equal(p, r):
            n["chain_differ"] += 1
        if p.get("lines") != r["lines"]:
            n["records_differ"] += 1
    return n


def check(st, w) -> SimpleNamespace:
    """Compare a sample of the reads the window finished, drawn from the
    seed with the longest in it, and the sampled gap fills with the plain
    reference.  reads_missing counts the reads the emissions skipped
    (each pass emits the pool in order) and those of the last finished
    batch that never came; truth_off the finished reads whose primary
    record is a confident wrong answer (reference/truth.py)."""
    from bench_port.reference import check as ref
    lengths = [len(s) for _, s in st.pool]
    due = [st.pool[i][0] for i in sample(st.longest, st.drawn, w.kept,
                                         lengths, st.n_check)]
    seqs = dict(st.pool)
    t = time.perf_counter()
    argv = list(st.cell.config["argv"])
    rindex, rmo = ref.index_and_options(st.chroms, argv)
    t_index = time.perf_counter() - t
    got = ref.map_reads(rindex, argv, [(n, seqs[n]) for n in due])
    prog = {}
    for n in due:
        text, ax, ay = w.kept[w.cap.pos[n]]
        d = dict(ax=ax, ay=ay, lines=text)
        if n in w.cap.fp:
            d.update(f=w.cap.fp[n][0], p=w.cap.fp[n][1])
        if n in w.cap.rmq:
            d.update(zip(("u", "cx", "cy"), w.cap.rmq[n]))
        prog[n] = d
    nums = dict(reads_missing=w.skipped)
    nums.update(compare(due, prog, got))
    nums["repeats_differ"] = w.repeats_differ
    fills_differ = 0
    t_fills = time.perf_counter()
    for fl in w.cap.fills:
        sc, cig = ref.fill(rmo, fl["q"], fl["t"], fl["w"], fl["zdrop"],
                           fl["flag"])
        if sc != fl["score"] or not np.array_equal(cig, fl["cigar"]):
            fills_differ += 1
    nums["fills_differ"] = fills_differ
    t_fills = time.perf_counter() - t_fills
    nums["truth_off"] = w.truth_off
    wrong = {n for n in due if prog[n].get("lines") != got[n]["lines"]
             or not chains_equal(prog[n], got[n])}
    return SimpleNamespace(
        numbers=nums, reads=len(due), fills=len(w.cap.fills),
        failed=len(wrong) + fills_differ + w.truth_off,
        correct=bool(due) and all(nums[k] <= LIMITS[k] for k in LIMITS),
        seconds=time.perf_counter() - t, index_s=t_index,
        bases=sum(len(seqs[n]) for n in due),
        chain_s=sum(got[n]["seconds"]["chain"] for n in due),
        map_s=sum(got[n]["seconds"]["all"] for n in due), fills_s=t_fills,
        fill_max=max([(0, 0)] + [(fl["t"].size, fl["q"].size)
                                 for fl in w.cap.fills]))


# ----------------------------------------------------------------- a run

def device_info(device, peak: int) -> dict:
    import torch
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1, memory_peak_bytes=int(peak))


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        workdir: str | None = None, n_check: int | None = None) -> dict:
    """One run of `cell`; returns the result line's object.  The
    caller checks for the card first (run.py)."""
    import torch
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="bench_port.")
    try:
        st = setup(cell, seed, device, workdir)
        st.workdir = workdir
        st.n_check = n_check or int(cell.traffic["check_reads"])
        st.longest, st.drawn = candidates([len(s) for _, s in st.pool],
                                          st.n_check, seed)
        st.clock["setup_s"] = process_age()
        w = window(st, seconds, trace)
        peak = (torch.cuda.max_memory_allocated(st.device)
                if st.device.type == "cuda" else 0)
        bad = forbidden_modules()
        if bad:
            raise RuntimeError("modules of JAX or the JAX package are "
                               f"loaded: {', '.join(bad)}")
        log(f"window: {w.reads} reads, {w.bases} bases, {w.batches} "
            f"batches, {w.passes} whole passes over {len(st.pool)} reads, "
            f"{w.seconds:.3f} s; {w.metrics.n_anchors} anchors; mid_occ "
            f"{st.mo.mid_occ}; device memory peak {peak} bytes; "
            f"{os.cpu_count()} host cores; set-up: " + ", ".join(
                f"{k} {v:.3f}" for k, v in st.clock.items()))
        m = w.metrics
        log(f"window stages: seed {m.t_seed:.3f} s, dispatch "
            f"{m.t_range + m.t_pack + m.t_dispatch:.3f} s, wait "
            f"{m.t_wait:.3f} s, finish {m.t_finish:.3f} s (collect "
            f"{m.t_collect:.3f}, fill batch {m.fills.batch_s:.3f}), chain "
            f"kernel {m.t_kernel:.6f} s, fill kernel {m.fills.fill_ms:.3f} "
            f"ms, backtrack kernel {m.fills.backtrack_ms:.3f} ms, host CPU "
            f"{w.cpu_s:.3f} s")
        del st.index
        gc.collect()
        if st.device.type == "cuda":
            torch.cuda.empty_cache()
        ck = check(st, w)
        log(f"check: {ck.reads} reads ({ck.bases} bases) and {ck.fills} "
            f"gap fills against the reference in {ck.seconds:.3f} s (its "
            f"index {ck.index_s:.3f} s; summed over its workers, chaining "
            f"{ck.chain_s:.3f} s of mapping {ck.map_s:.3f} s; the fills "
            f"{ck.fills_s:.3f} s, the largest {ck.fill_max[0]} target by "
            f"{ck.fill_max[1]} query bases); the primary records of "
            f"{sum(h is not None for h in w.hashes)} reads against their "
            "origins")
        ctx = SimpleNamespace(cell=cell, clock=st.clock, window=w,
                              metrics=w.metrics, fills=w.metrics.fills,
                              gbp=w.bases / 1e9, trace=w.trace)
        metrics = {}
        for m in cell.per_layer if trace else cell.end_to_end:
            v = (st.clock["setup_s"] if m["name"] == "setup_s"
                 else metric_reader(m["name"])(ctx))
            if v is not None:   # a reader with nothing to read
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res = dict(correct=ck.correct, attempted=w.reads, failed=ck.failed,
                   metrics=metrics, device=device_info(st.device, peak))
        if trace:
            res["device"].update(busy_s=w.trace.busy_s,
                                 window_s=w.trace.window_s)
            res["breakdown"] = dict(device_ops=w.trace.device_ops,
                                    idle_gaps=w.trace.idle_gaps)
        res["check"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in ck.numbers.items()}
        return res
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
