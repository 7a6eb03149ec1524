"""GPU chaining: range selection, segment cutting and the chain kernel.

Port of the host half of mm2_gb_tpu/ops/chain_tpu.py and of
ops/chain_xla.py.  The device DP is the hand-written CUDA kernel in
csrc/chain_kernel.cu (a warp, a group of warps or a block per segment by
its size, `segment_shape`, the window in shared memory);
`chain_segments_torch` is its plain PyTorch twin, which the wrapper
`chain_segments` takes only for tensors on the CPU.

- **Range selection** (`compute_ranges`, plrange.cu:38-76 analog):
  per-anchor successor count, on the host.
- **Segment cutting** (`cut_segments`): the anchor stream is severed
  after every anchor with range 0; segments are independent DP problems.
- **Forward score kernel** (`chain_segments`): for every anchor j,
  f[j] = max(span, max_i f[i] + sc(i, j)) over 0 < j - i <= rng[i],
  with the reference's tie rule (see the kernel source).

Like the TPU and the reference GPU paths, the device DP assumes a
uniform minimizer span (non-HPC presets) and `max_skip` = infinity; HPC
batches chain on the host with the oracle (`chain_scores_host`).  The
kernel has no window-width limit, so every other segment, however wide
its successor ranges, chains on the device.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, replace

import numpy as np
import torch

from mm2_gb_tpu_torch.utils import kernels, timeline

INT32_MIN = -(2**31)

launches = 0  # chain kernel launches (chain_segments on CUDA tensors)
# the segments those launches gave each class: ("chain_segments", "warp" |
# "group" | "block" | "block_global"), block_global a block-class segment
# whose window is read from global memory
launch_classes = Counter()

# the kernel's block (kChainThreads) and a mid segment's group of warps
# (kGroupThreads); the block's ring of RING_SLOTS anchors (16 bytes each
# of shared memory), of which a group takes a quarter and a warp a
# sixteenth.  A segment of at most SHORT_LEN anchors takes a warp and one
# of at most MID_LEN a group: their rings hold the whole segment.  A
# longer one takes the block, with the window in the ring when the
# segment or its widest range plus CHAIN_THREADS fits it, else read from
# global memory.
CHAIN_THREADS = 512
GROUP_THREADS = 128
CHAIN_BLOCKS_PER_SM = 2
RING_SLOTS = 4096
SHORT_LEN = RING_SLOTS // (CHAIN_THREADS // 32)
MID_LEN = RING_SLOTS // (CHAIN_THREADS // GROUP_THREADS)


# --------------------------------------------------------------------------
# range selection + segment cutting (host, vectorized)
# --------------------------------------------------------------------------

def compute_ranges(ax: np.ndarray, read_bounds: np.ndarray,
                   max_dist_x: int, max_iter: int) -> np.ndarray:
    """Successor count per anchor (plrange analog).

    `ax` is the concatenated anchor x-column of a batch of reads, each
    read's slice sorted; `read_bounds` are start offsets per read (with a
    trailing total).  range[i] = #succ j>i in the same (read, strand, rid)
    group with rpos_j <= rpos_i + max_dist_x, capped at max_iter.
    """
    n = ax.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    from mm2_gb_tpu_torch.utils import native
    if native.available():
        return native.compute_ranges(ax, read_bounds, max_dist_x, max_iter)
    hi = (ax >> np.uint64(32)).astype(np.int64)       # rev|rid
    grp_change = np.zeros(n, dtype=bool)
    grp_change[0] = True
    grp_change[1:] = hi[1:] != hi[:-1]
    starts = read_bounds[:-1]
    grp_change[starts[starts < n]] = True  # anchor-less reads share bounds
    g = np.cumsum(grp_change).astype(np.int64)
    rpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    comp = (g << 33) | rpos
    hi_idx = np.searchsorted(comp, (g << 33) | (rpos + max_dist_x),
                             side="right")
    rng = hi_idx - np.arange(n, dtype=np.int64) - 1
    return np.minimum(rng, max_iter).astype(np.int32)


def cut_segments(rng: np.ndarray) -> np.ndarray:
    """Segment start offsets (with trailing total).

    A cut after every anchor with range == 0 is provably safe: positions
    are sorted, so if the next anchor is out of the gap window for i it is
    out of the window for every j < i as well.
    """
    n = rng.shape[0]
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    ends = np.nonzero(rng == 0)[0] + 1
    return np.concatenate(([0], ends)).astype(np.int64)


def segment_work(bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) int32 of the segments with at least two anchors,
    longest first: the kernel's work order.  A one-anchor segment needs
    no work: it keeps (span, 0)."""
    lens = np.diff(bounds)
    idx = np.nonzero(lens >= 2)[0]
    idx = idx[np.argsort(-lens[idx], kind="stable")]
    return (bounds[:-1][idx].astype(np.int32),
            bounds[1:][idx].astype(np.int32))


@dataclass
class SegmentShape:
    """The chain kernel's work (segment_shape)."""
    work: np.ndarray | torch.Tensor   # int32 [m, 4]: start, end, widest
    #   range, 1 when the window is in the ring (0: global memory); the
    #   long segments, then the mid and the short ones, each longest first
    n_long: int
    n_mid: int
    n_short: int
    n_global: int = 0   # long segments whose window is in global memory


def segment_shape(starts: np.ndarray, ends: np.ndarray,
                  rng: np.ndarray) -> SegmentShape:
    """Each segment's class (the unit of threads the kernel gives it) and
    whether its window fits the unit's ring.  starts, ends: the segments
    (non-overlapping, e - s >= 2, any order); rng: every anchor's range.
    A segment of at most SHORT_LEN anchors takes a warp, of at most
    MID_LEN a group of GROUP_THREADS, else the block; each class is
    listed longest first (stably), long, mid, short."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    m = starts.shape[0]
    work = np.zeros((m, 4), np.int32)
    if m == 0:
        return SegmentShape(work, 0, 0, 0)
    # the widest range of each segment: a max over [s, e), taken at the
    # even entries of the interleaved bounds
    order = np.argsort(starts, kind="stable")
    idx = np.stack([starts[order], ends[order]], 1).ravel()
    wide = np.empty(m, np.int64)
    wide[order] = np.maximum.reduceat(
        np.append(np.asarray(rng, np.int64), 0), idx)[::2]
    lens = ends - starts
    cls = np.where(lens <= SHORT_LEN, 2, np.where(lens <= MID_LEN, 1, 0))
    ring = (cls > 0) | (lens <= RING_SLOTS) | (wide + CHAIN_THREADS
                                                <= RING_SLOTS)
    pick = np.lexsort((-lens, cls))   # class, then longest first (stable)
    work[:, 0], work[:, 1] = starts[pick], ends[pick]
    work[:, 2], work[:, 3] = wide[pick], ring[pick]
    n = np.bincount(cls, minlength=3)
    return SegmentShape(work, int(n[0]), int(n[1]), int(n[2]),
                        int((~ring).sum()))


# --------------------------------------------------------------------------
# score function (plain PyTorch; the kernel's pair_total is its twin)
# --------------------------------------------------------------------------

def mg_log2_f32(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact mg_log2 (mmpriv.h:118-126) on a float32 tensor.

    Eager PyTorch runs each product and sum as its own rounded op, so no
    fused multiply-add can form (the JAX package pins this with _nofma).
    """
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    zi = x.view(torch.int32)
    e = ((zi >> 23) & 255) - 128
    zf = ((zi & -0x7F800001) + (127 << 23)).view(torch.float32)  # 0x807FFFFF
    r = zf * c(-0.34484843) + c(2.02466578)
    r = r * zf
    r = r + c(-0.67487759)
    return e.to(torch.float32) + r


def pair_score(xs, ys, ss, xp, yp, sp, fp, max_dist_x, max_dist_y, bw,
               cg, cs, is_cdna=False):
    """Score of predecessor (xp, yp, span sp, score fp) against successors
    (xs, ys, span ss).  Returns (total, valid) int32/bool tensors.

    Single-segment-read form of comput_sc (lchain.c:113-138).  is_cdna
    (splice chaining): a deletion-side gap (dr > dq, a candidate intron)
    pays min(lin_pen, log_pen) instead of lin + 0.5*log (lchain.c:128-133).
    Integer differences wrap like int32; float penalties truncate toward
    zero.  `sp` is the uniform span (an int); `ss` is unused, as in the
    JAX form.
    """
    del ss
    dq = ys - yp
    dr = xs - xp
    dd = (dr - dq).abs()
    valid = (dq > 0) & (dq <= max_dist_x) & (dr != 0) & (dd <= bw)
    if max_dist_y != max_dist_x:
        valid &= dq <= max_dist_y
    dg = torch.minimum(dr, dq)
    sc = dg.clamp(max=sp)
    cg = torch.tensor(cg, dtype=torch.float32, device=dd.device)
    cs = torch.tensor(cs, dtype=torch.float32, device=dd.device)
    lin = cg * dd.to(torch.float32) + cs * dg.to(torch.float32)
    log_pen = torch.where(dd >= 1, mg_log2_f32((dd + 1).to(torch.float32)),
                          torch.zeros((), dtype=torch.float32,
                                      device=dd.device))
    pen = (lin + log_pen * 0.5).to(torch.int32)
    if is_cdna:
        pen_min = torch.minimum(lin, log_pen).to(torch.int32)
        pen = torch.where(dr > dq, pen_min, pen)
    sc = torch.where((dd != 0) | (dg > sp), sc - pen, sc)
    return sc + fp, valid


# --------------------------------------------------------------------------
# the chain DP: plain twin and kernel wrapper
# --------------------------------------------------------------------------

def _check_operands(x, y, rng, seg_start, seg_end) -> None:
    n = x.shape[0]
    for name, t, m in (("x", x, n), ("y", y, n), ("rng", rng, n),
                       ("seg_start", seg_start, None),
                       ("seg_end", seg_end, seg_start.shape[0])):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"chain_segments: {name} must be a contiguous "
                             "1-D int32 tensor")
        if m is not None and t.shape[0] != m:
            raise ValueError(f"chain_segments: {name} has {t.shape[0]} "
                             f"elements, expected {m}")
        if t.device != x.device:
            raise ValueError(f"chain_segments: {name} is on {t.device}, "
                             f"x on {x.device}")


def chain_segments_torch(x, y, rng, seg_start, seg_end, *, span,
                         max_dist_x, max_dist_y, bw, cg, cs, is_cdna=False):
    """Plain PyTorch chain DP (the torch form of chain_xla.chain_bucket_xla).

    Steps t = 1, 2, ... walk every segment in lockstep: the anchor t rows
    into each segment still that long relaxes against its predecessor
    window of the previous min(t, widest range) anchors.  Same inputs and
    outputs as `chain_segments`; runs on any device.
    """
    n = x.shape[0]
    dev = x.device
    f = torch.full((n,), span, dtype=torch.int32, device=dev)
    p = torch.zeros(n, dtype=torch.int32, device=dev)
    if seg_start.shape[0] == 0:
        return f, p
    st = seg_start.to(torch.int64)
    lens = seg_end.to(torch.int64) - st
    order = torch.argsort(lens, descending=True, stable=True)
    st, lens = st[order], lens[order]
    # widest successor range per segment bounds its window
    seg_id = torch.repeat_interleave(
        torch.arange(st.shape[0], device=dev), lens)
    offs = torch.cumsum(lens, 0) - lens
    anchor = st[seg_id] + torch.arange(seg_id.shape[0], device=dev) \
        - offs[seg_id]
    win = torch.zeros(st.shape[0], dtype=torch.int32, device=dev)
    win.scatter_reduce_(0, seg_id, rng[anchor], "amax")
    lens_h = lens.cpu().numpy()
    cwin = np.maximum.accumulate(win.cpu().numpy())
    k_all = torch.arange(1, int(cwin[-1]) + 1, device=dev)[:, None]
    for t in range(1, int(lens_h[0])):
        s_t = int(np.searchsorted(-lens_h, -t, side="left"))  # len > t
        w = min(t, int(cwin[s_t - 1]))
        if w == 0:
            continue
        dest = st[:s_t] + t
        k = k_all[:w]
        pred = dest[None, :] - k
        tot, valid = pair_score(x[dest], y[dest], span, x[pred], y[pred],
                                span, f[pred], max_dist_x, max_dist_y, bw,
                                cg, cs, is_cdna)
        ok = valid & (k <= rng[pred]) & (tot != span)
        totm = torch.where(ok, tot, INT32_MIN)
        best = totm.max(0).values
        # largest i at the maximum == smallest distance k
        kwin = torch.where(totm == best, k, w + 1).min(0).values
        acc = best >= span
        f[dest] = torch.where(acc, best, span)
        p[dest] = torch.where(acc, kwin, 0).to(torch.int32)
    return f, p


def chain_segments(x, y, rng, seg_start, seg_end, *, span, max_dist_x,
                   max_dist_y, bw, cg, cs, is_cdna=False, events=None,
                   shape=None):
    """Chain DP over the segments [seg_start[k], seg_end[k]).

    x, y: low 32 bits of the anchors' (ref, query) positions; rng: the
    successor ranges; all int32 [n].  Returns (f, p) int32 [n]; p is the
    predecessor distance (0 = none); anchors outside every listed
    segment keep (span, 0).  Segments have at least two anchors and do
    not overlap (`segment_work` lists them longest first).

    CPU tensors take the plain twin; CUDA tensors launch the kernel
    (built on first use); a build or launch failure raises.  events: a
    (start, end) pair of CUDA events recorded right around the launch,
    after the wrapper's host work, or None.  shape: the segments'
    `segment_shape` (its work on the device or in numpy), or None to
    make it here from the segments and ranges (a device-to-host copy).
    """
    global launches
    _check_operands(x, y, rng, seg_start, seg_end)
    if x.device.type == "cpu":
        return chain_segments_torch(
            x, y, rng, seg_start, seg_end, span=span, max_dist_x=max_dist_x,
            max_dist_y=max_dist_y, bw=bw, cg=cg, cs=cs, is_cdna=is_cdna)
    if x.device.type != "cuda":
        raise ValueError(f"chain_segments: unsupported device {x.device}")
    lib = kernels.library()
    n = x.shape[0]
    f = torch.full((n,), span, dtype=torch.int32, device=x.device)
    p = torch.zeros(n, dtype=torch.int32, device=x.device)
    if seg_start.shape[0] == 0:
        return f, p
    if shape is None:
        shape = segment_shape(seg_start.cpu().numpy(), seg_end.cpu().numpy(),
                              rng.cpu().numpy())
    work = shape.work
    if not isinstance(work, torch.Tensor):
        work = torch.from_numpy(work)
    work = work.to(x.device).contiguous()
    if work.dtype != torch.int32 or work.shape != (seg_start.shape[0], 4):
        raise ValueError("chain_segments: shape.work must be int32 "
                         f"[{seg_start.shape[0]}, 4]")
    if work.data_ptr() % 16:   # the kernel reads a row as one int4
        work = work.clone()
    counters = torch.zeros(3, dtype=torch.int32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    units = (shape.n_long + -(-shape.n_mid // (CHAIN_THREADS // GROUP_THREADS))
             + -(-shape.n_short // (CHAIN_THREADS // 32)))
    n_blocks = max(1, min(units, sms * CHAIN_BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if events is not None:
        events[0].record()
    rc = lib.mm2_chain_segments(
        x.data_ptr(), y.data_ptr(), rng.data_ptr(), work.data_ptr(),
        shape.n_long, shape.n_mid, shape.n_short, counters.data_ptr(),
        f.data_ptr(), p.data_ptr(), int(span), int(max_dist_x),
        int(max_dist_y), int(bw), float(cg), float(cs), int(bool(is_cdna)),
        n_blocks, CHAIN_THREADS, RING_SLOTS, stream)
    if events is not None:
        events[1].record()
    kernels.check(rc, "chain_segments")
    launches += 1
    for cls, n in (("warp", shape.n_short), ("group", shape.n_mid),
                   ("block", shape.n_long), ("block_global", shape.n_global)):
        launch_classes["chain_segments", cls] += n
    return f, p


def mg_log2_kernel(x: torch.Tensor) -> torch.Tensor:
    """The kernel's own mg_log2 over a float32 CUDA tensor (test entry:
    checks the device bit arithmetic against utils.hashkit.mg_log2)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("mg_log2_kernel takes a float32 CUDA tensor")
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = kernels.library().mm2_mg_log2(
        x.data_ptr(), out.data_ptr(), x.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "mg_log2")
    return out


# --------------------------------------------------------------------------
# batch dispatch
# --------------------------------------------------------------------------

class PendingScores:
    """In-flight device chain scores for one macro-batch.

    dispatch_scores() uploads the batch from pinned host memory and
    launches the kernel on a side stream without blocking; collect()
    waits on the batch's event and scatters the results back.  The host
    backtracks the previous batch between the two (the reference's
    drain-previous-while-next-runs design, plchain.cu:292-306).
    """

    def __init__(self, n: int):
        self.f = np.zeros(n, dtype=np.int32)
        self.p = np.full(n, -1, dtype=np.int64)
        self.collected = n == 0
        self.metrics = None
        self.out = None        # [2, n] int32 results (pinned on CUDA)
        self.done = None       # CUDA event recorded after the readback
        self.timing = None     # (start, end) CUDA events around the kernel
        self.keep = ()         # buffers that must outlive the copies

    def collect(self) -> tuple[np.ndarray, np.ndarray]:
        """Block on the device results and scatter into (f, p)."""
        if not self.collected:
            if self.done is not None:
                self.done.synchronize()
            if self.timing is not None and self.metrics is not None:
                self.metrics.t_kernel += \
                    self.timing[0].elapsed_time(self.timing[1]) / 1e3
            out = self.out.numpy()
            self.f[:] = out[0]
            prel = out[1].astype(np.int64)
            self.p[:] = np.where(prel > 0,
                                 np.arange(prel.shape[0]) - prel, -1)
            self.out = self.done = self.timing = None
            self.keep = ()
            self.collected = True
        return self.f, self.p


def chain_scores_host(ax: np.ndarray, ay: np.ndarray, max_dist_x: int,
                      max_dist_y: int, bw: int, max_iter: int, cg: float,
                      cs: float, is_cdna: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The host oracle over one read's anchors (the JAX package's
    `_chain_dp_scores` at max_skip = infinity): (f, p) with p a local
    index, -1 for none.  The HPC route of dispatch_scores."""
    from mm2_gb_tpu_torch.ops.chain import _chain_dp_scores
    return _chain_dp_scores(ax, ay, max(max_dist_x, bw), max(max_dist_y, bw),
                            bw, 2**31 - 1, max_iter, np.float32(cg),
                            np.float32(cs), is_cdna, 1)


def dispatch_scores(ax: np.ndarray, ay: np.ndarray,
                    read_bounds: np.ndarray, max_dist_x: int,
                    max_dist_y: int, bw: int, max_iter: int,
                    cg: float, cs: float, metrics=None,
                    device: torch.device | str = "cuda",
                    is_cdna: bool = False,
                    stream: torch.cuda.Stream | None = None
                    ) -> PendingScores:
    """Cut a batch into segments and launch its chain scoring.

    Host work (range selection, cutting, work order) happens here.  On a
    CUDA device the upload, kernel and readback are queued on `stream`
    (a new side stream when None) and this returns at once; on the CPU
    the twin runs before it returns.  Non-uniform-span (HPC) input
    chains on the host, mirroring the reference GPU path's fixed-span
    restriction (plscore.cuh:11) and CPU fallback (map.c:1030-1035); the
    route is counted in `metrics`.  The three steps are spans
    (`dispatch.range`, `dispatch.pack`, `dispatch.upload`) that feed
    metrics.t_range, t_pack and t_dispatch.
    """
    device = torch.device(device)
    n = ax.shape[0]
    pend = PendingScores(n)
    if n == 0:
        return pend
    if max_dist_x < bw:
        max_dist_x = bw
    if max_dist_y < bw:
        max_dist_y = bw

    span32 = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    span = int(span32[0])
    if not np.all(span32 == span):
        # each read on its own: the oracle's windows and max_iter hold
        # within one read's sorted anchors (a batch's are not sorted)
        for s, e in zip(read_bounds[:-1].tolist(), read_bounds[1:].tolist()):
            if e > s:
                f, p = chain_scores_host(ax[s:e], ay[s:e], max_dist_x,
                                         max_dist_y, bw, max_iter, cg, cs,
                                         is_cdna)
                pend.f[s:e] = f
                pend.p[s:e] = np.where(p >= 0, p + s, -1)
        pend.collected = True
        if metrics is not None:
            metrics.n_host_hpc += 1
        return pend

    with timeline.span("dispatch.range") as sp:
        rng = compute_ranges(ax, read_bounds, max_dist_x, max_iter)
        bounds = cut_segments(rng)
        n_segs = bounds.shape[0] - 1
        starts, ends = segment_work(bounds)
    if metrics is not None:
        metrics.t_range += sp.wall_s
        metrics.n_segs += int(n_segs)
        metrics.n_pairs += int(rng.sum(dtype=np.int64))

    m = starts.shape[0]
    if m == 0:
        # no anchor has a successor: each keeps its span and no
        # predecessor, and nothing goes to the device (chain_segments
        # would return before its launch, its events unrecorded)
        pend.f[:] = span
        pend.collected = True
        return pend

    cuda = device.type == "cuda"
    with timeline.span("dispatch.pack") as sp:
        # the kernel's work rows first, where the buffer is 16-aligned
        shape = segment_shape(starts, ends, rng) if cuda else None
        w = 4 * m if cuda else 0
        host = torch.empty(w + 3 * n + 2 * m, dtype=torch.int32,
                           pin_memory=cuda)
        hv = host.numpy()
        if cuda:
            hv[:w] = shape.work.ravel()
        hv[w:w + n] = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
        hv[w + n:w + 2 * n] = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
        hv[w + 2 * n:w + 3 * n] = rng
        hv[w + 3 * n:w + 3 * n + m] = starts
        hv[w + 3 * n + m:] = ends
    if metrics is not None:
        metrics.t_pack += sp.wall_s
        metrics.n_dispatch += 1

    params = dict(span=span, max_dist_x=max_dist_x, max_dist_y=max_dist_y,
                  bw=bw, cg=cg, cs=cs, is_cdna=is_cdna)
    with timeline.span("dispatch.upload") as sp:
        if cuda:
            stream = stream or torch.cuda.Stream(device=device)
            t_start = torch.cuda.Event(enable_timing=True)
            t_end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                dev = host.to(device, non_blocking=True)
                ops, shape = dev[w:], replace(shape,
                                              work=dev[:w].view(m, 4))
                f, p = chain_segments(ops[:n], ops[n:2 * n],
                                      ops[2 * n:3 * n],
                                      ops[3 * n:3 * n + m], ops[3 * n + m:],
                                      events=(t_start, t_end), shape=shape,
                                      **params)
                out = torch.empty((2, n), dtype=torch.int32,
                                  pin_memory=True)
                out[0].copy_(f, non_blocking=True)
                out[1].copy_(p, non_blocking=True)
                pend.done = torch.cuda.Event()
                pend.done.record(stream)
            pend.timing = (t_start, t_end)
            pend.keep = (host, dev, f, p)
        else:
            f, p = chain_segments(host[:n], host[n:2 * n],
                                  host[2 * n:3 * n], host[3 * n:3 * n + m],
                                  host[3 * n + m:], **params)
            out = torch.stack([f, p])
        pend.out = out
        pend.collected = False
        pend.metrics = metrics
    if metrics is not None:
        metrics.t_dispatch += sp.wall_s
    return pend


def chain_scores_device(ax: np.ndarray, ay: np.ndarray,
                        read_bounds: np.ndarray, max_dist_x: int,
                        max_dist_y: int, bw: int, max_iter: int,
                        cg: float, cs: float, *, is_cdna: bool = False,
                        device: torch.device | str = "cuda",
                        metrics=None) -> tuple[np.ndarray, np.ndarray]:
    """Synchronous dispatch + collect (see dispatch_scores)."""
    return dispatch_scores(ax, ay, read_bounds, max_dist_x, max_dist_y,
                           bw, max_iter, cg, cs, metrics, device,
                           is_cdna).collect()
