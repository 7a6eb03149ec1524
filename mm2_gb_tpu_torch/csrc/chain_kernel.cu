// Segmented forward chaining DP for Hopper (sm_90a).
//
// Replaces the Pallas kernel mm2_gb_tpu/ops/chain_tpu.py::_chain_kernel
// (with the scatter/gather of chain_compact_tpu around it).  For every
// anchor j of a segment it computes
//
//     f[j] = max(span, max_i f[i] + sc(i, j))   over 0 < j - i <= rng[i]
//     p[j] = j - i of the winning i, 0 when none
//
// where sc is comput_sc (minimap2 lchain.c:113-138) in float32 with the
// bit-exact mg_log2 approximation.  The selection is the order-free form
// of the reference's ascending last-wins `>=` fold: a candidate whose
// total equals `span` never relaxes, the maximum total wins, and among
// equal totals the largest i wins; the result is accepted only when the
// maximum is above `span`.
//
// What bounds it: dependent latency, not bytes.  f[j] needs the final
// f[i] of its whole predecessor window, so a segment is a chain of
// n_seg dependent steps, each a pass over the window plus a reduction.
// The first port ran a warp per segment and read the window from global
// memory: the flowcell's launches lasted as long as their longest segment
// (~9,600 anchors, ~470 predecessors a step) at 2.5-2.9 us a step, the
// latency of a ballot scan, window/32 rounds of L1/L2 loads and a
// 5-level shuffle reduction.  The design (mm2-gb's size-classed split,
// plscore.cu:330-451, with the window in shared memory):
//   - size classes, chosen per segment by the wrapper
//     (chain_gpu.segment_shape): a warp per short segment (at most
//     SHORT_LEN anchors), a group of four warps per mid segment (at most
//     MID_LEN), the whole block of 512 threads per long one.  One
//     persistent launch holds them all: every block first takes long
//     segments from an atomic queue, longest first, then its four groups
//     take mid segments and then its warps short ones from queues of
//     their own, so the longest dependent chains start first and the rest
//     fill in behind them (one launch: a launch per class would run the
//     classes one after the other);
//   - the window in shared memory: a unit (the block, a group, a warp)
//     keeps x, y, rng and f of its segment's anchors in a ring of its
//     share of the block's RING_SLOTS slots, anchor i in slot i mod the
//     unit's slots.  Every NT steps (NT the unit's threads) the unit loads
//     the next NT anchors; a slot is overwritten only once no later
//     window reaches it, which holds when the segment fits the ring or its
//     widest range plus NT fits it (segment_shape checks it).  A long
//     segment whose widest range is larger reads its window from global
//     memory inside the kernel (the same code, another address space);
//   - the forward pointer lo (the first i whose range reaches j) for the
//     unit's next NT steps is computed with those loads, each warp
//     scanning its 32 steps by ballots from a bound it already holds, so
//     no scan sits on a step's chain;
//   - a step splits the window's pairs over the unit's threads, reduces
//     (total, i) per warp with two __reduce_max_sync (the largest total,
//     then the largest i at it), and across the unit's warps through
//     parity slots read after one barrier; thread 0 writes f[j], p[j] to
//     the ring and to global memory, and takes the pair (j, j + 1) of the
//     next step itself, so one barrier a step orders everything.
// What bounds it now: the longest segment's steps, ~0.53 us each for a
// block alone on ~460 pairs (PERF.md); a step pipelined so that warp 0
// finishes f[j] while the other warps pass over j + 1's window was
// exact but slower (0.63 us), so the pass over the window, not the
// barrier or the reduction, holds a step.
//
// Numerics: every float product and sum is written with __fmul_rn /
// __fadd_rn so nvcc cannot contract it into an FMA (the host oracle
// rounds each product); mg_log2 is bit arithmetic; float->int penalties
// truncate toward zero; integer differences wrap like int32 arithmetic.
//
// Plain C interface (no PyTorch headers): the Python wrapper in
// mm2_gb_tpu_torch/ops/chain_gpu.py passes raw device pointers and the
// stream, and raises when a launch returns a CUDA error.

#include <cuda_runtime.h>

#include <climits>

namespace {

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// mg_log2 (minimap2 mmpriv.h:118-126), bit-exact.
__device__ __forceinline__ float mg_log2_dev(float x) {
  unsigned zi = __float_as_uint(x);
  float e = (float)((int)((zi >> 23) & 255u) - 128);
  zi = (zi & 0x807FFFFFu) + (127u << 23);
  float zf = __uint_as_float(zi);
  float r = __fadd_rn(__fmul_rn(-0.34484843f, zf), 2.02466578f);
  r = __fmul_rn(r, zf);
  r = __fadd_rn(r, -0.67487759f);
  return __fadd_rn(e, r);
}

struct ChainParams {
  int span, max_dist_x, max_dist_y, bw, is_cdna;
  float cg, cs;
};

// Total score of predecessor (xp, yp, fp) for successor (xs, ys); sets
// *valid.  Port of chain_tpu.py::_pair_score with a uniform span.
__device__ __forceinline__ int pair_total(int xs, int ys, int xp, int yp,
                                          int fp, const ChainParams& c,
                                          bool* valid) {
  int dq = wrap_sub(ys, yp);
  int dr = wrap_sub(xs, xp);
  int diff = wrap_sub(dr, dq);
  int dd = diff < 0 ? (int)(0u - (unsigned)diff) : diff;
  bool ok = dq > 0 && dq <= c.max_dist_x && dr != 0 && dd <= c.bw;
  if (c.max_dist_y != c.max_dist_x) ok = ok && dq <= c.max_dist_y;
  *valid = ok;
  int dg = min(dr, dq);
  int sc = min(c.span, dg);
  float lin = __fadd_rn(__fmul_rn(c.cg, __int2float_rn(dd)),
                        __fmul_rn(c.cs, __int2float_rn(dg)));
  float log_pen = dd >= 1 ? mg_log2_dev(__int2float_rn(wrap_add(dd, 1)))
                          : 0.0f;
  int pen = __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, log_pen)));
  if (c.is_cdna && dr > dq) pen = __float2int_rz(fminf(lin, log_pen));
  if (dd != 0 || dg > c.span) sc = wrap_sub(sc, pen);
  return wrap_add(sc, fp);
}

// the block (chain_gpu.CHAIN_THREADS), a mid segment's group of warps
// (chain_gpu.GROUP_THREADS), and blocks an SM holds (at most 64
// registers a thread)
constexpr int kChainThreads = 512;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kGroupThreads = 128;
constexpr int kGroups = kChainThreads / kGroupThreads;
constexpr int kChainBlocksPerSm = 2;

struct ChainArgs {
  const int* x;
  const int* y;
  const int* rng;
  int* f;   // not __restrict__: a segment read from global memory reads
  int* p;   // back the f it wrote
  const int4* work;   // start, end, widest range, ring (1) or global (0)
  ChainParams c;
};

// a unit's window: its ring in shared memory (x, y, rng, f of anchor i in
// slot i & mask), or the arrays in global memory (mask -1; only f is
// written then)
struct Window {
  int* x;
  int* y;
  int* rng;
  int* f;
  int mask;
};

// the barrier of a unit of NT threads: a warp, a group (named barrier
// bar), the block
template <int NT>
__device__ __forceinline__ void unit_sync(int bar) {
  if (NT == 32)
    __syncwarp();
  else if (NT == kChainThreads)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(NT) : "memory");
}

// The batch of a unit of NT threads at step jb: anchors [jb, jb + NT) of
// segment [s, e) into the ring (their slots held anchors below
// jb + NT - (mask + 1) <= jb - W, which no window from jb on reads; W >=
// the segment's widest range), and lo of the successors j in
// [jb, jb + NT) into lo_of[j & (NT - 1)]: the first i >= s with
// i + rng[i] >= j, or j.  lo is nondecreasing in j and at least j - W, so
// warp w, taking the 32 successors from jb + 32 w, scans from the larger
// of j - W and its lo of NT successors before (the same slot of lo_of).
template <int NT, bool RING>
__device__ __forceinline__ void chain_batch(const ChainArgs& A, int s, int e,
                                            int W, int tid, int bar,
                                            const Window& win, int* lo_of,
                                            int jb) {
  const int lane = tid & 31, warp = tid >> 5, M = win.mask;
  if (RING && jb + tid < e) {
    const int a = jb + tid, sl = a & M;
    win.x[sl] = A.x[a];
    win.y[sl] = A.y[a];
    win.rng[sl] = A.rng[a];
    if (a == s) win.f[sl] = A.c.span;
  }
  const int j0 = jb + 32 * warp;
  int lo = jb == s ? s : lo_of[j0 & (NT - 1)];
  lo = max(lo, max(s, j0 - W));
  unit_sync<NT>(bar);   // the ring's new anchors, and lo_of read
  for (int k = 0; k < 32 && j0 + k < e; ++k) {
    const int j = j0 + k;
    for (;;) {
      const int i = lo + lane;
      const bool stop = i >= j || i + win.rng[i & M] >= j;
      const unsigned hit = __ballot_sync(0xffffffffu, stop);
      if (hit) {
        lo = min(lo + __ffs(hit) - 1, j);
        break;
      }
      lo += 32;
    }
    if (lane == 0) lo_of[j & (NT - 1)] = lo;
  }
  unit_sync<NT>(bar);
}

// The best (total, i) over the pairs (i, j), i in [lo, hi], that thread
// t of n takes (i = hi - t, hi - t - n, ...), reduced over its warp: the
// largest total, and at it the largest i ((INT_MIN, -1): none).  A pair
// out of i's range, invalid, or with a total equal to span is no
// candidate.
__device__ __forceinline__ int2 best_pair(const ChainArgs& A,
                                          const Window& win, int j, int lo,
                                          int hi, int t, int n) {
  const int M = win.mask, sj = j & M;
  const int xs = win.x[sj], ys = win.y[sj];
  int bt = INT_MIN, bi = -1;   // i falls: the first i at a total is the
  for (int i = hi - t; i >= lo; i -= n) {   // largest
    const int sl = i & M;
    if (j - i > win.rng[sl]) continue;
    bool valid;
    const int tot = pair_total(xs, ys, win.x[sl], win.y[sl], win.f[sl], A.c,
                               &valid);
    if (!valid || tot == A.c.span) continue;
    if (tot > bt) {
      bt = tot;
      bi = i;
    }
  }
  const int wt = __reduce_max_sync(0xffffffffu, bt);
  return make_int2(wt, __reduce_max_sync(0xffffffffu, bt == wt ? bi : -1));
}

// f[j], p[j] from the best candidate (a total equal to span never was one)
__device__ __forceinline__ void chain_store(const ChainArgs& A, Window& win,
                                            bool ring, int j, int2 best) {
  const bool acc = best.x >= A.c.span;
  const int fj = acc ? best.x : A.c.span;
  if (ring) win.f[j & win.mask] = fj;
  A.f[j] = fj;
  A.p[j] = acc ? j - best.y : 0;
}

// Segment [s, e) (e - s >= 2) by the NT threads of a unit, tid in
// [0, NT); W >= its widest range.  RING: the window in the unit's ring
// (win, in shared memory, whose slots hold the segment or W + NT
// anchors), else in global memory.  lo_of: NT ints, slot: 2 x NT / 32
// int2 of the unit's in shared memory.  Step j's pairs go over the
// unit's threads; each warp reduces its own, and in a unit of several
// warps lane k of every warp reads warp k's best from the slots of j's
// parity after one barrier (the next write to them is two steps later,
// after another barrier).  Thread 0 stores f[j], and takes the pair
// (j, j + 1) of the next step itself, so that no barrier is needed for
// the f it reads.
template <int NT, bool RING>
__device__ void chain_one(const ChainArgs& A, int s, int e, int W, int tid,
                          int bar, Window win, int* lo_of, int2* slot) {
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  if (!RING)
    win = Window{const_cast<int*>(A.x), const_cast<int*>(A.y),
                 const_cast<int*>(A.rng), A.f, -1};
  if (tid == 0) {
    A.f[s] = A.c.span;
    A.p[s] = 0;
  }
  chain_batch<NT, RING>(A, s, e, W, tid, bar, win, lo_of, s);
  for (int j = s + 1; j < e; ++j) {
    if (((j - s) & (NT - 1)) == 0)
      chain_batch<NT, RING>(A, s, e, W, tid, bar, win, lo_of, j);
    int2 best = best_pair(A, win, j, lo_of[j & (NT - 1)], j - 1, tid, NT);
    if (NT > 32) {
      int2* par = slot + (j & 1) * NW;
      if (lane == 0) par[warp] = best;
      unit_sync<NT>(bar);
      const int2 v = lane < NW ? par[lane] : make_int2(INT_MIN, -1);
      const int wt = __reduce_max_sync(0xffffffffu, v.x);
      best = make_int2(wt,
                       __reduce_max_sync(0xffffffffu, v.x == wt ? v.y : -1));
    }
    if (tid == 0) chain_store(A, win, RING, j, best);
    if (NT == 32) __syncwarp();
  }
}

// work: n_long long segments, then n_mid mid and n_short short ones, each
// class longest first; counters: three zeroed ints; ring_slots: the
// block's ring (a power of two, 16 bytes a slot of dynamic shared memory)
__global__ void __launch_bounds__(kChainThreads, kChainBlocksPerSm)
chain_segments_kernel(ChainArgs A, int n_long, int n_mid, int n_short,
                      int* __restrict__ counters, int ring_slots) {
  extern __shared__ __align__(16) int ring[];
  __shared__ int lo_of[kChainThreads];
  __shared__ int2 slot[2 * kChainWarps];
  __shared__ int item[kGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto window = [&](int unit, int units) {
    const int n = ring_slots / units, o = unit * n;
    return Window{ring + o, ring + ring_slots + o, ring + 2 * ring_slots + o,
                  ring + 3 * ring_slots + o, n - 1};
  };
  for (;;) {   // long segments: the block each
    if (tid == 0) item[0] = atomicAdd(&counters[0], 1);
    __syncthreads();
    const int k = item[0];
    __syncthreads();
    if (k >= n_long) break;
    const int4 w = A.work[k];
    if (w.w)
      chain_one<kChainThreads, true>(A, w.x, w.y, w.z, tid, 0, window(0, 1),
                                     lo_of, slot);
    else
      chain_one<kChainThreads, false>(A, w.x, w.y, w.z, tid, 0, Window{},
                                      lo_of, slot);
  }
  const int g = tid / kGroupThreads, gt = tid % kGroupThreads;
  for (;;) {   // mid segments: a group of four warps each
    if (gt == 0) item[g] = n_long + atomicAdd(&counters[1], 1);
    unit_sync<kGroupThreads>(1 + g);
    const int k = item[g];
    unit_sync<kGroupThreads>(1 + g);
    if (k >= n_long + n_mid) break;
    const int4 w = A.work[k];
    chain_one<kGroupThreads, true>(
        A, w.x, w.y, w.z, gt, 1 + g, window(g, kGroups),
        lo_of + g * kGroupThreads, slot + g * 2 * (kGroupThreads / 32));
  }
  for (;;) {   // short segments: a warp each
    int k = 0;
    if (lane == 0) k = n_long + n_mid + atomicAdd(&counters[2], 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= n_long + n_mid + n_short) break;
    const int4 w = A.work[k];
    chain_one<32, true>(A, w.x, w.y, w.z, lane, 0,
                        window(warp, kChainWarps), lo_of + warp * 32,
                        nullptr);
  }
}

__global__ void mg_log2_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mg_log2_dev(in[i]);
}

}  // namespace

extern "C" {

// Chains the segments of work (int32 [n_long + n_mid + n_short, 4]:
// start, end, widest range, ring flag; chain_gpu.segment_shape) on
// n_blocks persistent blocks of `threads` (the kernel's 512).  f and p of
// anchors outside every listed segment are not written.  counters is
// three zeroed ints on the device; ring_slots a power of two, the
// block's ring.  Returns the CUDA error of the launch (0 on success).
int mm2_chain_segments(const void* x, const void* y, const void* rng,
                       const void* work, int n_long, int n_mid, int n_short,
                       void* counters, void* f, void* p, int span,
                       int max_dist_x, int max_dist_y, int bw, float cg,
                       float cs, int is_cdna, int n_blocks, int threads,
                       int ring_slots, void* stream) {
  if (n_long + n_mid + n_short <= 0) return 0;
  if (threads != kChainThreads || ring_slots < kChainThreads ||
      (ring_slots & (ring_slots - 1)))
    return (int)cudaErrorInvalidValue;
  const int smem = 16 * ring_slots;
  cudaError_t rc = cudaFuncSetAttribute(
      chain_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  ChainArgs a{(const int*)x, (const int*)y, (const int*)rng, (int*)f,
              (int*)p, (const int4*)work,
              ChainParams{span, max_dist_x, max_dist_y, bw, is_cdna, cg, cs}};
  chain_segments_kernel<<<n_blocks, kChainThreads, smem,
                          (cudaStream_t)stream>>>(
      a, n_long, n_mid, n_short, (int*)counters, ring_slots);
  return (int)cudaGetLastError();
}

// Test entry: the kernel's mg_log2 applied elementwise.
int mm2_mg_log2(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  mg_log2_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
