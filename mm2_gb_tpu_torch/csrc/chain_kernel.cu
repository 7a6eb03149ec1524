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
// n_seg dependent steps, each a load of the window plus a reduction.
// The design (mm2-gb's warp-per-segment short kernel, plscore.cu) hides
// that latency with many segments in flight instead of within one:
//   - one warp owns one segment; segments are taken longest-first from
//     an atomic work counter, so the longest dependent chains start
//     first and short ones fill in behind them;
//   - for each j the window starts at the first anchor whose range
//     reaches j (a pointer that only moves forward), so the lanes walk
//     the live predecessors and not the segment's widest range;
//   - the 32 lanes split that window (coalesced loads of x, y, rng and
//     f from global memory, L1/L2 resident);
//   - a warp shuffle reduction over packed (total << 32 | i) keys picks
//     the maximum total and, on a tie, the largest i;
//   - lane 0 writes f[j], p[j]; __syncwarp() orders that store before the
//     next step's loads.
// Shared-memory staging of the window and block-per-long-segment
// scheduling are later work.
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

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
chain_segments_kernel(const int* __restrict__ x, const int* __restrict__ y,
                      const int* __restrict__ rng,
                      const int* __restrict__ seg_start,
                      const int* __restrict__ seg_end, int n_work,
                      int* __restrict__ work_counter, int* f, int* p,
                      ChainParams c) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(work_counter, 1);
    k = __shfl_sync(0xffffffffu, k, 0);
    if (k >= n_work) return;
    const int s = seg_start[k];
    const int e = seg_end[k];

    if (lane == 0) {
      f[s] = c.span;
      p[s] = 0;
    }
    __syncwarp();
    // lo = the first i whose reach i + rng[i] covers j.  It never moves
    // back as j grows (an i skipped for j cannot reach j + 1 either), so
    // the warp advances it 32 anchors per ballot; for ranges from
    // compute_ranges (reach nondecreasing) [lo, j) is exactly the set of
    // predecessors, in general a superset that the range test filters.
    int lo = s;
    for (int j = s + 1; j < e; ++j) {
      for (;;) {
        const int i = lo + lane;
        const bool stop = i >= j || i + rng[i] >= j;
        const unsigned hit = __ballot_sync(0xffffffffu, stop);
        if (hit) {
          lo = min(lo + __ffs(hit) - 1, j);
          break;
        }
        lo += 32;
      }
      const int xs = x[j];
      const int ys = y[j];
      // key = total << 32 | i: the max is the best total, then largest i
      long long best = LLONG_MIN;
      for (int i = j - 1 - lane; i >= lo; i -= 32) {
        if (j - i > rng[i]) continue;
        bool valid;
        int tot = pair_total(xs, ys, x[i], y[i], f[i], c, &valid);
        if (!valid || tot == c.span) continue;
        long long key = (long long)(((unsigned long long)(unsigned)tot << 32)
                                    | (unsigned)i);
        best = key > best ? key : best;
      }
      for (int o = 16; o > 0; o >>= 1) {
        long long other = __shfl_xor_sync(0xffffffffu, best, o);
        best = other > best ? other : best;
      }
      if (lane == 0) {
        int tot = best == LLONG_MIN ? INT_MIN : (int)(best >> 32);
        if (tot >= c.span) {
          f[j] = tot;
          p[j] = j - (int)(unsigned)(best & 0xffffffffLL);
        } else {
          f[j] = c.span;
          p[j] = 0;
        }
      }
      __syncwarp();
    }
  }
}

__global__ void mg_log2_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mg_log2_dev(in[i]);
}

}  // namespace

extern "C" {

// Chains the segments [seg_start[k], seg_end[k]) for k < n_work, in that
// order of work.  f and p of anchors outside every listed segment are
// not written.  work_counter is one zeroed int on the device.  Returns
// the CUDA error of the launch (0 on success).
int mm2_chain_segments(const void* x, const void* y, const void* rng,
                       const void* seg_start, const void* seg_end,
                       int n_work, void* work_counter, void* f, void* p,
                       int span, int max_dist_x, int max_dist_y, int bw,
                       float cg, float cs, int is_cdna, int n_blocks,
                       void* stream) {
  if (n_work <= 0) return 0;
  ChainParams c{span, max_dist_x, max_dist_y, bw, is_cdna, cg, cs};
  chain_segments_kernel<<<n_blocks, 32 * kWarpsPerBlock, 0,
                          (cudaStream_t)stream>>>(
      (const int*)x, (const int*)y, (const int*)rng, (const int*)seg_start,
      (const int*)seg_end, n_work, (int*)work_counter, (int*)f, (int*)p, c);
  return (int)cudaGetLastError();
}

int mm2_chain_warps_per_block(void) { return kWarpsPerBlock; }

// Test entry: the kernel's mg_log2 applied elementwise.
int mm2_mg_log2(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  mg_log2_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
