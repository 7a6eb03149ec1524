// Gap-fill DP (ksw2 extd2, APPROX_MAX) and its backtrack for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel mm2_gb_tpu/ops/ksw2_tpu.py::_extd2_kernel in
// fill mode (track_h=False), with prep_fill_operands folded in, and the
// XLA program backtrack_device with _rle_cigar folded in.  Semantics are
// the oracle's, mm2_gb_tpu/ops/ksw2.py::extd2 (the SSE4.1
// ksw2_extd2_sse.c kernel), as csrc/ksw2kit.cpp writes them in scalar
// int8 C++:
//   - the 16-aligned windows st = st0 & ~15, en = en0 | 15 of each
//     anti-diagonal r; lanes of [st, en] outside [st0, en0] compute on
//     the stale values earlier rows left there;
//   - the score row is stored over [st0, st0 + 16*((en0-st0)/16 + 1))
//     (the unaligned 16-byte store span) and persists: lanes the store
//     span does not reach keep an earlier row's score;
//   - the x1/v1/x21 boundary values read the previous row at st - 1 only
//     when that row's window held st - 1;
//   - the en >= r reset of y, y2 and u at lane r with bound_v(r);
//   - KSW_EZ_RIGHT (>= / > tie rules) and the d bits 0x08-0x40;
//   - the approx-max H0 walk, whose value at the last row is the score.
// Arithmetic is int with the C++ kernel's int8 casts; state is int8.
//
// extd2_fill: one thread block per fill, threads over the lanes t of a
// row.  Cell t of row r reads x, v, x2 at t - 1 of row r - 1 and u, y,
// y2, s at t, so x, v and x2 are double-buffered by row parity and one
// __syncthreads() per row orders the rows.  The six state rows, the three
// spare buffers and the score row (10 x nbytes int8) live in shared memory
// (a global scratch region for fills too long for it).  The H0 walk reads
// v at lh and u at lh + 1 of the row just written; the lanes that own
// them copy the two values into a parity slot, and every thread repeats
// the walk on them, so no second barrier is needed.  Row r's direction
// bytes go to the fill's region at the running sum of the earlier rows'
// widths (en - st + 1).
// What bounds it: the row barrier.  A ~210 bp fill (the common case) has
// ~420 rows of ~220 lanes, so a row is one step for 256 threads and the
// kernel is latency-bound on the dependent rows; many fills per SM (small
// blocks, ~2 KB of shared memory each) hide it.
//
// ksw2_backtrack: ksw_backtrack with is_rot (ksw2.h:126-158), one thread
// per fill: the walk is serial and the fills independent.  Off-band
// cells force the state (i < st: I, i > en: D); the two tails follow the
// loop.  Run-length words are written straight into the fill's slot of
// qlen + tlen words and reversed in place unless KSW_EZ_REV_CIGAR.
//
// Plain C interface (no PyTorch headers): the Python wrappers in
// mm2_gb_tpu_torch/ops/ksw2_gpu.py pass raw device pointers and the
// stream, and raise when a launch returns a CUDA error.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNegInf = -0x40000000;

struct FillConsts {
  int q, e, q2, e2;          // swapped: q + e <= q2 + e2
  int mat0, mat1, sc_n;
  int long_thres, long_diff;
};

__device__ __forceinline__ void row_window(int r, int qlen, int tlen, int w,
                                           int& st0, int& en0) {
  st0 = 0;
  en0 = tlen - 1;
  if (st0 < r - qlen + 1) st0 = r - qlen + 1;
  if (en0 > r) en0 = r;
  if (st0 < ((r - w + 1) >> 1)) st0 = (r - w + 1) >> 1;
  if (en0 > ((r + w) >> 1)) en0 = (r + w) >> 1;
}

__device__ __forceinline__ int row_width(int r, int qlen, int tlen, int w) {
  int st0, en0;
  row_window(r, qlen, tlen, w, st0, en0);
  return (en0 | 15) - (st0 & ~15) + 1;
}

template <bool RIGHT>
__global__ void __launch_bounds__(256) extd2_fill_kernel(
    const uint8_t* __restrict__ qblob, const uint8_t* __restrict__ tblob,
    const long long* __restrict__ qoff, const long long* __restrict__ toff,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const long long* __restrict__ p_off,
    const long long* __restrict__ scr_off, int8_t* __restrict__ scratch,
    uint8_t* __restrict__ p, int* __restrict__ score, FillConsts c) {
  extern __shared__ int8_t smem[];
  __shared__ int slot_v[2], slot_u[2];
  const int f = blockIdx.x;
  const int qlen = qlens[f], tlen = tlens[f];
  int w = ws[f];
  if (w < 0) w = qlen > tlen ? qlen : tlen;
  const int nbytes = (tlen + 15) / 16 * 16;
  int8_t* base = scr_off[f] >= 0 ? scratch + scr_off[f] : smem;
  int8_t* U = base;
  int8_t* Y = U + nbytes;
  int8_t* Y2 = Y + nbytes;
  int8_t* S = Y2 + nbytes;
  int8_t* X0 = S + nbytes;
  int8_t* X1 = X0 + nbytes;
  int8_t* V0 = X1 + nbytes;
  int8_t* V1 = V0 + nbytes;
  int8_t* X20 = V1 + nbytes;
  int8_t* X21 = X20 + nbytes;
  const uint8_t* qs = qblob + qoff[f];
  const uint8_t* ts = tblob + toff[f];
  uint8_t* pf = p + p_off[f];

  const int8_t nqe = (int8_t)(-c.q - c.e), nqe2 = (int8_t)(-c.q2 - c.e2);
  const int8_t q8 = (int8_t)c.q, q28 = (int8_t)c.q2;
  const int8_t qe8 = (int8_t)(c.q + c.e), qe28 = (int8_t)(c.q2 + c.e2);
  const int8_t mat0 = (int8_t)c.mat0, mat1 = (int8_t)c.mat1;
  const int8_t scn = (int8_t)c.sc_n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int t = tid; t < nbytes; t += nt) {
    U[t] = Y[t] = X0[t] = X1[t] = V0[t] = V1[t] = nqe;
    Y2[t] = X20[t] = X21[t] = nqe2;
    S[t] = 0;
  }
  __syncthreads();

  int H0 = 0, lh = 0, sc_final = kNegInf;
  int last_st = -1, last_en = -1;
  long long row_off = 0;
  const int n_rows = qlen + tlen - 1;
  for (int r = 0; r < n_rows; ++r) {
    const int par = r & 1;
    int8_t* xc = par ? X1 : X0;
    const int8_t* xp = par ? X0 : X1;
    int8_t* vc = par ? V1 : V0;
    const int8_t* vp = par ? V0 : V1;
    int8_t* x2c = par ? X21 : X20;
    const int8_t* x2p = par ? X20 : X21;
    int st0, en0;
    row_window(r, qlen, tlen, w, st0, en0);
    const int st = st0 & ~15, en = en0 | 15;
    const int8_t bv = r == 0 ? nqe
                      : r < c.long_thres ? (int8_t)-c.e
                      : r == c.long_thres ? (int8_t)c.long_diff
                                          : (int8_t)-c.e2;
    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en) {
        x1 = xp[st - 1];
        x21 = x2p[st - 1];
        v1 = vp[st - 1];
      } else {
        x1 = nqe;
        x21 = nqe2;
        v1 = nqe;
      }
    } else {
      x1 = nqe;
      x21 = nqe2;
      v1 = bv;
    }
    const bool reset = en >= r;
    int hi = st0 + 16 * ((en0 - st0) / 16 + 1);
    if (hi > nbytes) hi = nbytes;
    const int last = en > hi - 1 ? en : hi - 1;
    uint8_t* prow = pf + row_off;
    for (int t = st + tid; t <= last; t += nt) {
      int8_t z;
      if (t >= st0 && t < hi) {   // this row's score store span
        const int tb = t < tlen ? ts[t] : 0;
        const int qb = t <= r ? qs[r - t] : 0;
        z = tb == qb ? mat0 : mat1;
        if (tb == 4 || qb == 4) z = scn;
        S[t] = z;
      } else {
        z = S[t];
      }
      if (t > en) continue;
      const int8_t xt1 = t == st ? x1 : xp[t - 1];
      const int8_t vt1 = t == st ? v1 : vp[t - 1];
      const int8_t x2t1 = t == st ? x21 : x2p[t - 1];
      const bool rs = reset && t == r;
      const int8_t ut = rs ? bv : U[t];
      const int8_t yt = rs ? nqe : Y[t];
      const int8_t y2t = rs ? nqe2 : Y2[t];
      int8_t a = (int8_t)(xt1 + vt1);
      int8_t b = (int8_t)(yt + ut);
      int8_t a2 = (int8_t)(x2t1 + vt1);
      int8_t b2 = (int8_t)(y2t + ut);
      uint8_t d;
      if (RIGHT) {
        d = (z > a) ? 0 : 1;
        z = z > a ? z : a;
        d = (z > b) ? d : 2;
        z = z > b ? z : b;
        d = (z > a2) ? d : 3;
        z = z > a2 ? z : a2;
        d = (z > b2) ? d : 4;
        z = z > b2 ? z : b2;
      } else {
        d = (a > z) ? 1 : 0;
        z = z > a ? z : a;
        d = (b > z) ? 2 : d;
        z = z > b ? z : b;
        d = (a2 > z) ? 3 : d;
        z = z > a2 ? z : a2;
        d = (b2 > z) ? 4 : d;
        z = z > b2 ? z : b2;
      }
      z = z < mat0 ? z : mat0;
      const int8_t un = (int8_t)(z - vt1), vn = (int8_t)(z - ut);
      const int8_t tq = (int8_t)(z - q8);
      a = (int8_t)(a - tq);
      b = (int8_t)(b - tq);
      const int8_t tq2 = (int8_t)(z - q28);
      a2 = (int8_t)(a2 - tq2);
      b2 = (int8_t)(b2 - tq2);
      const bool ta = RIGHT ? (a >= 0) : (a > 0);
      const bool tb = RIGHT ? (b >= 0) : (b > 0);
      const bool ta2 = RIGHT ? (a2 >= 0) : (a2 > 0);
      const bool tb2 = RIGHT ? (b2 >= 0) : (b2 > 0);
      U[t] = un;
      vc[t] = vn;
      xc[t] = (int8_t)((ta ? a : 0) - qe8);
      Y[t] = (int8_t)((tb ? b : 0) - qe8);
      x2c[t] = (int8_t)((ta2 ? a2 : 0) - qe28);
      Y2[t] = (int8_t)((tb2 ? b2 : 0) - qe28);
      d |= (ta ? 0x08 : 0) | (tb ? 0x10 : 0) | (ta2 ? 0x20 : 0) |
           (tb2 ? 0x40 : 0);
      prow[t - st] = d;
      if (t == lh) slot_v[par] = vn;
      if (t == lh + 1) slot_u[par] = un;
    }
    __syncthreads();
    // the approx-max H0 walk (ksw2.py:587-608); lh stays in [st0, en0]
    // of the row, so the lanes it reads were written just now
    const int vl = slot_v[par], ul = slot_u[par];
    if (r == 0) {
      H0 = vl - (c.q + c.e);
      lh = 0;
    } else {
      const bool in0 = lh >= st0 && lh <= en0;
      const bool in1 = lh + 1 >= st0 && lh + 1 <= en0;
      if (in0 && in1) {
        if (vl > ul) {
          H0 += vl;
        } else {
          H0 += ul;
          ++lh;
        }
      } else if (in0) {
        H0 += vl;
      } else {
        ++lh;
        H0 += ul;
      }
    }
    if (r == n_rows - 1 && en0 == tlen - 1) sc_final = H0;
    last_st = st;
    last_en = en;
    row_off += en - st + 1;
  }
  if (tid == 0) score[f] = sc_final;
}

__global__ void ksw2_backtrack_kernel(
    const uint8_t* __restrict__ p, const long long* __restrict__ p_off,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const long long* __restrict__ cig_off, int n,
    int rev, unsigned* __restrict__ cig, int* __restrict__ n_cig) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int qlen = qlens[f], tlen = tlens[f];
  int w = ws[f];
  if (w < 0) w = qlen > tlen ? qlen : tlen;
  const uint8_t* pf = p + p_off[f];
  unsigned* out = cig + cig_off[f];
  const int n_rows = qlen + tlen - 1;
  long long off = 0;  // start of row cur_r in the fill's region
  for (int r = 0; r < n_rows - 1; ++r) off += row_width(r, qlen, tlen, w);
  int cur_r = n_rows - 1;
  int i = tlen - 1, j = qlen - 1, state = 0, nc = 0;
  unsigned run_op = 0, run_len = 0;
  auto push = [&](unsigned op, unsigned len) {
    if (run_len > 0 && run_op == op) {
      run_len += len;
    } else {
      if (run_len > 0) out[nc++] = run_len << 4 | run_op;
      run_op = op;
      run_len = len;
    }
  };
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    while (cur_r > r) {
      --cur_r;
      off -= row_width(cur_r, qlen, tlen, w);
    }
    int st0, en0;
    row_window(r, qlen, tlen, w, st0, en0);
    const int st = st0 & ~15, en = en0 | 15;
    int force = -1;
    if (i < st) force = 2;
    if (i > en) force = 1;
    const unsigned tmp = force < 0 ? pf[off + i - st] : 0u;
    if (state == 0) {
      state = tmp & 7;
    } else if (!((tmp >> (state + 2)) & 1)) {
      state = 0;
    }
    if (state == 0) state = tmp & 7;
    if (force >= 0) state = force;
    if (state == 0) {
      push(0, 1);
      --i;
      --j;
    } else if (state == 1 || state == 3) {
      push(2, 1);
      --i;
    } else {
      push(1, 1);
      --j;
    }
  }
  if (i >= 0) push(2, i + 1);
  if (j >= 0) push(1, j + 1);
  if (run_len > 0) out[nc++] = run_len << 4 | run_op;
  if (!rev) {
    for (int a = 0, b = nc - 1; a < b; ++a, --b) {
      const unsigned tmp = out[a];
      out[a] = out[b];
      out[b] = tmp;
    }
  }
  n_cig[f] = nc;
}

}  // namespace

extern "C" {

// Fills fill k (qlen[k] x tlen[k] bases at qoff[k] / toff[k] of the
// blobs, band w[k]) for k < n: direction bytes into p at p_off[k], the
// score into score[k].  scr_off[k] >= 0 puts the fill's state at that
// offset of scratch instead of shared memory; smem_bytes is the dynamic
// shared memory of a block (at least 10 x nbytes of every other fill).
// Returns the CUDA error of the launch (0 on success).
int mm2_extd2_fill(const void* qblob, const void* tblob, const void* qoff,
                   const void* toff, const void* qlen, const void* tlen,
                   const void* w, const void* p_off, const void* scr_off,
                   int n, void* scratch, void* p, void* score, int q, int e,
                   int q2, int e2, int mat0, int mat1, int sc_n,
                   int long_thres, int long_diff, int right, int threads,
                   int smem_bytes, void* stream) {
  if (n <= 0) return 0;
  FillConsts c{q, e, q2, e2, mat0, mat1, sc_n, long_thres, long_diff};
  auto kernel = right ? extd2_fill_kernel<true> : extd2_fill_kernel<false>;
  kernel<<<n, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)qblob, (const uint8_t*)tblob, (const long long*)qoff,
      (const long long*)toff, (const int*)qlen, (const int*)tlen,
      (const int*)w, (const long long*)p_off, (const long long*)scr_off,
      (int8_t*)scratch, (uint8_t*)p, (int*)score, c);
  return (int)cudaGetLastError();
}

// Backtracks the n fills of mm2_extd2_fill from (tlen-1, qlen-1): CIGAR
// words into cig at cig_off[k] (room for qlen[k] + tlen[k]), their count
// into n_cig[k].  Returns the CUDA error of the launch.
int mm2_ksw2_backtrack(const void* p, const void* p_off, const void* qlen,
                       const void* tlen, const void* w, const void* cig_off,
                       int n, int rev, void* cig, void* n_cig, void* stream) {
  if (n <= 0) return 0;
  ksw2_backtrack_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const long long*)p_off, (const int*)qlen,
      (const int*)tlen, (const int*)w, (const long long*)cig_off, n, rev,
      (unsigned*)cig, (int*)n_cig);
  return (int)cudaGetLastError();
}

}  // extern "C"
