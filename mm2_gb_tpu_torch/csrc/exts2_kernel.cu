// Splice gap-fill DP (ksw2 exts2, APPROX_MAX) for Hopper (sm_90a).
//
// Replaces the Pallas kernel mm2_gb_tpu/ops/ksw2_tpu.py::_exts2_kernel in
// fill mode (track_h=False) and in its track_h=True branch, with
// prep_fill_operands, prep_splice_bands and the host's per-fill
// _splice_sites folded in.  Semantics are the
// oracle's, mm2_gb_tpu/ops/ksw2_splice.py::exts2 (ksw2_exts2_sse.c), as
// csrc/ksw2kit.cpp::mmt_ksw_exts2 writes them in scalar int8 C++:
//   - the DP is unbanded: anti-diagonal r spans [st0, en0] =
//     [max(0, r-qlen+1), min(tlen-1, r)], widened to the 16-aligned
//     window [st0 & ~15, en0 | 15] whose outer lanes compute on the stale
//     values earlier rows left there;
//   - the persistent score row over its unaligned store span, the
//     boundary fallbacks at st - 1 and the en >= r reset, as in
//     extd2_kernel.cu;
//   - x2 is the intron state: it starts (and falls back) at -q2, closes
//     into H through a2 + acceptor[t] and stays open while a2 > donor[t]
//     (>= under KSW_EZ_RIGHT), else reopens from donor[t];
//   - no y2 state, no z <= mat0 cap, bound_v is 0 past long_thres, and
//     the d bits are 0x08, 0x10 and 0x20;
//   - the approx-max H0 walk; the fills carry no KSW_EZ_APPROX_DROP.
// Donor and acceptor scores come from the target and the fill's BED
// junction bytes (ksw2kit.cpp:701-753) as each lane first enters a row
// window: the canonical GT..AG (or reversed) motifs, the C-truncated
// -(noncan/2) flank score, the int8-wrapping junction bonus, and the
// -noncan pad on lanes past tlen - 4 (donors) and below 2 or past tlen
// (acceptors) up to the 16-aligned nbytes.  The flag is per fill.
//
// exts2_fill: one thread block per fill, threads over the lanes of a row,
// one __syncthreads() per row, as extd2_fill.  A splice fill is narrow
// and long (qlen ~200 against tlen up to ~25 kb across an intron), so the
// state does not live in absolute lane coordinates: a row's live lanes
// span at most min(qlen, tlen) + 32 (from st - 1 of this row to the last
// lane of the next row's window) and move right by at most one lane a
// row, so a ring of R lanes (the next power of two at or above that span)
// holds them.  Lane t lives in slot t & (R - 1); at the end of each row
// the lanes the next row reaches for the first time are set to their
// initial values and site scores (their slots held lanes no later row
// reads).  Eleven int8 ring rows (u, y, s, x and v and x2 twice by row
// parity, donor, acceptor) take 11 R bytes of shared memory, ~2.8 KB at
// qlen 200; a fill whose ring exceeds the wrapper's shared-memory cap
// keeps it in a global scratch region of its own.
// What bounds it: the row barrier, as for extd2_fill.  A 200 x 20000
// fill is 20,200 dependent rows of ~210 lanes; many blocks per SM hide
// the latency of each.
//
// Extension mode (TRACK_H: splice extensions and the non-approx splice
// DP, no KSW_EZ_APPROX_MAX) is the oracle's non-approx branch
// (ksw2_splice.py:239-258, 284-291), as extd2_kernel.cu's extension mode
// with these differences:
//   - the int32 H row lives in the ring too (4 R bytes more, so 15 R in
//     all); a lane entering the ring starts at KSW_NEG_INF;
//   - the previous row's H[en0 - 1], which another thread updates in
//     place in this row, comes through a parity slot its owner filled in
//     the previous row (when that row did not hold the lane, it is read in
//     place);
//   - the row maximum takes the ranked keys of ksw2_row_max.cuh, made
//     from the absolute lane, so a ring that wraps inside the window
//     reorders no tie;
//   - Z-drop takes gap extension 0 (ksw2_splice.py:255);
//   - the backtrack start is picked in the kernel: (tlen-1, qlen-1) when
//     nothing dropped and the fill has no KSW_EZ_EXTZ_ONLY, else
//     (max_t, max_q) when both are >= 0, else none.  No end bonus, no
//     reach_end.
//
// The backtrack is extd2_kernel.cu's ksw2_backtrack in intron mode
// (min_intron_len > 0) with a window w = qlen + tlen, which makes its
// row windows the unbanded ones; for extensions it starts from the
// kernel's per-fill (i0, j0) with the per-fill REV_CIGAR byte.
//
// Plain C interface (no PyTorch headers): the Python wrapper
// mm2_gb_tpu_torch/ops/ksw2s_gpu.py::exts2_fill passes raw device
// pointers and the stream, and raises when a launch returns a CUDA error.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

#include "ksw2_row_max.cuh"

constexpr int kNegInf = -0x40000000;
constexpr int kMaxWarps = 8;   // blocks of at most 256 threads
constexpr int kRight = 0x02, kExtzOnly = 0x40, kRevCigar = 0x80;
constexpr int kSpliceFor = 0x100, kSpliceRev = 0x200, kSpliceFlank = 0x400;

struct SpliceConsts {
  int q, e, q2, noncan, junc_bonus;
  int mat0, mat1, sc_n;
  int long_thres, long_diff;
};

// donor and acceptor score of lane i (ksw2kit.cpp:701-753); jc is the
// fill's junction bytes or null
__device__ __forceinline__ void site_scores(int i, const uint8_t* ts,
                                            const uint8_t* jc, int tlen,
                                            int flag, const SpliceConsts& c,
                                            int8_t& dn, int8_t& ac) {
  dn = ac = (int8_t)-c.noncan;
  if (!(flag & (kSpliceFor | kSpliceRev))) return;
  const bool sfor = flag & kSpliceFor, srev = flag & kSpliceRev;
  const bool rc = flag & kRevCigar;
  const int semi = (flag & kSpliceFlank) ? -(c.noncan / 2) : 0;
  if (i < tlen - 4) {
    int can = 0;
    const int a = ts[i + 1], b = ts[i + 2], d = ts[i + 3];
    if (!rc) {
      if (sfor && a == 2 && b == 3) can = 1;  // GTr...
      if (srev && a == 1 && b == 3) can = 1;  // CTr...
      if (can && (d == 0 || d == 2)) can = 2;
    } else {
      if (sfor && a == 2 && b == 0) can = 1;  // GAy...
      if (srev && a == 1 && b == 0) can = 1;  // CAy...
      if (can && (d == 1 || d == 3)) can = 2;
    }
    if (can) dn = can == 2 ? 0 : (int8_t)semi;
  }
  if (jc && i < tlen - 1) {
    const int j = jc[i + 1];
    if (rc ? ((sfor && (j & 2)) || (srev && (j & 4)))
           : ((sfor && (j & 1)) || (srev && (j & 8))))
      dn = (int8_t)(dn + c.junc_bonus);
  }
  if (i >= 2 && i < tlen) {
    int can = 0;
    const int a = ts[i - 1], b = ts[i], d = ts[i - 2];
    if (!rc) {
      if (sfor && a == 0 && b == 2) can = 1;  // ...yAG
      if (srev && a == 0 && b == 1) can = 1;  // ...yAC
      if (can && (d == 1 || d == 3)) can = 2;
    } else {
      if (sfor && a == 3 && b == 2) can = 1;  // ...rTG
      if (srev && a == 3 && b == 1) can = 1;  // ...rTC
      if (can && (d == 0 || d == 2)) can = 2;
    }
    if (can) ac = can == 2 ? 0 : (int8_t)semi;
  }
  if (jc && i < tlen) {
    const int j = jc[i];
    if (rc ? ((sfor && (j & 1)) || (srev && (j & 8)))
           : ((sfor && (j & 2)) || (srev && (j & 4))))
      ac = (int8_t)(ac + c.junc_bonus);
  }
}

// the last lane row r touches: the window's en or the score store span's
__device__ __forceinline__ int row_last(int r, int qlen, int tlen,
                                        int nbytes) {
  const int st0 = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
  const int en0 = r < tlen - 1 ? r : tlen - 1;
  int hi = st0 + 16 * ((en0 - st0) / 16 + 1);
  if (hi > nbytes) hi = nbytes;
  const int en = en0 | 15;
  return en > hi - 1 ? en : hi - 1;
}

template <bool TRACK_H>
__global__ void __launch_bounds__(256) exts2_fill_kernel(
    const uint8_t* __restrict__ qblob, const uint8_t* __restrict__ tblob,
    const uint8_t* __restrict__ jblob, const long long* __restrict__ qoff,
    const long long* __restrict__ toff, const long long* __restrict__ joff,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ flags, const long long* __restrict__ p_off,
    const long long* __restrict__ scr_off, int8_t* __restrict__ scratch,
    uint8_t* __restrict__ p, int* __restrict__ score, SpliceConsts c,
    const int* __restrict__ zdrops, int* __restrict__ ext) {
  extern __shared__ int8_t smem[];
  __shared__ int slot_v[2], slot_u[2];
  // extension mode: H[en0 - 1] of the previous row, H[en0] and H[st0] of
  // this row, and each warp's best row key, by row parity
  __shared__ int slot_hp[2], slot_hen0[2], slot_hst0[2];
  __shared__ long long slot_key[2][kMaxWarps];
  const int f = blockIdx.x;
  const int qlen = qlens[f], tlen = tlens[f], flag = flags[f];
  const bool right = flag & kRight;
  const int nbytes = (tlen + 15) / 16 * 16;
  const int mn = qlen < tlen ? qlen : tlen;
  int R = 32;  // ksw2s_gpu.ring_lanes
  while (R < mn + 32) R <<= 1;
  const int mask = R - 1;
  int8_t* base = scr_off[f] >= 0 ? scratch + scr_off[f] : smem;
  int8_t* U = base;
  int8_t* Y = U + R;
  int8_t* S = Y + R;
  int8_t* X0 = S + R;
  int8_t* X1 = X0 + R;
  int8_t* V0 = X1 + R;
  int8_t* V1 = V0 + R;
  int8_t* X20 = V1 + R;
  int8_t* X21 = X20 + R;
  int8_t* DN = X21 + R;
  int8_t* AC = DN + R;
  int* H = (int*)(AC + R);   // extension mode: 4 R bytes more
  const uint8_t* qs = qblob + qoff[f];
  const uint8_t* ts = tblob + toff[f];
  const uint8_t* jc = joff[f] >= 0 ? jblob + joff[f] : nullptr;
  uint8_t* pf = p + p_off[f];

  const int8_t nqe = (int8_t)(-c.q - c.e), nq2 = (int8_t)-c.q2;
  const int8_t q8 = (int8_t)c.q, q28 = (int8_t)c.q2;
  const int8_t qe8 = (int8_t)(c.q + c.e);
  const int8_t mat0 = (int8_t)c.mat0, mat1 = (int8_t)c.mat1;
  const int8_t scn = (int8_t)c.sc_n;
  const int tid = threadIdx.x, nt = blockDim.x;

  // lanes 0 .. R-1 start in their own slots
  for (int t = tid; t < R; t += nt) {
    U[t] = Y[t] = X0[t] = X1[t] = V0[t] = V1[t] = nqe;
    X20[t] = X21[t] = nq2;
    S[t] = 0;
    site_scores(t, ts, jc, tlen, flag, c, DN[t], AC[t]);
    if (TRACK_H) H[t] = kNegInf;
  }
  int exposed = R - 1;  // lanes up to here hold their initial values
  __syncthreads();

  int H0 = 0, lh = 0, sc_final = kNegInf;
  int last_st = -1, last_en = -1;
  long long row_off = 0;
  const int n_rows = qlen + tlen - 1;
  // extension mode: the oracle's Extz fields, the same in every thread
  const int zdrop = TRACK_H ? zdrops[f] : -1;
  int mx = 0, max_t = -1, max_q = -1, mqe = kNegInf, mqe_t = -1;
  int mte = kNegInf, mte_q = -1, dropped = 0;
  int prev_st0 = -1, prev_en0 = -1;
  for (int r = 0; r < n_rows; ++r) {
    const int par = r & 1;
    int8_t* xc = par ? X1 : X0;
    const int8_t* xp = par ? X0 : X1;
    int8_t* vc = par ? V1 : V0;
    const int8_t* vp = par ? V0 : V1;
    int8_t* x2c = par ? X21 : X20;
    const int8_t* x2p = par ? X20 : X21;
    const int st0 = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
    const int en0 = r < tlen - 1 ? r : tlen - 1;
    const int st = st0 & ~15, en = en0 | 15;
    const int8_t bv = r == 0 ? nqe
                      : r < c.long_thres ? (int8_t)-c.e
                      : r == c.long_thres ? (int8_t)c.long_diff
                                          : (int8_t)0;
    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en) {
        const int s = (st - 1) & mask;
        x1 = xp[s];
        x21 = x2p[s];
        v1 = vp[s];
      } else {
        x1 = nqe;
        x21 = nq2;
        v1 = nqe;
      }
    } else {
      x1 = nqe;
      x21 = nq2;
      v1 = bv;
    }
    const bool reset = en >= r;
    // extension mode: the previous row's H[en0 - 1], and the lane whose
    // H the next row reads so (the next row's en0 - 1)
    int h_prev = 0;
    const int next_en0 = r + 1 < tlen - 1 ? r + 1 : tlen - 1;
    if (TRACK_H && r > 0 && en0 > 0)
      h_prev = en0 - 1 >= prev_st0 && en0 - 1 <= prev_en0
                   ? slot_hp[par]
                   : H[(en0 - 1) & mask];
    long long key = LLONG_MIN;
    int hi = st0 + 16 * ((en0 - st0) / 16 + 1);
    if (hi > nbytes) hi = nbytes;
    const int last = en > hi - 1 ? en : hi - 1;
    uint8_t* prow = pf + row_off;
    for (int t = st + tid; t <= last; t += nt) {
      const int s = t & mask;
      int8_t z;
      if (t >= st0 && t < hi) {   // this row's score store span
        const int tb = t < tlen ? ts[t] : 0;
        const int qb = t <= r ? qs[r - t] : 0;
        z = tb == qb ? mat0 : mat1;
        if (tb == 4 || qb == 4) z = scn;
        S[s] = z;
      } else {
        z = S[s];
      }
      if (t > en) continue;
      const int s1 = (t - 1) & mask;
      const int8_t xt1 = t == st ? x1 : xp[s1];
      const int8_t vt1 = t == st ? v1 : vp[s1];
      const int8_t x2t1 = t == st ? x21 : x2p[s1];
      const bool rs = reset && t == r;
      const int8_t ut = rs ? bv : U[s];
      const int8_t yt = rs ? nqe : Y[s];
      const int8_t dn = DN[s];
      int8_t a = (int8_t)(xt1 + vt1);
      int8_t b = (int8_t)(yt + ut);
      int8_t a2 = (int8_t)(x2t1 + vt1);
      const int8_t a2a = (int8_t)(a2 + AC[s]);
      uint8_t d;
      if (right) {
        d = (z > a) ? 0 : 1;
        z = z > a ? z : a;
        d = (z > b) ? d : 2;
        z = z > b ? z : b;
        d = (z > a2a) ? d : 3;
        z = z > a2a ? z : a2a;
      } else {
        d = (a > z) ? 1 : 0;
        z = z > a ? z : a;
        d = (b > z) ? 2 : d;
        z = z > b ? z : b;
        d = (a2a > z) ? 3 : d;
        z = z > a2a ? z : a2a;
      }
      const int8_t un = (int8_t)(z - vt1), vn = (int8_t)(z - ut);
      const int8_t tq = (int8_t)(z - q8);
      a = (int8_t)(a - tq);
      b = (int8_t)(b - tq);
      a2 = (int8_t)(a2 - (int8_t)(z - q28));
      const bool ta = right ? (a >= 0) : (a > 0);
      const bool tb = right ? (b >= 0) : (b > 0);
      const bool ta2 = right ? (a2 >= dn) : (a2 > dn);
      U[s] = un;
      vc[s] = vn;
      xc[s] = (int8_t)((ta ? a : 0) - qe8);
      Y[s] = (int8_t)((tb ? b : 0) - qe8);
      x2c[s] = (int8_t)((ta2 ? a2 : dn) - q28);
      d |= (ta ? 0x08 : 0) | (tb ? 0x10 : 0) | (ta2 ? 0x20 : 0);
      prow[t - st] = d;
      if (TRACK_H) {
        if (t >= st0 && t <= en0) {   // the H row (ksw2_splice.py:240-250)
          int h;
          if (r == 0)
            h = vn - (c.q + c.e);
          else if (t < en0)
            h = H[s] + vn;
          else
            h = en0 > 0 ? h_prev + un : H[s] + vn;
          H[s] = h;
          const long long k = row_key(h, t, st0, en0);
          key = k > key ? k : key;
          if (t == st0) slot_hst0[par] = h;
          if (t == en0) slot_hen0[par] = h;
          if (t == next_en0 - 1) slot_hp[par ^ 1] = h;
        }
      } else {
        if (t == lh) slot_v[par] = vn;
        if (t == lh + 1) slot_u[par] = un;
      }
    }
    // lanes the next row reaches for the first time: their slots held
    // lanes below this row's st - 1, which no later row reads
    if (r + 1 < n_rows) {
      const int nl = row_last(r + 1, qlen, tlen, nbytes);
      for (int t = exposed + 1 + tid; t <= nl; t += nt) {
        const int s = t & mask;
        U[s] = Y[s] = X0[s] = X1[s] = V0[s] = V1[s] = nqe;
        X20[s] = X21[s] = nq2;
        S[s] = 0;
        site_scores(t, ts, jc, tlen, flag, c, DN[s], AC[s]);
        if (TRACK_H) H[s] = kNegInf;
      }
      if (nl > exposed) exposed = nl;
    }
    if (TRACK_H) {
      for (int o = 16; o > 0; o >>= 1) {
        const long long k = __shfl_xor_sync(0xffffffffu, key, o);
        key = k > key ? k : key;
      }
      if ((tid & 31) == 0) slot_key[par][tid >> 5] = key;
    }
    __syncthreads();
    if (TRACK_H) {
      // the row maximum, mte, mqe, Z-drop and the score
      // (ksw2_splice.py:247-258), the same in every thread
      for (int k = 0; k < (nt >> 5); ++k)
        key = slot_key[par][k] > key ? slot_key[par][k] : key;
      const int max_h = (int)(key >> 32);
      const int mt = key_lane(key, st0, en0);
      const int h_en0 = slot_hen0[par], h_st0 = slot_hst0[par];
      if (en0 == tlen - 1 && h_en0 > mte) {
        mte = h_en0;
        mte_q = r - en;
      }
      if (r - st0 == qlen - 1 && h_st0 > mqe) {
        mqe = h_st0;
        mqe_t = st0;
      }
      // apply_zdrop with gap extension 0 (ksw2_splice.py:255)
      if (max_h > mx) {
        mx = max_h;
        max_t = mt;
        max_q = r - mt;
      } else if (mt >= max_t && r - mt >= max_q) {
        if (zdrop >= 0 && mx - max_h > zdrop) {
          dropped = 1;
          break;
        }
      }
      if (r == n_rows - 1 && en0 == tlen - 1) sc_final = h_en0;
      prev_st0 = st0;
      prev_en0 = en0;
      last_st = st;
      last_en = en;
      row_off += en - st + 1;
      continue;
    }
    // the approx-max H0 walk (ksw2_splice.py:259-281); lh stays in
    // [st0, en0] of the row, so the lanes it reads were written just now
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
  if (tid != 0) return;
  if (!TRACK_H) {
    score[f] = sc_final;
    return;
  }
  // the backtrack start (ksw2_splice.py:284-291)
  int i0 = -1, j0 = -1;
  if (!dropped && !(flag & kExtzOnly)) {
    i0 = tlen - 1;
    j0 = qlen - 1;
  } else if (max_t >= 0 && max_q >= 0) {
    i0 = max_t;
    j0 = max_q;
  }
  int* o = ext + 12LL * f;
  o[0] = sc_final;
  o[1] = mx;
  o[2] = max_t;
  o[3] = max_q;
  o[4] = mqe;
  o[5] = mqe_t;
  o[6] = mte;
  o[7] = mte_q;
  o[8] = dropped;
  o[9] = 0;   // reach_end: exts2 has no end bonus
  o[10] = i0;
  o[11] = j0;
}

}  // namespace

extern "C" {

// Fills splice fill k (qlen[k] x tlen[k] bases at qoff[k] / toff[k] of
// the blobs, junction bytes at joff[k] of jblob or none when joff[k] < 0,
// KSW_EZ_* flag flags[k]) for k < n: direction bytes into p at p_off[k],
// the score into score[k].  scr_off[k] >= 0 puts the fill's ring at that
// offset of scratch instead of shared memory; smem_bytes is the dynamic
// shared memory of a block (at least 11 x the ring lanes of every other
// fill, at most the default 48 KB).  Returns the CUDA error of the launch
// (0 on success).
int mm2_exts2_fill(const void* qblob, const void* tblob, const void* jblob,
                   const void* qoff, const void* toff, const void* joff,
                   const void* qlen, const void* tlen, const void* flags,
                   const void* p_off, const void* scr_off, int n,
                   void* scratch, void* p, void* score, int q, int e, int q2,
                   int noncan, int junc_bonus, int mat0, int mat1, int sc_n,
                   int long_thres, int long_diff, int threads, int smem_bytes,
                   void* stream) {
  if (n <= 0) return 0;
  SpliceConsts c{q, e, q2, noncan, junc_bonus, mat0, mat1, sc_n,
                 long_thres, long_diff};
  exts2_fill_kernel<false><<<n, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)qblob, (const uint8_t*)tblob, (const uint8_t*)jblob,
      (const long long*)qoff, (const long long*)toff,
      (const long long*)joff, (const int*)qlen, (const int*)tlen,
      (const int*)flags, (const long long*)p_off,
      (const long long*)scr_off, (int8_t*)scratch, (uint8_t*)p, (int*)score,
      c, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// Extension mode (no KSW_EZ_APPROX_MAX; KSW_EZ_EXTZ_ONLY per fill) of the
// n splice fills: as mm2_exts2_fill, with Z-drop zdrop[k] (< 0: none);
// fill k's [score, max, max_t, max_q, mqe, mqe_t, mte, mte_q, zdropped,
// reach_end (0), i0, j0] into ext[12k ...], (i0, j0) the backtrack start
// (-1: none).  The ring takes 15 x its lanes (the int32 H row after the
// 11 int8 rows).  threads is a multiple of 32, at most 256.
int mm2_exts2_ext(const void* qblob, const void* tblob, const void* jblob,
                  const void* qoff, const void* toff, const void* joff,
                  const void* qlen, const void* tlen, const void* flags,
                  const void* zdrop, const void* p_off, const void* scr_off,
                  int n, void* scratch, void* p, void* ext, int q, int e,
                  int q2, int noncan, int junc_bonus, int mat0, int mat1,
                  int sc_n, int long_thres, int long_diff, int threads,
                  int smem_bytes, void* stream) {
  if (n <= 0) return 0;
  if (threads <= 0 || threads > 32 * kMaxWarps || threads % 32)
    return (int)cudaErrorInvalidValue;
  SpliceConsts c{q, e, q2, noncan, junc_bonus, mat0, mat1, sc_n,
                 long_thres, long_diff};
  exts2_fill_kernel<true><<<n, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)qblob, (const uint8_t*)tblob, (const uint8_t*)jblob,
      (const long long*)qoff, (const long long*)toff,
      (const long long*)joff, (const int*)qlen, (const int*)tlen,
      (const int*)flags, (const long long*)p_off,
      (const long long*)scr_off, (int8_t*)scratch, (uint8_t*)p, nullptr, c,
      (const int*)zdrop, (int*)ext);
  return (int)cudaGetLastError();
}

}  // extern "C"
