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
// The state ring.  A splice fill is narrow and long (qlen ~200 against
// tlen up to ~25 kb across an intron), so the state does not live in
// absolute lane coordinates: the lanes rows read move right by at most
// one a row, so a ring of R lanes (a power of two) holds them; lane t
// lives in slot t & (R - 1), and a lane is set to its initial values and
// site scores before a row first reads it (its slot held a lane no later
// row reads).
//
// exts2_fill (fill mode).  What bounded the first port (a block per
// fill, 28 launches of 40-84 fills for the cDNA set) was the row's
// dependency chain, the instructions a cell took and the launches' size:
// a row waited on the target and query bytes and on the site scores of
// the lanes entering the window (up to 8 target and junction bytes
// each), then on a __syncthreads() of up to 8 warps; a cell took about
// 150 instructions (the int8 casts, sign extensions and byte accesses,
// read off the SASS); and a launch of 40-84 blocks left most of the 132
// SMs idle while it lasted as long as its longest fill.  The design:
//   - a warp per fill for fills whose ring is at most
//     ksw2s_gpu.WARP_RING lanes (the bulk of a cDNA set's fills: an
//     intron against a short query gap), eight of them to a block, each
//     with its own rings in shared memory and __syncwarp() between rows;
//     wider fills, and the longest of a launch (a block runs a row about
//     twice as fast as a warp), keep a block of 256 threads.  The class is
//     the wrapper's choice per fill (ksw2s_gpu.fill_shape); one launch
//     holds both classes, block-class blocks first, so a chunk's fills
//     all run at once and the launch lasts as long as its longest fill;
//   - four lanes to a thread at a time: a thread takes four adjacent
//     lanes in one 32-bit word of each ring and runs their cell update at
//     once with the per-byte SIMD intrinsics (__vadd4 and __vsub4 wrap per
//     byte as the int8 casts do, __vmaxs4, __vcmpgts4, __vcmpges4,
//     __vcmpeq4); lane t - 1 of the last row comes in by __byte_perm from
//     the word below, the query bases by a funnel shift of two words of
//     the query ring, reversed, and the direction bytes go out as one
//     32-bit store where the fill's region is 4-aligned (the batch aligns
//     it);
//   - no device-memory load on a row's chain: the query and the target
//     (with the junction bits beside each base, TJ) have rings of their
//     own, filled kBatch rows ahead; every kBatch rows the first warp
//     stores the bytes it loaded kBatch rows earlier (one lane a thread,
//     coalesced), the lanes the next kBatch rows reach take their initial
//     values and site scores from the TJ ring, and the loads for the
//     batch after that are issued, so they land while the rows compute.
//     The ring therefore spans min(qlen, tlen) + kRingPad lanes:
//     kBatch + 34 of slack covers the lanes the batch exposes ahead of
//     the oldest lane a later row reads (the 16-aligned window's 15
//     lanes either side, the st - 1 boundary and the donor's 3 lanes of
//     lookahead);
//   - three blocks an SM (at most 85 registers a thread);
//   - rings past the wrapper's shared-memory cap stay in a global scratch
//     region of the fill's own.
// What bounds it now: the rows of the longest fill of a launch, about
// 0.7 us a row for a block alone, and the card's issue rate when a
// launch holds thousands of fills (PERF.md).  Thirteen byte rings of R
// lanes (u, y, the score row, x, v and x2 twice by row parity, donor,
// acceptor, TJ, query) and four int32 H0-walk slots: ~3.3 KB a fill at
// qlen 150.
//
// Extension mode (exts2_ext_kernel: splice extensions and the non-approx
// splice DP, no KSW_EZ_APPROX_MAX) is the oracle's non-approx branch
// (ksw2_splice.py:239-258, 284-291), in the fill mode's body
// (exts2_one<NT, EXT>), classes (ksw2s_gpu.ext_ring_shape: a warp per
// extension whose rings have at most WARP_RING lanes, which is every
// splice extension of the cDNA set, a block for wider ones, rings past
// EXT_SMEM_MAX in scratch, no LONG_FILLS rule) and rings, which stage the
// target, junction and query bytes ahead of the rows; the first port's
// block per extension loaded them from device memory on each row's chain
// and took 2.7 us a row.  With extd2_kernel.cu's extension mode
// (ksw2_row_max.cuh) and these differences:
//   - the int32 H row lives in a ring of its own (4 R bytes more); a lane
//     entering the ring starts at KSW_NEG_INF (lane 0 at -(q + e));
//   - the row maximum ranks the absolute lanes, so a ring that wraps
//     inside the window reorders no tie;
//   - Z-drop takes gap extension 0 (ksw2_splice.py:255);
//   - the backtrack start is picked in the kernel: (tlen-1, qlen-1) when
//     nothing dropped and the fill has no KSW_EZ_EXTZ_ONLY, else
//     (max_t, max_q) when both are >= 0, else none.  No end bonus, no
//     reach_end.
// What bounds it: a warp's row chain, as in extd2_kernel.cu, and a
// launch of the cDNA set's 4,000 extensions its longest one's 414 rows
// and the two waves of blocks it takes at two blocks an SM.
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
constexpr int kRight = 0x02, kExtzOnly = 0x40, kRevCigar = 0x80;
constexpr int kSpliceFor = 0x100, kSpliceRev = 0x200, kSpliceFlank = 0x400;
// rows between two batches of entering lanes, the ring's slack beyond
// min(qlen, tlen) (>= kBatch + 34), the threads of a block and its
// warp-class fills (fill and extension modes)
constexpr int kBatch = 32;
constexpr int kRingPad = 80;
constexpr int kFillThreads = 256;
constexpr int kFillWarps = kFillThreads / 32;
static_assert(kFillWarps <= 8, "ExtSlots holds a block's warp keys");
// blocks an SM holds: at most 85 registers a thread (the unbounded
// build took 112, two blocks an SM); in extension mode at most 128 (a
// row's chain is what bounds it, and 85 registers spilled on it)
constexpr int kFillBlocksPerSm = 3;
constexpr int kExtBlocksPerSm = 2;

struct SpliceConsts {
  int q, e, q2, noncan, junc_bonus;
  int mat0, mat1, sc_n;
  int long_thres, long_diff;
};

// donor and acceptor score of lane i (ksw2kit.cpp:701-753); tb(k) is the
// target base at k < tlen, jb(k) its junction byte (has_j: the fill has
// junction bytes)
template <class TB, class JB>
__device__ __forceinline__ void site_scores(int i, TB tb, JB jb, bool has_j,
                                            int tlen, int flag,
                                            const SpliceConsts& c,
                                            int8_t& dn, int8_t& ac) {
  dn = ac = (int8_t)-c.noncan;
  if (!(flag & (kSpliceFor | kSpliceRev))) return;
  const bool sfor = flag & kSpliceFor, srev = flag & kSpliceRev;
  const bool rc = flag & kRevCigar;
  const int semi = (flag & kSpliceFlank) ? -(c.noncan / 2) : 0;
  if (i < tlen - 4) {
    int can = 0;
    const int a = tb(i + 1), b = tb(i + 2), d = tb(i + 3);
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
  if (has_j && i < tlen - 1) {
    const int j = jb(i + 1);
    if (rc ? ((sfor && (j & 2)) || (srev && (j & 4)))
           : ((sfor && (j & 1)) || (srev && (j & 8))))
      dn = (int8_t)(dn + c.junc_bonus);
  }
  if (i >= 2 && i < tlen) {
    int can = 0;
    const int a = tb(i - 1), b = tb(i), d = tb(i - 2);
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
  if (has_j && i < tlen) {
    const int j = jb(i);
    if (rc ? ((sfor && (j & 1)) || (srev && (j & 8)))
           : ((sfor && (j & 2)) || (srev && (j & 4))))
      ac = (int8_t)(ac + c.junc_bonus);
  }
}

// a bound on the last lane rows 0 .. r touch (the window's en = en0 | 15
// or the end of the score store span, at most 15 lanes past en0),
// nondecreasing in r: min(en0 + 15, nbytes - 1)
__device__ __forceinline__ int lane_bound(int r, int n_rows, int tlen,
                                          int nbytes) {
  if (r > n_rows - 1) r = n_rows - 1;
  const int en0 = r < tlen - 1 ? r : tlen - 1;
  return en0 + 15 < nbytes - 1 ? en0 + 15 : nbytes - 1;
}

// the ring's lanes, ksw2s_gpu.fill_ring_lanes
__device__ __forceinline__ int fill_ring(int qlen, int tlen) {
  const int mn = qlen < tlen ? qlen : tlen;
  int R = 64;
  while (R < mn + kRingPad) R <<= 1;
  return R;
}

struct FillArgs {
  const uint8_t* qblob;
  const uint8_t* tblob;
  const uint8_t* jblob;
  const long long* qoff;
  const long long* toff;
  const long long* joff;
  const int* qlens;
  const int* tlens;
  const int* flags;
  const long long* p_off;
  const long long* scr_off;
  int8_t* scratch;
  uint8_t* p;
  int* score;        // fill mode: the score of each fill
  // extension mode: the Z-drop of each fill (< 0: none) and its 12
  // output fields
  const int* zdrops;
  int* ext;
};

// four int8 lanes to a 32-bit word (SIMD within a register)
__device__ __forceinline__ unsigned bcast(int8_t v) {
  return (unsigned)(uint8_t)v * 0x01010101u;
}
// where m has 0xff bytes, b; elsewhere a
__device__ __forceinline__ unsigned pick(unsigned m, unsigned a,
                                         unsigned b) {
  return (b & m) | (a & ~m);
}

// one fill by NT threads (a warp, or the block), tid in [0, NT); base:
// its rings, in shared memory or the fill's global scratch region (the
// caller passes one or the other, so that each inlined copy knows its
// address space and takes shared-memory instructions where it can);
// EXT: extension mode, a block-class fill's row state in xs
template <int NT, bool EXT>
__device__ __forceinline__ void exts2_one(const FillArgs& a, int f, int tid,
                                          int8_t* base,
                                          const SpliceConsts& c,
                                          ExtSlots* xs) {
  auto sync = [] {
    if (NT == 32)
      __syncwarp();
    else
      __syncthreads();
  };
  const int qlen = a.qlens[f], tlen = a.tlens[f], flag = a.flags[f];
  const bool right = flag & kRight;
  const int nbytes = (tlen + 15) / 16 * 16;
  const int n_rows = qlen + tlen - 1;
  const int R = fill_ring(qlen, tlen), mask = R - 1;
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
  uint8_t* TJ = (uint8_t*)(AC + R);   // base | junction bits << 3
  uint8_t* Q = TJ + R;
  // fill mode: the H0 walk's v and u, by parity; extension mode: the
  // int32 H ring
  int* slot = (int*)(Q + R);
  int* H = slot;
  const uint8_t* qs = a.qblob + a.qoff[f];
  const uint8_t* ts = a.tblob + a.toff[f];
  const bool has_j = a.joff[f] >= 0;
  const uint8_t* jc = has_j ? a.jblob + a.joff[f] : nullptr;
  uint8_t* pf = a.p + a.p_off[f];
  const bool p_words = ((uintptr_t)pf & 3) == 0;   // rows start 16-aligned

  const int8_t nqe = (int8_t)(-c.q - c.e), nq2 = (int8_t)-c.q2;
  const unsigned q8 = bcast((int8_t)c.q), q28 = bcast((int8_t)c.q2);
  const unsigned qe8 = bcast((int8_t)(c.q + c.e));
  const unsigned mat0 = bcast((int8_t)c.mat0), mat1 = bcast((int8_t)c.mat1);
  const unsigned scn = bcast((int8_t)c.sc_n);
  auto word = [](const void* ring, int s) {   // lanes s .. s + 3
    return *(const unsigned*)((const uint8_t*)ring + s);
  };
  auto put = [](void* ring, int s, unsigned w) {
    *(unsigned*)((uint8_t*)ring + s) = w;
  };
  auto tj_byte = [&](int t) -> uint8_t {
    if (t >= tlen) return 0;
    return (uint8_t)(ts[t] | (has_j ? (jc[t] & 15) << 3 : 0));
  };
  auto base_at = [&](int k) { return TJ[k & mask] & 7; };
  auto junc_at = [&](int k) { return TJ[k & mask] >> 3; };
  auto enter = [&](int t) {   // lane t's initial state and site scores
    const int s = t & mask;
    U[s] = Y[s] = X0[s] = X1[s] = V0[s] = V1[s] = nqe;
    X20[s] = X21[s] = nq2;
    S[s] = 0;
    site_scores(t, base_at, junc_at, has_j, tlen, flag, c, DN[s], AC[s]);
    if (EXT) H[s] = t == 0 ? -(c.q + c.e) : kNegInf;   // row 0: H[0] + v
  };

  // lanes [0, lane_bound(0)] with the TJ lanes 3 past them and the first
  // query base; then the loads of the first batch are issued
  int tj_hi = lane_bound(0, n_rows, tlen, nbytes) + 3, q_hi = 0;
  for (int t = tid; t <= tj_hi; t += NT) TJ[t] = tj_byte(t);
  if (tid == 0) Q[0] = qs[0];
  sync();
  int exposed = tj_hi - 3;
  for (int t = tid; t <= exposed; t += NT) enter(t);
  int tj_pf = lane_bound(kBatch, n_rows, tlen, nbytes) + 3;
  int q_pf = kBatch < qlen - 1 ? kBatch : qlen - 1;
  uint8_t reg_tj = 0, reg_q = 0;
  if (tid < 32) {
    if (tj_hi + 1 + tid <= tj_pf) reg_tj = tj_byte(tj_hi + 1 + tid);
    if (q_hi + 1 + tid <= q_pf) reg_q = qs[q_hi + 1 + tid];
  }
  sync();

  int H0 = 0, lh = 0, sc_final = kNegInf;
  int last_st = -1, last_en = -1;
  long long row_off = 0;
  // extension mode: the Extz fields, the previous row's window and the
  // H[en0 - 1] a warp's shuffle carried over from it
  ExtTrack ez;
  const int zdrop = EXT ? a.zdrops[f] : -1;
  int prev_st0 = -1, prev_en0 = -1, hp_next = 0;
  bool dropped = false;
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
    // x, v, x2 at st - 1 of the last row, for the window's first lane
    uint8_t x1 = (uint8_t)nqe, x21 = (uint8_t)nq2, v1 = (uint8_t)nqe;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en) {
        const int s = (st - 1) & mask;
        x1 = xp[s];
        x21 = x2p[s];
        v1 = vp[s];
      }
    } else {
      v1 = (uint8_t)bv;
    }
    const bool reset = en >= r;
    int hi = st0 + 16 * ((en0 - st0) / 16 + 1);
    if (hi > nbytes) hi = nbytes;
    const int last = en > hi - 1 ? en : hi - 1;
    uint8_t* prow = pf + row_off;
    // extension mode: the previous row's H[en0 - 1] (its owner's copy
    // when that row's window held the lane, which this row overwrites;
    // else in place), the next row's en0, and this thread's lanes of the
    // H row
    int hp = 0;
    const int nen0 = r + 1 < tlen - 1 ? r + 1 : tlen - 1;
    if (EXT && r > 0 && en0 > 0)
      hp = en0 - 1 >= prev_st0 && en0 - 1 <= prev_en0
               ? (NT == 32 ? hp_next : xs->hp[par])
               : H[(en0 - 1) & mask];
    ExtLanes x(st0, en0, nen0, hp);
    // four lanes t0 .. t0 + 3 of the row (t0 a multiple of 4, as st and
    // en + 1 are of 16) in one 32-bit word of each ring, bytes in lane
    // order; a cell reads lane t - 1 of the last row, so the x, v and x2
    // words are shifted up a byte, the lane below from the word before
    // (or the boundary values at st)
    for (int t0 = st + 4 * tid; t0 <= last; t0 += 4 * NT) {
      const int s = t0 & mask;
      // lanes of the score store span [st0, hi): their score from the
      // target and query bases, the others keep the row's old score
      const int lo_f = st0 - t0, hi_f = hi - t0;   // fresh bytes' range
      unsigned fresh = 0;
      for (int i = 0; i < 4; ++i)
        if (i >= lo_f && i < hi_f) fresh |= 0xffu << (8 * i);
      unsigned z = word(S, s);
      if (fresh) {
        const unsigned tb = word(TJ, s) & 0x07070707u;
        // query bases r - t0 - i: four of the query ring's positions
        // p_lo .. p_lo + 3 (p_lo = r - t0 - 3), reversed; 0 past r
        const int p_lo = r - t0 - 3, w0 = p_lo & ~3;
        const unsigned qa = word(Q, w0 & mask);
        const unsigned qb4 = word(Q, (w0 + 4) & mask);
        unsigned qb = __byte_perm(__funnelshift_r(qa, qb4, 8 * (p_lo - w0)),
                                  0, 0x0123);
        const int n_q = r - t0 + 1;   // bytes with t <= r
        if (n_q < 4) qb &= n_q <= 0 ? 0u : (1u << (8 * n_q)) - 1;
        const unsigned eq = __vcmpeq4(tb, qb);
        const unsigned nn = __vcmpeq4(tb, 0x04040404u) |
                            __vcmpeq4(qb, 0x04040404u);
        z = pick(fresh, z, pick(nn, pick(eq, mat1, mat0), scn));
      }
      if (t0 > en) {   // past the window: the score row alone
        if (fresh) put(S, s, z);
        continue;
      }
      put(S, s, z);
      unsigned xt1, vt1, x2t1;
      if (t0 == st) {
        xt1 = (word(xp, s) << 8) | x1;
        vt1 = (word(vp, s) << 8) | v1;
        x2t1 = (word(x2p, s) << 8) | x21;
      } else {
        const int s4 = (t0 - 4) & mask;
        xt1 = __byte_perm(word(xp, s4), word(xp, s), 0x6543);
        vt1 = __byte_perm(word(vp, s4), word(vp, s), 0x6543);
        x2t1 = __byte_perm(word(x2p, s4), word(x2p, s), 0x6543);
      }
      unsigned ut = word(U, s), yt = word(Y, s);
      if (reset && r >= t0 && r < t0 + 4) {   // lane r restarts
        const unsigned m = 0xffu << (8 * (r - t0));
        ut = pick(m, ut, bcast(bv));
        yt = pick(m, yt, bcast(nqe));
      }
      const unsigned dn = word(DN, s);
      unsigned av = __vadd4(xt1, vt1);
      unsigned bv4 = __vadd4(yt, ut);
      unsigned a2 = __vadd4(x2t1, vt1);
      const unsigned a2a = __vadd4(a2, word(AC, s));
      // each step's compare mask gives both the d bits and the max
      unsigned d, m;
      if (right) {   // z keeps its value only where it is larger
        m = __vcmpgts4(z, av);
        d = ~m & 0x01010101u;
        z = pick(m, av, z);
        m = __vcmpgts4(z, bv4);
        d = pick(m, 0x02020202u, d);
        z = pick(m, bv4, z);
        m = __vcmpgts4(z, a2a);
        d = pick(m, 0x03030303u, d);
        z = pick(m, a2a, z);
      } else {       // a candidate takes over only where it is larger
        m = __vcmpgts4(av, z);
        d = m & 0x01010101u;
        z = pick(m, z, av);
        m = __vcmpgts4(bv4, z);
        d = pick(m, d, 0x02020202u);
        z = pick(m, z, bv4);
        m = __vcmpgts4(a2a, z);
        d = pick(m, d, 0x03030303u);
        z = pick(m, z, a2a);
      }
      const unsigned un = __vsub4(z, vt1), vn = __vsub4(z, ut);
      const unsigned tq = __vsub4(z, q8);
      av = __vsub4(av, tq);
      bv4 = __vsub4(bv4, tq);
      a2 = __vsub4(a2, __vsub4(z, q28));
      const unsigned ta = right ? __vcmpges4(av, 0) : __vcmpgts4(av, 0);
      const unsigned tb = right ? __vcmpges4(bv4, 0) : __vcmpgts4(bv4, 0);
      const unsigned ta2 = right ? __vcmpges4(a2, dn) : __vcmpgts4(a2, dn);
      put(U, s, un);
      put(vc, s, vn);
      put(xc, s, __vsub4(av & ta, qe8));
      put(Y, s, __vsub4(bv4 & tb, qe8));
      put(x2c, s, __vsub4(pick(ta2, dn, a2), q28));
      d |= (ta & 0x08080808u) | (tb & 0x10101010u) | (ta2 & 0x20202020u);
      if (p_words) {
        put(prow, t0 - st, d);
      } else {
        for (int i = 0; i < 4; ++i)
          prow[t0 - st + i] = (uint8_t)(d >> (8 * i));
      }
      if (EXT) {
        // the H row over [st0, en0] in the ring (ksw2_splice.py:240-250)
        // and this thread's best lane of it, ranked by the absolute lane
        if (t0 <= en0 && t0 + 3 >= st0) {
          int4 h4 = *(const int4*)(H + s);
          x.word(h4, t0, un, vn);
          *(int4*)(H + s) = h4;
        }
        continue;
      }
      // the H0 walk reads v at lh and u at lh + 1 of this row
      if (lh >= t0 && lh < t0 + 4) slot[par] = byte_at(vn, lh - t0);
      if (lh + 1 >= t0 && lh + 1 < t0 + 4)
        slot[2 + par] = byte_at(un, lh + 1 - t0);
    }
    if (r % kBatch == 0 && r + 1 < n_rows) {
      // the batch: store the bytes loaded kBatch rows ago, give the lanes
      // rows r + 1 .. r + kBatch reach their initial values and site
      // scores, and issue the loads of the batch after
      if (tid < 32) {
        if (tj_hi + 1 + tid <= tj_pf) TJ[(tj_hi + 1 + tid) & mask] = reg_tj;
        if (q_hi + 1 + tid <= q_pf) Q[(q_hi + 1 + tid) & mask] = reg_q;
      }
      tj_hi = tj_pf;
      q_hi = q_pf;
      sync();
      const int nl = lane_bound(r + kBatch, n_rows, tlen, nbytes);
      for (int t = exposed + 1 + tid; t <= nl; t += NT) enter(t);
      exposed = nl;
      tj_pf = lane_bound(r + 2 * kBatch, n_rows, tlen, nbytes) + 3;
      q_pf = r + 2 * kBatch < qlen - 1 ? r + 2 * kBatch : qlen - 1;
      if (tid < 32) {
        if (tj_hi + 1 + tid <= tj_pf) reg_tj = tj_byte(tj_hi + 1 + tid);
        if (q_hi + 1 + tid <= q_pf) reg_q = qs[q_hi + 1 + tid];
      }
    }
    if (EXT) {
      // the row maximum, H[st0] and H[en0]: in a warp by __reduce_*_sync
      // and shuffles from the lanes' owners (words go to threads (word
      // index) mod NT), in a block through the owners' parity slots; Z-drop with
      // gap extension 0 (ksw2_splice.py:255)
      int m, rank, mt, h_st0, h_en0;
      warp_row_max(x, m, rank, mt);
      if (NT == 32) {
        h_st0 = __shfl_sync(0xffffffffu, x.hst0, ((st0 - st) >> 2) & 31);
        h_en0 = __shfl_sync(0xffffffffu, x.hen0, ((en0 - st) >> 2) & 31);
        hp_next =
            __shfl_sync(0xffffffffu, x.hnext, ((nen0 - 1 - st) >> 2) & 31);
        sync();
      } else {
        if (tid == ((st0 - st) >> 2) % NT) xs->hst0[par] = x.hst0;
        if (tid == ((en0 - st) >> 2) % NT) xs->hen0[par] = x.hen0;
        if (nen0 - 1 >= st0 && nen0 - 1 <= en0 &&
            tid == ((nen0 - 1 - st) >> 2) % NT)
          xs->hp[par ^ 1] = x.hnext;
        if ((tid & 31) == 0) put_warp_max(xs, par, tid >> 5, m, rank, mt);
        sync();
        block_row_max(xs, par, NT / 32, m, mt);
        h_st0 = xs->hst0[par];
        h_en0 = xs->hen0[par];
      }
      if (ez.row(m, mt, h_st0, h_en0, r, st0, en0, en, qlen, tlen, zdrop,
                 0)) {
        dropped = true;
        break;
      }
      prev_st0 = st0;
      prev_en0 = en0;
    } else {
      sync();
      // the approx-max H0 walk (ksw2_splice.py:259-281); lh stays in
      // [st0, en0] of the row, so the lanes it reads were written just now
      const int vl = slot[par], ul = slot[2 + par];
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
    }
    last_st = st;
    last_en = en;
    row_off += en - st + 1;
  }
  if (tid != 0) return;
  if (!EXT) {
    a.score[f] = sc_final;
    return;
  }
  // the backtrack start (ksw2_splice.py:284-291)
  int i0 = -1, j0 = -1;
  if (!dropped && !(flag & kExtzOnly)) {
    i0 = tlen - 1;
    j0 = qlen - 1;
  } else if (ez.max_t >= 0 && ez.max_q >= 0) {
    i0 = ez.max_t;
    j0 = ez.max_q;
  }
  int* o = a.ext + 12LL * f;
  o[0] = ez.score;
  o[1] = ez.mx;
  o[2] = ez.max_t;
  o[3] = ez.max_q;
  o[4] = ez.mqe;
  o[5] = ez.mqe_t;
  o[6] = ez.mte;
  o[7] = ez.mte_q;
  o[8] = dropped;
  o[9] = 0;   // reach_end: exts2 has no end bonus
  o[10] = i0;
  o[11] = j0;
}

// work[0 .. n_block): the block-class fills, one to a block; then the
// warp-class fills, eight to a block (-1: none), each warp's rings at
// warp * warp_stride of the block's shared memory smem (a warp-class
// fill's rings are never in scratch)
template <bool EXT>
__device__ __forceinline__ void exts2_launch(const FillArgs& a,
                                             const int* __restrict__ work,
                                             int n_block, int warp_stride,
                                             const SpliceConsts& c,
                                             int8_t* smem, ExtSlots* xs) {
  if ((int)blockIdx.x < n_block) {
    const int f = work[blockIdx.x];
    if (a.scr_off[f] >= 0)
      exts2_one<kFillThreads, EXT>(a, f, threadIdx.x,
                                   a.scratch + a.scr_off[f], c, xs);
    else
      exts2_one<kFillThreads, EXT>(a, f, threadIdx.x, smem, c, xs);
    return;
  }
  const int w = threadIdx.x >> 5;
  const int f = work[n_block + (blockIdx.x - n_block) * kFillWarps + w];
  if (f < 0) return;
  exts2_one<32, EXT>(a, f, threadIdx.x & 31, smem + w * warp_stride, c, xs);
}

__global__ void __launch_bounds__(kFillThreads, kFillBlocksPerSm)
exts2_fill_kernel(FillArgs a, const int* __restrict__ work, int n_block,
                  int warp_stride, SpliceConsts c) {
  extern __shared__ __align__(16) int8_t smem[];
  exts2_launch<false>(a, work, n_block, warp_stride, c, smem, nullptr);
}

// extension mode: the fill kernel's classes and body, with the H ring
__global__ void __launch_bounds__(kFillThreads, kExtBlocksPerSm)
exts2_ext_kernel(FillArgs a, const int* __restrict__ work, int n_block,
                 int warp_stride, SpliceConsts c) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ ExtSlots xs;
  exts2_launch<true>(a, work, n_block, warp_stride, c, smem, &xs);
}

// the fill or the extension kernel over work (block-class fills first)
template <class K>
int launch_fills(K kernel, const FillArgs& a, const void* work, int n_block,
                 int n_warp, const SpliceConsts& c, int warp_stride,
                 int smem_bytes, void* stream) {
  if (n_block + n_warp <= 0) return 0;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = n_block + (n_warp + kFillWarps - 1) / kFillWarps;
  kernel<<<blocks, kFillThreads, smem_bytes, (cudaStream_t)stream>>>(
      a, (const int*)work, n_block, warp_stride, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Fills splice fill k (qlen[k] x tlen[k] bases at qoff[k] / toff[k] of
// the blobs, junction bytes at joff[k] of jblob or none when joff[k] < 0,
// KSW_EZ_* flag flags[k]) for k < n: direction bytes into p at p_off[k],
// the score into score[k].  work lists the fills: its first n_block
// entries are the block-class fills (a block of 256 threads each), then
// n_warp entries of the warp-class fills (a warp each, eight to a block;
// -1 pads the last block).  scr_off[k] >= 0 puts a block-class fill's
// rings at that offset of scratch instead of shared memory (a warp-class
// fill's must be -1); smem_bytes is the dynamic
// shared memory of a block (at least 13 x the ring lanes of a
// block-class fill in shared memory + 16, and 8 x warp_stride, itself at
// least 13 x the ring lanes of a warp-class fill + 16).  Returns the
// CUDA error of the launch (0 on success).
int mm2_exts2_fill(const void* qblob, const void* tblob, const void* jblob,
                   const void* qoff, const void* toff, const void* joff,
                   const void* qlen, const void* tlen, const void* flags,
                   const void* p_off, const void* scr_off, const void* work,
                   int n_block, int n_warp, void* scratch, void* p,
                   void* score, int q, int e, int q2, int noncan,
                   int junc_bonus, int mat0, int mat1, int sc_n,
                   int long_thres, int long_diff, int warp_stride,
                   int smem_bytes, void* stream) {
  FillArgs a{(const uint8_t*)qblob, (const uint8_t*)tblob,
             (const uint8_t*)jblob, (const long long*)qoff,
             (const long long*)toff, (const long long*)joff,
             (const int*)qlen, (const int*)tlen, (const int*)flags,
             (const long long*)p_off, (const long long*)scr_off,
             (int8_t*)scratch, (uint8_t*)p, (int*)score, nullptr, nullptr};
  return launch_fills(exts2_fill_kernel, a, work, n_block, n_warp,
                      SpliceConsts{q, e, q2, noncan, junc_bonus, mat0, mat1,
                                   sc_n, long_thres, long_diff},
                      warp_stride, smem_bytes, stream);
}

// Extension mode (no KSW_EZ_APPROX_MAX; KSW_EZ_EXTZ_ONLY per fill) of the
// splice fills: operands and classes as mm2_exts2_fill's (the rings of
// ksw2s_gpu.ext_ring_bytes: the fill's and the int32 H ring), with
// Z-drop zdrop[k] (< 0: none); fill k's [score, max, max_t, max_q, mqe,
// mqe_t, mte, mte_q, zdropped, reach_end (0), i0, j0] into ext[12k ...],
// (i0, j0) the backtrack start (-1: none).
int mm2_exts2_ext(const void* qblob, const void* tblob, const void* jblob,
                  const void* qoff, const void* toff, const void* joff,
                  const void* qlen, const void* tlen, const void* flags,
                  const void* zdrop, const void* p_off, const void* scr_off,
                  const void* work, int n_block, int n_warp, void* scratch,
                  void* p, void* ext, int q, int e, int q2, int noncan,
                  int junc_bonus, int mat0, int mat1, int sc_n,
                  int long_thres, int long_diff, int warp_stride,
                  int smem_bytes, void* stream) {
  FillArgs a{(const uint8_t*)qblob, (const uint8_t*)tblob,
             (const uint8_t*)jblob, (const long long*)qoff,
             (const long long*)toff, (const long long*)joff,
             (const int*)qlen, (const int*)tlen, (const int*)flags,
             (const long long*)p_off, (const long long*)scr_off,
             (int8_t*)scratch, (uint8_t*)p, nullptr, (const int*)zdrop,
             (int*)ext};
  return launch_fills(exts2_ext_kernel, a, work, n_block, n_warp,
                      SpliceConsts{q, e, q2, noncan, junc_bonus, mat0, mat1,
                                   sc_n, long_thres, long_diff},
                      warp_stride, smem_bytes, stream);
}

}  // extern "C"
