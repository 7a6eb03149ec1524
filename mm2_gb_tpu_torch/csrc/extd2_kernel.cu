// Gap-fill and extension DP (ksw2 extd2) and its backtrack for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel mm2_gb_tpu/ops/ksw2_tpu.py::_extd2_kernel in
// fill mode (track_h=False) and in extension mode (track_h=True), with
// prep_fill_operands folded in, the XLA program backtrack_device with
// _rle_cigar folded in, and ext_batch_device's host epilogue (the
// backtrack start of each extension).  Semantics are
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
// extd2_fill (fill mode).  Cell t of row r reads x, v, x2 at t - 1 of row
// r - 1 and u, y, y2, s at t, so x, v and x2 are double-buffered by row
// parity and one barrier per row orders the rows.  What bounded the
// first port (a block per fill, threads over the lanes of a row, 48,000
// fills a launch on the flowcell taking 46 ms) was the launch shape and
// the instructions a cell took: a launch's threads were its widest
// fill's row and its shared memory its largest fill's state, so the
// common ~213 bp fill ran as a block of 256 threads, most of them idle
// on short rows, a handful of blocks an SM; a cell took the int8 casts
// and byte accesses one lane at a time, and loaded its target and query
// bases from device memory on the row's chain.  The design (the splice
// fill's, exts2_kernel.cu):
//   - a warp per fill whose state is at most ksw2_gpu.WARP_LANES lanes
//     wide (every fill of the flowcell), eight of them to a block, each
//     with its own state in shared memory at the launch's warp stride and
//     __syncwarp() between rows; wider fills, and the longest of a launch
//     (a block runs a row faster than a warp), keep a block of 256
//     threads with __syncthreads().  The class is the wrapper's choice per
//     fill (ksw2_gpu.fill_shape); one launch holds both classes,
//     block-class blocks first;
//   - four lanes to a thread at a time: a thread takes four adjacent
//     lanes in one 32-bit word of each row; a window starts on a 16-lane
//     boundary, so a word never straddles it, and per-byte masks carry the
//     score store span, the reset lane r and the boundary lane st - 1 (by
//     __byte_perm from the word below); the direction bytes go out as one
//     32-bit store where the fill's region is 4-aligned (the batch
//     16-aligns it);
//   - the cell update of a word in two registers of 16-bit lanes on the
//     DPX instructions (cell2, below), each step exact to the int8 casts:
//     a word took ~280 instructions in the warp class with the emulated
//     per-byte SIMD intrinsics (__vadd4, __vcmpgts4 ...), which sm_90 has
//     no hardware for; a lane's score is a prmt lookup of its two bases;
//   - no device-memory load on a row's chain: the target (0 past tlen)
//     and the query reversed (zeros after it, for t > r) are staged in
//     shared memory with the state before the first row, so a word's four
//     query bases are a funnel shift of two aligned words;
//   - the H0 walk's two lanes (v at lh, u at lh + 1 of the row just
//     written): a warp-class fill reads them after its barrier, a
//     block-class one through a parity slot;
//   - three blocks an SM (at most 85 registers a thread);
//   - a block-class fill whose state exceeds ksw2_gpu.FILL_SMEM_MAX keeps
//     it in a global scratch region of its own.
// The state: ten rows of nbytes = tlen rounded up to 16 (u, y, y2, the
// score row, and x, v, x2 twice), the target row, the reversed query
// and the walk's slots: ~12 x nbytes, 2.9 KB for a 213 bp fill.  Row r's
// direction bytes go to the fill's region at the running sum of the
// earlier rows' widths (en - st + 1), the layout ksw2_backtrack reads.
//
// Extension mode (extd2_ext_kernel; KSW_EZ_EXTZ_ONLY: the left and right
// extensions and the inversion fill of the align driver) is the oracle's
// non-approx branch (ksw2kit.cpp:554-568): an int32 H row with H[en0] =
// H[en0-1] + u[en0] (H[0] + v[0] when en0 == 0) and H[t] += v[t] over
// [st0, en0), then the row maximum, mte, mqe, Z-drop and the score.
// What bounded the first port (a block per extension, threads over the
// lanes of a row) was a row's chain: each lane's target and query bases
// loaded from device memory, a 64-bit key over five shuffle levels, a
// slot per warp and a __syncthreads() a row, 1.6-1.9 us a row for
// extensions whose rows are ~20-140 lanes.  The design is the fill
// mode's, in the same body (extd2_one<NT, RIGHT, EXT>):
//   - its classes (ksw2_gpu.ext_shape): a warp per extension of at most
//     WARP_LANES lanes (every extension of a flowcell --qstrand run),
//     eight to a block, a block of 256 threads for wider ones, the state
//     of a block past EXT_SMEM_MAX in global scratch; no LONG_FILLS rule,
//     as a warp runs a short extension's row no slower than a block;
//   - four lanes a word, the target and the reversed query staged in
//     shared memory, and the H row beside the state (4 x nbytes, an int4
//     per word, H[0] starting at -(q + e) so that row 0 needs no case);
//   - the row maximum without a barrier in a warp (ksw2_row_max.cuh):
//     each thread's best (H, rank, lane) over its words, then three
//     __reduce_*_sync; H[st0], H[en0] and the next row's H[en0 - 1] come
//     by shuffle from the threads that own them, so a Z-drop ends one
//     warp's loop and the block's other warps run on.  A block-class
//     extension passes them and each warp's best through parity slots
//     and its one barrier a row;
//   - two blocks an SM (at most 128 registers a thread; at 85 the H
//     row's state spilled onto the row's chain).
// What bounds it: the row's chain of dependent instructions in one warp,
// 1.0-1.3 us a row alone with the emulated per-byte SIMD (PERF.md), now
// the cell's DPX update and the H row's lanes; a launch of the flowcell's
// 200 extensions lasts as long as its longest one's rows.
// After the loop, ext_batch_device's epilogue (ksw2_tpu.py:1741-1762)
// picks the backtrack start: (mqe_t, qlen-1) when the end bonus reaches
// the query end, else (max_t, max_q), else none.  The fill's [score, max,
// max_t, max_q, mqe, mqe_t, mte, mte_q, zdropped, reach_end, i0, j0] go
// out as int32, and the backtrack reads i0, j0 from there: no host round
// trip between the two launches.
//
// ksw2_backtrack: ksw_backtrack with is_rot (ksw2.h:126-158).  It starts
// at (tlen-1, qlen-1), or at a per-fill (i0, j0) (extensions; a start of
// -1 writes no CIGAR).  Off-band cells force the state (i < st: I,
// i > en: D); the two tails follow the loop.  Run-length words are
// written straight into the fill's slot of qlen + tlen words and
// reversed in place unless KSW_EZ_REV_CIGAR (one flag for the launch, or
// one byte per fill).  Intron mode (min_intron_len > 0, the splice fills
// of exts2_kernel.cu) is backtrack_core's (ksw2kit.cpp:117-145),
// replacing backtrack_device's intron_ops and the host
// _rle_cigar_splice: state 3 emits N, and the tail deletion of i + 1
// bases is an N when i >= min_intron_len.
// What bounds it: the walk is serial, and each step's byte address
// depends on the step before.  The first port (a thread per fill, 128
// fills to a block) waited a device-memory latency every step (a chunk's
// direction bytes do not fit in L2), summed the widths of every row
// before the start serially, and ran a chunk's 40-84 splice fills in one
// block on one SM.  The design: a warp per fill (kBtWarps to a block, so
// a launch spreads its fills over the SMs); the warp sums the start
// row's offset in parallel; from (i0, j0) the next kTile steps stay in
// rows [r0 - 2 kTile + 2, r0] and lanes [i0 - kTile + 1, i0], so the
// warp loads that tile of direction bytes into shared memory with
// independent, coalesced loads (a lane a column, 32 rows in flight at a
// time, the rows' offsets by a warp scan of their widths; an off-band
// cell holds its forced state) and lane 0 walks kTile steps in it with
// one shared-memory load a step: two memory latencies per kTile steps.
// The warp reverses the words.  What bounds it now: a long walk's tile
// loads and steps (about 0.16 us a step alone); a launch of many short
// walks (genomic fills) its throughput, with 16 walks in flight an SM.
//
// Plain C interface (no PyTorch headers): the Python wrappers in
// mm2_gb_tpu_torch/ops/ksw2_gpu.py pass raw device pointers and the
// stream, and raise when a launch returns a CUDA error.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

#include "ksw2_row_max.cuh"

constexpr int kNegInf = -0x40000000;
// the threads of a block, the warp-class fills of a block, blocks an SM
// holds (at most 85 registers a thread), and the zero bytes before the
// reversed query (fill and extension modes)
constexpr int kFillThreads = 256;
constexpr int kFillWarps = kFillThreads / 32;
constexpr int kFillBlocksPerSm = 3;
constexpr int kQPad = 16;
// extension mode: blocks an SM holds (at most 128 registers a thread: a
// row's chain is what bounds it, and 85 registers spilled on it)
constexpr int kExtBlocksPerSm = 2;
static_assert(kFillWarps <= 8, "ExtSlots holds a block's warp keys");

// the 16-bit lanes of m0 (aux 0), q and q2 (aux CellTags::q_aux), q + e
// and q2 + e2 (aux 0); the candidates' tags (aux bytes): s's, and x's,
// y's, x2's and y2's in bytes 0-3 of a word; the score of a lane by its
// index: a match, three mismatches, and four where either base is N;
// bound_v's values
struct CellConsts {
  unsigned m0, q, q2, qe, qe2;
  unsigned tag_s, tags;
  unsigned sc_lo, sc_hi;
  int bv_e, bv_long, bv_e2;   // bound_v(r) past row 0, as int8 values
};

struct FillConsts {
  int q, e, q2, e2;          // swapped: q + e <= q2 + e2
  int mat0, mat1, sc_n;
  int long_thres, long_diff;
  // built by the launch (fill_consts), so that the row loop reads them
  // from the kernel's parameters and keeps no register for them
  CellConsts cell;
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

// four int8 lanes to a 32-bit word (SIMD within a register)
__host__ __device__ __forceinline__ unsigned bcast(int8_t v) {
  return (unsigned)(uint8_t)v * 0x01010101u;
}
// where m has 0xff bytes, b; elsewhere a
__device__ __forceinline__ unsigned pick(unsigned m, unsigned a,
                                         unsigned b) {
  return (b & m) | (a & ~m);
}

// The cell update in 16-bit lanes.  A word's four int8 lanes go to two
// registers of two 16-bit lanes, E (lanes 0 and 2) and O (lanes 1 and 3);
// a lane holds its int8 value in its high byte and an aux byte below it.
// So a 16-bit add wraps the value exactly as the int8 casts do (the aux
// bytes never carry into it), a signed 16-bit max or min orders lanes by
// value and then by aux, and the update runs on Hopper's DPX instructions
// (add.s16x2 + max.s16x2 fuse into VIADDMNMX) and plain 32-bit adds
// instead of the emulated per-byte __v*4 intrinsics.  The aux bytes carry:
//   - a tag per candidate of the four-way max (s, x + v, y + u, x2 + v,
//     y2 + u), so the max's winner is the d code: increasing tags, the
//     last of equal candidates wins (KSW_EZ_RIGHT's >=), decreasing ones
//     the first (>);
//   - a guard, so that the borrow or carry of a 32-bit add from the low
//     lane never reaches the high lane's value;
//   - the sign tests of the d bits 0x08-0x40: a candidate's relu picks
//     either its own lane (aux 0xbc-0xc6 under RIGHT, 0x3b-0x48 without)
//     or the zero lane (CellTags::zero, aux 0x40 or 0xc0), so bit 7 of
//     the aux byte says which one won, and prmt's sign mode gathers it.
// tests/test_torch_ksw2.py holds a NumPy model of these steps to the
// oracle's int8 update.
template <unsigned S>
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b) {
  unsigned r;   // prmt with the selector's sign bits (__byte_perm drops them)
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "n"(S));
  return r;
}
__device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
  unsigned r;
  asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned min2(unsigned a, unsigned b) {
  unsigned r;
  asm("min.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned prmt_r(unsigned a, unsigned b,
                                           unsigned s) {
  unsigned r;   // a selector in a register (nibbles 0-7)
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}
// lanes 0 and 2 (E) or 1 and 3 (O) of w, with aux byte J of g
template <int J>
__device__ __forceinline__ unsigned lanes_e(unsigned w, unsigned g) {
  return __byte_perm(w, g, 0x2404 + 0x101 * J);
}
template <int J>
__device__ __forceinline__ unsigned lanes_o(unsigned w, unsigned g) {
  return __byte_perm(w, g, 0x3414 + 0x101 * J);
}
// an int8 in the value byte of both lanes, aux byte g
__host__ __device__ __forceinline__ unsigned lane2(int v, unsigned g) {
  return ((unsigned)(uint8_t)v << 8 | g) * 0x10001u;
}

// the guards of q - z and of the relu's zero lane (see above)
template <bool RIGHT>
struct CellTags {
  static constexpr unsigned q_aux = RIGHT ? 0xc0 : 0x40;
  static constexpr unsigned zero = RIGHT ? 0x00400040u : 0x00c000c0u;
};

// FillConsts with its CellConsts.  The tags: the d code of the max's
// winner is the tag under RIGHT and 7 - tag otherwise.  (As parameters,
// the tags let prmt keep its selector as an immediate: with both
// constant, ptxas moves the selector into a register before each prmt.)
FillConsts fill_consts(int q, int e, int q2, int e2, int mat0, int mat1,
                       int sc_n, int long_thres, int long_diff, bool right) {
  const unsigned q_aux =
      right ? CellTags<true>::q_aux : CellTags<false>::q_aux;
  const CellConsts cell{lane2(mat0, 0), lane2(q, q_aux), lane2(q2, q_aux),
                        lane2(q + e, 0), lane2(q2 + e2, 0),
                        right ? 0u : 7u, right ? 0x04030201u : 0x03040506u,
                        (unsigned)(uint8_t)mat0 | bcast((int8_t)mat1) << 8,
                        bcast((int8_t)sc_n), (int8_t)-e, (int8_t)long_diff,
                        (int8_t)-e2};
  return FillConsts{q, e, q2, e2, mat0, mat1, sc_n, long_thres, long_diff,
                    cell};
}

struct CellOut {
  unsigned z, u, v, x, y, x2, y2;   // z: the max before the min with m0
};

// the cell update (ksw2.py's extd2 row, ksw2_extd2_sse.c) of the two
// lanes of one register: s the score, x, v, x2 at t - 1 of the last row,
// u, y, y2 at t
template <bool RIGHT>
__device__ __forceinline__ CellOut cell2(unsigned s, unsigned x, unsigned v,
                                         unsigned x2, unsigned u, unsigned y,
                                         unsigned y2, const CellConsts& k) {
  CellOut o;
  unsigned z = __viaddmax_s16x2(x, v, s);
  z = __viaddmax_s16x2(y, u, z);
  z = __viaddmax_s16x2(x2, v, z);
  z = __viaddmax_s16x2(y2, u, z);
  o.z = z;
  z = min2(z, k.m0);
  // the guard 0x10000: the high lane's aux absorbs the low lane's borrow
  o.u = z - v + 0x10000u;
  o.v = z - u + 0x10000u;
  // a - (z - q) as the int8 casts give it: the value bytes add mod 256
  const unsigned nq = k.q - z, nq2 = k.q2 - z;
  constexpr unsigned zero = CellTags<RIGHT>::zero;
  o.x = max2(x + v + nq, zero) - k.qe;
  o.y = max2(y + u + nq, zero) - k.qe;
  o.x2 = max2(x2 + v + nq2, zero) - k.qe2;
  o.y2 = max2(y2 + u + nq2, zero) - k.qe2;
  return o;
}

// fill mode: the reversed query's bytes (kQPad before it, zeros after),
// ksw2_gpu.fill_bytes
__device__ __forceinline__ int query_bytes(int qlen) {
  return (qlen + kQPad + 32 + 15) & ~15;
}

struct FillArgs {
  const uint8_t* qblob;
  const uint8_t* tblob;
  const long long* qoff;
  const long long* toff;
  const int* qlens;
  const int* tlens;
  const int* ws;
  const long long* p_off;
  const long long* scr_off;
  int8_t* scratch;
  uint8_t* p;
  int* score;        // fill mode: the score of each fill
  // extension mode: the Z-drop of each fill (< 0: none), the end bonus,
  // and the 12 output fields of each fill
  const int* zdrops;
  int end_bonus;
  int* ext;
};

// one fill by NT threads (a warp, or the block), tid in [0, NT); base:
// its state, in shared memory or the fill's global scratch region (the
// caller passes one or the other, so that each inlined copy knows its
// address space); EXT: extension mode, a block-class fill's row state in
// xs
template <int NT, bool RIGHT, bool EXT>
__device__ __forceinline__ void extd2_one(const FillArgs& a, int f, int tid,
                                          int8_t* base, const FillConsts& c,
                                          ExtSlots* xs) {
  auto sync = [] {
    if (NT == 32)
      __syncwarp();
    else
      __syncthreads();
  };
  const int qlen = a.qlens[f], tlen = a.tlens[f];
  int w = a.ws[f];
  if (w < 0) w = qlen > tlen ? qlen : tlen;
  const int nbytes = (tlen + 15) / 16 * 16;
  const int n_rows = qlen + tlen - 1;
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
  uint8_t* T = (uint8_t*)(X21 + nbytes);   // the target, 0 past tlen
  uint8_t* QR = T + nbytes;                // the query reversed
  // fill mode: the H0 walk's v and u; extension mode: the int32 H row
  int* slot = (int*)(QR + query_bytes(qlen));
  int* H = slot;
  const uint8_t* qs = a.qblob + a.qoff[f];
  const uint8_t* ts = a.tblob + a.toff[f];
  uint8_t* pf = a.p + a.p_off[f];
  const bool p_words = ((uintptr_t)pf & 3) == 0;   // rows start 16-aligned

  const int8_t nqe = (int8_t)(-c.q - c.e), nqe2 = (int8_t)(-c.q2 - c.e2);
  const unsigned nqe4 = bcast(nqe), nqe24 = bcast(nqe2);
  const unsigned x1w = (unsigned)(uint8_t)nqe << 24;   // boundary x, x2
  const unsigned x21w = (unsigned)(uint8_t)nqe2 << 24;
  const CellConsts& cc = c.cell;
  auto word = [](const void* row, int s) {   // lanes s .. s + 3
    return *(const unsigned*)((const uint8_t*)row + s);
  };
  auto put = [](void* row, int s, unsigned v) {
    *(unsigned*)((uint8_t*)row + s) = v;
  };

  // the initial state, the target and the reversed query: every byte a
  // row reads, so no device-memory load sits on a row's chain
  for (int s = 4 * tid; s < nbytes; s += 4 * NT) {
    put(U, s, nqe4);
    put(Y, s, nqe4);
    put(X0, s, nqe4);
    put(X1, s, nqe4);
    put(V0, s, nqe4);
    put(V1, s, nqe4);
    put(Y2, s, nqe24);
    put(X20, s, nqe24);
    put(X21, s, nqe24);
    put(S, s, 0u);
    if (EXT)   // H[0] starts at -(q + e): row 0 is H[0] + v
      *(int4*)(H + s) = make_int4(s == 0 ? -(c.q + c.e) : kNegInf, kNegInf,
                                  kNegInf, kNegInf);
  }
  for (int t = tid; t < nbytes; t += NT) T[t] = t < tlen ? ts[t] : 0;
  const int qrb = query_bytes(qlen);
  for (int k = tid; k < qrb; k += NT) {
    const int m = k - kQPad;   // QR[kQPad + m] = qs[qlen - 1 - m]
    QR[k] = m >= 0 && m < qlen ? qs[qlen - 1 - m] : 0;
  }
  sync();

  int H0 = 0, lh = 0;
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
    int st0, en0;
    row_window(r, qlen, tlen, w, st0, en0);
    const int st = st0 & ~15, en = en0 | 15;
    const int bv = r == 0 ? nqe
                   : r < c.long_thres ? cc.bv_e
                   : r == c.long_thres ? cc.bv_long : cc.bv_e2;
    // the window's first lane reads x, v and x2 at st - 1 of the last row:
    // in the word below st where that row's window held st - 1, else the
    // boundary values (v's is bound_v(r) at st = 0)
    const bool held = st > 0 && st - 1 >= last_st && st - 1 <= last_en;
    const unsigned v1w = (unsigned)(uint8_t)(st > 0 ? nqe : bv) << 24;
    const bool reset = en >= r;
    int hi = st0 + 16 * ((en0 - st0) / 16 + 1);
    if (hi > nbytes) hi = nbytes;
    const int last = en > hi - 1 ? en : hi - 1;
    // lane t's query base qs[r - t] is QR[q_at + t]: a word's four are a
    // funnel shift by q_sh bits of the two aligned words at q_w0 + t0 - st
    const int q_at = kQPad + qlen - 1 - r;
    const int q_w0 = (q_at + st) & ~3, q_sh = 8 * ((q_at + st) & 3);
    // extension mode: the previous row's H[en0 - 1] (its owner's copy
    // when that row's window held the lane, which this row overwrites;
    // else in place), the next row's en0, and this thread's lanes of the
    // H row
    int hp = 0, nen0 = 0;
    if (EXT) {
      if (r > 0 && en0 > 0)
        hp = en0 - 1 >= prev_st0 && en0 - 1 <= prev_en0
                 ? (NT == 32 ? hp_next : xs->hp[par])
                 : H[en0 - 1];
      int nst0;
      row_window(r + 1, qlen, tlen, w, nst0, nen0);
    }
    ExtLanes x(st0, en0, nen0, hp);
    // lanes of the score store span [st0, hi) get their score from the
    // target and query bases, the others keep the row's old score: the
    // word's score lanes, stored back
    auto score = [&](int t0) {
      unsigned fresh = 0xffffffffu;
      if (t0 < st0 || t0 + 4 > hi) {   // a word at either end of the span
        const int lo_f = st0 - t0, hi_f = hi - t0;   // fresh bytes' range
        fresh = 0;
        for (int i = 0; i < 4; ++i)
          if (i >= lo_f && i < hi_f) fresh |= 0xffu << (8 * i);
      }
      const unsigned tb = word(T, t0);
      // query bases r - t0 - i, i < 4 (0 past r: the pad after the query)
      const int w0 = q_w0 + t0 - st;
      const unsigned qb = __funnelshift_r(word(QR, w0), word(QR, w0 + 4), q_sh);
      // each lane's index into sc_lo:sc_hi (bases are 0-3 and N = 4): 0 a
      // match, 1-3 a mismatch, 4-7 an N; as a prmt selector
      const unsigned ix = (tb ^ qb) | ((tb | qb) & 0x04040404u);
      const unsigned sel = __byte_perm(ix + (ix >> 4), 0, 0x20);
      const unsigned z =
          pick(fresh, word(S, t0), prmt_r(cc.sc_lo, cc.sc_hi, sel));
      put(S, t0, z);
      return z;
    };
    // four lanes t0 .. t0 + 3 of the row (t0 a multiple of 4, as st and
    // en + 1 are of 16) in one 32-bit word of each row, bytes in lane
    // order, and the score row's words past the window; a cell reads lane
    // t - 1 of the last row, so the x, v and x2 words are shifted up a
    // byte, the lane below from the word before (or the boundary values
    // at st)
    uint8_t* pw = pf + row_off + 4 * tid;   // this word's direction bytes
    int t0 = st + 4 * tid;
    for (; t0 <= en; t0 += 4 * NT, pw += 4 * NT) {
      const unsigned z = score(t0);
      const bool bnd = t0 == st && !held;   // the boundary values
      const unsigned xt1 = __byte_perm(bnd ? x1w : word(xp, t0 - 4),
                                       word(xp, t0), 0x6543);
      const unsigned vt1 = __byte_perm(bnd ? v1w : word(vp, t0 - 4),
                                       word(vp, t0), 0x6543);
      const unsigned x2t1 = __byte_perm(bnd ? x21w : word(x2p, t0 - 4),
                                        word(x2p, t0), 0x6543);
      unsigned ut = word(U, t0), yt = word(Y, t0), y2t = word(Y2, t0);
      if (reset && r >= t0 && r < t0 + 4) {   // lane r restarts
        const unsigned m = 0xffu << (8 * (r - t0));
        ut = pick(m, ut, bcast(bv));
        yt = pick(m, yt, nqe4);
        y2t = pick(m, y2t, nqe24);
      }
      const unsigned g = cc.tags;   // the tags of x, y, x2, y2 in bytes 0-3
      const CellOut e = cell2<RIGHT>(
          lanes_e<0>(z, cc.tag_s), lanes_e<0>(xt1, g), lanes_e<0>(vt1, 0),
          lanes_e<2>(x2t1, g), lanes_e<0>(ut, 0), lanes_e<1>(yt, g),
          lanes_e<3>(y2t, g), cc);
      const CellOut o = cell2<RIGHT>(
          lanes_o<0>(z, cc.tag_s), lanes_o<0>(xt1, g), lanes_o<0>(vt1, 0),
          lanes_o<2>(x2t1, g), lanes_o<0>(ut, 0), lanes_o<1>(yt, g),
          lanes_o<3>(y2t, g), cc);
      // the value bytes back in lane order
      auto bytes = [](unsigned a, unsigned b) {
        return __byte_perm(a, b, 0x7351);
      };
      const unsigned un = bytes(e.u, o.u), vn = bytes(e.v, o.v);
      put(U, t0, un);
      put(vc, t0, vn);
      put(xc, t0, bytes(e.x, o.x));
      put(Y, t0, bytes(e.y, o.y));
      put(x2c, t0, bytes(e.x2, o.x2));
      put(Y2, t0, bytes(e.y2, o.y2));
      // the d code from the max's tags, the d bits from the aux bytes'
      // bit 7 (set where a candidate's relu kept it: a >= 0 under RIGHT,
      // the zero lane otherwise, a <= 0)
      const unsigned tg = __byte_perm(e.z, o.z, 0x6240);
      const unsigned sa = prmt<0xeac8>(e.x, o.x), sb = prmt<0xeac8>(e.y, o.y);
      const unsigned sa2 = prmt<0xeac8>(e.x2, o.x2);
      const unsigned sb2 = prmt<0xeac8>(e.y2, o.y2);
      const unsigned d =
          RIGHT ? tg | (sa & 0x08080808u) | (sb & 0x10101010u) |
                      (sa2 & 0x20202020u) | (sb2 & 0x40404040u)
                : (~tg & 0x07070707u) | (~sa & 0x08080808u) |
                      (~sb & 0x10101010u) | (~sa2 & 0x20202020u) |
                      (~sb2 & 0x40404040u);
      if (p_words) {
        put(pw, 0, d);
      } else {   // a loop, so that the common case takes no predicated stores
#pragma unroll 1
        for (int i = 0; i < 4; ++i) pw[i] = (uint8_t)(d >> (8 * i));
      }
      if (EXT) {
        // the H row over [st0, en0] (ksw2kit.cpp:556-564) and this
        // thread's best lane of it (ksw2_row_max.cuh)
        if (t0 <= en0 && t0 + 3 >= st0) {
          int4 h4 = *(const int4*)(H + t0);
          x.word(h4, t0, un, vn);
          *(int4*)(H + t0) = h4;
        }
      }
    }
    for (; t0 <= last; t0 += 4 * NT) score(t0);   // past the window
    if (EXT) {
      // the row maximum, H[st0] and H[en0]: in a warp by __reduce_*_sync
      // and shuffles from the lanes' owners (words go to threads (word
      // index) mod NT), in a block through the owners' parity slots
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
                 c.e2)) {
        dropped = true;
        break;
      }
      prev_st0 = st0;
      prev_en0 = en0;
    } else {
      // the H0 walk reads v at lh and u at lh + 1 of this row: a warp
      // reads them after its barrier, and orders the reads before the
      // next row's writes with a second one; in a block the threads that
      // wrote their words (words go to threads (word index) mod NT) read
      // them back into a parity slot
      int vl, ul;
      if (NT == 32) {
        sync();
        vl = vc[lh];
        ul = U[lh + 1];
        sync();
      } else {
        if (tid == (((lh - st) >> 2) & (NT - 1))) slot[par] = vc[lh];
        if (tid == (((lh + 1 - st) >> 2) & (NT - 1))) slot[2 + par] = U[lh + 1];
        sync();
        vl = slot[par];
        ul = slot[2 + par];
      }
      // the approx-max H0 walk (ksw2.py:587-608): it steps to lane lh + 1
      // where lh left the window, or both lanes are in it and v > u does
      // not hold; row 0 starts it at lane 0 (lh starts at 0)
      if (r == 0) {
        H0 = vl - (c.q + c.e);
      } else {
        const bool in0 = lh >= st0 && lh <= en0;
        const bool in1 = lh + 1 >= st0 && lh + 1 <= en0;
        const bool step = !in0 || (in1 && ul >= vl);
        H0 += step ? ul : vl;
        lh += step;
      }
    }
    last_st = st;
    last_en = en;
    row_off += en - st + 1;
  }
  if (tid != 0) return;
  if (!EXT) {   // the score: H0 at the last row, where it ends at tlen - 1
    int st0, en0;
    row_window(n_rows - 1, qlen, tlen, w, st0, en0);
    a.score[f] = en0 == tlen - 1 ? H0 : kNegInf;
    return;
  }
  // ext_batch_device's epilogue (ksw2_tpu.py:1741-1762): the backtrack
  // start
  int reach_end = 0, i0 = -1, j0 = -1;
  if (!dropped && ez.mqe + a.end_bonus > ez.mx) {
    reach_end = 1;
    i0 = ez.mqe_t;
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
  o[9] = reach_end;
  o[10] = i0;
  o[11] = j0;
}

// work[0 .. n_block): the block-class fills, one to a block; then the
// warp-class fills, kFillWarps to a block (-1: none), each warp's state
// at warp * warp_stride of the block's shared memory smem (a warp-class
// fill's state is never in scratch)
template <bool RIGHT, bool EXT>
__device__ __forceinline__ void extd2_launch(const FillArgs& a,
                                             const int* __restrict__ work,
                                             int n_block, int warp_stride,
                                             const FillConsts& c,
                                             int8_t* smem, ExtSlots* xs) {
  if ((int)blockIdx.x < n_block) {
    const int f = work[blockIdx.x];
    if (a.scr_off[f] >= 0)
      extd2_one<kFillThreads, RIGHT, EXT>(a, f, threadIdx.x,
                                          a.scratch + a.scr_off[f], c, xs);
    else
      extd2_one<kFillThreads, RIGHT, EXT>(a, f, threadIdx.x, smem, c, xs);
    return;
  }
  const int w = threadIdx.x >> 5;
  const int f = work[n_block + (blockIdx.x - n_block) * kFillWarps + w];
  if (f < 0) return;
  extd2_one<32, RIGHT, EXT>(a, f, threadIdx.x & 31, smem + w * warp_stride,
                            c, xs);
}

template <bool RIGHT>
__global__ void __launch_bounds__(kFillThreads, kFillBlocksPerSm)
extd2_fill_kernel(FillArgs a, const int* __restrict__ work, int n_block,
                  int warp_stride, FillConsts c) {
  extern __shared__ __align__(16) int8_t smem[];
  extd2_launch<RIGHT, false>(a, work, n_block, warp_stride, c, smem,
                             nullptr);
}

// extension mode: the fill kernel's classes and body, with the H row
template <bool RIGHT>
__global__ void __launch_bounds__(kFillThreads, kExtBlocksPerSm)
extd2_ext_kernel(FillArgs a, const int* __restrict__ work, int n_block,
                 int warp_stride, FillConsts c) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ ExtSlots xs;
  extd2_launch<RIGHT, true>(a, work, n_block, warp_stride, c, smem, &xs);
}

// the backtrack's tile: the direction bytes of lanes [i0 - 31, i0] of
// rows r0 - k, k < kTileRows, which the next kTile steps from (i0, j0)
// (r0 = i0 + j0) can read: a step lowers the row by 1 or 2 and the lane
// by 0 or 1; and the offsets of rows r0 - k, k <= 2 kTile, in the fill's
// region
constexpr int kTile = 32;
constexpr int kTileRows = 2 * kTile - 1;
constexpr int kBtWarps = 4;   // fills (warps) of a backtrack block
// blocks an SM holds: a tile's loads go out 32 rows at a time, a
// register each, within 128 registers a thread: 16 walks an SM
constexpr int kBtBlocksPerSm = 4;

struct BtTile {
  long long off[2 * kTile + 1];
  uint8_t p[kTileRows][32];
};

__device__ __forceinline__ int warp_scan(int v, int lane) {  // inclusive
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(32 * kBtWarps, kBtBlocksPerSm)
ksw2_backtrack_kernel(
    const uint8_t* __restrict__ p, const long long* __restrict__ p_off,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const long long* __restrict__ cig_off,
    const uint8_t* __restrict__ rev_fill, const int* __restrict__ start,
    int start_stride, int n, int rev, int min_intron_len,
    unsigned* __restrict__ cig, int* __restrict__ n_cig) {
  __shared__ BtTile tiles[kBtWarps];
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kBtWarps + (threadIdx.x >> 5);
  if (f >= n) return;
  BtTile& T = tiles[threadIdx.x >> 5];
  if (rev_fill) rev = rev_fill[f];
  const int qlen = qlens[f], tlen = tlens[f];
  int w = ws[f];
  if (w < 0) w = qlen > tlen ? qlen : tlen;
  const uint8_t* pf = p + p_off[f];
  unsigned* out = cig + cig_off[f];
  int i = tlen - 1, j = qlen - 1;
  if (start) {
    i = start[(long long)f * start_stride];
    j = start[(long long)f * start_stride + 1];
    if (i < 0 || j < 0) {
      if (lane == 0) n_cig[f] = 0;
      return;
    }
  }
  // the start row's offset: the widths of the rows before it, summed by
  // the warp
  long long off = 0;
  for (int r = lane; r < i + j; r += 32) off += row_width(r, qlen, tlen, w);
  for (int o = 16; o > 0; o >>= 1) off += __shfl_xor_sync(0xffffffffu, off, o);
  // the walk's state, in lane 0
  int state = 0, nc = 0;
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
    const int r0 = i + j, i0 = i;
    // the offsets of rows r0 - 1 .. r0 - 2 kTile: the start minus the
    // widths between, by a warp scan; lane l holds rows r0 - l and
    // r0 - 32 - l in registers (the tile's loads take them by shuffle,
    // so no shared-memory access orders the loads)
    const int w1 = r0 - 1 - lane >= 0 ? row_width(r0 - 1 - lane, qlen, tlen, w)
                                       : 0;
    const int w2 = r0 - 33 - lane >= 0
                       ? row_width(r0 - 33 - lane, qlen, tlen, w)
                       : 0;
    const int s1 = warp_scan(w1, lane);
    const int s2 = warp_scan(w2, lane) + __shfl_sync(0xffffffffu, s1, 31);
    T.off[1 + lane] = off - s1;
    T.off[33 + lane] = off - s2;
    if (lane == 0) T.off[0] = off;
    long long base[2];   // the row's start minus its window's st
    int lo[2], hi[2];    // its window [st, en]; empty before row 0
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      int st0 = 0, en0 = -1;
      if (r0 - k >= 0) row_window(r0 - k, qlen, tlen, w, st0, en0);
      lo[h] = st0 & ~15;
      hi[h] = r0 - k >= 0 ? en0 | 15 : -1;
      base[h] = (h ? off - (s2 - w2) : off - (s1 - w1)) - lo[h];
    }
    // the tile, lane l holding lane i0 - 31 + l of each row.  Every lane
    // loads a byte of every row (an off-band one loads the fill's first
    // byte), so the loads take no branch and are in flight together.  An
    // off-band cell holds its forced state with bit 0x80 (i < st: I,
    // i > en: D), so a step reads one byte
    const int t = i0 - 31 + lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows r0 - 32 h - k: 32 in flight
      uint8_t b[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int st = __shfl_sync(0xffffffffu, lo[h], k);
        const int en = __shfl_sync(0xffffffffu, hi[h], k);
        const long long at = __shfl_sync(0xffffffffu, base[h], k);
        const bool in = t >= st && t <= en;
        const uint8_t v = __ldg(pf + (in ? at + t : 0));
        b[k] = in ? v : t < st ? 0x82 : 0x81;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (32 * h + k < kTileRows) T.p[32 * h + k][lane] = b[k];
    }
    __syncwarp();
    if (lane == 0) {
      // a step: the state stays while its continuation bit is set, else
      // it is the cell's own (a forced cell's, off the band); M steps i
      // and j, D (N from state 3 in intron mode) i, I j
      for (int s = 0; s < kTile && i >= 0 && j >= 0; ++s) {
        const unsigned tmp = T.p[r0 - (i + j)][i - i0 + 31];
        const bool keep = state != 0 && ((tmp >> (state + 2)) & 1);
        state = (tmp & 0x80) || !keep ? (int)(tmp & 7) : state;
        const bool di = state == 0 || state == 1 || state == 3;
        const bool dj = state == 0 || !di;
        const unsigned op = state == 0 ? 0u
                            : !di ? 1u
                            : state == 3 && min_intron_len > 0 ? 3u : 2u;
        if (op != run_op || run_len == 0) {
          if (run_len > 0) out[nc++] = run_len << 4 | run_op;
          run_op = op;
          run_len = 0;
        }
        ++run_len;
        i -= di;
        j -= dj;
      }
    }
    i = __shfl_sync(0xffffffffu, i, 0);
    j = __shfl_sync(0xffffffffu, j, 0);
    if (i >= 0 && j >= 0) off = T.off[r0 - (i + j)];
    __syncwarp();   // the tile is read before the next one is written
  }
  if (lane == 0) {
    if (i >= 0)
      push(min_intron_len > 0 && i >= min_intron_len ? 3 : 2, i + 1);
    if (j >= 0) push(1, j + 1);
    if (run_len > 0) out[nc++] = run_len << 4 | run_op;
    n_cig[f] = nc;
  }
  nc = __shfl_sync(0xffffffffu, nc, 0);
  __syncwarp();   // lane 0's words are written before the warp reverses
  if (!rev) {
    for (int a = lane; a < nc / 2; a += 32) {
      const unsigned tmp = out[a];
      out[a] = out[nc - 1 - a];
      out[nc - 1 - a] = tmp;
    }
  }
}

// the fill or the extension kernel over work (block-class fills first)
template <class K>
int launch_fills(K kernel, const FillArgs& a, const void* work, int n_block,
                 int n_warp, const FillConsts& c, int warp_stride,
                 int smem_bytes, void* stream) {
  if (n_block + n_warp <= 0) return 0;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = n_block + (n_warp + kFillWarps - 1) / kFillWarps;
  kernel<<<blocks, kFillThreads, smem_bytes, (cudaStream_t)stream>>>(
      a, (const int*)work, n_block, warp_stride, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Fills fill k (qlen[k] x tlen[k] bases at qoff[k] / toff[k] of the
// blobs, band w[k]) for k < n: direction bytes into p at p_off[k], the
// score into score[k].  work lists the fills: its first n_block entries
// are the block-class fills (a block of 256 threads each), then n_warp
// entries of the warp-class fills (a warp each, eight to a block; -1
// pads the last block).  scr_off[k] >= 0 puts a block-class fill's state
// at that offset of scratch instead of shared memory (a warp-class
// fill's must be -1); smem_bytes is the dynamic shared memory of a block
// (at least ksw2_gpu.fill_bytes of a block-class fill in shared memory,
// and 8 x warp_stride, itself at least fill_bytes of a warp-class fill).
// Returns the CUDA error of the launch (0 on success).
int mm2_extd2_fill(const void* qblob, const void* tblob, const void* qoff,
                   const void* toff, const void* qlen, const void* tlen,
                   const void* w, const void* p_off, const void* scr_off,
                   const void* work, int n_block, int n_warp, void* scratch,
                   void* p, void* score, int q, int e, int q2, int e2,
                   int mat0, int mat1, int sc_n, int long_thres,
                   int long_diff, int right, int warp_stride, int smem_bytes,
                   void* stream) {
  FillArgs a{(const uint8_t*)qblob, (const uint8_t*)tblob,
             (const long long*)qoff, (const long long*)toff,
             (const int*)qlen, (const int*)tlen, (const int*)w,
             (const long long*)p_off, (const long long*)scr_off,
             (int8_t*)scratch, (uint8_t*)p, (int*)score, nullptr, 0,
             nullptr};
  return launch_fills(right ? extd2_fill_kernel<true>
                            : extd2_fill_kernel<false>,
                      a, work, n_block, n_warp,
                      fill_consts(q, e, q2, e2, mat0, mat1, sc_n, long_thres,
                                  long_diff, right),
                      warp_stride, smem_bytes, stream);
}

// Extension mode (KSW_EZ_EXTZ_ONLY) of the fills: operands and classes as
// mm2_extd2_fill's (the state of ksw2_gpu.ext_bytes: fill_bytes and the
// int32 H row), with Z-drop zdrop[k] (< 0: none) and the launch's end
// bonus; fill k's [score, max, max_t, max_q, mqe, mqe_t, mte, mte_q,
// zdropped, reach_end, i0, j0] into ext[12k ...], (i0, j0) the backtrack
// start (-1: none).
int mm2_extd2_ext(const void* qblob, const void* tblob, const void* qoff,
                  const void* toff, const void* qlen, const void* tlen,
                  const void* w, const void* zdrop, const void* p_off,
                  const void* scr_off, const void* work, int n_block,
                  int n_warp, void* scratch, void* p, void* ext, int q,
                  int e, int q2, int e2, int mat0, int mat1, int sc_n,
                  int long_thres, int long_diff, int right, int end_bonus,
                  int warp_stride, int smem_bytes, void* stream) {
  FillArgs a{(const uint8_t*)qblob, (const uint8_t*)tblob,
             (const long long*)qoff, (const long long*)toff,
             (const int*)qlen, (const int*)tlen, (const int*)w,
             (const long long*)p_off, (const long long*)scr_off,
             (int8_t*)scratch, (uint8_t*)p, nullptr, (const int*)zdrop,
             end_bonus, (int*)ext};
  return launch_fills(right ? extd2_ext_kernel<true> : extd2_ext_kernel<false>,
                      a, work, n_block, n_warp,
                      fill_consts(q, e, q2, e2, mat0, mat1, sc_n, long_thres,
                                  long_diff, right),
                      warp_stride, smem_bytes, stream);
}

// Backtracks the n fills of mm2_extd2_fill (or mm2_exts2_fill, with
// w = qlen + tlen, or mm2_extd2_ext) from (tlen-1, qlen-1), or from
// (start[k * start_stride], start[k * start_stride + 1]) when start is
// not null (a start of -1 writes no word): CIGAR words into cig at
// cig_off[k] (room for qlen[k] + tlen[k]), their count into n_cig[k].
// KSW_EZ_REV_CIGAR order is rev_fill[k] when rev_fill is not null, else
// rev; min_intron_len > 0 is the splice fills' intron mode.  Returns the
// CUDA error of the launch.
int mm2_ksw2_backtrack(const void* p, const void* p_off, const void* qlen,
                       const void* tlen, const void* w, const void* cig_off,
                       const void* rev_fill, const void* start,
                       int start_stride, int n, int rev, int min_intron_len,
                       void* cig, void* n_cig, void* stream) {
  if (n <= 0) return 0;
  ksw2_backtrack_kernel<<<(n + kBtWarps - 1) / kBtWarps, 32 * kBtWarps, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)p, (const long long*)p_off, (const int*)qlen,
      (const int*)tlen, (const int*)w, (const long long*)cig_off,
      (const uint8_t*)rev_fill, (const int*)start, start_stride, n, rev,
      min_intron_len, (unsigned*)cig, (int*)n_cig);
  return (int)cudaGetLastError();
}

}  // extern "C"
