// The H row, the ranked row maximum and the Extz fields of the ksw2
// extension kernels (extd2_kernel.cu and exts2_kernel.cu in extension
// mode).
//
// row_max (csrc/ksw2kit.cpp:94-110, ksw2.py::_row_max) ranks the lanes of
// a row window [st0, en0]: en0 first, then the 4-lane blocks by
// ((t-st0)%4, (t-st0)/4), then the tail lanes by position; a later lane
// wins only with a strictly larger H.  So the row maximum is the largest
// H, and at it the lane of the smallest rank.  The rank is a function of
// the absolute lane t, never of where the lane's state is stored, and no
// two lanes of a row share one.  A thread keeps its best (H, rank, lane)
// over the lanes it owns, and a warp reduces them with three
// __reduce_*_sync (the largest H, the smallest rank at it, the lane of
// that rank), with no division and no shared memory.

#pragma once

// the rank of lane t of [st0, en0] under row_max's tie rules, nb =
// (en0 - st0) / 4 (the 4-lane blocks)
__device__ __forceinline__ int lane_rank(int t, int st0, int en0, int nb) {
  const int d = t - st0;
  return t == en0 ? 0 : d < 4 * nb ? 1 + (d & 3) * nb + (d >> 2) : 1 + d;
}

// byte i of w, as a signed int
__device__ __forceinline__ int byte_at(unsigned w, int i) {
  return (int)(int8_t)(w >> (8 * i));
}

// one thread's part of an extension row: the H row over the lanes of
// [st0, en0] it owns (H[t] += v; H[en0] = the previous row's H[en0 - 1]
// + u when en0 > 0: the kernels start H[0] at -(q + e), so row 0 takes
// the H[t] + v case), its best (H, rank, lane), and its copies of H[st0],
// H[en0] and H[nen0 - 1] (nen0: the next row's en0), for the owners of
// those lanes
struct ExtLanes {
  int st0, en0, nen0, nb, hp;   // the row, and its H[en0 - 1] in
  int bh, br, bt;               // the best lane so far
  int hst0, hen0, hnext;

  __device__ __forceinline__ ExtLanes(int st0_, int en0_, int nen0_,
                                      int hp_)
      : st0(st0_), en0(en0_), nen0(nen0_), nb((en0_ - st0_) >> 2),
        hp(hp_), bh(INT_MIN), br(INT_MAX), bt(0), hst0(0), hen0(0),
        hnext(0) {}

  // the four lanes t0 .. t0 + 3 of a word (h4: their H in place; un, vn:
  // their u and v bytes): each lane's H, then the word's largest H and
  // the smallest rank at it, as a tree over the lanes and not a chain,
  // merged into the thread's best
  __device__ __forceinline__ void word(int4& h4, int t0, unsigned un,
                                      unsigned vn) {
    int h[4] = {h4.x, h4.y, h4.z, h4.w};
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      in[i] = t >= st0 && t <= en0;
      const int hn = t == en0 && en0 > 0 ? hp + byte_at(un, i)
                                         : h[i] + byte_at(vn, i);
      h[i] = in[i] ? hn : h[i];
    }
    int c[4], rk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = in[i] ? h[i] : INT_MIN;
      rk[i] = lane_rank(t0 + i, st0, en0, nb) << 2 | i;
    }
    const int wh = max(max(c[0], c[1]), max(c[2], c[3]));
    // (rank << 2 | i) of the lanes at wh: the smallest is the winner
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = c[i] == wh ? rk[i] : INT_MAX;
    const int wr = min(min(c[0], c[1]), min(c[2], c[3]));
    const bool better = wh > bh || (wh == bh && (wr >> 2) < br);
    bh = better ? wh : bh;
    br = better ? wr >> 2 : br;
    bt = better ? t0 + (wr & 3) : bt;
    // the word's lane k (0..3; any other k leaves v as it is)
    auto take = [&](int k, int v) {
      v = k == 0 ? h[0] : v;
      v = k == 1 ? h[1] : v;
      v = k == 2 ? h[2] : v;
      return k == 3 ? h[3] : v;
    };
    hst0 = take(st0 - t0, hst0);
    hen0 = take(en0 - t0, hen0);
    hnext = take(nen0 - 1 - t0, hnext);
    h4 = make_int4(h[0], h[1], h[2], h[3]);
  }
};

// the row maximum of a warp's lanes: H m at the lane mt of rank rank, in
// every lane
__device__ __forceinline__ void warp_row_max(const ExtLanes& x, int& m,
                                             int& rank, int& mt) {
  m = __reduce_max_sync(0xffffffffu, x.bh);
  rank = __reduce_min_sync(0xffffffffu, x.bh == m ? x.br : INT_MAX);
  mt = __reduce_max_sync(0xffffffffu, x.bh == m && x.br == rank ? x.bt : -1);
}

// the Extz fields of one extension (ksw2kit.cpp Ez), the same in every
// thread of its warp or block
struct ExtTrack {
  int mx, max_t, max_q, mqe, mqe_t, mte, mte_q, score;

  __device__ __forceinline__ ExtTrack()
      : mx(0), max_t(-1), max_q(-1), mqe(-0x40000000), mqe_t(-1),
        mte(-0x40000000), mte_q(-1), score(-0x40000000) {}

  // row r's maximum max_h at lane mt, H[st0] and H[en0]: mte, mqe, the
  // score at the last row, and apply_zdrop (ksw2kit.cpp:37-50, 560-568)
  // with gap extension e2; true on a Z-drop (zdrop < 0: none)
  __device__ __forceinline__ bool row(int max_h, int mt, int h_st0,
                                      int h_en0, int r, int st0, int en0,
                                      int en, int qlen, int tlen, int zdrop,
                                      int e2) {
    if (en0 == tlen - 1 && h_en0 > mte) {
      mte = h_en0;
      mte_q = r - en;
    }
    if (r - st0 == qlen - 1 && h_st0 > mqe) {
      mqe = h_st0;
      mqe_t = st0;
    }
    if (max_h > mx) {
      mx = max_h;
      max_t = mt;
      max_q = r - mt;
    } else if (mt >= max_t && r - mt >= max_q) {
      const int tl = mt - max_t, ql = r - mt - max_q;
      const int l = tl > ql ? tl - ql : ql - tl;
      if (zdrop >= 0 && mx - max_h > zdrop + l * e2) return true;
    }
    if (r == qlen + tlen - 2 && en0 == tlen - 1) score = h_en0;
    return false;
  }
};

// an extension's block-class row state, by row parity: H[en0 - 1] for
// the next row, H[st0] and H[en0] of this row, and each warp's row
// maximum (H and inverted rank in one key) and its lane
struct ExtSlots {
  int hp[2], hst0[2], hen0[2];
  long long key[2][8];
  int lane[2][8];
};

// the row maximum of a block of nw warps: each warp's from warp_row_max
// into the slots before the block's barrier; after it block_row_max
// picks the largest key
__device__ __forceinline__ void put_warp_max(ExtSlots* xs, int par, int w,
                                             int m, int rank, int mt) {
  xs->key[par][w] = (long long)m * 4294967296LL + (0x7fffffff - rank);
  xs->lane[par][w] = mt;
}

__device__ __forceinline__ void block_row_max(const ExtSlots* xs, int par,
                                              int nw, int& m, int& mt) {
  int k = 0;
  for (int i = 1; i < nw; ++i)
    k = xs->key[par][i] > xs->key[par][k] ? i : k;
  m = (int)(xs->key[par][k] >> 32);
  mt = xs->lane[par][k];
}
