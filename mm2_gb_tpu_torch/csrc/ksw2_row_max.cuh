// The ranked row maximum of the ksw2 extension kernels (extd2_kernel.cu
// and exts2_kernel.cu in extension mode).
//
// row_max (csrc/ksw2kit.cpp:94-110, ksw2.py::_row_max) ranks the lanes of
// a row window [st0, en0]: en0 first, then the 4-lane blocks by
// ((t-st0)%4, (t-st0)/4), then the tail lanes by position; a later lane
// wins only with a strictly larger H.  Each thread packs (H, inverted
// rank) into one 64-bit key, so the largest key over the row is the
// winner.  The rank is a function of the absolute lane t, never of where
// the lane's state is stored.

#pragma once

// the row-maximum key of lane t of [st0, en0]: H in the high word, the
// lane's rank under row_max's tie rules inverted in the low word
__device__ __forceinline__ long long row_key(int h, int t, int st0,
                                             int en0) {
  int rank = 0;
  if (t != en0) {
    const int nb = (en0 - st0) / 4, d = t - st0;
    rank = d < 4 * nb ? 1 + (d % 4) * nb + d / 4 : 1 + d;
  }
  return (long long)h * 4294967296LL + (long long)(0x7fffffff - rank);
}

// lane of the rank a row_key holds
__device__ __forceinline__ int key_lane(long long key, int st0, int en0) {
  const int rank = 0x7fffffff - (int)(key & 0xffffffffLL);
  if (rank == 0) return en0;
  const int nb = (en0 - st0) / 4;
  if (rank <= 4 * nb) {
    const int k = rank - 1;
    return st0 + 4 * (k % nb) + k / nb;
  }
  return st0 + rank - 1;
}
