# Frozen copy of mm2_gb_tpu_torch/utils/ksort.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Exact emulation of the reference's sorting primitives.

Several of the mapper's sorts use an in-place MSD radix sort keyed on a
64-bit field only (ksort.h KRADIX_SORT_INIT; instantiations misc.c:167-171).
That sort is NOT stable, so the relative order of tie records after sorting
depends on the exact bucket-cycle permutation the algorithm performs.  Output
byte-compatibility (chain tie-breaking in mg_chain_backtrack's z[] sort, and
anchor order in collect_seed_hits) therefore requires reproducing the exact
permutation, not just "a sort by key".

`radix_perm64` returns the permutation that the reference's radix_sort would
apply to an array of records with the given 64-bit keys.  The implementation
is our own, but follows the same specification: 8-bit MSD digits, in-place
bucket cycling, recursion for buckets > 64 records, binary-insertion-free
insertion sort below that, and insertion sort outright for inputs <= 64.

A C++ implementation (csrc/hostkit.cpp) provides the fast path; this module
is the always-available fallback and the test oracle for the C++ one.
"""

from __future__ import annotations

import numpy as np

RS_MIN_SIZE = 64


def _insertion(keys: np.ndarray, perm: np.ndarray, lo: int, hi: int) -> None:
    """Stable insertion sort of perm[lo:hi] by keys[perm] (ksort.h rs_insertsort)."""
    for i in range(lo + 1, hi):
        ki = keys[perm[i]]
        if ki < keys[perm[i - 1]]:
            pi = perm[i]
            j = i
            while j > lo and ki < keys[perm[j - 1]]:
                perm[j] = perm[j - 1]
                j -= 1
            perm[j] = pi


def _rs_sort(keys: np.ndarray, perm: np.ndarray, lo: int, hi: int, shift: int) -> None:
    """One MSD pass over perm[lo:hi] on digit (key >> shift) & 0xff, then recurse."""
    # counting pass
    digits = (keys[perm[lo:hi]] >> np.uint64(shift)) & np.uint64(0xFF)
    counts = np.bincount(digits.astype(np.int64), minlength=256)
    ends = lo + np.cumsum(counts)            # exclusive end of each bucket
    starts = ends - counts                    # start of each bucket
    cur = starts.copy()                       # fill cursor per bucket
    # in-place bucket cycling, identical order of moves to the reference
    k = 0
    while k < 256:
        if cur[k] != ends[k]:
            tgt = int((keys[perm[cur[k]]] >> np.uint64(shift)) & np.uint64(0xFF))
            if tgt != k:
                tmp = perm[cur[k]]
                while True:
                    swap = tmp
                    tmp = perm[cur[tgt]]
                    perm[cur[tgt]] = swap
                    cur[tgt] += 1
                    tgt = int((keys[tmp] >> np.uint64(shift)) & np.uint64(0xFF))
                    if tgt == k:
                        break
                perm[cur[k]] = tmp
                cur[k] += 1
            else:
                cur[k] += 1
        else:
            k += 1
    if shift:
        nxt = shift - 8 if shift > 8 else 0
        for k in range(256):
            n = int(counts[k])
            if n > RS_MIN_SIZE:
                _rs_sort(keys, perm, int(starts[k]), int(ends[k]), nxt)
            elif n > 1:
                _insertion(keys, perm, int(starts[k]), int(ends[k]))


def radix_perm64(keys: np.ndarray) -> np.ndarray:
    """Permutation applied by the reference's radix_sort_128x / radix_sort_64.

    `keys` is the uint64 sort key of each record (for radix_sort_128x this is
    the .x field; the .y payload just rides along).  Returns an int64 index
    array `perm` such that record order after sorting is records[perm].
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    perm = np.arange(n, dtype=np.int64)
    if n <= RS_MIN_SIZE:
        _insertion(keys, perm, 0, n)
    else:
        _rs_sort(keys, perm, 0, n, 56)
    return perm


def ksmall_u32(arr: np.ndarray, kk: int) -> int:
    """kk-th (0-based) order statistic of a uint32 array (ksort.h ks_ksmall).

    Quickselect's result is algorithm-independent, so plain sorting matches.
    """
    return int(np.partition(np.asarray(arr, dtype=np.uint32), kk)[kk])


def heap_topk_select(values: np.ndarray, k: int) -> np.ndarray:
    """Indices (into values) selected by the reference's bounded max-heap
    top-k-smallest pass in mm_seed_select (seed.c:75-84).

    Keeps the k entries with smallest (value, position) packed as
    value<<32|position in a size-k max-heap; iteration replaces the root
    whenever a strictly smaller *value* arrives.  Returns the selected
    positions in heap order is irrelevant — callers only flag membership —
    so we return the set of selected positions as an int64 array.
    """
    n = len(values)
    k = min(k, n)
    heap = [(int(values[j]) << 32) | j for j in range(k)]
    # ks_heapmake / ks_heapdown semantics (max-heap on uint64 <)
    def heapdown(i: int, size: int) -> None:
        tmp = heap[i]
        kk_ = i
        while True:
            kk_ = (kk_ << 1) + 1
            if kk_ >= size:
                break
            if kk_ != size - 1 and heap[kk_] < heap[kk_ + 1]:
                kk_ += 1
            if heap[kk_] < tmp:
                break
            heap[i] = heap[kk_]
            i = kk_
        heap[i] = tmp

    for i in range((k >> 1) - 1, -1, -1):
        heapdown(i, k)
    for j in range(k, n):
        if int(values[j]) < (heap[0] >> 32):
            heap[0] = (int(values[j]) << 32) | j
            heapdown(0, k)
    return np.array([h & 0xFFFFFFFF for h in heap], dtype=np.int64)

