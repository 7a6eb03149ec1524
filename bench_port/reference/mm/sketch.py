# Frozen copy of mm2_gb_tpu_torch/ops/sketch.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""(w,k)-minimizer sketching.

Computes the symmetric minimizer sketch of a DNA sequence with the exact
output semantics of the reference (sketch.c:77-143), including:

- strand-canonical k-mers hashed with the invertible 64-bit mix hash
  (sketch.c:28-38), symmetric k-mers skipped;
- homopolymer compression (HPC) with kmer_span accounting;
- the precise emission rules for window minima and ties (duplicate minima
  are emitted in sorted order; the first window is special-cased), which
  downstream chain tie-breaking depends on.

Output encoding per minimizer (one (x, y) uint64 pair):
    x = hash(kmer) << 8 | kmer_span
    y = rid << 32 | last_base_pos << 1 | strand

The Python implementation below is the semantic oracle.  A C++ fast path
(csrc/hostkit.cpp, loaded via ctypes) is used automatically when built; it
is cross-checked against this oracle in tests/test_sketch.py.
"""

from __future__ import annotations

import numpy as np

from . import native

# base encoding: A=0 C=1 G=2 T/U=3, anything else = 4 (ambiguous)
_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _NT4[ord(_c)] = _i
    _NT4[ord(_c.lower())] = _i
_NT4[ord("U")] = 3
_NT4[ord("u")] = 3

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix_hash(key: int, mask: int) -> int:
    """Invertible 64-bit mix hash (sketch.c:28-38), scalar int version."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def sketch_py(seq: str | bytes, w: int, k: int, rid: int, is_hpc: bool) -> np.ndarray:
    """Sketch one sequence; returns an (n, 2) uint64 array of (x, y) pairs."""
    if isinstance(seq, str):
        seq = seq.encode()
    codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes)
    assert n > 0 and 0 < w < 256 and 0 < k <= 28
    mask = (1 << (2 * k)) - 1
    shift1 = 2 * (k - 1)
    out_x: list[int] = []
    out_y: list[int] = []

    INF = (1 << 64) - 1
    # ring buffer of the last w candidate k-mers as (x, y) pairs
    buf = [(INF, INF)] * w
    min_x, min_y = INF, INF
    min_pos = 0
    buf_pos = 0
    fwd = rev = 0          # rolling forward/reverse k-mer codes
    l = 0                  # bases since last ambiguity
    kmer_span = 0
    hpc_q: list[int] = []  # run lengths of the last k HPC-compressed symbols
    rid_hi = rid << 32

    i = 0
    while i < n:
        c = int(codes[i])
        info = (INF, INF)
        if c < 4:
            if is_hpc:
                run = 1
                if i + 1 < n and int(codes[i + 1]) == c:
                    run = 2
                    while i + run < n and int(codes[i + run]) == c:
                        run += 1
                    i += run - 1  # land on the last base of the run
                hpc_q.append(run)
                kmer_span += run
                if len(hpc_q) > k:
                    kmer_span -= hpc_q.pop(0)
            else:
                kmer_span = l + 1 if l + 1 < k else k
            fwd = ((fwd << 2) | c) & mask
            rev = (rev >> 2) | ((3 ^ c) << shift1)
            if fwd == rev:
                # symmetric k-mer: strand is ambiguous; skip this position
                # entirely (no buffer write, no window advance) — sketch.c:104
                i += 1
                continue
            strand = 0 if fwd < rev else 1
            l += 1
            if l >= k and kmer_span < 256:
                info = (
                    (_mix_hash(fwd if strand == 0 else rev, mask) << 8) | kmer_span,
                    rid_hi | ((i & 0xFFFFFFFF) << 1) | strand,
                )
        else:
            l = 0
            hpc_q.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and min_x != INF:
            # first full window: emit duplicates of the minimum (older first)
            for j in range(buf_pos + 1, w):
                if min_x == buf[j][0] and buf[j][1] != min_y:
                    out_x.append(buf[j][0]); out_y.append(buf[j][1])
            for j in range(buf_pos):
                if min_x == buf[j][0] and buf[j][1] != min_y:
                    out_x.append(buf[j][0]); out_y.append(buf[j][1])
        if info[0] <= min_x:
            if l >= w + k and min_x != INF:
                out_x.append(min_x); out_y.append(min_y)
            min_x, min_y = info
            min_pos = buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and min_x != INF:
                out_x.append(min_x); out_y.append(min_y)
            min_x = INF
            for j in range(buf_pos + 1, w):
                if min_x >= buf[j][0]:
                    min_x, min_y = buf[j]
                    min_pos = j
            for j in range(buf_pos + 1):
                if min_x >= buf[j][0]:
                    min_x, min_y = buf[j]
                    min_pos = j
            if l >= w + k - 1 and min_x != INF:
                for j in range(buf_pos + 1, w):
                    if min_x == buf[j][0] and min_y != buf[j][1]:
                        out_x.append(buf[j][0]); out_y.append(buf[j][1])
                for j in range(buf_pos + 1):
                    if min_x == buf[j][0] and min_y != buf[j][1]:
                        out_x.append(buf[j][0]); out_y.append(buf[j][1])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
        i += 1
    if min_x != INF:
        out_x.append(min_x); out_y.append(min_y)
    out = np.empty((len(out_x), 2), dtype=np.uint64)
    out[:, 0] = out_x
    out[:, 1] = out_y
    return out


def sketch(seq: str | bytes, w: int, k: int, rid: int, is_hpc: bool) -> np.ndarray:
    """Sketch one sequence using the fastest available backend."""
    if native.available():
        if isinstance(seq, str):
            seq = seq.encode()
        return native.sketch(seq, w, k, rid, is_hpc)
    return sketch_py(seq, w, k, rid, is_hpc)
