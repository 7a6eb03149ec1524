"""The reference's own minimizer index of a genome, in NumPy.

The frozen MinimizerIndex.build sketches base by base in Python, which
takes minutes for a genome of tens of Mbp.  `build` makes the same
table in a few array passes: the index keeps, sorted by (hash,
position), every k-mer whose hash is the least of some window of w
consecutive k-mers, ties included, which is the set minimap2's mm_sketch
emits (sketch.c:77-142) for sequences of A, C, G and T and odd k.  The
tests hold it to the frozen sketch_py base by base.
"""

from __future__ import annotations

import numpy as np

from bench_port.reference.mm import opts as O
from bench_port.reference.mm.index import MinimizerIndex
from bench_port.reference.mm.sketch import _NT4

_U = np.uint64


def _mix_hash(key: np.ndarray, mask: int) -> np.ndarray:
    """sketch._mix_hash over an array (hash64, sketch.c:28-38)."""
    m = _U(mask)
    key = (~key + (key << _U(21))) & m
    key = key ^ (key >> _U(24))
    key = (key + (key << _U(3)) + (key << _U(8))) & m
    key = key ^ (key >> _U(14))
    key = (key + (key << _U(2)) + (key << _U(4))) & m
    key = key ^ (key >> _U(28))
    return (key + (key << _U(31))) & m


def _sliding(a: np.ndarray, w: int, op) -> np.ndarray:
    """op (np.minimum or np.maximum) over each run of w consecutive
    elements of a: len(a) - w + 1 values."""
    out = a[:a.shape[0] - w + 1].copy()
    for d in range(1, w):
        op(out, a[d:d + out.shape[0]], out=out)
    return out


def sketch_set(codes: np.ndarray, w: int, k: int, rid: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """(hashes, positions) of the minimizers of one sequence of base
    codes (0-3), positions packed as rid << 32 | end << 1 | strand."""
    if k % 2 == 0 or not 0 < k <= 28 or not 0 < w < 256:
        raise ValueError("the reference index takes odd k <= 28, w < 256")
    if codes.max(initial=0) > 3:
        raise ValueError("the reference index takes A, C, G and T only")
    m = codes.shape[0] - k + 1
    if m < w:
        raise ValueError("a sequence shorter than one window")
    c = codes.astype(np.uint64)
    fwd = np.zeros(m, np.uint64)
    rev = np.zeros(m, np.uint64)
    for d in range(k):
        fwd = (fwd << _U(2)) | c[d:d + m]
        rev |= (_U(3) - c[d:d + m]) << _U(2 * d)
    strand = (fwd > rev).astype(np.uint64)
    h = _mix_hash(np.minimum(fwd, rev), (1 << (2 * k)) - 1)
    del fwd, rev
    win = _sliding(h, w, np.minimum)
    pad = np.zeros(w - 1, np.uint64)
    best = _sliding(np.concatenate([pad, win, pad]), w, np.maximum)
    keep = np.nonzero(h == best)[0]
    pos = ((_U(rid) << _U(32)) | ((keep + k - 1).astype(np.uint64) << _U(1))
           | strand[keep])
    return h[keep], pos


def build(chroms: list[tuple[str, str]], io: O.IndexOptions) -> MinimizerIndex:
    """The frozen MinimizerIndex of `chroms` [(name, sequence)], its
    minimizers from sketch_set."""
    if io.flag & O.MM_I_HPC:
        raise ValueError("the reference index has no HPC sketch")
    names = [n for n, _ in chroms]
    lens = np.array([len(s) for _, s in chroms], np.uint32)
    offsets = np.concatenate([[0], np.cumsum(lens[:-1], dtype=np.uint64)]
                             ).astype(np.uint64)
    seq_codes = _NT4[np.frombuffer("".join(s for _, s in chroms).encode(),
                                   np.uint8)]
    hs, ps = [], []
    for rid, (_, s) in enumerate(chroms):
        off = int(offsets[rid])
        h, p = sketch_set(seq_codes[off:off + len(s)], io.w, io.k, rid)
        hs.append(h)
        ps.append(p)
    h = np.concatenate(hs)
    p = np.concatenate(ps)
    order = np.lexsort((p, h))
    return MinimizerIndex(io.k, io.w, io.flag, names, lens, offsets,
                          seq_codes, np.ascontiguousarray(h[order]),
                          np.ascontiguousarray(p[order]))
