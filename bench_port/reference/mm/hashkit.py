# Frozen copy of mm2_gb_tpu_torch/utils/hashkit.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Integer hash functions used throughout the mapper.

These reproduce, bit for bit, the hash functions of the reference
implementation (cited per-function), because anchor identity, chain
tie-breaking and output ordering all depend on them.

All functions are vectorized over NumPy uint64/uint32 arrays.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_U32 = np.uint32


def hash64(key: np.ndarray, mask: int) -> np.ndarray:
    """Invertible 64-bit mix hash restricted to `mask` bits.

    Semantics of sketch.c:28-38 (minimap2's strand-canonical k-mer hash).
    `key` is uint64 array; returns uint64 array.
    """
    key = np.asarray(key, dtype=_U64)
    m = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & m
        key = key ^ (key >> _U64(24))
        key = ((key + (key << _U64(3))) + (key << _U64(8))) & m
        key = key ^ (key >> _U64(14))
        key = ((key + (key << _U64(2))) + (key << _U64(4))) & m
        key = key ^ (key >> _U64(28))
        key = (key + (key << _U64(31))) & m
    return key


def hash64_full(key: np.ndarray) -> np.ndarray:
    """Same mix without masking (hit.c:40-50), used for chain-order hashing."""
    key = np.asarray(key, dtype=_U64)
    with np.errstate(over="ignore"):
        key = ~key + (key << _U64(21))
        key = key ^ (key >> _U64(24))
        key = (key + (key << _U64(3))) + (key << _U64(8))
        key = key ^ (key >> _U64(14))
        key = (key + (key << _U64(2))) + (key << _U64(4))
        key = key ^ (key >> _U64(28))
        key = key + (key << _U64(31))
    return key


def x31_hash_string(s: str | bytes) -> int:
    """X31 string hash (khash.h:383-388); uint32 semantics."""
    if isinstance(s, str):
        s = s.encode()
    h = 0
    if s:
        h = s[0]
        if h:
            for c in s[1:]:
                h = ((h << 5) - h + c) & 0xFFFFFFFF
    return h


def wang_hash32(key: int) -> int:
    """Wang 32-bit integer hash (khash.h:400-409)."""
    key = key & 0xFFFFFFFF
    key = (key + (~(key << 15) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key = key ^ (key >> 10)
    key = (key + (key << 3)) & 0xFFFFFFFF
    key = key ^ (key >> 6)
    key = (key + (~(key << 11) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key = key ^ (key >> 16)
    return key


def read_order_hash(qname: str | None, qlen_sum: int, seed: int,
                    no_hash_name: bool = False) -> int:
    """The per-read hash that randomizes equal-scoring chain order.

    Reproduces map.c:659-661:
        hash  = qname? X31(qname) : 0
        hash ^= Wang(qlen_sum) + Wang(seed)
        hash  = Wang(hash)
    """
    h = 0 if (qname is None or no_hash_name) else x31_hash_string(qname)
    h = (h ^ ((wang_hash32(qlen_sum) + wang_hash32(seed)) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return wang_hash32(h)


def mg_log2(x: np.ndarray) -> np.ndarray:
    """Fast approximate float32 log2 (mmpriv.h:118-126). Bit-exact.

    Valid for x >= 2 (as in the reference); vectorized float32 in/out.
    """
    x = np.asarray(x, dtype=np.float32)
    zi = x.view(_U32) if x.ndim else np.float32(x).reshape(1).view(_U32)
    log2i = ((zi >> _U32(23)) & _U32(255)).astype(np.int32) - 128
    zi = zi & _U32(~np.uint32(255 << 23) & 0xFFFFFFFF)
    zi = zi + _U32(127 << 23)
    zf = zi.view(np.float32)
    # evaluation order matters for float32 bit-exactness:
    # ((-0.34484843f*z + 2.02466578f)*z - 0.67487759f) + log_2
    c1 = np.float32(-0.34484843)
    c2 = np.float32(2.02466578)
    c3 = np.float32(-0.67487759)
    r = (c1 * zf + c2).astype(np.float32)
    r = (r * zf).astype(np.float32)
    r = (r + c3).astype(np.float32)
    out = (log2i.astype(np.float32) + r).astype(np.float32)
    return out if x.ndim else out[0]
