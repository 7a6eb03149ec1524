"""Loader for the optional C++ host-kit (csrc/host/*.cpp → libhostkit).

The host-kit provides fast native implementations of the sequential host
components (minimizer sketch, radix permutation, chain backtracking) used
outside the TPU compute path.  Everything here has a pure-NumPy/Python
fallback, so the package works without the native library; tests cross-check
the two.

This package builds its own copy of the kit, from its own sources, into
<repo>/build/hostkit/libhostkit-<hash of the sources>.so, so it never
shares a loaded library (and the C++ fill session's state) with another
package in the same process.  MM2TPU_NATIVE_LIB names another library to
load instead, as for the JAX package's loader: a sanitizer build,
`python -c "from mm2_gb_tpu_torch.utils import native;
print(native.build_sanitized('ubsan'))"` (or 'asan'; the targets of the
JAX package's csrc/Makefile).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hostkit")
_SOURCES = ("hostkit.cpp", "ksw2kit.cpp", "rmqkit.cpp", "alignkit.cpp")
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
# the sanitizer builds' extra flags (csrc/Makefile's asan and ubsan)
SANITIZERS = {
    "asan": ["-g", "-fsanitize=address", "-fno-omit-frame-pointer"],
    "ubsan": ["-g", "-fsanitize=undefined", "-fno-sanitize-recover=all"],
}


def _build_path(sanitizer: str = "") -> str:
    """Where the kit is built: its name holds a hash of the sources, so an
    edited source never loads a stale build (and a sanitizer's name for a
    sanitizer build)."""
    import hashlib
    h = hashlib.sha1()
    for name in _SOURCES + ("krmq_avl.h",):
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    tag = f"{sanitizer}-" if sanitizer else ""
    return os.path.join(BUILD_DIR, f"libhostkit-{tag}{h.hexdigest()[:12]}.so")


def _lib_path() -> str:
    """The library to load: MM2TPU_NATIVE_LIB when it is set, else the
    build's."""
    return os.environ.get("MM2TPU_NATIVE_LIB") or _build_path()


def _warn(why: str) -> None:
    """Say on stderr that the kit is missing, and what runs instead."""
    import sys
    sys.stderr.write(f"[WARNING] mm2_gb_tpu_torch host kit: {why}; the "
                     "NumPy host layer runs instead (much slower; "
                     "--gpu-align -c runs take the Python fill session)\n")


def _build(path: str, flags=()) -> None:
    """g++ the kit into `path` when it is missing, with the extra flags:
    under a file lock (test workers build at once), into a temporary
    name, then renamed.  A failure is reported on stderr, with g++'s own
    messages."""
    import fcntl
    import shutil
    import subprocess
    import tempfile
    if not shutil.which("g++"):
        _warn("no g++ to build it")
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_CXXFLAGS, *flags, "-o", tmp,
                            *(os.path.join(SRC_DIR, s) for s in _SOURCES)],
                           capture_output=True, text=True, timeout=300,
                           check=True)
            os.replace(tmp, path)
        except subprocess.CalledProcessError as e:
            _warn(f"g++ failed:\n{e.stderr[-3000:]}")
        except (OSError, subprocess.SubprocessError) as e:
            _warn(f"building it failed ({e})")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if path == _build_path() and not os.path.exists(path):
        _build(path)   # on first use, when a toolchain is available
        if not os.path.exists(path):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _warn(f"loading {path} failed ({e})")
        return None
    lib.mmt_sketch.restype = ctypes.c_int64
    lib.mmt_sketch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.mmt_radix_perm64.restype = None
    lib.mmt_radix_perm64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_chain_dp.restype = ctypes.c_int64
    lib.mmt_chain_dp.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.mmt_ksw_extz2.restype = ctypes.c_int64
    lib.mmt_ksw_extz2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_ksw_extd2.restype = ctypes.c_int64
    lib.mmt_ksw_extd2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_ksw_exts2.restype = ctypes.c_int64
    lib.mmt_ksw_exts2.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
        i32p, u32p, ctypes.c_int64,
    ]
    lib.mmt_chain_rmq.restype = ctypes.c_int64
    lib.mmt_chain_rmq.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        i32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_chain_backtrack.restype = ctypes.c_int64
    lib.mmt_chain_backtrack.argtypes = [
        i32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mmt_sw_ll.restype = ctypes.c_int32
    lib.mmt_sw_ll.argtypes = [
        u8p, ctypes.c_int32, u8p, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p,
    ]
    lib.mmt_test_zdrop.restype = ctypes.c_int32
    lib.mmt_test_zdrop.argtypes = [
        u8p, u8p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, i8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.mmt_lpt_pack.restype = None
    lib.mmt_lpt_pack.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.mmt_compute_ranges.restype = None
    lib.mmt_compute_ranges.argtypes = [
        u64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p,
    ]
    lib.mmt_scatter_max.restype = None
    lib.mmt_scatter_max.argtypes = [i32p, i64p, i32p, ctypes.c_int64]
    lib.mmt_tile_starts.restype = None
    lib.mmt_tile_starts.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p,
    ]
    lib.mmt_idx_lookup.restype = None
    lib.mmt_idx_lookup.argtypes = [
        u64p, i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int, u64p, ctypes.c_int64, i64p, i64p,
    ]
    lib.mmt_fill_check.restype = None
    lib.mmt_fill_check.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), i64p,
    ]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.mmt_pack_class_flat.restype = None
    lib.mmt_pack_class_flat.argtypes = [
        i64p, i64p, ctypes.c_int64, i64p,
        i32p, i32p, i32p, ctypes.c_int64,
        i32p, i32p, i16p, i64p, i32p, i64p,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mmt_seed_mz_flt.restype = None
    lib.mmt_seed_mz_flt.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, u8p,
    ]
    lib.mmt_fill_mode.restype = None
    lib.mmt_fill_mode.argtypes = [ctypes.c_int32]
    lib.mmt_fill_counts.restype = None
    lib.mmt_fill_counts.argtypes = [i64p, i64p, i64p]
    lib.mmt_fill_fetch.restype = None
    lib.mmt_fill_fetch.argtypes = [i64p, u8p, u8p]
    lib.mmt_fill_table_bulk.restype = None
    lib.mmt_fill_table_bulk.argtypes = [
        ctypes.c_int64, i64p, i64p, u8p, i64p, u8p,
        i32p, i64p, u32p,
    ]
    lib.mmt_collect_anchors.restype = ctypes.c_int64
    lib.mmt_collect_anchors.argtypes = [
        u64p, i64p, i64p, u32p, i32p, i32p, u8p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u64p, u64p,
    ]
    lib.mmt_align1.restype = ctypes.c_int64
    lib.mmt_align1.argtypes = [
        u64p, u64p, ctypes.c_int64,                      # ax, ay, n_a
        ctypes.POINTER(ctypes.c_uint8), u64p, i64p,      # seq, offsets, lens
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8), i64p, i64p,       # mat, params, out
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def sketch(seq: bytes, w: int, k: int, rid: int, is_hpc: bool) -> np.ndarray:
    lib = _load()
    n = len(seq)
    cap = 2 * (n + 16)  # xy pairs; generous upper bound (<= 2 per base)
    out = np.empty(cap, dtype=np.uint64)
    m = lib.mmt_sketch(
        seq, n, w, k, rid, 1 if is_hpc else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), cap,
    )
    if m < 0:
        raise RuntimeError("mmt_sketch: output capacity exceeded")
    return out[: 2 * m].reshape(-1, 2).copy()


def radix_perm64(keys: np.ndarray) -> np.ndarray:
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.empty(keys.shape[0], dtype=np.int64)
    lib.mmt_radix_perm64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        keys.shape[0],
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm


def chain_dp(ax: np.ndarray, ay: np.ndarray, max_dist_x: int, max_dist_y: int,
             bw: int, max_skip: int, max_iter: int,
             chn_pen_gap: float, chn_pen_skip: float,
             is_cdna: int, n_seg: int) -> tuple[np.ndarray, np.ndarray]:
    """Native chain DP: returns (f int32 scores, p int64 predecessors)."""
    lib = _load()
    n = ax.shape[0]
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    f = np.empty(n, dtype=np.int32)
    p = np.empty(n, dtype=np.int64)
    lib.mmt_chain_dp(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ay.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, max_dist_x, max_dist_y, bw, max_skip, max_iter,
        chn_pen_gap, chn_pen_skip, is_cdna, n_seg,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return f, p


def _u8(a):
    import ctypes as _c
    return a.ctypes.data_as(_c.POINTER(_c.c_uint8))


def ksw_extz2(qseq, tseq, mat, q, e, w, zdrop, end_bonus, flag):
    """Native extz2; returns (ez_scalars int32[10], cigar uint32[n])."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_extz2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, w, zdrop, end_bonus, flag,
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_extz2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def ksw_extd2(qseq, tseq, mat, q, e, q2, e2, w, zdrop, end_bonus, flag):
    """Native extd2; returns (ez_scalars int32[10], cigar uint32[n])."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_extd2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, q2, e2, w, zdrop, end_bonus, flag,
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_extd2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def test_zdrop(qseq, tseq, cigar, mat, q, e, zdrop, zdrop_inv, max_gap,
               try_inv, min_sc, min_dp_max):
    """Native mm_test_zdrop; returns 0/1/2."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    cig = np.ascontiguousarray(cigar, np.uint32)
    mat = np.ascontiguousarray(mat, np.int8)
    return int(lib.mmt_test_zdrop(
        _u8(qseq), _u8(tseq),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cig.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        q, e, zdrop, zdrop_inv, max_gap, 1 if try_inv else 0,
        min_sc, min_dp_max))


def sw_ll(qseq, tseq, mat, gapo, gape):
    """Native small SW; returns (score, qe, te)."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    qe = ctypes.c_int32()
    te = ctypes.c_int32()
    score = lib.mmt_sw_ll(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5, gapo, gape,
        ctypes.byref(qe), ctypes.byref(te))
    return int(score), int(qe.value), int(te.value)


def ksw_exts2(qseq, tseq, mat, q, e, q2, noncan, zdrop, junc_bonus, flag,
              junc):
    """Native splice extension; returns (ez_scalars int32[10], cigar)."""
    lib = _load()
    qseq = np.ascontiguousarray(qseq, np.uint8)
    tseq = np.ascontiguousarray(tseq, np.uint8)
    mat = np.ascontiguousarray(mat, np.int8)
    junc = np.ascontiguousarray(
        junc if junc is not None else np.zeros(tseq.shape[0], np.uint8),
        np.uint8)
    ez = np.zeros(10, np.int32)
    cap = qseq.shape[0] + tseq.shape[0] + 4
    cig = np.empty(cap, np.uint32)
    n = lib.mmt_ksw_exts2(
        _u8(qseq), qseq.shape[0], _u8(tseq), tseq.shape[0],
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 5,
        q, e, q2, noncan, zdrop, junc_bonus, flag, _u8(junc),
        ez.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
    if n < 0:
        raise RuntimeError("mmt_ksw_exts2: cigar capacity exceeded")
    return ez, cig[:n].copy()


def chain_rmq_scores(ax, ay, max_dist, max_dist_inner, bw, max_chn_skip,
                     cap_rmq_size, cg, cs):
    """Native RMQ chain scores; returns (f int32, p int64)."""
    lib = _load()
    ax = np.ascontiguousarray(ax, np.uint64)
    ay = np.ascontiguousarray(ay, np.uint64)
    n = ax.shape[0]
    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int64)
    lib.mmt_chain_rmq(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ay.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n, max_dist, max_dist_inner, bw, max_chn_skip, cap_rmq_size,
        cg, cs,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return f, p


def chain_backtrack_native(f, p, z_y, min_cnt, min_sc, max_drop):
    """Native score-sorted chain extraction. Returns (u, v)."""
    lib = _load()
    f = np.ascontiguousarray(f, np.int32)
    p = np.ascontiguousarray(p, np.int64)
    z_y = np.ascontiguousarray(z_y, np.int64)
    n = f.shape[0]
    u = np.empty(max(z_y.shape[0], 1), np.uint64)
    v = np.empty(max(n, 1), np.int64)
    n_u = ctypes.c_int64()
    n_v = lib.mmt_chain_backtrack(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, min_cnt, min_sc, max_drop,
        z_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), z_y.shape[0],
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(n_u))
    return u[:n_u.value].copy(), v[:n_v].copy()


def lpt_pack(lens: np.ndarray, lanes: int
             ) -> tuple[np.ndarray, np.ndarray, int]:
    """LPT bin packing (chain_tpu._pack_lanes fast path); packing is
    bit-identical to the Python heapq fallback."""
    lib = _load()
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = lens.shape[0]
    lane_of = np.empty(n, dtype=np.int64)
    off_of = np.empty(n, dtype=np.int64)
    height = ctypes.c_int64(0)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.mmt_lpt_pack(lens.ctypes.data_as(p), n, lanes,
                     lane_of.ctypes.data_as(p), off_of.ctypes.data_as(p),
                     ctypes.byref(height))
    return lane_of, off_of, int(height.value)


def tile_starts(rmax: np.ndarray, H: int, W: int, tile: int,
                n_tiles: int) -> np.ndarray:
    """Per-tile dynamic window starts from a per-row range max."""
    lib = _load()
    p32 = ctypes.POINTER(ctypes.c_int32)
    start = np.empty(n_tiles, np.int32)
    lib.mmt_tile_starts(rmax.ctypes.data_as(p32), H, W, tile, n_tiles,
                        start.ctypes.data_as(p32))
    return start


def fill_check(qlen: np.ndarray, tlen: np.ndarray, w: np.ndarray,
               w_band: int) -> tuple[np.ndarray, np.ndarray]:
    """Vector drop/row-count decisions for fill planning (exact scalar
    form of ksw2_tpu._row_params + block-base validation)."""
    lib = _load()
    p64 = ctypes.POINTER(ctypes.c_int64)
    qlen = np.ascontiguousarray(qlen, np.int64)
    tlen = np.ascontiguousarray(tlen, np.int64)
    w = np.ascontiguousarray(w, np.int64)
    n = qlen.shape[0]
    dropped = np.empty(n, np.uint8)
    r_true = np.empty(n, np.int64)
    lib.mmt_fill_check(qlen.ctypes.data_as(p64), tlen.ctypes.data_as(p64),
                       w.ctypes.data_as(p64), n, w_band,
                       dropped.ctypes.data_as(
                           ctypes.POINTER(ctypes.c_uint8)),
                       r_true.ctypes.data_as(p64))
    return dropped.astype(bool), r_true


def pack_class_flat(cuts: np.ndarray, sel: np.ndarray, off_of: np.ndarray,
                    x32: np.ndarray, y32: np.ndarray, rng: np.ndarray,
                    W: int, H: int, n_real: int, n_pad: int,
                    flat: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """One-pass per-class pack into the flat 10 B/anchor uplink layout
    [x32 | y32 | rng16 | seg-meta] (chain_tpu.dispatch_scores fast path).
    Writes x/y/rng in place into `flat` (int32, zeroed, len >= 2.5*n_pad);
    returns (src, rmax, pairs)."""
    lib = _load()
    p16 = ctypes.POINTER(ctypes.c_int16)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    cuts = np.ascontiguousarray(cuts, dtype=np.int64)
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    off_of = np.ascontiguousarray(off_of, dtype=np.int64)
    src = np.empty(n_real, np.int64)
    rmax = np.zeros(H, np.int32)
    pairs = ctypes.c_int64(0)
    fx = flat[:n_pad]
    fy = flat[n_pad:2 * n_pad]
    fr = flat[2 * n_pad:2 * n_pad + n_pad // 2]
    lib.mmt_pack_class_flat(
        cuts.ctypes.data_as(p64), sel.ctypes.data_as(p64), sel.shape[0],
        off_of.ctypes.data_as(p64),
        x32.ctypes.data_as(p32), y32.ctypes.data_as(p32),
        rng.ctypes.data_as(p32), W,
        fx.ctypes.data_as(p32), fy.ctypes.data_as(p32),
        fr.ctypes.data_as(p16), src.ctypes.data_as(p64),
        rmax.ctypes.data_as(p32), ctypes.byref(pairs))
    return src, rmax, int(pairs.value)


def idx_lookup(uniq: np.ndarray, start: np.ndarray, cnt: np.ndarray,
               boff: np.ndarray, n_buckets: int, shift: int,
               q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bucketed minimizer point lookup (MinimizerIndex.lookup fast path)."""
    lib = _load()
    nq = q.shape[0]
    lo_out = np.empty(nq, dtype=np.int64)
    cnt_out = np.empty(nq, dtype=np.int64)
    ip = ctypes.POINTER(ctypes.c_int64)
    up = ctypes.POINTER(ctypes.c_uint64)
    lib.mmt_idx_lookup(uniq.ctypes.data_as(up),
                       start.ctypes.data_as(ip), cnt.ctypes.data_as(ip),
                       uniq.shape[0], boff.ctypes.data_as(ip), n_buckets,
                       shift, q.ctypes.data_as(up), nq,
                       lo_out.ctypes.data_as(ip), cnt_out.ctypes.data_as(ip))
    return lo_out, cnt_out


def compute_ranges(ax: np.ndarray, bounds: np.ndarray, max_dist: int,
                   max_iter: int) -> np.ndarray:
    """Native successor-range selection (chain_tpu.compute_ranges)."""
    lib = _load()
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    rng = np.empty(ax.shape[0], dtype=np.int32)
    lib.mmt_compute_ranges(
        ax.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), ax.shape[0],
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bounds.shape[0], max_dist, max_iter,
        rng.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return rng


def pack_meta(rows: np.ndarray, rng_src: np.ndarray, H: int, W: int,
              tile: int, n_tiles: int) -> np.ndarray:
    """rmax scatter-max + per-tile window starts (chain_tpu packing)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    rng_src = np.ascontiguousarray(rng_src, dtype=np.int32)
    rmax = np.zeros(H, np.int32)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.mmt_scatter_max(rmax.ctypes.data_as(p32),
                        rows.ctypes.data_as(p64),
                        rng_src.ctypes.data_as(p32), rows.shape[0])
    start = np.empty(n_tiles, np.int32)
    lib.mmt_tile_starts(rmax.ctypes.data_as(p32), H, W, tile, n_tiles,
                        start.ctypes.data_as(p32))
    return start


def seed_mz_flt_mask(keys: np.ndarray, q_occ_max: int,
                     q_occ_frac: float) -> np.ndarray:
    """Order-preserving keep mask for the query occurrence filter."""
    lib = _load()
    n = keys.shape[0]
    keep = np.empty(n, np.uint8)
    lib.mmt_seed_mz_flt(
        np.ascontiguousarray(keys, np.uint64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint64)),
        n, q_occ_max, q_occ_frac,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.view(bool)


def fill_mode(mode: int) -> None:
    """Set the native align1 fill-session mode: 0 off (clears the
    table), 1 collect, 2 table (see csrc/alignkit.cpp FillSession)."""
    _load().mmt_fill_mode(mode)


def fill_fetch() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drain the collected fills: (meta (n,4) int64 [ql,tl,w,zdrop],
    qblob uint8, tblob uint8; sequences concatenated in meta order)."""
    lib = _load()
    n = ctypes.c_int64()
    qb = ctypes.c_int64()
    tb = ctypes.c_int64()
    lib.mmt_fill_counts(ctypes.byref(n), ctypes.byref(qb), ctypes.byref(tb))
    meta = np.empty((n.value, 4), np.int64)
    qblob = np.empty(qb.value, np.uint8)
    tblob = np.empty(tb.value, np.uint8)
    if n.value:
        i64 = ctypes.POINTER(ctypes.c_int64)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.mmt_fill_fetch(meta.ctypes.data_as(i64),
                           qblob.ctypes.data_as(u8),
                           tblob.ctypes.data_as(u8))
    return meta, qblob, tblob


def fill_table_bulk(meta: np.ndarray, qoff: np.ndarray, qblob: np.ndarray,
                    toff: np.ndarray, tblob: np.ndarray,
                    scores: np.ndarray, cig_off: np.ndarray,
                    cig_blob: np.ndarray) -> None:
    """Load device fill results into the native lookup table."""
    lib = _load()
    i64 = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.mmt_fill_table_bulk(
        meta.shape[0],
        np.ascontiguousarray(meta, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qoff, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qblob, np.uint8).ctypes.data_as(u8),
        np.ascontiguousarray(toff, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(tblob, np.uint8).ctypes.data_as(u8),
        np.ascontiguousarray(scores, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)),
        np.ascontiguousarray(cig_off, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(cig_blob, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)))


def collect_anchors(occ_pos: np.ndarray, start: np.ndarray, cnt: np.ndarray,
                    q_pos: np.ndarray, q_span: np.ndarray,
                    seg_id: np.ndarray, tandem: np.ndarray,
                    qlen: int) -> tuple[np.ndarray, np.ndarray]:
    """Fused default-path anchor expansion + encode + radix permutation
    (mmt_collect_anchors; collect_seed_hits semantics, map.c:295-331)."""
    lib = _load()
    n_hits = int(cnt.sum())
    ax = np.empty(n_hits, np.uint64)
    ay = np.empty(n_hits, np.uint64)
    if n_hits == 0:
        return ax, ay
    u64 = ctypes.POINTER(ctypes.c_uint64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.mmt_collect_anchors(
        occ_pos.ctypes.data_as(u64),
        np.ascontiguousarray(start, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(cnt, np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(q_pos, np.uint32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint32)),
        np.ascontiguousarray(q_span, np.int32).ctypes.data_as(i32),
        np.ascontiguousarray(seg_id, np.int32).ctypes.data_as(i32),
        np.ascontiguousarray(tandem, np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)),
        q_pos.shape[0], qlen, n_hits,
        ax.ctypes.data_as(u64), ay.ctypes.data_as(u64))
    return ax, ay


def align1(ax, ay, n_a, seq_codes, offsets, lens, fwd, rc, mat, params):
    """Native per-region alignment driver (mmt_align1, alignkit.cpp —
    mm_align1 semantics, align.c:573-826).  Mutates ay (seed flags) in
    place.  Returns (out int64[12], cigar uint32[n]) or None when the
    C++ side requests the Python fallback."""
    import ctypes as _c
    lib = _load()
    u8p = _c.POINTER(_c.c_uint8)
    i64p = _c.POINTER(_c.c_int64)
    out = np.zeros(12, np.int64)
    cap = int(params[33]) // 2 + 256   # qlen//2 + slack; retried if short
    for _ in range(3):
        cig = np.empty(cap, np.uint32)
        n = lib.mmt_align1(
            ax.ctypes.data_as(_c.POINTER(_c.c_uint64)),
            ay.ctypes.data_as(_c.POINTER(_c.c_uint64)), n_a,
            seq_codes.ctypes.data_as(u8p),
            offsets.ctypes.data_as(_c.POINTER(_c.c_uint64)),
            lens.ctypes.data_as(i64p),
            fwd.ctypes.data_as(u8p), rc.ctypes.data_as(u8p),
            mat.ctypes.data_as(_c.POINTER(_c.c_int8)),
            params.ctypes.data_as(i64p),
            out.ctypes.data_as(i64p),
            cig.ctypes.data_as(_c.POINTER(_c.c_uint32)), cap)
        if n == -2:
            return None
        if n == -1:
            cap = int(out[0]) + 16
            continue
        return out, cig[:n]
    raise RuntimeError("mmt_align1: cigar capacity retry failed")


def build_sanitized(sanitizer: str) -> str | None:
    """Build the kit with a sanitizer ("asan" or "ubsan") into BUILD_DIR,
    once for each source hash; its path, or None if the build failed.
    Load it with MM2TPU_NATIVE_LIB=<path> and the sanitizer's runtime in
    LD_PRELOAD ($(g++ -print-file-name=libasan.so) or libubsan.so); under
    asan also ASAN_OPTIONS=detect_leaks=0, as the interpreter's own
    allocations live until exit."""
    path = _build_path(sanitizer)
    if not os.path.exists(path):
        _build(path, SANITIZERS[sanitizer])
    return path if os.path.exists(path) else None

