"""Build and load the package's CUDA kernels (csrc/*.cu).

The TPU package compiled its Pallas kernels through XLA at first call;
here the CUDA sources are compiled once per checkout with nvcc, through
torch.utils.cpp_extension.load, into <repo>/build/kernels (delete that
directory for a clean rebuild).  The sources use a plain C interface and
include no PyTorch header, so a build takes seconds; the library is then
opened with ctypes and the wrappers pass raw device pointers.

Nothing here runs at import: the first wrapper call on a CUDA tensor
builds the library.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_lib = None
_lock = threading.Lock()

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_SIGNATURES = {
    "mm2_chain_segments": [_vp, _vp, _vp, _vp, _vp, _i, _vp, _vp, _vp,
                           _i, _i, _i, _i, _f, _f, _i, _i, _vp],
    "mm2_chain_warps_per_block": [],
    "mm2_mg_log2": [_vp, _vp, _i, _vp],
    "mm2_extd2_fill": [_vp] * 9 + [_i, _vp, _vp, _vp] + [_i] * 12 + [_vp],
    "mm2_ksw2_backtrack": [_vp] * 7 + [_i, _i, _i, _vp, _vp, _vp],
    "mm2_exts2_fill": [_vp] * 11 + [_i, _vp, _vp, _vp] + [_i] * 12 + [_vp],
}


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            path = load(name="mm2_gb_tpu_torch_kernels",
                        sources=sorted(glob.glob(os.path.join(CSRC, "*.cu"))),
                        build_directory=BUILD_DIR,
                        extra_cuda_cflags=CUDA_FLAGS,
                        is_python_module=False, verbose=False)
            lib = ctypes.CDLL(path)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
