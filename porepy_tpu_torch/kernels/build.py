"""Build and load the CUDA kernels of :mod:`porepy_tpu_torch.kernels`.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so ``torch.utils.cpp_extension.load`` compiles them in seconds.
The shared library goes to ``kernels/_build/`` at first use and is then
loaded with ``ctypes``; nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "library", "build_seconds"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = (
    "ell_spmv.cu",
    "ell_jacobi_sweep.cu",
    "fgmres_givens.cu",
    "dense_block.cu",
    "structured_flow.cu",
    "tpfa_flow.cu",
)
_NAME = "porepy_tpu_torch_kernels"
_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ppt_ell_spmv": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ppt_ell_jacobi_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "ppt_fgmres_givens": [_P, _P, _P, _P, _P, _P, _P, _I, _P],
    "ppt_dense_block_scatter": [_P, _P, _P, _I, _I, _I, _P, _P],
    "ppt_gj_pivot_inverse": [_P, _P, _P, _I, _I, _P],
    "ppt_dense_block_apply": [_P, _P, _P, _I, _I, _P],
    "ppt_structured_residual": [_P] * 11 + [_I] * 3 + [_P],
    "ppt_structured_jvp": [_P] * 11 + [_I] * 3 + [_P],
    "ppt_tpfa_residual": [_P] * 13 + [_I] * 2 + [_P],
    "ppt_tpfa_jvp": [_P] * 13 + [_I] * 2 + [_P],
}

_LIB = None
_LOCK = threading.Lock()
_BUILD_SECONDS = [None]


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on the first call. Raises if the
    CUDA toolkit or the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            tic = time.perf_counter()
            load(
                name=_NAME,
                sources=[os.path.join(CSRC, s) for s in SOURCES],
                extra_cuda_cflags=_CFLAGS,
                build_directory=BUILD_DIR,
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, _NAME + ".so"))
            for base, argtypes in _SIGNATURES.items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, base + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _BUILD_SECONDS[0] = time.perf_counter() - tic
            _LIB = lib
    return _LIB


def build_seconds():
    """Wall time of this process's build, or None before :func:`library`."""
    return _BUILD_SECONDS[0]
