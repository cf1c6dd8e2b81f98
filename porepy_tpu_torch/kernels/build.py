"""Build and load the CUDA kernels of :mod:`porepy_tpu_torch.kernels`.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so ``torch.utils.cpp_extension.load`` compiles them in seconds.
The shared library goes to ``kernels/_build/`` at first use and is then
loaded with ``ctypes``; nothing is built when the package is imported.
The flags carry a digest of the headers the sources include
(:data:`HEADERS`), so that a changed header rebuilds the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import time

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "HEADERS", "cflags", "library", "build_seconds"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = (
    "ell_spmv.cu",
    "amg_vcycle.cu",
    "fgmres_arnoldi.cu",
    "dense_block.cu",
    "structured_flow.cu",
    "tpfa_flow.cu",
    "region_solve.cu",
    "krylov.cu",
    "flash.cu",
    "interp_lookup.cu",
    "block_inverse.cu",
    "halo_spmv.cu",
    "upwind.cu",
    "tpfa_ad.cu",
    "dual_ad.cu",
)
HEADERS = ("ell_rows.cuh",)
_NAME = "porepy_tpu_torch_kernels"
_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "ppt_ell_spmv": [_P] * 5 + [_I] * 5 + [_P],
    # The level table is a host array (a ctypes array of int64).
    "ppt_amg_vcycle": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
    "ppt_jacobi_sweeps": [_P] * 7 + [_I] * 3 + [_P],
    # A launch table of int64 words in host memory (ops.FgmresArnoldi).
    "ppt_fgmres_arnoldi": [_P, _P, _P, _I, _P],
    "ppt_fgmres_arnoldi_grid": [_I, _I, _P],
    "ppt_dense_block_scatter": [_P, _P, _P, _I, _I, _I, _P, _P],
    "ppt_gj_pivot_inverse": [_P, _P, _P, _I, _I, _P],
    "ppt_dense_block_apply": [_P, _P, _P, _I, _I, _P],
    "ppt_structured_residual": [_P] * 11 + [_I] * 3 + [_P],
    "ppt_structured_jvp": [_P] * 11 + [_I] * 3 + [_P],
    "ppt_structured_residual_rho": [_P] * 12 + [_I] * 3 + [_P],
    "ppt_structured_refine": [_P] * 13 + [_I] * 3 + [_P],
    "ppt_tpfa_residual": [_P] * 12 + [_I, _P],
    "ppt_tpfa_jvp": [_P] * 12 + [_I, _P],
    "ppt_tpfa_step": [_P] * 17 + [_I, _P],
    "ppt_region_solve": [_P] * 5 + [_I] * 4 + [_P],
    "ppt_region_solve_route": [_I, _I],
    "ppt_bicgstab_cycle": [_P] * 17 + [_I] * 2 + [_P],
    "ppt_bicgstab_cycle_grid": [_I, _P],
    "ppt_bicgstab_stencil": [_P] * 15 + [_I] * 4 + [_D] * 2 + [_P],
    "ppt_bicgstab_stencil_grid": [_I, _P],
    "ppt_bicgstab_tpfa": [_P] * 17 + [_I] * 2 + [_D] * 2 + [_P],
    "ppt_bicgstab_tpfa_grid": [_I, _P],
    "ppt_structured_linearize": [_P] * 10 + [_I] * 3 + [_P],
    "ppt_tpfa_linearize": [_P] * 13 + [_I, _P],
    "ppt_gmres_cycle": [_P] * 14 + [_I] * 3 + [_P],
    "ppt_gmres_cycle_grid": [_I, _P],
    "ppt_rachford_rice": [_P] * 9 + [_I, _L, _I, _D, _P],
    # A launch table of int64 words in host memory (ops.InterpLauncher).
    "ppt_interp_dual": [_P, _P],
    "ppt_interp_dual_words": [],
    "ppt_block_inverse": [_P] * 3 + [_I, _I, _P],
    "ppt_halo_interior": [_P] * 7 + [_I] * 4 + [_P],
    "ppt_halo_boundary": [_P] * 6 + [_I] * 4 + [_P],
    # A launch table of int64 words in host memory (ops.UpwindLauncher).
    "ppt_upwind_dual": [_P, _P],
    "ppt_upwind_dual_words": [],
    "ppt_segment_sum_sorted": [_P, _L, _P, _P, _P, _I, _I, _P],
    # A launch table of int64 words in host memory (ops.TpfaAdLauncher).
    "ppt_tpfa_ad_dual": [_P, _I, _P],
    "ppt_tpfa_ad_dual_words": [],
    # Pointer and stride tables are host arrays (ctypes arrays).
    # A launch table of int64 words in host memory (ops.DualEwLauncher).
    "ppt_dual_ew": [_P, _P],
    "ppt_dual_gather_value": [_P, _P, _P, _I, _P],
    "ppt_dual_seed_rows": [_P, _P, _P, _I, _I, _P],
    "ppt_dual_gather_copy": [_P, _P, _I, _P, _L, _I, _P],
}
# The dtypes each kernel is built for (default: both). K8, K10, K11, K14, K15,
# K16, K17 and K18 are float64 only; the flow steps' solves and
# linearizations (K12, K13) take both.
_F64_ONLY = (
    "ppt_region_solve", "ppt_region_solve_route", "ppt_bicgstab_cycle", "ppt_bicgstab_cycle_grid",
    "ppt_gmres_cycle", "ppt_gmres_cycle_grid",
    "ppt_rachford_rice", "ppt_interp_dual", "ppt_interp_dual_words", "ppt_block_inverse",
    "ppt_upwind_dual", "ppt_upwind_dual_words",
    "ppt_segment_sum_sorted", "ppt_tpfa_ad_dual", "ppt_tpfa_ad_dual_words",
    "ppt_dual_ew", "ppt_dual_gather_value", "ppt_dual_seed_rows", "ppt_dual_gather_copy",
)
_SUFFIXES = {name: ("_f64",) for name in _F64_ONLY}

_LIB = None
_LOCK = threading.Lock()
_BUILD_SECONDS = [None]


def cflags(csrc: str = CSRC) -> list:
    """The compiler flags: :data:`_CFLAGS` and a digest of the headers in
    ``csrc``, which the build's version hash reads."""
    digest = hashlib.sha256()
    for h in HEADERS:
        with open(os.path.join(csrc, h), "rb") as fh:
            digest.update(fh.read())
    return _CFLAGS + [f"-DPPT_HEADERS_DIGEST={digest.hexdigest()[:16]}"]


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
                extra_cuda_cflags=cflags(),
                build_directory=BUILD_DIR,
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, _NAME + ".so"))
            for base, argtypes in _SIGNATURES.items():
                for suffix in _SUFFIXES.get(base, ("_f32", "_f64")):
                    fn = getattr(lib, base + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _BUILD_SECONDS[0] = time.perf_counter() - tic
            _LIB = lib
    return _LIB


def build_seconds():
    """Wall time of this process's build, or None before :func:`library`."""
    return _BUILD_SECONDS[0]
