"""PyTorch operators over the hand-written CUDA kernels.

Each operator is a ``torch.library.custom_op``: on a CUDA tensor it
launches its kernel from ``csrc/`` (and raises if the build or the launch
fails); on a CPU tensor it runs the plain version from
:mod:`porepy_tpu_torch.kernels.reference`. ``LAUNCHES`` counts kernel
launches per operator, and only those.
"""

from __future__ import annotations

import torch

from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.kernels.build import library

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "ell_spmv",
    "ell_jacobi_sweep",
    "fgmres_givens",
]

#: Kernel launches per operator since the last :func:`reset_launches`.
LAUNCHES = {"ell_spmv": 0, "ell_jacobi_sweep": 0, "fgmres_givens": 0}

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, tensors: dict, dtype: torch.dtype) -> None:
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    fn = getattr(library(), "ppt_" + name + _SUFFIX[dtype])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


# -- K1 ---------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::ell_spmv", mutates_args=())
def ell_spmv(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in padded-row form; ``x`` is ``(n_cols,)`` or
    ``(B, n_cols)``. Padding columns equal ``n_cols``."""
    return reference.ell_spmv(val, col, x)


@ell_spmv.register_kernel("cuda")
def _ell_spmv_cuda(val, col, x):
    if col.dtype != torch.int32 or val.dtype != x.dtype:
        raise TypeError("ell_spmv: needs val of x's dtype and int32 col")
    if val.dim() != 2 or col.shape != val.shape or x.dim() not in (1, 2):
        raise ValueError("ell_spmv: needs (n, K) val and col, x of shape (m,) or (B, m)")
    _check("ell_spmv", {"val": val, "col": col, "x": x}, x.dtype)
    n_rows, K = val.shape
    n_cols = x.shape[-1]
    batch = x.shape[0] if x.dim() == 2 else 1
    y = torch.empty(x.shape[:-1] + (n_rows,), dtype=x.dtype, device=x.device)
    _launch(
        "ell_spmv", x.dtype,
        val.data_ptr(), col.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_rows, K, n_cols, batch,
    )
    return y


@ell_spmv.register_fake
def _(val, col, x):
    return x.new_empty(x.shape[:-1] + (val.shape[0],))


# -- K2 ---------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::ell_jacobi_sweep", mutates_args=())
def ell_jacobi_sweep(
    val: torch.Tensor,
    col: torch.Tensor,
    sinv: torch.Tensor,
    r: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """One smoother sweep ``y + sinv * (r - A y)``."""
    return reference.ell_jacobi_sweep(val, col, sinv, r, y)


@ell_jacobi_sweep.register_kernel("cuda")
def _ell_jacobi_sweep_cuda(val, col, sinv, r, y):
    dtype = y.dtype
    if col.dtype != torch.int32 or any(t.dtype != dtype for t in (val, sinv, r)):
        raise TypeError("ell_jacobi_sweep: needs one float dtype and int32 col")
    n = y.shape[0]
    if val.dim() != 2 or col.shape != val.shape or val.shape[0] != n or any(
        t.shape != (n,) for t in (sinv, r, y)
    ):
        raise ValueError("ell_jacobi_sweep: needs (n, K) val/col and (n,) sinv, r, y")
    _check(
        "ell_jacobi_sweep",
        {"val": val, "col": col, "sinv": sinv, "r": r, "y": y},
        dtype,
    )
    K = val.shape[1]
    out = torch.empty_like(y)
    _launch(
        "ell_jacobi_sweep", dtype,
        val.data_ptr(), col.data_ptr(), sinv.data_ptr(), r.data_ptr(),
        y.data_ptr(), out.data_ptr(), n, K,
    )
    return out


@ell_jacobi_sweep.register_fake
def _(val, col, sinv, r, y):
    return torch.empty_like(y)


# -- K4g --------------------------------------------------------------------------


@torch.library.custom_op(
    "porepy_tpu_torch::fgmres_givens",
    mutates_args=("hcol", "cs", "sn", "g", "j", "flag"),
)
def fgmres_givens(
    hcol: torch.Tensor,
    cs: torch.Tensor,
    sn: torch.Tensor,
    g: torch.Tensor,
    j: torch.Tensor,
    atol: torch.Tensor,
    flag: torch.Tensor,
) -> None:
    """Givens step of FGMRES Arnoldi column ``j`` (device int32 scalar),
    in place; writes the continue flag and advances ``j``. A ``j``
    outside ``[0, restart)`` only clears the flag."""
    reference.fgmres_givens(hcol, cs, sn, g, j, atol, flag)


@fgmres_givens.register_kernel("cuda")
def _fgmres_givens_cuda(hcol, cs, sn, g, j, atol, flag):
    dtype = hcol.dtype
    if any(t.dtype != dtype for t in (cs, sn, g, atol)):
        raise TypeError("fgmres_givens: hcol, cs, sn, g, atol need one dtype")
    if j.dtype != torch.int32 or flag.dtype != torch.int32:
        raise TypeError("fgmres_givens: j and flag must be int32")
    restart = hcol.shape[0] - 1
    if (
        hcol.dim() != 1 or g.shape != hcol.shape
        or cs.shape != (restart,) or sn.shape != (restart,)
        or j.numel() != 1 or atol.numel() != 1 or flag.numel() != 1
    ):
        raise ValueError("fgmres_givens: needs hcol, g (restart + 1,), cs, sn (restart,), scalars")
    _check(
        "fgmres_givens",
        {"hcol": hcol, "cs": cs, "sn": sn, "g": g, "j": j, "atol": atol,
         "flag": flag},
        dtype,
    )
    _launch(
        "fgmres_givens", dtype,
        hcol.data_ptr(), cs.data_ptr(), sn.data_ptr(), g.data_ptr(),
        j.data_ptr(), atol.data_ptr(), flag.data_ptr(), restart,
    )


@fgmres_givens.register_fake
def _(hcol, cs, sn, g, j, atol, flag):
    return None
