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
    "dense_block_scatter",
    "gj_pivot_inverse",
    "dense_block_apply",
    "structured_residual",
    "structured_jvp",
    "tpfa_residual",
    "tpfa_jvp",
    "region_solve",
]

#: Kernel launches per operator since the last :func:`reset_launches`.
LAUNCHES = {
    "ell_spmv": 0,
    "ell_jacobi_sweep": 0,
    "fgmres_givens": 0,
    "dense_block_scatter": 0,
    "gj_pivot_inverse": 0,
    "dense_block_apply": 0,
    "structured_residual": 0,
    "structured_jvp": 0,
    "tpfa_residual": 0,
    "tpfa_jvp": 0,
    "region_solve": 0,
}

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


# -- K6 ---------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::dense_block_scatter", mutates_args=())
def dense_block_scatter(
    vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, ni: int, n_pad: int
) -> torch.Tensor:
    """Coalesced COO entries into a zero ``(n_pad, n_pad)`` matrix, with
    ones on the diagonal of the pad rows ``ni <= i < n_pad``."""
    return reference.dense_block_scatter(vals, rows, cols, ni, n_pad)


@dense_block_scatter.register_kernel("cuda")
def _dense_block_scatter_cuda(vals, rows, cols, ni, n_pad):
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("dense_block_scatter: rows and cols must be int32")
    nnz = vals.shape[0]
    if vals.dim() != 1 or rows.shape != (nnz,) or cols.shape != (nnz,):
        raise ValueError("dense_block_scatter: needs (nnz,) vals, rows, cols")
    if not 0 <= ni <= n_pad:
        raise ValueError("dense_block_scatter: needs 0 <= ni <= n_pad")
    _check("dense_block_scatter", {"vals": vals, "rows": rows, "cols": cols}, vals.dtype)
    D = torch.zeros((n_pad, n_pad), dtype=vals.dtype, device=vals.device)
    _launch(
        "dense_block_scatter", vals.dtype,
        vals.data_ptr(), rows.data_ptr(), cols.data_ptr(), nnz, ni, n_pad,
        D.data_ptr(),
    )
    return D


@dense_block_scatter.register_fake
def _(vals, rows, cols, ni, n_pad):
    return vals.new_empty((n_pad, n_pad))


@torch.library.custom_op("porepy_tpu_torch::gj_pivot_inverse", mutates_args=("flag",))
def gj_pivot_inverse(a: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, b, b)`` matrices ``a`` (partial pivoting
    inside each); sets ``flag[m] = 1`` where matrix ``m`` is singular or its
    inverse is not finite, and never clears it."""
    return reference.gj_pivot_inverse(a, flag)


@gj_pivot_inverse.register_kernel("cuda")
def _gj_pivot_inverse_cuda(a, flag):
    if flag.dtype != torch.int32:
        raise TypeError("gj_pivot_inverse: flag must be int32")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or flag.shape != (a.shape[0],):
        raise ValueError("gj_pivot_inverse: needs (B, b, b) matrices and a (B,) flag")
    b = a.shape[1]
    if not 1 <= b <= 128:
        raise ValueError(f"gj_pivot_inverse: b = {b} outside 1..128")
    _check("gj_pivot_inverse", {"a": a, "flag": flag}, a.dtype)
    out = torch.empty_like(a)
    _launch(
        "gj_pivot_inverse", a.dtype,
        a.data_ptr(), out.data_ptr(), flag.data_ptr(), a.shape[0], b,
    )
    return out


@gj_pivot_inverse.register_fake
def _(a, flag):
    return torch.empty_like(a)


@torch.library.custom_op("porepy_tpu_torch::dense_block_apply", mutates_args=())
def dense_block_apply(D: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``D[:ni, :ni] @ r`` for float32 ``D`` of shape ``(n_pad, n_pad)``,
    accumulated in float32 and returned in ``r``'s dtype (``ni = r.numel()``)."""
    return reference.dense_block_apply(D, r)


@dense_block_apply.register_kernel("cuda")
def _dense_block_apply_cuda(D, r):
    if D.dtype != torch.float32:
        raise TypeError("dense_block_apply: D must be float32")
    if D.dim() != 2 or D.shape[0] != D.shape[1] or r.dim() != 1 or r.shape[0] > D.shape[0]:
        raise ValueError("dense_block_apply: needs a square D and r of length <= D's")
    _check("dense_block_apply", {"D": D, "r": r}, r.dtype)
    if D.data_ptr() % 16 or D.shape[1] % 4:
        raise ValueError("dense_block_apply: D needs 16-byte aligned rows")
    y = torch.empty_like(r)
    _launch(
        "dense_block_apply", r.dtype,
        D.data_ptr(), r.data_ptr(), y.data_ptr(), r.shape[0], D.shape[1],
    )
    return y


@dense_block_apply.register_fake
def _(D, r):
    return torch.empty_like(r)


# -- K12 --------------------------------------------------------------------------


def _structured_cuda(name, p, q, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    dtype = p.dtype
    tensors = {
        "p": p, "q": q, "tx": tx, "ty": ty, "tz": tz, "pbc_x": pbc_x,
        "pbc_y": pbc_y, "pbc_z": pbc_z, "pv": pv, "coef": coef,
    }
    if any(t.dtype != dtype for t in tensors.values()):
        raise TypeError(f"{name}: every tensor needs p's dtype")
    if p.dim() != 3:
        raise ValueError(f"{name}: p must be (nx, ny, nz)")
    nx, ny, nz = p.shape
    shapes = {
        "q": (nx, ny, nz), "tx": (nx + 1, ny, nz), "ty": (nx, ny + 1, nz),
        "tz": (nx, ny, nz + 1), "pbc_x": (2, ny, nz), "pbc_y": (2, nx, nz),
        "pbc_z": (2, nx, ny), "pv": (nx, ny, nz), "coef": (5,),
    }
    for arg, shape in shapes.items():
        if tuple(tensors[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(tensors[arg].shape)}, expected {shape}")
    _check(name, tensors, dtype)
    out = torch.empty_like(p)
    _launch(
        name, dtype,
        *(t.data_ptr() for t in tensors.values()), out.data_ptr(), nx, ny, nz,
    )
    return out


@torch.library.custom_op("porepy_tpu_torch::structured_residual", mutates_args=())
def structured_residual(
    p: torch.Tensor,
    p_prev: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    pbc_x: torch.Tensor,
    pbc_y: torch.Tensor,
    pbc_z: torch.Tensor,
    pv: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """Structured 7-point TPFA mass-balance residual (see
    :func:`porepy_tpu_torch.kernels.reference.structured_residual`)."""
    return reference.structured_residual(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


@structured_residual.register_kernel("cuda")
def _structured_residual_cuda(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return _structured_cuda(
        "structured_residual", p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef
    )


@structured_residual.register_fake
def _(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return torch.empty_like(p)


@torch.library.custom_op("porepy_tpu_torch::structured_jvp", mutates_args=())
def structured_jvp(
    p: torch.Tensor,
    dp: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    tz: torch.Tensor,
    pbc_x: torch.Tensor,
    pbc_y: torch.Tensor,
    pbc_z: torch.Tensor,
    pv: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """``J(p) dp`` of :func:`structured_residual`, upwind side frozen."""
    return reference.structured_jvp(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


@structured_jvp.register_kernel("cuda")
def _structured_jvp_cuda(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return _structured_cuda(
        "structured_jvp", p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef
    )


@structured_jvp.register_fake
def _(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    return torch.empty_like(p)


# -- K13 --------------------------------------------------------------------------


def _tpfa_cuda(name, p, q, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    dtype = p.dtype
    if any(x.dtype != dtype for x in (q, t, bc_val, pv, coef)):
        raise TypeError(f"{name}: p, q, t, bc_val, pv, coef need one dtype")
    if any(x.dtype != torch.int32 for x in (lo, hi, cell_ptr, cell_faces)):
        raise TypeError(f"{name}: lo, hi, cell_ptr, cell_faces must be int32")
    if is_neu.dtype != torch.bool:
        raise TypeError(f"{name}: is_neu must be bool")
    nc, nf = p.shape[0], t.shape[0]
    if (
        p.dim() != 1 or q.shape != (nc,) or pv.shape != (nc,)
        or any(x.shape != (nf,) for x in (lo, hi, t, is_neu, bc_val))
        or cell_ptr.shape != (nc + 1,) or cell_faces.dim() != 1 or coef.shape != (5,)
    ):
        raise ValueError(f"{name}: inconsistent cell/face shapes")
    tensors = {
        "p": p, "q": q, "lo": lo, "hi": hi, "t": t, "is_neu": is_neu,
        "bc_val": bc_val, "pv": pv, "cell_ptr": cell_ptr,
        "cell_faces": cell_faces, "coef": coef,
    }
    _check(name, tensors, dtype)
    m = torch.empty(nf, dtype=dtype, device=p.device)
    out = torch.empty_like(p)
    _launch(
        name, dtype,
        *(x.data_ptr() for x in tensors.values()), m.data_ptr(), out.data_ptr(), nc, nf,
    )
    return out


@torch.library.custom_op("porepy_tpu_torch::tpfa_residual", mutates_args=())
def tpfa_residual(
    p: torch.Tensor,
    p_prev: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    t: torch.Tensor,
    is_neu: torch.Tensor,
    bc_val: torch.Tensor,
    pv: torch.Tensor,
    cell_ptr: torch.Tensor,
    cell_faces: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """Unstructured TPFA mass-balance residual (see
    :func:`porepy_tpu_torch.kernels.reference.tpfa_residual`)."""
    return reference.tpfa_residual(
        p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_residual.register_kernel("cuda")
def _tpfa_residual_cuda(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return _tpfa_cuda(
        "tpfa_residual", p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_residual.register_fake
def _(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return torch.empty_like(p)


@torch.library.custom_op("porepy_tpu_torch::tpfa_jvp", mutates_args=())
def tpfa_jvp(
    p: torch.Tensor,
    dp: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    t: torch.Tensor,
    is_neu: torch.Tensor,
    bc_val: torch.Tensor,
    pv: torch.Tensor,
    cell_ptr: torch.Tensor,
    cell_faces: torch.Tensor,
    coef: torch.Tensor,
) -> torch.Tensor:
    """``J(p) dp`` of :func:`tpfa_residual`, upwind side frozen."""
    return reference.tpfa_jvp(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)


@tpfa_jvp.register_kernel("cuda")
def _tpfa_jvp_cuda(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return _tpfa_cuda(
        "tpfa_jvp", p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef
    )


@tpfa_jvp.register_fake
def _(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    return torch.empty_like(p)


# -- K10 --------------------------------------------------------------------------

# Dynamic shared memory the region-solve kernel may take (``kSmemMax`` in
# ``csrc/region_solve.cu``); larger regions work from a device workspace.
_REGION_SMEM_MAX = 231424


@torch.library.custom_op("porepy_tpu_torch::region_solve", mutates_args=())
def region_solve(a: torch.Tensor, rhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``W @ solve(A / s, RHS / s)`` per region, ``s`` the row maxima of
    ``|A|`` (see :func:`porepy_tpu_torch.kernels.reference.region_solve_contract`);
    ``(B, n, n)``, ``(B, n, m)``, ``(B, q, n)`` float64 in, ``(B, q, m)`` out."""
    return reference.region_solve_contract(a, rhs, w)


@region_solve.register_kernel("cuda")
def _region_solve_cuda(a, rhs, w):
    if any(t.dtype != torch.float64 for t in (a, rhs, w)):
        raise TypeError("region_solve: a, rhs and w must be float64")
    if a.dim() != 3 or rhs.dim() != 3 or w.dim() != 3:
        raise ValueError("region_solve: needs (B, n, n) a, (B, n, m) rhs, (B, q, n) w")
    B, n = a.shape[0], a.shape[1]
    m, q = rhs.shape[2], w.shape[1]
    if a.shape != (B, n, n) or rhs.shape != (B, n, m) or w.shape != (B, q, n):
        raise ValueError("region_solve: needs (B, n, n) a, (B, n, m) rhs, (B, q, n) w")
    _check("region_solve", {"a": a, "rhs": rhs, "w": w}, a.dtype)
    out = torch.empty((B, q, m), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    work = None
    if 8 * n * (n + m + 1) > _REGION_SMEM_MAX:
        work = torch.empty((B, n, n + m), dtype=a.dtype, device=a.device)
    _launch(
        "region_solve", a.dtype,
        a.data_ptr(), rhs.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, n, m, q,
    )
    return out


@region_solve.register_fake
def _(a, rhs, w):
    return a.new_empty((a.shape[0], w.shape[1], rhs.shape[2]))
