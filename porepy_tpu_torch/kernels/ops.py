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
    "bicgstab_p",
    "krylov_dots",
    "bicgstab_s",
    "bicgstab_xr",
    "bicgstab_scalars",
    "cgs_project",
    "cgs_update",
    "cgs_normalize",
    "gmres_lstsq",
    "gmres_correct",
    "gmres_residual",
    "gmres_restart",
    "K18A",
    "K18B",
    "rachford_rice",
    "interp_lookup",
    "interp_tangent",
    "block_inverse",
    "halo_pack",
    "ell_spmv_split",
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
    "bicgstab_p": 0,
    "krylov_dots": 0,
    "bicgstab_s": 0,
    "bicgstab_xr": 0,
    "bicgstab_scalars": 0,
    "cgs_project": 0,
    "cgs_update": 0,
    "cgs_normalize": 0,
    "gmres_lstsq": 0,
    "gmres_correct": 0,
    "gmres_residual": 0,
    "gmres_restart": 0,
    "rachford_rice": 0,
    "interp_lookup": 0,
    "block_inverse": 0,
    "halo_pack": 0,
    "ell_spmv_split": 0,
}

#: The operators of the fused BiCGStab step (K18a) and of the GMRES Arnoldi
#: and restart work (K18b), all in ``csrc/krylov.cu``.
K18A = ("bicgstab_p", "krylov_dots", "bicgstab_s", "bicgstab_xr", "bicgstab_scalars")
K18B = (
    "cgs_project", "cgs_update", "cgs_normalize", "gmres_lstsq", "gmres_correct",
    "gmres_residual", "gmres_restart",
)

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

# Dynamic shared memory the region-solve and block-inverse kernels may take
# (``kSmemMax`` in ``csrc/region_solve.cu`` and ``csrc/block_inverse.cu``);
# larger systems work from a device workspace.
_SMEM_MAX = 231424


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
    if 8 * n * (n + m + 1) > _SMEM_MAX:
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


# -- K18 --------------------------------------------------------------------------


def _check_f64(name: str, tensors: dict, ints=()) -> None:
    """Contiguous CUDA tensors, float64 (int32 for the names in ``ints``)."""
    for arg, t in tensors.items():
        want = torch.int32 if arg in ints else torch.float64
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}")
    _check(name, tensors, torch.float64)


def _nb(n: int) -> int:
    return -(-n // reference.KRYLOV_BLOCK)


def _vectors(name: str, n: int, **vectors) -> None:
    for arg, t in vectors.items():
        if t.shape != (n,):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected ({n},)")


def _partials(name: str, partials: torch.Tensor, rows: int, n: int) -> None:
    if partials.dim() != 2 or partials.shape[0] < rows or partials.shape[1] != _nb(n):
        raise ValueError(f"{name}: partials must be (>= {rows}, {_nb(n)})")


@torch.library.custom_op("porepy_tpu_torch::bicgstab_p", mutates_args=("p", "phat"))
def bicgstab_p(
    r: torch.Tensor, q: torch.Tensor, dinv: torch.Tensor, st: torch.Tensor,
    p: torch.Tensor, phat: torch.Tensor,
) -> None:
    """In place: ``p <- r + beta (p - omega q)``, ``phat = dinv p``."""
    reference.bicgstab_p(r, q, dinv, st, p, phat)


@bicgstab_p.register_kernel("cuda")
def _bicgstab_p_cuda(r, q, dinv, st, p, phat):
    n = r.shape[0]
    _vectors("bicgstab_p", n, r=r, q=q, dinv=dinv, p=p, phat=phat)
    _check_f64("bicgstab_p", {"r": r, "q": q, "dinv": dinv, "st": st, "p": p, "phat": phat})
    _launch("bicgstab_p", torch.float64, r.data_ptr(), q.data_ptr(), dinv.data_ptr(),
            st.data_ptr(), p.data_ptr(), phat.data_ptr(), n)


@torch.library.custom_op("porepy_tpu_torch::krylov_dots", mutates_args=("partials",))
def krylov_dots(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
    partials: torch.Tensor, ndots: int,
) -> None:
    """Block partials of ``<a, b>`` into ``partials[0]`` and, with
    ``ndots == 2``, of ``<c, d>`` into ``partials[1]``."""
    reference.krylov_dots(a, b, c, d, partials, ndots)


@krylov_dots.register_kernel("cuda")
def _krylov_dots_cuda(a, b, c, d, partials, ndots):
    n = a.shape[0]
    if ndots not in (1, 2):
        raise ValueError("krylov_dots: ndots must be 1 or 2")
    _vectors("krylov_dots", n, a=a, b=b, c=c, d=d)
    _partials("krylov_dots", partials, ndots, n)
    _check_f64("krylov_dots", {"a": a, "b": b, "c": c, "d": d, "partials": partials})
    _launch("krylov_dots", torch.float64, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d.data_ptr(), partials.data_ptr(), n, ndots)


@torch.library.custom_op(
    "porepy_tpu_torch::bicgstab_s", mutates_args=("s", "shat", "partials")
)
def bicgstab_s(
    r: torch.Tensor, q: torch.Tensor, dinv: torch.Tensor, st: torch.Tensor,
    s: torch.Tensor, shat: torch.Tensor, partials: torch.Tensor,
) -> None:
    """In place: ``s = r - alpha_ q``, ``shat = dinv s``, partials of
    ``<s, s>`` into ``partials[0]``."""
    reference.bicgstab_s(r, q, dinv, st, s, shat, partials)


@bicgstab_s.register_kernel("cuda")
def _bicgstab_s_cuda(r, q, dinv, st, s, shat, partials):
    n = r.shape[0]
    _vectors("bicgstab_s", n, r=r, q=q, dinv=dinv, s=s, shat=shat)
    _partials("bicgstab_s", partials, 1, n)
    _check_f64("bicgstab_s", {"r": r, "q": q, "dinv": dinv, "st": st, "s": s,
                              "shat": shat, "partials": partials})
    _launch("bicgstab_s", torch.float64, r.data_ptr(), q.data_ptr(), dinv.data_ptr(),
            st.data_ptr(), s.data_ptr(), shat.data_ptr(), partials.data_ptr(), n)


@torch.library.custom_op(
    "porepy_tpu_torch::bicgstab_xr", mutates_args=("x", "r", "partials")
)
def bicgstab_xr(
    x: torch.Tensor, r: torch.Tensor, phat: torch.Tensor, shat: torch.Tensor,
    s: torch.Tensor, t: torch.Tensor, rhat: torch.Tensor, st: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """In place: the update of ``x`` and ``r`` that ends a BiCGStab
    iteration, partials of ``<r, r>`` and ``<rhat, r>`` into rows 0, 1."""
    reference.bicgstab_xr(x, r, phat, shat, s, t, rhat, st, partials)


@bicgstab_xr.register_kernel("cuda")
def _bicgstab_xr_cuda(x, r, phat, shat, s, t, rhat, st, partials):
    n = x.shape[0]
    vec = {"x": x, "r": r, "phat": phat, "shat": shat, "s": s, "t": t, "rhat": rhat}
    _vectors("bicgstab_xr", n, **vec)
    _partials("bicgstab_xr", partials, 2, n)
    _check_f64("bicgstab_xr", {**vec, "st": st, "partials": partials})
    _launch("bicgstab_xr", torch.float64, *(v.data_ptr() for v in vec.values()),
            st.data_ptr(), partials.data_ptr(), n)


@torch.library.custom_op(
    "porepy_tpu_torch::bicgstab_scalars", mutates_args=("st", "cont")
)
def bicgstab_scalars(
    partials: torch.Tensor, st: torch.Tensor, cont: torch.Tensor, stage: int
) -> None:
    """One block: finish the partial rows of ``stage`` (``reference.STAGE_*``)
    and run that stage of the scalar recurrence on ``st`` and ``cont``."""
    reference.bicgstab_scalars(partials, st, cont, stage)


@bicgstab_scalars.register_kernel("cuda")
def _bicgstab_scalars_cuda(partials, st, cont, stage):
    rows = {reference.STAGE_INIT: 1, reference.STAGE_ALPHA: 1,
            reference.STAGE_OMEGA: 3, reference.STAGE_NEXT: 2}
    if stage not in rows:
        raise ValueError(f"bicgstab_scalars: unknown stage {stage}")
    if partials.dim() != 2 or partials.shape[0] < rows[stage]:
        raise ValueError(f"bicgstab_scalars: stage {stage} needs {rows[stage]} partial rows")
    if st.shape != (reference.BICG_SLOTS,) or cont.shape != (1,):
        raise ValueError("bicgstab_scalars: needs the state and a (1,) flag")
    n = partials.shape[1] * reference.KRYLOV_BLOCK
    _check_f64("bicgstab_scalars", {"partials": partials, "st": st, "cont": cont}, ints=("cont",))
    _launch("bicgstab_scalars", torch.float64, partials.data_ptr(), st.data_ptr(),
            cont.data_ptr(), n, stage)


def _arnoldi_shapes(name, V, w, partials, flags, k, H=None):
    n = w.shape[0]
    restart = V.shape[0] - 1
    if V.dim() != 2 or V.shape[1] != n or not 0 <= k < restart:
        raise ValueError(f"{name}: needs V (restart + 1, n) and 0 <= k < restart")
    if restart > 30:
        raise ValueError(f"{name}: restart {restart} above 30")
    _partials(name, partials, restart + 3, n)
    if flags.shape != (restart + 1,):
        raise ValueError(f"{name}: flags must be (restart + 1,)")
    if H is not None and H.shape != (restart, restart + 1):
        raise ValueError(f"{name}: H must be (restart, restart + 1)")
    return n, restart


@torch.library.custom_op(
    "porepy_tpu_torch::cgs_project", mutates_args=("w", "partials")
)
def cgs_project(
    av: torch.Tensor, dinv: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
    partials: torch.Tensor, flags: torch.Tensor, k: int,
) -> None:
    """Arnoldi step ``k``: ``w = dinv av``, partials of ``V[:k+1] w`` and of
    ``<w, w>``; nothing after a breakdown (``flags[k]``)."""
    reference.cgs_project(av, dinv, V, w, partials, flags, k)


@cgs_project.register_kernel("cuda")
def _cgs_project_cuda(av, dinv, V, w, partials, flags, k):
    n, _ = _arnoldi_shapes("cgs_project", V, w, partials, flags, k)
    _vectors("cgs_project", n, av=av, dinv=dinv)
    _check_f64("cgs_project", {"av": av, "dinv": dinv, "V": V, "w": w,
                               "partials": partials, "flags": flags}, ints=("flags",))
    _launch("cgs_project", torch.float64, av.data_ptr(), dinv.data_ptr(), V.data_ptr(),
            w.data_ptr(), partials.data_ptr(), flags.data_ptr(), n, k)


@torch.library.custom_op(
    "porepy_tpu_torch::cgs_update", mutates_args=("w", "partials")
)
def cgs_update(
    V: torch.Tensor, w: torch.Tensor, partials: torch.Tensor, flags: torch.Tensor, k: int
) -> None:
    """``w <- w - V[:k+1]^T h`` with ``h`` finished from the partials, and
    the partials of ``<w, w>``."""
    reference.cgs_update(V, w, partials, flags, k)


@cgs_update.register_kernel("cuda")
def _cgs_update_cuda(V, w, partials, flags, k):
    n, _ = _arnoldi_shapes("cgs_update", V, w, partials, flags, k)
    _check_f64("cgs_update", {"V": V, "w": w, "partials": partials, "flags": flags}, ints=("flags",))
    _launch("cgs_update", torch.float64, V.data_ptr(), w.data_ptr(), partials.data_ptr(),
            flags.data_ptr(), n, k)


@torch.library.custom_op(
    "porepy_tpu_torch::cgs_normalize", mutates_args=("V", "H", "flags")
)
def cgs_normalize(
    w: torch.Tensor, V: torch.Tensor, H: torch.Tensor, partials: torch.Tensor,
    flags: torch.Tensor, k: int,
) -> None:
    """``V[k + 1] = w / |w|``, Hessenberg row ``k``, breakdown flag ``k + 1``."""
    reference.cgs_normalize(w, V, H, partials, flags, k)


@cgs_normalize.register_kernel("cuda")
def _cgs_normalize_cuda(w, V, H, partials, flags, k):
    n, restart = _arnoldi_shapes("cgs_normalize", V, w, partials, flags, k, H)
    _check_f64("cgs_normalize", {"w": w, "V": V, "H": H, "partials": partials,
                                 "flags": flags}, ints=("flags",))
    _launch("cgs_normalize", torch.float64, w.data_ptr(), V.data_ptr(), H.data_ptr(),
            partials.data_ptr(), flags.data_ptr(), n, k, restart)


@torch.library.custom_op("porepy_tpu_torch::gmres_lstsq", mutates_args=("y",))
def gmres_lstsq(H: torch.Tensor, st: torch.Tensor, y: torch.Tensor) -> None:
    """One block: ``y`` from the normal equations ``H H^T y = beta H[:, 0]``
    (Cholesky), jax's ``_lstsq`` of a GMRES restart."""
    reference.gmres_lstsq(H, st, y)


@gmres_lstsq.register_kernel("cuda")
def _gmres_lstsq_cuda(H, st, y):
    restart = H.shape[0]
    if H.dim() != 2 or H.shape[1] != restart + 1 or y.shape != (restart,) or not 1 <= restart <= 30:
        raise ValueError("gmres_lstsq: needs H (restart, restart + 1), y (restart,), restart <= 30")
    if st.shape != (reference.GMRES_SLOTS,):
        raise ValueError("gmres_lstsq: needs the GMRES state")
    _check_f64("gmres_lstsq", {"H": H, "st": st, "y": y})
    _launch("gmres_lstsq", torch.float64, H.data_ptr(), st.data_ptr(), y.data_ptr(), restart)


@torch.library.custom_op("porepy_tpu_torch::gmres_correct", mutates_args=("x",))
def gmres_correct(V: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> None:
    """``x <- x + V[:restart]^T y``."""
    reference.gmres_correct(V, y, x)


@gmres_correct.register_kernel("cuda")
def _gmres_correct_cuda(V, y, x):
    n, restart = x.shape[0], y.shape[0]
    if V.dim() != 2 or V.shape != (restart + 1, n):
        raise ValueError("gmres_correct: needs V (restart + 1, n), y (restart,), x (n,)")
    _check_f64("gmres_correct", {"V": V, "y": y, "x": x})
    _launch("gmres_correct", torch.float64, V.data_ptr(), y.data_ptr(), x.data_ptr(), n, restart)


@torch.library.custom_op(
    "porepy_tpu_torch::gmres_residual", mutates_args=("w", "partials")
)
def gmres_residual(
    b: torch.Tensor, ax: torch.Tensor, dinv: torch.Tensor, w: torch.Tensor,
    partials: torch.Tensor,
) -> None:
    """``w = dinv (b - ax)``, partials of ``<w, w>`` into row 0."""
    reference.gmres_residual(b, ax, dinv, w, partials)


@gmres_residual.register_kernel("cuda")
def _gmres_residual_cuda(b, ax, dinv, w, partials):
    n = b.shape[0]
    _vectors("gmres_residual", n, b=b, ax=ax, dinv=dinv, w=w)
    _partials("gmres_residual", partials, 1, n)
    _check_f64("gmres_residual", {"b": b, "ax": ax, "dinv": dinv, "w": w,
                                  "partials": partials})
    _launch("gmres_residual", torch.float64, b.data_ptr(), ax.data_ptr(), dinv.data_ptr(),
            w.data_ptr(), partials.data_ptr(), n)


@torch.library.custom_op(
    "porepy_tpu_torch::gmres_restart",
    mutates_args=("V", "H", "flags", "st", "cont"),
)
def gmres_restart(
    w: torch.Tensor, V: torch.Tensor, H: torch.Tensor, partials: torch.Tensor,
    flags: torch.Tensor, st: torch.Tensor, cont: torch.Tensor,
) -> None:
    """Start of a restart: ``V[0] = w / |w|``, the residual norm and the
    continue flag ``|w| > atol``, ``H = eye``, breakdown flags cleared."""
    reference.gmres_restart(w, V, H, partials, flags, st, cont)


@gmres_restart.register_kernel("cuda")
def _gmres_restart_cuda(w, V, H, partials, flags, st, cont):
    n = w.shape[0]
    restart = H.shape[0]
    if V.shape != (restart + 1, n) or H.shape != (restart, restart + 1) or not 1 <= restart <= 30:
        raise ValueError("gmres_restart: needs V (restart + 1, n), H (restart, restart + 1)")
    if flags.shape != (restart + 1,) or st.shape != (reference.GMRES_SLOTS,) or cont.shape != (1,):
        raise ValueError("gmres_restart: needs flags (restart + 1,), the state, a (1,) flag")
    _partials("gmres_restart", partials, 1, n)
    _check_f64("gmres_restart", {"w": w, "V": V, "H": H, "partials": partials,
                                 "flags": flags, "st": st, "cont": cont}, ints=("flags", "cont"))
    _launch("gmres_restart", torch.float64, w.data_ptr(), V.data_ptr(), H.data_ptr(),
            partials.data_ptr(), flags.data_ptr(), st.data_ptr(), cont.data_ptr(), n, restart)


# -- K17 --------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::rachford_rice", mutates_args=())
def rachford_rice(
    zs: torch.Tensor, K: torch.Tensor, max_iter: int, tol: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The constant-K flash at the points ``zs`` ``(nc, N)``: ``(V, x, y,
    converged, iters)`` (see :func:`porepy_tpu_torch.kernels.reference.rachford_rice`)."""
    return reference.rachford_rice(zs, K, max_iter, tol)


@rachford_rice.register_kernel("cuda")
def _rachford_rice_cuda(zs, K, max_iter, tol):
    if zs.dtype != torch.float64 or K.dtype != torch.float64:
        raise TypeError("rachford_rice: zs and K must be float64")
    if zs.dim() != 2 or K.shape != (zs.shape[0],) or not 1 <= zs.shape[0] <= 8:
        raise ValueError("rachford_rice: needs zs (nc, N), K (nc,), 1 <= nc <= 8")
    _check("rachford_rice", {"zs": zs, "K": K}, zs.dtype)
    nc, n = zs.shape
    V = torch.empty(n, dtype=zs.dtype, device=zs.device)
    x, y = torch.empty_like(zs), torch.empty_like(zs)
    converged = torch.empty(n, dtype=torch.bool, device=zs.device)
    iters = torch.empty(n, dtype=torch.int32, device=zs.device)
    _launch(
        "rachford_rice", zs.dtype,
        zs.data_ptr(), K.data_ptr(), V.data_ptr(), x.data_ptr(), y.data_ptr(),
        converged.data_ptr(), iters.data_ptr(), nc, n, max_iter, float(tol),
    )
    return V, x, y, converged, iters


@rachford_rice.register_fake
def _(zs, K, max_iter, tol):
    n = zs.shape[1]
    return (
        zs.new_empty(n), torch.empty_like(zs), torch.empty_like(zs),
        zs.new_empty(n, dtype=torch.bool), zs.new_empty(n, dtype=torch.int32),
    )


# -- K16 --------------------------------------------------------------------------


def _interp_cuda(values, fgeom, igeom, x, dx):
    d, n = x.shape
    if not 1 <= d <= 3:
        raise ValueError(f"interp_lookup: {d} parameters, the kernel takes 1 to 3")
    if any(t.dtype != torch.float64 for t in (values, fgeom, x)) or igeom.dtype != torch.int32 or (
        dx is not None and dx.dtype != torch.float64
    ):
        raise TypeError("interp_lookup: needs float64 values, fgeom, x, dx and int32 igeom")
    if values.dim() != 1 or fgeom.shape != (2 * d,) or igeom.shape != (2 * d,):
        raise ValueError("interp_lookup: needs flat values, fgeom = [low, h], igeom = [npt, strides]")
    tensors = {"values": values, "fgeom": fgeom, "igeom": igeom, "x": x}
    if dx is not None:
        if dx.dim() != 3 or dx.shape[1:] != (d, n):
            raise ValueError("interp_lookup: dx must be (B, d, N)")
        tensors["dx"] = dx
    _check("interp_lookup", tensors, torch.float64)
    if dx is None:
        out = torch.empty(n, dtype=x.dtype, device=x.device)
        ptrs = (0, out.data_ptr(), 0, 0)
    else:
        out = torch.empty((dx.shape[0], n), dtype=x.dtype, device=x.device)
        ptrs = (dx.data_ptr(), 0, out.data_ptr(), dx.shape[0])
    dx_ptr, out_ptr, dout_ptr, batch = ptrs
    _launch(
        "interp_lookup", torch.float64,
        values.data_ptr(), fgeom.data_ptr(), igeom.data_ptr(), x.data_ptr(),
        dx_ptr or None, out_ptr or None, dout_ptr or None, d, n, batch,
    )
    return out


@torch.library.custom_op("porepy_tpu_torch::interp_lookup", mutates_args=())
def interp_lookup(
    values: torch.Tensor, fgeom: torch.Tensor, igeom: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Multilinear table lookup at the points ``x`` ``(d, N)``, ``d <= 3``;
    ``fgeom = [low, h]`` float64, ``igeom = [npt, strides]`` int32."""
    return reference.interp_lookup(values, fgeom, igeom, x)


@interp_lookup.register_kernel("cuda")
def _interp_lookup_cuda(values, fgeom, igeom, x):
    return _interp_cuda(values, fgeom, igeom, x, None)


@interp_lookup.register_fake
def _(values, fgeom, igeom, x):
    return x.new_empty(x.shape[1])


@torch.library.custom_op("porepy_tpu_torch::interp_tangent", mutates_args=())
def interp_tangent(
    values: torch.Tensor, fgeom: torch.Tensor, igeom: torch.Tensor, x: torch.Tensor,
    dx: torch.Tensor,
) -> torch.Tensor:
    """Tangents ``(B, N)`` of :func:`interp_lookup` at ``x`` for the seeds
    ``dx`` ``(B, d, N)``; the same kernel as the lookup, so its launches
    count under ``interp_lookup``."""
    return reference.interp_tangent(values, fgeom, igeom, x, dx)


@interp_tangent.register_kernel("cuda")
def _interp_tangent_cuda(values, fgeom, igeom, x, dx):
    return _interp_cuda(values, fgeom, igeom, x, dx)


@interp_tangent.register_fake
def _(values, fgeom, igeom, x, dx):
    return x.new_empty((dx.shape[0], x.shape[1]))


# -- K11 --------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::block_inverse", mutates_args=())
def block_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, n, n)`` float64 matrices ``a`` by Gauss-Jordan
    elimination with partial pivoting (see
    :func:`porepy_tpu_torch.kernels.reference.block_inverse`)."""
    return reference.block_inverse(a)


@block_inverse.register_kernel("cuda")
def _block_inverse_cuda(a):
    if a.dtype != torch.float64:
        raise TypeError("block_inverse: a must be float64")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError("block_inverse: needs (B, n, n) matrices")
    _check("block_inverse", {"a": a}, a.dtype)
    B, n = a.shape[0], a.shape[1]
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    work = None
    if 8 * n * (2 * n + 1) > _SMEM_MAX:
        work = torch.empty((B, n, 2 * n), dtype=a.dtype, device=a.device)
    _launch(
        "block_inverse", a.dtype,
        a.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), B, n,
    )
    return out


@block_inverse.register_fake
def _(a):
    return torch.empty_like(a)


# -- K19 --------------------------------------------------------------------------


@torch.library.custom_op("porepy_tpu_torch::halo_pack", mutates_args=())
def halo_pack(x_own: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The send buffer ``x_own[send_idx]`` of a halo exchange; ``send_idx``
    int32, grouped by destination rank."""
    return reference.halo_pack(x_own, send_idx)


@halo_pack.register_kernel("cuda")
def _halo_pack_cuda(x_own, send_idx):
    if send_idx.dtype != torch.int32:
        raise TypeError("halo_pack: send_idx must be int32")
    if x_own.dim() != 1 or send_idx.dim() != 1:
        raise ValueError("halo_pack: needs (n_own,) x_own and (n_send,) send_idx")
    _check("halo_pack", {"x_own": x_own, "send_idx": send_idx}, x_own.dtype)
    send = torch.empty(send_idx.shape[0], dtype=x_own.dtype, device=x_own.device)
    if send.numel():
        _launch("halo_pack", x_own.dtype, x_own.data_ptr(), send_idx.data_ptr(),
                send.data_ptr(), send.numel())
    return send


@halo_pack.register_fake
def _(x_own, send_idx):
    return x_own.new_empty(send_idx.shape[0])


@torch.library.custom_op("porepy_tpu_torch::ell_spmv_split", mutates_args=())
def ell_spmv_split(
    val: torch.Tensor, col: torch.Tensor, x_own: torch.Tensor, x_halo: torch.Tensor
) -> torch.Tensor:
    """The owned rows of ``A @ x`` from ``x_own`` and the received halo
    ``x_halo``, not concatenated: ``col`` below ``n_own`` reads ``x_own``,
    from ``n_own`` ``x_halo``, ``n_own + n_halo`` is padding (see
    :func:`porepy_tpu_torch.kernels.reference.ell_spmv_split`)."""
    return reference.ell_spmv_split(val, col, x_own, x_halo)


@ell_spmv_split.register_kernel("cuda")
def _ell_spmv_split_cuda(val, col, x_own, x_halo):
    dtype = x_own.dtype
    if col.dtype != torch.int32 or val.dtype != dtype or x_halo.dtype != dtype:
        raise TypeError("ell_spmv_split: needs val, x_own, x_halo of one dtype and int32 col")
    if val.dim() != 2 or col.shape != val.shape or x_own.dim() != 1 or x_halo.dim() != 1:
        raise ValueError("ell_spmv_split: needs (n, K) val and col, 1-d x_own and x_halo")
    _check("ell_spmv_split", {"val": val, "col": col, "x_own": x_own, "x_halo": x_halo}, dtype)
    n_rows, K = val.shape
    y = torch.empty(n_rows, dtype=dtype, device=x_own.device)
    if n_rows:
        _launch(
            "ell_spmv_split", dtype,
            val.data_ptr(), col.data_ptr(), x_own.data_ptr(), x_halo.data_ptr(),
            y.data_ptr(), n_rows, K, x_own.shape[0], x_halo.shape[0],
        )
    return y


@ell_spmv_split.register_fake
def _(val, col, x_own, x_halo):
    return x_own.new_empty(val.shape[0])
