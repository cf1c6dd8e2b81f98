"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
with ordinary tensor operations. The kernel wrappers in
:mod:`porepy_tpu_torch.kernels.ops` call these for tensors on the CPU; the
tests and ``chip_smoke.py`` hold each kernel against its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "ell_spmv",
    "ell_jacobi_sweep",
    "jacobi_sweeps",
    "amg_vcycle",
    "dense_block_scatter",
    "gj_pivot_inverse",
    "dense_block_apply",
    "structured_residual",
    "structured_residual_rho",
    "structured_jvp",
    "structured_refine",
    "fma",
    "structured_linearize",
    "stencil_matvec",
    "tpfa_residual",
    "tpfa_jvp",
    "tpfa_linearize",
    "region_solve_contract",
    "region_solve_ordered",
    "KRYLOV_BLOCK",
    "block_partials",
    "finish",
    "ell_spmv_ordered",
    "fgmres_arnoldi",
    "fgmres_arnoldi_split",
    "bicgstab_p",
    "krylov_dots",
    "bicgstab_s",
    "bicgstab_xr",
    "bicgstab_scalars",
    "bicgstab_cycle",
    "bicgstab_stencil",
    "bicgstab_tpfa",
    "cgs_project",
    "cgs_update",
    "cgs_normalize",
    "gmres_lstsq",
    "gmres_correct",
    "gmres_residual",
    "gmres_restart",
    "csr_ell",
    "gmres_cycle",
    "rachford_rice",
    "rachford_rice_full",
    "rachford_rice_iterates",
    "flash_iteration_stats",
    "flash_work",
    "same_bits",
    "FLASH_RING",
    "interp_lookup",
    "interp_tangent",
    "corner_table",
    "interp_dual",
    "block_inverse",
    "halo_pack",
    "ell_spmv_split",
    "halo_interior",
    "halo_boundary",
    "upwind_select",
    "upwind_select_pair",
    "upwind_masks",
    "upwind_flux",
    "upwind_flux_tangent",
    "UPWIND_KINDS",
    "upwind_dual",
    "segment_sum_sorted",
    "tpfa_ad_flux",
    "tpfa_ad_trace",
    "tpfa_ad_tangent",
    "tpfa_ad_dual",
    "DUAL_OPCODES",
    "DUAL_OP",
    "DUAL_MAX_INPUTS",
    "DUAL_MAX_INSTRS",
    "dual_ew",
    "dual_seed_rows",
    "dual_gather_var",
    "dual_gather_copy",
    "jac_gather",
    "dual_ew_scatter",
]


def ell_spmv(
    val: torch.Tensor, col: torch.Tensor, x: torch.Tensor, c=None, sign: int = 1
) -> torch.Tensor:
    """``y = c + sign * (A x)`` for A in padded-row (ELL) form: ``val``/``col``
    of shape ``(n_rows, K)``, padding columns equal to ``x.shape[-1]`` read
    zero. ``x`` is ``(n_cols,)`` or ``(B, n_cols)``; ``c`` (optional) has the
    result's shape, ``sign`` is 1 or -1. ``A x`` is rounded to the type
    before ``c`` is added: ``c - A x`` and ``c + A x`` as two operations."""
    pad = x.new_zeros(x.shape[:-1] + (1,))
    x_p = torch.cat([x, pad], dim=-1)
    y = (val * x_p[..., col]).sum(dim=-1)
    if sign < 0:
        y = -y
    return y if c is None else c + y


def ell_jacobi_sweep(
    val: torch.Tensor,
    col: torch.Tensor,
    sinv: torch.Tensor,
    r: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """One smoother sweep ``y + sinv * (r - A y)`` for square ELL ``A``
    (:func:`jacobi_sweeps` with ``s = 1``)."""
    return jacobi_sweeps(val, col, sinv, r, y, 1)


def jacobi_sweeps(val, col, sinv, r, y, s: int) -> torch.Tensor:
    """``s`` sweeps ``y <- y + sinv * (r - A y)`` from ``y``, or from ``y =
    sinv * r`` when ``y`` is None, as the kernel rounds them: each row of
    ``A y`` summed in slot order (:func:`ell_spmv_ordered`), then the
    subtraction, the product and the sum, each rounded."""
    y = sinv * r if y is None else y
    for _ in range(s):
        y = y + sinv * (r - ell_spmv_ordered(val, col, y))
    return y


def amg_vcycle(levels, coarse_inv: torch.Tensor, r: torch.Tensor, nu: int) -> torch.Tensor:
    """The V(``nu``, ``nu``) cycle of ``amg.Hierarchy`` over ``levels`` (dicts
    of the ELL tensors ``A_*``, ``P_*``, ``R_*`` and ``sinv``) and the coarse
    inverse, as the kernel rounds it: rows of every product summed in slot
    order, the coarse product row by row in column order."""
    return _vcycle(levels, coarse_inv, r, nu, 0)


def _vcycle(levels, coarse_inv, r, nu: int, l: int) -> torch.Tensor:
    if l == len(levels):
        acc = r.new_zeros(coarse_inv.shape[0])
        for k in range(coarse_inv.shape[1]):
            acc = acc + coarse_inv[:, k] * r[k]
        return acc
    lv = levels[l]
    A, sinv = (lv["A_val"], lv["A_col"]), lv["sinv"]
    y = jacobi_sweeps(*A, sinv, r, None, max(nu - 1, 0))
    r_c = ell_spmv_ordered(lv["R_val"], lv["R_col"], r - ell_spmv_ordered(*A, y))
    y = y + ell_spmv_ordered(lv["P_val"], lv["P_col"], _vcycle(levels, coarse_inv, r_c, nu, l + 1))
    return jacobi_sweeps(*A, sinv, r, y, nu)


def dense_block_scatter(
    vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, ni: int, n_pad: int
) -> torch.Tensor:
    """The ``(n_pad, n_pad)`` matrix holding coalesced COO entries
    ``(rows, cols, vals)`` (no duplicate positions), with ones on the
    diagonal of the pad rows ``ni <= i < n_pad``, zeros elsewhere."""
    D = vals.new_zeros((n_pad, n_pad))
    D[rows.long(), cols.long()] = vals
    pad = torch.arange(ni, n_pad, device=vals.device)
    D[pad, pad] = 1.0
    return D


def gj_pivot_inverse(a: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, b, b)`` matrices ``a`` by LU with partial
    pivoting; sets ``flag[m] = 1`` (never clears it) where matrix ``m`` is
    singular or its inverse is not finite."""
    inv, info = torch.linalg.inv_ex(a)
    bad = (info != 0) | ~torch.isfinite(inv).flatten(1).all(dim=1)
    flag.copy_(torch.where(bad, torch.ones_like(flag), flag))
    return inv


def dense_block_apply(D: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``(D @ pad(r))[:ni]`` in float32, cast back to ``r``'s dtype;
    ``ni = r.numel()``, the pad is zero up to ``D.shape[1]``."""
    ni = r.shape[0]
    rp = torch.nn.functional.pad(r.to(torch.float32), (0, D.shape[1] - ni))
    return (D @ rp)[:ni].to(r.dtype)


# -- K12 --------------------------------------------------------------------------

# Veltkamp's splitting constant, 2^ceil(p / 2) + 1, and the integer view of
# each type (the last mantissa bit of a value).
_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = _SPLIT[a.dtype] * a
    hi = c - (c - a)
    return hi, a - hi


def _fma_values(a, b, c):
    a, b, c = torch.broadcast_tensors(a, b, c)
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(_BITS[v.dtype]) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(v, float("inf")), torch.full_like(v, float("-inf")))
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    out = th + v
    # A product that is 0 or not finite needs no correction term.
    return torch.where(torch.isfinite(uh) & (uh != 0), out, uh + c)


class _Fma(torch.autograd.Function):
    """:func:`fma` with its tangent ``da b + a db + dc`` (``torch.func``'s
    forward mode and ``vmap`` go through it)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, c):
        return _fma_values(a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0], inputs[1])

    @staticmethod
    def jvp(ctx, da, db, dc):
        a, b = ctx.saved_tensors
        out = None
        for term in (None if da is None else da * b, None if db is None else a * db, dc):
            if term is not None:
                out = term if out is None else out + term
        return out


def fma(a, b, c):
    """``a * b + c`` rounded once, as the card's fused multiply-add rounds
    it, from operations of the operands' type: Dekker's exact product ``uh
    + ul``, ``th + tl = c + uh`` exactly, ``v = tl + ul`` rounded to odd,
    then ``th + v`` rounded to nearest (Boldo and Melquiond's emulation;
    exact for operands whose products neither overflow nor underflow). The
    K12 kernels' faces are formed so, where ``nvcc`` contracts a product and
    a sum into one instruction."""
    return _Fma.apply(a, b, c)


def _density(p, coef):
    return coef[0] * torch.exp(coef[1] * (p - coef[3]))


def _padded(p, ghosts, axis):
    return torch.cat([ghosts[0].unsqueeze(axis), p, ghosts[1].unsqueeze(axis)], axis)


def structured_residual(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """Mass-balance residual of the 7-point TPFA stencil on an ``(nx, ny,
    nz)`` grid with Dirichlet ghost values ``pbc_*`` on the six sides;
    ``coef = [rho_ref, comp, visc, p_ref, dt]``. The upwind side follows
    the sign of the (detached) flux. Each cell's divergence term along an
    axis, its low face's mass flux less its high face's, is
    ``fma(-w_hi, q_hi, w_lo q_lo)``, as the kernel forms it."""
    visc, dt = coef[2], coef[4]

    def axis_difference(t, ghosts, axis):
        pg = _padded(p, ghosts, axis)
        m = pg.shape[axis] - 1
        lo, hi = pg.narrow(axis, 0, m), pg.narrow(axis, 1, m)
        q = t * (lo - hi)
        w = torch.where(q.detach() >= 0, _density(lo, coef), _density(hi, coef)) / visc
        k = m - 1
        w_lo, q_lo = w.narrow(axis, 0, k), q.narrow(axis, 0, k)
        return fma(-w.narrow(axis, 1, k), q.narrow(axis, 1, k), w_lo * q_lo)

    div = (axis_difference(tx, pbc_x, 0) + axis_difference(ty, pbc_y, 1)) + axis_difference(tz, pbc_z, 2)
    accumulation = pv * (_density(p, coef) - _density(p_prev, coef)) / dt
    return accumulation - div


def structured_residual_rho(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``(residual, rho)``: :func:`structured_residual` and the cell
    densities ``rho(p)`` that the step's refinement reads
    (:func:`structured_refine`)."""
    return structured_residual(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef), _density(p, coef)


def _structured_tangent(p, dp, rho, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``J(p) dp`` with the cell densities ``rho`` given and the ghosts'
    computed; a face's tangent ``dw q + w dq`` is ``fma(w, dq, dw q)``, as
    the kernel forms it."""
    comp, visc, dt = coef[1], coef[2], coef[4]

    def axis_tangent(t, ghosts, axis):
        zero = torch.zeros_like(ghosts[0])
        pg = _padded(p, ghosts, axis)
        dg = _padded(dp, (zero, zero), axis)
        rg = _padded(rho, (_density(ghosts[0], coef), _density(ghosts[1], coef)), axis)
        m = pg.shape[axis] - 1
        lo, hi = pg.narrow(axis, 0, m), pg.narrow(axis, 1, m)
        dlo, dhi = dg.narrow(axis, 0, m), dg.narrow(axis, 1, m)
        rlo, rhi = rg.narrow(axis, 0, m), rg.narrow(axis, 1, m)
        q = t * (lo - hi)
        dq = t * (dlo - dhi)
        up = q >= 0
        w = torch.where(up, rlo, rhi) / visc
        dw = torch.where(up, comp * rlo * dlo, comp * rhi * dhi) / visc
        return fma(w, dq, dw * q)

    fx = axis_tangent(tx, pbc_x, 0)
    fy = axis_tangent(ty, pbc_y, 1)
    fz = axis_tangent(tz, pbc_z, 2)
    div = (fx[:-1] - fx[1:]) + (fy[:, :-1] - fy[:, 1:]) + (fz[:, :, :-1] - fz[:, :, 1:])
    return pv * (comp * rho * dp) / dt - div


def structured_jvp(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``J(p) dp`` of :func:`structured_residual`: its forward-mode
    derivative written out (upwind side fixed by the primal flux, ghost
    tangents 0). The tests hold it against ``torch.func.jvp`` of the
    residual, which costs ten times more per call."""
    return _structured_tangent(p, dp, _density(p, coef), tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


def structured_refine(p, dx, c, rho, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``c - J(p) dx`` with the cell densities ``rho`` of
    :func:`structured_residual_rho`: the refinement round of the structured
    Newton step, with ``c = -r``; the bits of ``c -
    structured_jvp(p, dx, ...)``."""
    return c - _structured_tangent(p, dx, rho, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef)


def _face_coefficients(t, p_lo, p_hi, coef):
    """A face's tangent ``dm = a_lo d_lo + a_hi d_hi`` at the frozen ``p``,
    the upwind side fixed by the sign of ``q = t (p_lo - p_hi)``: returns
    ``(a_lo, a_hi)`` (see ``csrc/structured_flow.cu``)."""
    comp, visc = coef[1], coef[2]
    r_lo, r_hi = _density(p_lo, coef), _density(p_hi, coef)
    q = t * (p_lo - p_hi)
    up = q >= 0
    wt = torch.where(up, r_lo, r_hi) / visc * t
    return (
        torch.where(up, comp * r_lo / visc * q + wt, wt),
        torch.where(up, -wt, comp * r_hi / visc * q - wt),
    )


def structured_linearize(p, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``J(p)`` of :func:`structured_residual` as a 7-point stencil, ``(7,
    nx, ny, nz)``: the centre, then the x-, x+, y-, y+, z-, z+ neighbours'
    coefficients (0 where the neighbour is a Dirichlet ghost, whose tangent
    is 0), so that :func:`stencil_matvec` is :func:`structured_jvp`."""
    comp, dt = coef[1], coef[4]

    def axis_coefficients(t, ghosts, axis):
        pg = torch.cat([ghosts[0].unsqueeze(axis), p, ghosts[1].unsqueeze(axis)], axis)
        m = pg.shape[axis] - 1
        return _face_coefficients(t, pg.narrow(axis, 0, m), pg.narrow(axis, 1, m), coef)

    centre = pv * (comp * _density(p, coef)) / dt
    out = [None] * 6
    for axis, (t, ghosts) in enumerate(((tx, pbc_x), (ty, pbc_y), (tz, pbc_z))):
        a_lo, a_hi = axis_coefficients(t, ghosts, axis)
        m = a_lo.shape[axis] - 1
        centre = centre - a_hi.narrow(axis, 0, m) + a_lo.narrow(axis, 1, m)
        low, high = -a_lo.narrow(axis, 0, m), a_hi.narrow(axis, 1, m).clone()
        low.narrow(axis, 0, 1).zero_()
        high.narrow(axis, m - 1, 1).zero_()
        out[2 * axis], out[2 * axis + 1] = low, high
    return torch.stack([centre] + out)


def stencil_matvec(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``J x`` for the stencil ``coef`` ``(7, nx, ny, nz)`` of
    :func:`structured_linearize` and a flat ``x``, as the K12 cycle's rows
    form it: ``c_0 x_i``, then each neighbour's product (``x`` read as 0
    outside the grid) added in the order x-, x+, y-, y+, z-, z+."""
    xs = x.view(coef.shape[1:])
    xp = torch.nn.functional.pad(xs, (1, 1, 1, 1, 1, 1))
    neighbours = (
        xp[:-2, 1:-1, 1:-1], xp[2:, 1:-1, 1:-1], xp[1:-1, :-2, 1:-1],
        xp[1:-1, 2:, 1:-1], xp[1:-1, 1:-1, :-2], xp[1:-1, 1:-1, 2:],
    )
    acc = coef[0] * xs
    for k, xn in enumerate(neighbours, 1):
        acc = acc + coef[k] * xn
    return acc.reshape(-1)


# -- K13 --------------------------------------------------------------------------


def _tpfa_face_values(p, lo, hi, bc_val):
    lo_ok, hi_ok = lo >= 0, hi >= 0
    p_lo = torch.where(lo_ok, p[lo.clamp(min=0).long()], bc_val)
    p_hi = torch.where(hi_ok, p[hi.clamp(min=0).long()], bc_val)
    return p_lo, p_hi


def tpfa_rows(cell_ptr, cell_faces):
    """Each cell's row of the cell-to-face CSR padded to the longest row:
    ``(face, own, valid)``, each ``(nc, D)``: the face of entry ``j`` of
    the cell's row, whether the cell is that face's ``lo`` (the entry
    ``f``, else ``-f - 1``), and whether the row has an entry ``j``."""
    nc = cell_ptr.shape[0] - 1
    start, deg = cell_ptr[:-1].long(), (cell_ptr[1:] - cell_ptr[:-1]).long()
    width = int(deg.max()) if nc > 0 else 0
    j = torch.arange(width, device=cell_ptr.device)
    valid = j < deg[:, None]
    cf = cell_faces.long()
    code = cf[torch.where(valid, start[:, None] + j, 0)] if cf.numel() else torch.zeros_like(valid, dtype=torch.long)
    own = code >= 0
    return torch.where(own, code, -code - 1), own, valid


def _tpfa_divergence(face_values, cell_ptr, cell_faces):
    """Per cell, ``+m[f]`` over the faces where it is ``lo`` and ``-m[f]``
    where it is ``hi``, added to 0 one at a time in ``cell_faces`` order,
    as the kernel's walk adds them."""
    face, own, valid = tpfa_rows(cell_ptr, cell_faces)
    m = face_values[face]
    terms = torch.where(own, m, -m)
    acc = face_values.new_zeros(valid.shape[0])
    for j in range(valid.shape[1]):
        acc = torch.where(valid[:, j], acc + terms[:, j], acc)
    return acc


def _tpfa_mass_flux(p, lo, hi, t, is_neu, bc_val, coef):
    """Each face's mass flux: its prescribed flux on a Neumann face, else
    ``w q`` with ``q = t (p_lo - p_hi)`` and ``w`` the upwind density over
    the viscosity (the side chosen by the detached ``q``)."""
    p_lo, p_hi = _tpfa_face_values(p, lo, hi, bc_val)
    q = torch.where(is_neu, bc_val, t * (p_lo - p_hi))
    upstream = q.detach() >= 0
    w = torch.where(upstream, _density(p_lo, coef), _density(p_hi, coef)) / coef[2]
    return torch.where(is_neu, q, w * q)


def tpfa_residual(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    """Mass-balance residual of the unstructured TPFA flow step: face mass
    fluxes (Dirichlet ghosts from ``bc_val`` where ``lo``/``hi`` is -1,
    prescribed fluxes on ``is_neu`` faces, detached upwind choice), summed
    into each cell through the CSR ``cell_ptr``/``cell_faces`` (``f`` where
    the cell is ``lo[f]``, ``-f - 1`` where it is ``hi[f]``) in its order,
    then added to the accumulation ``pv (rho(p) - rho(p_prev)) / dt``, its
    difference ``fma(rho_ref, exp(comp (p - p_ref)), -rho(p_prev))``, as the
    kernel forms it."""
    div = _tpfa_divergence(_tpfa_mass_flux(p, lo, hi, t, is_neu, bc_val, coef), cell_ptr, cell_faces)
    growth = torch.exp(coef[1] * (p - coef[3]))
    accumulation = pv * fma(coef[0], growth, -_density(p_prev, coef)) / coef[4]
    return accumulation + div


def tpfa_jvp(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    """``J(p) dp`` of :func:`tpfa_residual`: its forward-mode derivative
    written out (upwind side fixed by the primal flux, ghost tangents 0, a
    Neumann face's tangent 0). A face's tangent ``dw q + w dq`` is
    ``fma(dw, q, w dq)``, as the kernel forms it. The tests hold it
    against ``torch.func.jvp`` of the residual."""
    comp, visc, dt = coef[1], coef[2], coef[4]
    p_lo, p_hi = _tpfa_face_values(p, lo, hi, bc_val)
    d_lo, d_hi = _tpfa_face_values(dp, lo, hi, torch.zeros_like(bc_val))
    q = torch.where(is_neu, bc_val, t * (p_lo - p_hi))
    dq = torch.where(is_neu, torch.zeros_like(q), t * (d_lo - d_hi))
    r_lo, r_hi = _density(p_lo, coef), _density(p_hi, coef)
    up = q >= 0
    w = torch.where(up, r_lo, r_hi) / visc
    dw = torch.where(up, comp * r_lo * d_lo, comp * r_hi * d_hi) / visc
    dmass = torch.where(is_neu, dq, fma(dw, q, w * dq))
    div = _tpfa_divergence(dmass, cell_ptr, cell_faces)
    return pv * (comp * _density(p, coef) * dp) / dt + div


def _tpfa_face_coefficients(t, p_lo, p_hi, coef):
    """A face's tangent ``dm = a_lo d_lo + a_hi d_hi`` at the frozen ``p``,
    the upwind side fixed by the sign of ``q = t (p_lo - p_hi)``: ``(a_lo,
    a_hi)``, with ``wt = w t``, ``a_lo = fma(comp rho / visc, q, wt)`` and
    ``a_hi = (comp rho / visc) q - wt`` (the product rounded), as the kernel
    forms them (see ``csrc/tpfa_flow.cu``)."""
    comp, visc = coef[1], coef[2]
    r_lo, r_hi = _density(p_lo, coef), _density(p_hi, coef)
    q = t * (p_lo - p_hi)
    up = q >= 0
    wt = torch.where(up, r_lo, r_hi) / visc * t
    return (
        torch.where(up, fma(comp * r_lo / visc, q, wt), wt),
        torch.where(up, -wt, comp * r_hi / visc * q - wt),
    )


def tpfa_linearize(p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot,
                   nnz: int):
    """``J(p)`` of :func:`tpfa_residual` as the ``nnz`` values of a cell-cell
    CSR matrix on a fixed pattern: ``slot[e]`` is the value index of entry
    ``e`` of ``cell_faces``'s neighbour (-1 on a boundary face),
    ``diag_slot[c]`` that of cell ``c``'s diagonal. Each cell walks its row
    in ``cell_faces`` order, as the kernel does: the diagonal from ``pv
    (comp rho(p)) / dt`` gains ``a_lo`` where the cell is ``lo`` and loses
    ``a_hi`` where it is ``hi``, the neighbour's value (from 0) gains
    ``a_hi`` or loses ``a_lo``. Neumann faces add nothing (their flux is
    prescribed)."""
    comp, dt = coef[1], coef[4]
    p_lo, p_hi = _tpfa_face_values(p, lo, hi, bc_val)
    a_lo, a_hi = _tpfa_face_coefficients(t, p_lo, p_hi, coef)
    face, own, valid = tpfa_rows(cell_ptr, cell_faces)
    live = valid & ~is_neu[face]
    lo_f, hi_f = a_lo[face], a_hi[face]
    to_diag = torch.where(own, lo_f, -hi_f)
    to_other = torch.where(own, hi_f, -lo_f)
    nc, width = valid.shape
    k = torch.full((nc, width), -1, dtype=torch.long, device=p.device)
    if width:
        k[valid] = slot.long()
    diag = pv * (comp * _density(p, coef)) / dt
    vals = p.new_zeros(nnz)
    for j in range(width):
        diag = torch.where(live[:, j], diag + to_diag[:, j], diag)
        # A cell's slots are its own, so one column writes each slot once.
        sel = live[:, j] & (k[:, j] >= 0)
        kj = k[sel, j]
        vals[kj] = vals[kj] + to_other[sel, j]
    vals[diag_slot.long()] = diag
    return vals


def tpfa_jacobi_diagonal(p, t_sum, pv, coef):
    """The Newton step's Jacobi diagonal (``TpfaFlowKernel._jacobi_diagonal``):
    ``t_sum w + ((pv comp) rho) / dt`` with ``w = rho(p) / visc``, 1 where
    its magnitude is at most 1e-30."""
    rho = _density(p, coef)
    diag = t_sum * (rho / coef[2])
    diag = diag + pv * coef[1] * rho / coef[4]
    return torch.where(torch.abs(diag) > 1e-30, diag, torch.ones_like(diag))


def tpfa_step(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, t_sum, slot, diag_slot,
              nnz: int):
    """The unstructured Newton step's operands at ``p``: ``(r, vals,
    diag)``, :func:`tpfa_residual`, :func:`tpfa_linearize` and
    :func:`tpfa_jacobi_diagonal`, which the kernel's one launch writes."""
    args = (lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)
    return (tpfa_residual(p, p_prev, *args), tpfa_linearize(p, *args, slot, diag_slot, nnz),
            tpfa_jacobi_diagonal(p, t_sum, pv, coef))


# -- K10 --------------------------------------------------------------------------


def region_solve_contract(a: torch.Tensor, rhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per region of the batch: ``W @ solve(A / s, RHS / s)``, with ``s``
    the row maxima of ``|A|`` (1 for a zero row). ``a`` is ``(B, n, n)``,
    ``rhs`` ``(B, n, m)``, ``w`` ``(B, q, n)``; returns ``(B, q, m)``."""
    scale = a.abs().amax(dim=2, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    x = torch.linalg.solve(a / scale, rhs / scale)
    return w @ x


def region_solve_ordered(a: torch.Tensor, rhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`region_solve_contract` with the kernel's operations in the
    kernel's order, so that the two agree to the bit: rows of ``[A | RHS]``
    divided by their scale; per column ``k`` the first row ``i >= k`` of
    largest ``|M[i, k]|`` (NaN the largest) swapped into row ``k``, the
    multipliers ``M[i, k] / M[k, k]`` and ``M[i, j] - l_i M[k, j]`` (product
    and difference rounded apart) for the rows below and the columns right
    of ``k``; back substitution column by column from the last row, ``x_k =
    y_k / u_kk``, then ``y_i - u_ik x_k`` above it; ``OUT = W X`` as a sum
    over ``j`` ascending from 0.0, each product rounded before it is added.
    A zero pivot leaves inf/NaN, as the LU does."""
    B, n, _ = a.shape
    scale = a.abs().amax(dim=2, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    M = torch.cat([a / scale, rhs / scale], dim=2)
    batch = torch.arange(B, device=a.device)
    for k in range(n):
        p = k + torch.argmax(M[:, k:, k].abs(), dim=1)
        row_k = M[:, k].clone()
        M[:, k] = M[batch, p]
        M[batch, p] = row_k
        lk = M[:, k + 1 :, k] / M[:, k, k : k + 1]
        M[:, k + 1 :, k + 1 :] = M[:, k + 1 :, k + 1 :] - lk[:, :, None] * M[:, None, k, k + 1 :]
    for k in range(n - 1, -1, -1):
        x = M[:, k, n:] / M[:, k, k : k + 1]
        M[:, k, n:] = x
        M[:, :k, n:] = M[:, :k, n:] - M[:, :k, k : k + 1] * x[:, None, :]
    X = M[:, :, n:]
    out = torch.zeros((B, w.shape[1], rhs.shape[2]), dtype=a.dtype, device=a.device)
    for j in range(n):
        out = out + w[:, :, j : j + 1] * X[:, None, j, :]
    return out


# -- K18 --------------------------------------------------------------------------

#: Threads per block of the K18 kernels (``kBlock`` in ``csrc/krylov.cu``): a
#: dot product over ``n`` entries leaves ``ceil(n / KRYLOV_BLOCK)`` partials.
KRYLOV_BLOCK = 128

# Scalar slots of the BiCGStab state ``st`` and its stages.
BICG_RHO, BICG_ALPHA, BICG_OMEGA, BICG_RHO_NEW, BICG_BETA, BICG_ATOL2 = range(6)
BICG_ALPHA_NEW, BICG_OMEGA_NEW, BICG_EXIT, BICG_RR = range(6, 10)
BICG_SLOTS = 10
STAGE_INIT, STAGE_ALPHA, STAGE_OMEGA, STAGE_NEXT = range(4)
# Rows of the BiCGStab partial sums (``kPart*`` in ``csrc/krylov.cu``):
# <rhat, q>, <s, s>, <t, s>, <t, t>, <r, r>, <rhat, r>.
BICG_RQ, BICG_SS, BICG_TS, BICG_TT, BICG_RR_ROW, BICG_HR = range(6)
BICG_ROWS = 6
# Scalar slots of the GMRES state.
GMRES_ATOL, GMRES_RESNORM = range(2)
GMRES_SLOTS = 2

_EPS = torch.finfo(torch.float64).eps


def _tree(p: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis (``KRYLOV_BLOCK`` wide) in the kernels'
    ``block_sum`` tree: entry ``t`` adds entry ``t + s`` for ``s = 64, 32,
    ..., 1``."""
    s = KRYLOV_BLOCK // 2
    while s:
        p = p[..., :s] + p[..., s : 2 * s]
        s //= 2
    return p[..., 0]


def block_partials(v: torch.Tensor) -> torch.Tensor:
    """The per-block partial sums of ``v`` (length ``n``) in the kernels'
    blocking and order: ``ceil(n / KRYLOV_BLOCK)`` sums of consecutive
    entries (rows ``(m, n)`` give ``(m, nb)``)."""
    n = v.shape[-1]
    nb = -(-n // KRYLOV_BLOCK)
    v = torch.nn.functional.pad(v, (0, nb * KRYLOV_BLOCK - n))
    return _tree(v.view(v.shape[:-1] + (nb, KRYLOV_BLOCK)))


def finish(partials: torch.Tensor) -> torch.Tensor:
    """The sums of the rows of ``partials`` ``(m, nb)`` in the kernels'
    ``row_sum`` order: thread ``t`` adds partials ``t, t + 128, ...`` from
    0.0, then the ``block_sum`` tree."""
    m, nb = partials.shape
    acc = partials.new_zeros((m, KRYLOV_BLOCK))
    for t0 in range(0, nb, KRYLOV_BLOCK):
        w = min(KRYLOV_BLOCK, nb - t0)
        acc[:, :w] = acc[:, :w] + partials[:, t0 : t0 + w]
    return _tree(acc)


def _seq_sum(terms) -> torch.Tensor:
    """``((0 + t_0) + t_1) + ...``: a kernel's running sum, one rounding per
    term."""
    acc = None
    for t in terms:
        acc = (torch.zeros_like(t) if acc is None else acc) + t
    return acc


def ell_spmv_ordered(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x`` for a 1-d ``x`` as K1's rows form it (and the K18b kernel's):
    each row's products rounded, then added from 0.0 in slot order, columns
    at or past ``x``'s length (padding) skipped."""
    n_cols = x.shape[0]
    x_p = torch.cat([x, x.new_zeros(1)])
    # A padding slot's product is -0.0, which an addition leaves every value
    # unchanged by (+0.0 and -0.0 included): the same bits as skipping it.
    prod = (val * x_p[col.clamp(max=n_cols)]).masked_fill_(col >= n_cols, -0.0)
    acc = x.new_zeros(val.shape[0])
    for k in range(val.shape[1]):
        acc = acc + prod[:, k]
    return acc


def _givens(h: torch.Tensor, cs, sn, g, j: int, atol, flag) -> None:
    """In place: the ``j`` old Givens rotations applied to the Hessenberg
    column ``h`` (``h[:j+2]`` set), the new one into ``cs[j]``, ``sn[j]``,
    ``g[j]`` and ``g[j + 1]`` rotated, ``flag = (j + 1 < restart) & (|g[j +
    1]| > atol)``. Scalar arithmetic in numpy scalars of ``h``'s dtype, one
    rounding an operation in the kernel's order; ``max(x, 1e-30)`` keeps a
    NaN, as ``torch.clamp`` does."""
    ty = np.float32 if h.dtype == torch.float32 else np.float64
    restart = cs.shape[0]
    hv = h[: j + 2].cpu().numpy().copy()
    c_old, s_old = cs[:j].cpu().numpy(), sn[:j].cpu().numpy()
    gj = ty(float(g[j]))
    tiny = ty(1e-30)
    with np.errstate(all="ignore"):
        for i in range(j):
            hi, hn, c, s = hv[i], hv[i + 1], c_old[i], s_old[i]
            hv[i] = c * hi + s * hn
            hv[i + 1] = -s * hi + c * hn
        a, b = hv[j], hv[j + 1]
        denom = np.sqrt(a * a + b * b)
        safe = tiny if denom < tiny else denom
        c, s = a / safe, b / safe
        hv[j], hv[j + 1] = denom, ty(0)
        gn = -s * gj
        g_j = c * gj
    h[: j + 2] = torch.from_numpy(hv)
    cs[j], sn[j] = float(c), float(s)
    g[j], g[j + 1] = float(g_j), float(gn)
    flag.fill_(int(j + 1 < restart and bool(abs(gn) > ty(float(atol)))))


def fgmres_arnoldi_split(z, w, V, Z, Ht, cs, sn, g, j, atol, flag, all_sum=None) -> None:
    """The FGMRES Arnoldi step of :func:`fgmres_arnoldi` with ``w = A z``
    given, and each finished sum (``h``, ``h2``, ``|w|^2``, the rank's) handed
    to ``all_sum`` (default: none; a dof shard's all-reduce) before it is
    used: the sharded solve's step, four launches around its all-reduces on
    the card."""
    restart = Ht.shape[0]
    jj = int(j)
    if jj < 0 or jj >= restart:
        flag.fill_(0)
        return
    reduce = all_sum or (lambda t: t)
    m = jj + 1
    Z[jj] = z
    Vj = V[:m]
    h = reduce(finish(block_partials(Vj * w)))
    w = w - _seq_sum(Vj[r] * h[r] for r in range(m))
    h2 = reduce(finish(block_partials(Vj * w)))
    w = w - _seq_sum(Vj[r] * h2[r] for r in range(m))
    hj1 = torch.sqrt(reduce(finish(block_partials(w * w)[None]))[0])
    V[m] = w / torch.clamp(hj1, min=1e-30)
    Ht[jj, :m] = h + h2
    Ht[jj, m] = hj1
    _givens(Ht[jj], cs, sn, g, jj, atol, flag)
    j.fill_(m)


def fgmres_arnoldi(val, col, z, V, Z, Ht, cs, sn, g, j, atol, flag) -> None:
    """In place: FGMRES Arnoldi column ``j`` (a device int32 scalar) of a
    cycle of ``restart = Ht.shape[0]`` columns, less the preconditioner:
    ``w = A z`` (the ELL matrix ``(val, col)``, rows summed as K1 sums them),
    ``Z[j] = z``; CGS2 against ``V[:j+1]`` (``h = V w``, ``w -= V^T h``,
    ``h2 = V w``, ``w -= V^T h2``), ``hj1 = |w|``, ``V[j + 1] = w /
    max(hj1, 1e-30)``; ``Ht[j][:j+1] = h + h2``, ``Ht[j][j+1] = hj1``; the
    Givens step (:func:`_givens`) and ``j + 1``. A ``j`` outside ``[0,
    restart)`` only clears ``flag``. Dots and norms are the kernel's tile
    partials (:func:`block_partials`) finished in its order
    (:func:`finish`), every operation rounded on its own."""
    fgmres_arnoldi_split(z, ell_spmv_ordered(val, col, z), V, Z, Ht, cs, sn, g, j, atol, flag)


def bicgstab_p(r, q, dinv, st, p, phat, divide: bool = False) -> None:
    """In place: ``p <- r + beta (p - omega q)``, ``phat = dinv p`` (``p /
    dinv`` with ``divide``)."""
    p.copy_(r + st[BICG_BETA] * (p - st[BICG_OMEGA] * q))
    phat.copy_(p / dinv if divide else dinv * p)


def krylov_dots(a, b, c, d, partials, ndots: int) -> None:
    """Partials of ``<a, b>`` into ``partials[0]`` and, with ``ndots == 2``,
    of ``<c, d>`` into ``partials[1]``."""
    partials[0] = block_partials(a * b)
    if ndots > 1:
        partials[1] = block_partials(c * d)


def bicgstab_s(r, q, dinv, st, s, shat, partials, divide: bool = False) -> None:
    """In place: ``s = r - alpha_ q``, ``shat = dinv s`` (``s / dinv`` with
    ``divide``), partials of ``<s, s>`` into ``partials[0]``."""
    s.copy_(r - st[BICG_ALPHA_NEW] * q)
    shat.copy_(s / dinv if divide else dinv * s)
    partials[0] = block_partials(s * s)


def bicgstab_xr(x, r, phat, shat, s, t, rhat, st, partials) -> None:
    """In place: the BiCGStab update of ``x`` and ``r`` (the half step alone
    on the early exit), partials of ``<r, r>`` and ``<rhat, r>``."""
    alpha, omega = st[BICG_ALPHA_NEW], st[BICG_OMEGA_NEW]
    if bool(st[BICG_EXIT] != 0):
        x.copy_(x + alpha * phat)
        r.copy_(s)
    else:
        x.copy_(x + (alpha * phat + omega * shat))
        r.copy_(s - omega * t)
    partials[0] = block_partials(r * r)
    partials[1] = block_partials(rhat * r)


def bicgstab_scalars(partials, st, cont, stage: int) -> None:
    """In place: finish the partial rows of ``stage`` and run that stage of
    the BiCGStab scalar recurrence on ``st`` and the continue flag."""
    sums = finish(partials)
    if stage == STAGE_INIT:
        rr = sums[0]
        st[BICG_RHO_NEW] = rr
        st[BICG_RR] = rr
        st[BICG_BETA] = rr / st[BICG_RHO] * st[BICG_ALPHA] / st[BICG_OMEGA]
        cont.fill_(int(bool(rr > st[BICG_ATOL2])))
    elif stage == STAGE_ALPHA:
        st[BICG_ALPHA_NEW] = st[BICG_RHO_NEW] / sums[0]
    elif stage == STAGE_OMEGA:
        st[BICG_EXIT] = float(bool(sums[0] < st[BICG_ATOL2]))
        st[BICG_OMEGA_NEW] = sums[1] / sums[2]
    else:
        rr, hr = sums[0], sums[1]
        alpha, omega, rho = st[BICG_ALPHA_NEW].clone(), st[BICG_OMEGA_NEW].clone(), st[BICG_RHO_NEW].clone()
        breakdown = bool((omega == 0) | (alpha == 0) | (rho == 0))
        cont.fill_(int(bool(rr > st[BICG_ATOL2]) and not breakdown))
        st[BICG_RR] = rr
        st[BICG_RHO], st[BICG_ALPHA], st[BICG_OMEGA] = rho, alpha, omega
        st[BICG_RHO_NEW] = hr
        st[BICG_BETA] = hr / rho * alpha / omega


def _bicgstab(matvec, dinv, divide: bool, b, x, r, rhat, p, q, phat, s, shat, t, partials, st,
              cont, iterations: int, start=None) -> None:
    """The BiCGStab launch of the K18a/K12/K13 kernel (``bicgstab_kernel``
    in ``csrc/krylov.cu``) in plain passes, in place: with ``iterations =
    0`` the start, otherwise up to ``iterations`` iterations while
    ``cont[0]`` holds, each :func:`bicgstab_p`, :func:`krylov_dots`,
    :func:`bicgstab_s`, :func:`bicgstab_xr` and :func:`bicgstab_scalars`
    around two ``matvec`` calls that round as the kernel's. ``start`` is
    None for K18a's start (``r = b - A x``, the tolerance in ``st``), or
    ``(tol2, abs2)`` for the flow steps' (``x = 0``, ``r = b``, ``rho =
    alpha = omega = 1``, ``atol2 = max(tol2 <b, b>, abs2)`` in ``b``'s
    dtype, a NaN kept, as jax's maximum keeps it)."""
    flag = cont[:1]
    if iterations == 0:
        if start is None:
            r.copy_(b - matvec(x))
        else:
            x.zero_()
            r.copy_(b)
        for v in (rhat, p, q):
            v.copy_(r)
        rows = partials[BICG_RR_ROW : BICG_RR_ROW + 1]
        krylov_dots(r, r, r, r, rows, 1)
        if start is not None:
            tol2, abs2 = (torch.tensor(v, dtype=b.dtype, device=b.device) for v in start)
            a = tol2 * finish(rows)[0]
            st[BICG_ATOL2] = torch.where((a > abs2) | torch.isnan(a), a, abs2)
            st[[BICG_RHO, BICG_ALPHA, BICG_OMEGA]] = 1.0
            st[[BICG_ALPHA_NEW, BICG_OMEGA_NEW, BICG_EXIT]] = 0.0
        bicgstab_scalars(rows, st, flag, STAGE_INIT)
        cont[1] = 0
        return
    done = 0
    while done < iterations and bool(flag):
        bicgstab_p(r, q, dinv, st, p, phat, divide)
        q.copy_(matvec(phat))
        krylov_dots(rhat, q, rhat, q, partials[BICG_RQ : BICG_RQ + 1], 1)
        bicgstab_scalars(partials[BICG_RQ : BICG_RQ + 1], st, flag, STAGE_ALPHA)
        bicgstab_s(r, q, dinv, st, s, shat, partials[BICG_SS : BICG_SS + 1], divide)
        t.copy_(matvec(shat))
        krylov_dots(t, s, t, t, partials[BICG_TS : BICG_TT + 1], 2)
        bicgstab_scalars(partials[BICG_SS : BICG_TT + 1], st, flag, STAGE_OMEGA)
        bicgstab_xr(x, r, phat, shat, s, t, rhat, st, partials[BICG_RR_ROW : BICG_HR + 1])
        bicgstab_scalars(partials[BICG_RR_ROW : BICG_HR + 1], st, flag, STAGE_NEXT)
        done += 1
    cont[1] += done


def bicgstab_cycle(row_ptr, cols, vals, dinv, b, x, r, rhat, p, q, phat, s, shat, t,
                   partials, st, cont, iterations: int) -> None:
    """A BiCGStab solve with ``M = dinv *`` on the CSR matrix ``(row_ptr,
    cols, vals)``, in place, as the K18a kernel runs it (:func:`_bicgstab`):
    with ``iterations = 0`` the start from ``x`` (``r = b - A x``, ``rhat =
    p = q = r``, :func:`bicgstab_scalars` ``STAGE_INIT``); otherwise up to
    ``iterations`` iterations while ``cont[0]`` holds, the matvecs rounded
    as the kernel's (:func:`ell_spmv_ordered`). ``partials`` is
    ``(BICG_ROWS, nb)``, one row per dot product; ``cont`` int32 ``(2,)``:
    the continue flag and the iterations run since the start."""
    val, col = csr_ell(row_ptr, cols, vals, x.shape[0])
    _bicgstab(lambda v: ell_spmv_ordered(val, col, v), dinv, False, b, x, r, rhat, p, q, phat, s,
              shat, t, partials, st, cont, iterations)


def bicgstab_stencil(coef, diag, b, x, r, rhat, p, q, phat, s, shat, t, partials, st, cont,
                     iterations: int, tol2: float, abs2: float) -> None:
    """A flow step's BiCGStab solve (K12) with ``M = v / diag`` on the
    stencil ``coef`` ``(7, nx, ny, nz)`` of :func:`structured_linearize`
    (:func:`stencil_matvec`), flat vectors, in place: ``iterations = 0``
    starts it from ``x = 0`` with ``atol2 = max(tol2 <b, b>, abs2)``, as
    :func:`_bicgstab` says; f32 or f64."""
    _bicgstab(lambda v: stencil_matvec(coef, v), diag, True, b, x, r, rhat, p, q, phat, s, shat, t,
              partials, st, cont, iterations, (tol2, abs2))


def bicgstab_tpfa(row_ptr, cols, vals, diag, b, x, r, rhat, p, q, phat, s, shat, t, partials, st,
                  cont, iterations: int, tol2: float, abs2: float) -> None:
    """A flow step's BiCGStab solve (K13) with ``M = v / diag`` on the
    cell-cell CSR matrix of :func:`tpfa_linearize`, each row summed in its
    stored order (:func:`ell_spmv_ordered`), in place, started as
    :func:`bicgstab_stencil`; f32 or f64."""
    val, col = csr_ell(row_ptr, cols, vals, x.shape[0])
    _bicgstab(lambda v: ell_spmv_ordered(val, col, v), diag, True, b, x, r, rhat, p, q, phat, s,
              shat, t, partials, st, cont, iterations, (tol2, abs2))


# The GMRES passes below round as the K18b kernel does, operation by
# operation and sum by sum (products rounded before they are added, no
# fused multiply-add), so that the kernel equals their composition to the
# bit, up to the sign of a zero.


def cgs_project(av, dinv, V, w, partials, flags, k: int) -> None:
    """Arnoldi step ``k``, first pass: ``w = dinv av``; partials of
    ``<V[j], w>`` (rows ``j <= k``) and of ``<w, w>`` (row ``k + 1``).
    Nothing once ``flags[k]`` is set (a breakdown earlier in the restart)."""
    if bool(flags[k]):
        return
    w.copy_(dinv * av)
    partials[: k + 1] = block_partials(V[: k + 1] * w)
    partials[k + 1] = block_partials(w * w)


def cgs_update(V, w, partials, flags, k: int) -> None:
    """``h = V[:k+1] w`` from the partials, ``w <- w - V[:k+1]^T h``,
    partials of ``<w, w>`` into row ``k + 2``."""
    if bool(flags[k]):
        return
    h = finish(partials[: k + 1])
    w.copy_(w - _seq_sum(V[j] * h[j] for j in range(k + 1)))
    partials[k + 2] = block_partials(w * w)


def cgs_normalize(w, V, H, partials, flags, k: int) -> None:
    """``V[k + 1] = w / |w|`` (0 at or below ``eps |w_0|``), Hessenberg row
    ``k`` and the breakdown flag ``flags[k + 1]``, as the iteration's
    ``_kth_arnoldi_iteration`` with ``_safe_normalize``."""
    restart = H.shape[0]
    if bool(flags[k]):
        V[k + 1] = 0.0
        flags[k + 1] = 1
        return
    sums = finish(partials[: k + 3])
    norm0 = torch.sqrt(sums[k + 1])
    norm0 = torch.where(norm0 > _EPS, norm0, torch.zeros_like(norm0))
    norm = torch.sqrt(sums[k + 2])
    use = bool(norm > _EPS * norm0)
    V[k + 1] = w / norm if use else 0.0
    row = torch.zeros(restart + 1, dtype=H.dtype, device=H.device)
    row[: k + 1] = sums[: k + 1]
    row[k + 1] = norm if use else 0.0
    H[k] = row
    flags[k + 1] = int(not use or bool(norm == 0))


def _div(a: float, b: float) -> float:
    """``a / b`` with IEEE results where Python raises."""
    if b != 0.0:
        return a / b
    if a != a or a == 0.0:
        return math.nan
    return math.copysign(math.inf, a) * math.copysign(1.0, b)


def _sqrt(a: float) -> float:
    return math.sqrt(a) if a >= 0.0 else math.nan


def gmres_lstsq(H, st, y) -> None:
    """``y`` of ``_lstsq(H^T, beta e_0)``: the normal equations ``H H^T y =
    beta H[:, 0]`` by Cholesky, column by column, then the two triangular
    solves, each entry in the kernel's order (IEEE doubles, one rounding
    per operation): ``L u = z`` subtracts its terms by ascending column,
    ``L^T y = u`` by descending row, as the kernel's column sweeps do."""
    R = H.shape[0]
    h = H.tolist()
    beta = float(st[GMRES_RESNORM])
    a = [[0.0] * R for _ in range(R)]
    for i in range(R):
        for j in range(R):
            acc = 0.0
            for c in range(R + 1):
                acc = acc + h[i][c] * h[j][c]
            a[i][j] = acc
    z = [h[i][0] * beta for i in range(R)]
    for c in range(R):
        a[c][c] = _sqrt(a[c][c])
        for i in range(c + 1, R):
            a[i][c] = _div(a[i][c], a[c][c])
        for i in range(c + 1, R):
            for j in range(c + 1, i + 1):
                a[i][j] = a[i][j] - a[i][c] * a[j][c]
    for i in range(R):
        acc = z[i]
        for m in range(i):
            acc = acc - a[i][m] * z[m]
        z[i] = _div(acc, a[i][i])
    for i in range(R - 1, -1, -1):
        acc = z[i]
        for m in range(R - 1, i, -1):
            acc = acc - a[m][i] * z[m]
        z[i] = _div(acc, a[i][i])
    y.copy_(torch.tensor(z, dtype=y.dtype))


def gmres_correct(V, y, x) -> None:
    """``x <- x + V[:restart]^T y``."""
    x.copy_(x + _seq_sum(V[j] * y[j] for j in range(y.shape[0])))


def gmres_residual(b, ax, dinv, w, partials) -> None:
    """``w = dinv (b - ax)``, partials of ``<w, w>`` into row 0."""
    w.copy_(dinv * (b - ax))
    partials[0] = block_partials(w * w)


def gmres_restart(w, V, H, partials, flags, st, cont) -> None:
    """Start of a restart: ``V[0] = w / |w|`` (0 at or below eps), the
    residual norm, ``cont = |w| > atol``, ``H = eye``, flags cleared."""
    norm = torch.sqrt(finish(partials[:1])[0])
    use = bool(norm > _EPS)
    V[0] = w / norm if use else 0.0
    H.copy_(torch.eye(H.shape[0], H.shape[1], dtype=H.dtype, device=H.device))
    flags.zero_()
    st[GMRES_RESNORM] = norm if use else 0.0
    cont.fill_(int(bool(st[GMRES_RESNORM] > st[GMRES_ATOL])))


def csr_ell(row_ptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, n_cols: int):
    """The padded-row (ELL) form ``(val, col)`` of a CSR matrix (int32
    ``row_ptr`` and ``cols``), each row's entries in their CSR order,
    padding columns ``n_cols``: :func:`ell_spmv` of it sums each row in
    that order."""
    n = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    K = max(int(counts.max()) if n else 1, 1)
    row_of = torch.repeat_interleave(torch.arange(n, device=vals.device), counts)
    pos = torch.arange(vals.shape[0], device=vals.device) - row_ptr[:-1].long()[row_of]
    val = vals.new_zeros((n, K))
    col = torch.full((n, K), n_cols, dtype=torch.int32, device=vals.device)
    val[row_of, pos] = vals
    col[row_of, pos] = cols
    return val, col


def gmres_cycle(row_ptr, cols, vals, dinv, b, x, V, H, y, w, partials, flags, st, cont,
                arnoldi: int) -> None:
    """One restart of GMRES(``restart = H.shape[0]``) with ``M = dinv *`` on
    the CSR matrix ``(row_ptr, cols, vals)``, in place: with ``arnoldi`` the
    ``restart`` Arnoldi steps from ``V[0]`` (:func:`cgs_project`,
    :func:`cgs_update`, :func:`cgs_normalize`), :func:`gmres_lstsq` and
    :func:`gmres_correct`; then, with or without them, the residual ``w =
    dinv (b - A x)`` and :func:`gmres_restart` (``V[0]``, the residual norm,
    ``cont``). ``arnoldi = 0`` starts a solve from ``x``."""
    val, col = csr_ell(row_ptr, cols, vals, x.shape[0])
    if arnoldi:
        for k in range(H.shape[0]):
            cgs_project(ell_spmv_ordered(val, col, V[k]), dinv, V, w, partials, flags, k)
            cgs_update(V, w, partials, flags, k)
            cgs_normalize(w, V, H, partials, flags, k)
        gmres_lstsq(H, st, y)
        gmres_correct(V, y, x)
    gmres_residual(b, ell_spmv_ordered(val, col, x), dinv, w, partials)
    gmres_restart(w, V, H, partials, flags, st, cont)


# -- K17 --------------------------------------------------------------------------


#: The iterates a K17 point keeps for its cycle exit (``flash.cu``'s ring).
FLASH_RING = 8


def _flash_parts(zs: torch.Tensor, K: torch.Tensor):
    """What K17's loops share, in the jnp code's order
    (``porepy_tpu/compositional/flash.py:80-122``): ``(V_0, single, newton,
    finish)``, the first iterate, the single-phase points, the guarded
    Newton map ``V -> V'`` and ``finish(V, tol) -> (V, x, y, converged)``,
    the ending from the last iterate."""
    Kc = K[:, None]
    km1 = Kc - 1.0
    all_liquid = torch.sum(zs * Kc, dim=0) <= 1.0
    all_vapor = torch.sum(zs / Kc, dim=0) <= 1.0
    one = torch.ones((), dtype=zs.dtype, device=zs.device)

    def h_fun(V):
        return torch.sum(zs * km1 / (1.0 + V * km1), dim=0)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    Kmax, Kmin = torch.max(Kc), torch.min(Kc)
    lo = torch.where(Kmax > 1.0, 1.0 / (1.0 - Kmax), -1e10 * one) + 1e-12
    hi = torch.where(Kmin < 1.0, 1.0 / (1.0 - Kmin), 1e10 * one) - 1e-12

    def newton(V):
        dh = -torch.sum(zs * (km1 * km1) / ((1.0 + V * km1) * (1.0 + V * km1)), dim=0)
        return clip(V - h_fun(V) / torch.where(torch.abs(dh) > 1e-30, dh, -one), lo, hi)

    def finish(V, tol):
        V = torch.where(all_liquid, 0.0 * one, torch.where(all_vapor, one, V))
        V = clip(V, 0.0 * one, one)
        x = zs / (1.0 + V[None] * km1)
        y = Kc * x
        x = x / torch.sum(x, dim=0)
        y = y / torch.sum(y, dim=0)
        resid = torch.abs(h_fun(clip(V, lo, hi)))
        two_phase = ~(all_liquid | all_vapor)
        return V, x, y, torch.where(two_phase, resid < tol, torch.ones_like(two_phase))

    V0 = clip(torch.full((zs.shape[1],), 0.5, dtype=zs.dtype, device=zs.device), lo, hi)
    return V0, all_liquid | all_vapor, newton, finish


def rachford_rice(zs: torch.Tensor, K: torch.Tensor, max_iter: int, tol: float):
    """The constant-K Rachford-Rice flash of ``ConstantKFlash``: ``zs``
    ``(nc, N)``, ``K`` ``(nc,)``. Returns ``(V, x, y, converged, iters)``:
    the vapor fraction ``(N,)``, the normalised liquid and vapor
    compositions ``(nc, N)``, the convergence flags and, per point, the
    number of guarded Newton iterations it ran (0 for a single-phase point,
    whose ``V`` the corners set).

    ``V`` is the ``max_iter``-th iterate, as in ``porepy_tpu``'s loop of
    ``max_iter`` steps. A point stops once its iterate repeats one of its
    last ``FLASH_RING``, ``V_it = V_{it - m}``: the Newton map depends on
    ``V`` alone, so the orbit is periodic from ``s = it - m`` on and the
    ``max_iter``-th iterate is ``V_{s + (max_iter - s) mod m}``, which the
    ring holds (a fixed point is ``m = 1``). The result has the bits of all
    ``max_iter`` iterations (:func:`rachford_rice_full`); ``iters`` is
    ``it`` (``max_iter`` for a point without a repeat)."""
    V0, single, newton, finish = _flash_parts(zs, K)
    # ring[q] = V_{it - 1 - q}; NaN before V_0 (never equal to an iterate).
    ring = torch.full((FLASH_RING, zs.shape[1]), float("nan"), dtype=zs.dtype, device=zs.device)
    ring[0] = V0
    done = single.clone()
    V = V0.clone()
    iters = torch.zeros(zs.shape[1], dtype=torch.int32, device=zs.device)
    slots = torch.arange(1, FLASH_RING + 1, device=zs.device)[:, None]
    for it in range(1, max_iter + 1):
        if bool(done.all()):
            break
        Vn = newton(ring[0])
        # The least period m with V_it = V_{it - m} (FLASH_RING + 1: none).
        m = torch.where(Vn[None] == ring, slots, FLASH_RING + 1).amin(0)
        hit = ~done & (m <= FLASH_RING)
        m = torch.where(hit, m, 1)
        pos = m - 1 - torch.remainder(max_iter - (it - m), m)
        V = torch.where(hit, ring.gather(0, pos[None]).squeeze(0), V)
        iters = torch.where(hit, it, iters)
        done = done | hit
        ring = torch.roll(ring, 1, 0)
        ring[0] = Vn
        V = torch.where(done, V, Vn)
        iters = torch.where(done, iters, it)
    return (*finish(V, tol), iters)


def rachford_rice_iterates(zs: torch.Tensor, K: torch.Tensor, max_iter: int):
    """``V_0, ..., V_max_iter`` of the guarded Newton map at every point,
    with no exit (each ``(N,)``, yielded one at a time)."""
    V, _, newton, _ = _flash_parts(zs, K)
    yield V
    for _ in range(max_iter):
        V = newton(V)
        yield V


def rachford_rice_full(zs: torch.Tensor, K: torch.Tensor, max_iter: int, tol: float):
    """The flash with all ``max_iter`` Newton steps at every point and no
    exit, as ``porepy_tpu``'s ``fori_loop`` runs it: ``(V, x, y,
    converged)``, the result that every early stop must reproduce."""
    for V in rachford_rice_iterates(zs, K, max_iter):
        pass
    return _flash_parts(zs, K)[3](V, tol)


def flash_iteration_stats(iters: torch.Tensor, max_iter: int) -> dict:
    """K17's iterations: the mean a point, the mean over warps (32
    consecutive points) of each warp's slowest lane, and the points at
    ``max_iter``."""
    it = iters.long()
    pad = (-it.numel()) % 32
    warps = torch.cat([it, it.new_zeros(pad)]).view(-1, 32).amax(1)
    return {"mean": float(it.double().mean()), "warp_slowest": float(warps.double().mean()),
            "at_max": int((it == max_iter).sum())}


def flash_work(iters: torch.Tensor, nc: int) -> tuple[float, float]:
    """K17's work at these inputs, ``(bytes, f64 operations)``: z in, V, x,
    y, the flags and the counts out; ``9 nc + 5`` operations an iteration
    that the points ran, ``11 nc + 12`` a point around them."""
    n = iters.numel()
    return 8.0 * (3 * nc + 1) * n + 5.0 * n, float(iters.sum()) * (9 * nc + 5) + n * (11 * nc + 12)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits (a float64 tensor's as int64), or equal (any other)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


# -- K16 --------------------------------------------------------------------------


def _interp_corners(values, fgeom, igeom, x):
    """``frac`` of each axis and, per corner (itertools.product order), its
    bits and table value; ``fgeom = [low, h]``, ``igeom = [npt, strides]``."""
    d = x.shape[0]
    low, h = fgeom[:d], fgeom[d:]
    npt, strides = igeom[:d].long(), igeom[d:].long()
    rel = (x - low[:, None]) / h[:, None]
    base = torch.clamp(
        torch.floor(rel).to(torch.int64),
        min=torch.zeros_like(npt)[:, None],
        max=(npt - 2)[:, None],
    )
    frac = rel - base
    corners = []
    for c in range(1 << d):
        bits = [(c >> (d - 1 - k)) & 1 for k in range(d)]
        flat = sum((base[k] + bits[k]) * strides[k] for k in range(d))
        corners.append((bits, values[flat]))
    return frac, corners


def interp_lookup(values, fgeom, igeom, x):
    """Multilinear lookup (extrapolating outside the table) at the points
    ``x`` ``(d, N)``: a table of ``npt`` points per axis from ``low`` at
    spacing ``h`` (``fgeom = [low, h]``, float64), flat ``values`` with
    ``strides`` (``igeom = [npt, strides]``, int32). Returns ``(N,)``."""
    frac, corners = _interp_corners(values, fgeom, igeom, x)
    out = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    for bits, v in corners:
        w = torch.ones_like(out)
        for k, bk in enumerate(bits):
            w = w * (frac[k] if bk else 1 - frac[k])
        out = out + w * v
    return out


def interp_tangent(values, fgeom, igeom, x, dx):
    """Forward-mode tangent of :func:`interp_lookup` at ``x`` for the seeds
    ``dx`` ``(B, d, N)``: ``d frac_k = dx_k / h_k``, the integer cell index
    carries none. Returns ``(B, N)``."""
    d = x.shape[0]
    frac, corners = _interp_corners(values, fgeom, igeom, x)
    df = dx / fgeom[d:][None, :, None]
    out = torch.zeros(dx.shape[0], x.shape[1], dtype=x.dtype, device=x.device)
    for bits, v in corners:
        f = [frac[k] if bits[k] else 1 - frac[k] for k in range(d)]
        dw = torch.zeros_like(out)
        for k in range(d):
            term = df[:, k] if bits[k] else -df[:, k]
            for m in range(d):
                if m != k:
                    term = term * f[m]
            dw = dw + term
        out = out + dw * v
    return out


def corner_table(values, igeom):
    """The corner-block table that K16's kernel reads in place of a flat
    table (``igeom = [npt, strides]``, ``npt >= 2`` on every axis):
    ``(corners, cgeom)``, ``corners`` of shape
    ``(prod(npt - 1), 2^d)`` holding each cell's ``2^d`` corner values
    contiguous in ``itertools.product`` order (the first axis's bit the most
    significant), cells numbered with the first axis fastest, and ``cgeom =
    [npt, cell strides]`` (int32). It holds ``2^d`` times the flat table's
    entries, less the last point of each axis."""
    d = igeom.shape[0] // 2
    npt, strides = igeom[:d].long(), igeom[d:].long()
    cells = (npt - 1).tolist()
    if min(cells) < 1:
        raise ValueError(f"corner_table: needs at least 2 points per axis, got {npt.tolist()}")
    cstride = [1]
    for c in cells[:-1]:
        cstride.append(cstride[-1] * c)
    grids = torch.meshgrid(*(torch.arange(c, device=values.device) for c in cells), indexing="ij")
    base = [g.permute(*reversed(range(d))).reshape(-1) for g in grids]  # first axis fastest
    corners = torch.stack(
        [
            values[sum((base[k] + ((c >> (d - 1 - k)) & 1)) * strides[k] for k in range(d))]
            for c in range(1 << d)
        ],
        dim=1,
    )
    cgeom = torch.tensor(npt.tolist() + cstride, dtype=torch.int32, device=igeom.device)
    return corners.contiguous(), cgeom


def interp_dual(values, fgeom, igeom, xs, tans=None):
    """Value and tangents of the multilinear lookup in one ``(1 + B, N)``
    tensor: row 0 :func:`interp_lookup` at the points whose ``d``
    coordinates are the ``(N,)`` tensors ``xs``, rows ``1 ..``
    :func:`interp_tangent` for ``tans``, one ``(B, N)`` tensor a coordinate
    (``None``: a constant coordinate, its seed rows zero) or ``tans``
    ``None`` (the value alone, ``(1, N)``). The kernel computes the same rows
    from the corner-block table (:func:`corner_table`) to the bit: a constant
    coordinate's tangent is 0.0 divided by ``h`` and multiplied through
    there, as a zero seed row is here."""
    x = torch.stack(list(xs))
    val = interp_lookup(values, fgeom, igeom, x)[None]
    if tans is None or all(t is None for t in tans):
        return val
    zeros = x.new_zeros(next(t.shape for t in tans if t is not None))
    dx = torch.stack([zeros if t is None else t for t in tans], dim=1)
    return torch.cat([val, interp_tangent(values, fgeom, igeom, x, dx)])


# -- K11 --------------------------------------------------------------------------


def block_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverses of the ``(B, n, n)`` matrices ``a`` by Gauss-Jordan
    elimination with partial pivoting on ``[A | I]``: per column ``k``, the
    first row ``i >= k`` of largest ``|M[i, k]|`` is swapped into row ``k``,
    row ``k`` is divided by its pivot and ``M[i, k]`` times it is subtracted
    from every other row. A singular matrix gives non-finite entries."""
    B, n, _ = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    M = torch.cat([a, eye], dim=2)
    batch = torch.arange(B, device=a.device)
    for k in range(n):
        p = k + torch.argmax(M[:, k:, k].abs(), dim=1)
        row_k = M[:, k].clone()
        M[:, k] = M[batch, p]
        M[batch, p] = row_k
        M[:, k] = M[:, k] / M[:, k, k : k + 1]
        f = M[:, :, k].clone()
        f[:, k] = 0.0
        M -= f[:, :, None] * M[:, None, k, :]
    return M[:, :, n:].contiguous()


# -- K19 --------------------------------------------------------------------------


def halo_pack(x_own: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The send buffer of a halo exchange: ``x_own[send_idx]``."""
    return x_own[send_idx.long()]


def ell_spmv_split(
    val: torch.Tensor, col: torch.Tensor, x_own: torch.Tensor, x_halo: torch.Tensor
) -> torch.Tensor:
    """``y_i = sum_k val[i, k] src(col[i, k])`` over a row shard: ``src``
    reads ``x_own`` below ``n_own = x_own.numel()``, ``x_halo`` from there,
    and zero at the padding column ``n_own + x_halo.numel()``; every row
    summed as K1's (:func:`ell_spmv_ordered` on ``[x_own, x_halo]``), so that
    one shard holding every row gives K1's result bit for bit. The yardstick
    of :func:`halo_interior` and :func:`halo_boundary` composed."""
    return ell_spmv_ordered(val, col, torch.cat([x_own, x_halo]))


def halo_interior(
    val: torch.Tensor, col: torch.Tensor, x_own: torch.Tensor, send_idx: torch.Tensor,
    rows: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch A of the row-sharded matvec: the send buffer
    ``x_own[send_idx]`` and ``y`` (``n_own`` rows) with ``y[rows]`` the
    interior rows summed as K1's from ``x_own`` alone (a column from
    ``n_own`` on is padding for them), the other rows 0."""
    r = rows.long()
    y = x_own.new_zeros(val.shape[0])
    y[r] = ell_spmv_ordered(val[r], col[r], x_own)
    return halo_pack(x_own, send_idx), y


def halo_boundary(
    val: torch.Tensor, col: torch.Tensor, x_own: torch.Tensor, x_halo: torch.Tensor,
    rows: torch.Tensor, y: torch.Tensor,
) -> torch.Tensor:
    """Launch B: ``y[rows]`` (in place) the boundary rows summed as K1's
    from ``x_own`` and the received halo ``x_halo``; returns ``y``."""
    r = rows.long()
    y[r] = ell_spmv_ordered(val[r], col[r], torch.cat([x_own, x_halo]))
    return y


# -- K15 --------------------------------------------------------------------------


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


def upwind_select(q, w, lo, hi, is_dir, is_neu):
    """Upstream value of the cell field ``w`` on each face: ``w[lo]`` where
    ``q >= 0`` else ``w[hi]`` (IEEE: ``-0.0 >= 0`` holds, NaN does not), 0
    where that cell is missing (index -1), on Neumann faces and on Dirichlet
    faces with inflow from outside. ``q`` is ``(nf,)`` or ``(B, nf)``, ``w``
    ``(nc,)`` or ``(B, nc)``; the selection is taken from ``q`` as data."""
    pos = q.detach() >= 0
    up = torch.where(pos, lo, hi)
    idx = torch.clamp(up, min=0)
    if w.dim() == 2 and idx.dim() == 1:
        w_sel = w[:, idx]
    elif w.dim() == 2:
        w_sel = torch.gather(w, 1, idx)
    else:
        w_sel = w[idx]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    excluded = is_neu | (is_dir & (up < 0))
    return torch.where((up < 0) | excluded, zero, w_sel)


def upwind_select_pair(s, a, b):
    """``a`` where ``s >= 0`` else ``b``, the selection taken from ``s`` as
    data; a missing candidate (``None``) reads 0."""
    if a is None and b is None:
        raise ValueError("upwind_select_pair: needs at least one candidate")
    a = _zeros_if_none(a, b)
    b = _zeros_if_none(b, a)
    return torch.where(s.detach() >= 0, a, b)


def upwind_masks(q, lo, hi, is_dir, is_neu, sgn_div):
    """``(dir_mask, neu_coeff)``: 1 on Dirichlet faces whose upstream side
    lies outside the grid, and ``sgn_div`` on Neumann faces, else 0."""
    pos = q.detach() >= 0
    inflow_outside = torch.where(pos, lo < 0, hi < 0)
    dir_mask = (is_dir & inflow_outside).to(q.dtype)
    neu_coeff = torch.where(is_neu, sgn_div, torch.zeros_like(sgn_div))
    return dir_mask, neu_coeff


def upwind_flux(q, w, bc, lo, hi, is_dir, is_neu, sgn_div):
    """The upwinded advective face flux ``q up(w) + dir_mask q bc +
    neu_coeff bc`` (:func:`upwind_select`, :func:`upwind_masks`)."""
    dir_mask, neu_coeff = upwind_masks(q, lo, hi, is_dir, is_neu, sgn_div)
    return (
        q * upwind_select(q, w, lo, hi, is_dir, is_neu)
        + dir_mask * q * bc
        + neu_coeff * bc
    )


def upwind_flux_tangent(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div):
    """Forward-mode tangent of :func:`upwind_flux` at ``(q, w, bc)`` for the
    seeds ``(dq, dw, dbc)`` (``None`` is a zero seed), the selection frozen:
    ``dq (up(w) + dir_mask bc) + q up(dw) + (dir_mask q + neu_coeff) dbc``."""
    dir_mask, neu_coeff = upwind_masks(q, lo, hi, is_dir, is_neu, sgn_div)
    out = None
    if dq is not None:
        out = dq * (upwind_select(q, w, lo, hi, is_dir, is_neu) + dir_mask * bc)
    if dw is not None:
        term = q * upwind_select(q, dw, lo, hi, is_dir, is_neu)
        out = term if out is None else out + term
    if dbc is not None:
        term = (dir_mask * q + neu_coeff) * dbc
        out = term if out is None else out + term
    if out is None:
        raise ValueError("upwind_flux_tangent: needs at least one seed")
    return out


#: The functions of the one K15 kernel, in the kernel's order (``Mode``).
UPWIND_KINDS = ("flux", "apply", "pair", "interface")


def upwind_dual(kind, geometry, primals, seeds=None):
    """``(value (n,), tangents (B, n) or None)`` of one K15 function, the
    rows of the kernel's ``(1 + B, n)`` buffer, by its operations in its
    order. ``kind`` is one of :data:`UPWIND_KINDS`:

    - ``"flux"``: ``primals = (q, w, bc)``, ``seeds = (dq, dw, dbc)``; the
      value and tangents of :func:`upwind_flux` and
      :func:`upwind_flux_tangent` (a tangent without ``dq`` starts from 0.0,
      as the kernel's sum does);
    - ``"apply"``: ``(q, w, _)``, ``(_, dw, _)``; ``up(w)`` and ``up(dw)``;
    - ``"pair"``: ``(s, a, b)``, ``(_, da, db)``; ``s >= 0 ? a : b`` and the
      same choice of the seeds (``None`` reads 0);
    - ``"interface"``: ``(lam, a, b)``, ``(dlam, da, db)``; ``lam * sel``
      with ``sel`` the pair's choice, and the tangent of ``dual_ew``'s
      ``mul``: ``dlam sel + dsel lam``, one product where one operand has no
      seed.

    ``geometry`` is ``(lo, hi, is_dir, is_neu, sgn_div)`` for the flux and
    apply (``sgn_div`` may be ``None`` for apply), ``None`` for the others.
    Primals are ``(n,)`` (the cell field ``(nc,)``), seeds ``(B, n)`` or
    ``None``; none that the kind reads (or ``seeds=None``): the value alone.
    The choice is taken from the first primal as data."""
    if kind not in UPWIND_KINDS:
        raise ValueError(f"upwind_dual: kind {kind!r} is not one of {UPWIND_KINDS}")
    s = primals[0].detach()
    n = s.shape[-1]
    reads = {"flux": (0, 1, 2), "apply": (1,), "pair": (1, 2), "interface": (0, 1, 2)}[kind]
    live = [seeds[i] for i in reads if seeds[i] is not None] if seeds is not None else []
    batch = live[0].shape[0] if live else 0
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    first = s >= 0
    if kind in ("flux", "apply"):
        lo, hi, is_dir, is_neu, sgn_div = geometry
        up = torch.where(first, lo, hi)
        outside = up < 0
        take = ~(outside | is_neu)
        idx = up.clamp(min=0)

        def chosen(x):
            return torch.where(take, x[..., idx], zero)

    else:

        def chosen(a, b):
            return torch.where(first, zero if a is None else a, zero if b is None else b)

    out = s.new_empty((1 + batch, n))
    if kind == "flux":
        q, w, bc = primals
        dir_mask = (is_dir & outside).to(s.dtype)
        neu = torch.where(is_neu, sgn_div, zero)
        w_up = chosen(w)
        out[0] = q * w_up + dir_mask * q * bc + neu * bc
        if batch:
            dq, dw, dbc = seeds
            t = torch.zeros((batch, n), dtype=s.dtype, device=s.device)
            if dq is not None:
                t = dq * (w_up + dir_mask * bc)
            if dw is not None:
                t = t + q * chosen(dw)
            if dbc is not None:
                t = t + (dir_mask * q + neu) * dbc
            out[1:] = t
    elif kind == "apply":
        out[0] = chosen(primals[1])
        if batch:
            out[1:] = chosen(seeds[1])
    elif kind == "pair":
        out[0] = chosen(primals[1], primals[2])
        if batch:
            out[1:] = chosen(seeds[1], seeds[2])
    else:
        lam = primals[0]
        sel = chosen(primals[1], primals[2])
        out[0] = lam * sel
        if batch:
            dlam, da, db = seeds
            if dlam is None:
                out[1:] = chosen(da, db) * lam
            elif da is None and db is None:
                out[1:] = dlam * sel
            else:
                out[1:] = dlam * sel + chosen(da, db) * lam
    return out[0], (out[1:] if batch else None)


# -- K14 --------------------------------------------------------------------------


def segment_sum_sorted(x, ptr, idx, num):
    """Sums of ``x`` (last axis) over ``num`` segments in fixed order:
    segment ``s`` holds the items ``idx[ptr[s]:ptr[s + 1]]``, or
    ``ptr[s]:ptr[s + 1]`` themselves when ``idx`` is ``None``. Items are
    added in ascending position, from zero."""
    counts = (ptr[1:] - ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(num, device=x.device), counts)
    if idx is not None:
        seg_of = torch.empty_like(seg)
        seg_of[idx.long()] = seg
        seg = seg_of
    out = torch.zeros(x.shape[:-1] + (num,), dtype=x.dtype, device=x.device)
    return torch.index_add(out, -1, seg, x)


def _tpfa_ad_t_full(geom, k9, vol):
    """Harmonic face transmissibilities ``1 / sum(1 / t_hf)`` with ``t_hf =
    (n . (K vol) . d) / |d|^2`` per half-face; ``k9`` cell-major."""
    ci = geom["ci"].long()
    nc = vol.shape[-1]
    kv = (k9.reshape(nc, 3, 3) * vol[:, None, None]).permute(1, 2, 0)
    n, d = geom["nrm"], geom["dvec"]
    nk = torch.einsum("ijh,jh->ih", kv[:, :, ci], n)
    t_hf = torch.sum(nk * d, dim=0) / torch.sum(d * d, dim=0)
    recip = segment_sum_sorted(
        1.0 / t_hf, geom["face_ptr"], geom["face_hf"], geom["face_ptr"].shape[0] - 1
    )
    return 1.0 / recip


def _face_from_half_faces(geom, x_hf):
    """The face field that takes each face's last half-face value of ``x_hf``."""
    last = geom["face_hf"].long()[(geom["face_ptr"][1:] - 1).long()]
    return x_hf[last]


def tpfa_ad_flux(geom, k9, vol, p, bco, lam):
    """The differentiable TPFA face flux of one subdomain: ``t sum(sgn
    p[ci]) + coeff (bco + lam)`` with ``t`` the harmonic transmissibility
    (0 on effective Neumann faces) and ``coeff`` the boundary coefficient
    (``-t sgn`` Dirichlet, ``sgn`` Neumann, on faces with one half-face).
    ``geom`` holds ``face_ptr``, ``face_hf``, ``ci`` (int32), ``sgn``,
    ``nrm``, ``dvec`` (float64) and the bool face masks."""
    nf = geom["face_ptr"].shape[0] - 1
    t_full = _tpfa_ad_t_full(geom, k9, vol)
    zero = torch.zeros_like(t_full)
    t = torch.where(geom["is_neu"], zero, t_full)
    sgn_face = _face_from_half_faces(geom, geom["sgn"])
    coeff = torch.where(
        geom["is_dir"], -t * sgn_face, torch.where(geom["is_neu"], sgn_face, zero)
    )
    single = (geom["face_ptr"][1:] - geom["face_ptr"][:-1]) == 1
    coeff = torch.where(single, coeff, zero)
    cell_part = segment_sum_sorted(
        geom["sgn"] * p[geom["ci"].long()], geom["face_ptr"], geom["face_hf"], nf
    )
    return t * cell_part + coeff * (bco + lam)


def tpfa_ad_trace(geom, k9, vol, p, bco, lam):
    """The boundary pressure trace of one subdomain: the boundary value on
    (raw) Dirichlet faces, ``p_cell - (bco + lam) / t_full`` on raw Neumann
    faces, 0 elsewhere."""
    t_full = _tpfa_ad_t_full(geom, k9, vol)
    b = bco + lam
    p_face = _face_from_half_faces(geom, p[geom["ci"].long()])
    neu, dirr = geom["is_neu_raw"], geom["is_dir_raw"]
    zero = torch.zeros_like(t_full)
    safe = torch.where(neu, t_full, torch.ones_like(t_full))
    return torch.where(dirr, b, torch.where(neu, p_face - b / safe, zero))


def tpfa_ad_tangent(fn, geom, primals, seeds):
    """Forward-mode tangents ``(B, nf)`` of ``fn`` (:func:`tpfa_ad_flux` or
    :func:`tpfa_ad_trace`) at the five ``primals`` for the ``(B, ...)``
    ``seeds`` (``None`` is a zero seed), by ``torch.func.jvp`` of the plain
    version."""
    live = [i for i, s in enumerate(seeds) if s is not None]
    if not live:
        raise ValueError("tpfa_ad_tangent: needs at least one seed")

    def partial(*args):
        full = list(primals)
        for i, a in zip(live, args):
            full[i] = a
        return fn(geom, *full)

    def one(*tangents):
        return torch.func.jvp(partial, tuple(primals[i] for i in live), tangents)[1]

    return torch.func.vmap(one)(*(seeds[i] for i in live))


def tpfa_ad_dual(geom, primals, seeds=None, trace=False):
    """``(value, tangents)`` of :func:`tpfa_ad_flux` (or, with ``trace``,
    :func:`tpfa_ad_trace`) at the five ``primals``: the value and, for the
    ``(B, ...)`` ``seeds`` (``None`` is a zero seed), the ``(B, nf)``
    tangents of :func:`tpfa_ad_tangent`; ``None`` when every seed is."""
    fn = tpfa_ad_trace if trace else tpfa_ad_flux
    val = fn(geom, *primals)
    if seeds is None or all(s is None for s in seeds):
        return val, None
    return val, tpfa_ad_tangent(fn, geom, primals, seeds)


# -- K8 ---------------------------------------------------------------------------

#: The opcodes of a :func:`dual_ew` program, in the numbering of
#: ``csrc/dual_ad.cu``. An instruction is ``(opcode, a, b, c)`` with register
#: numbers ``a, b, c``: registers ``0 .. DUAL_MAX_INPUTS - 1`` are the inputs,
#: register ``DUAL_MAX_INPUTS + j`` is the result of instruction ``j``
#: (``loadi`` reads ``imm[a]`` instead). The last instruction is the output.
DUAL_OPCODES = (
    "loadi", "add", "sub", "mul", "div", "pow", "neg", "exp", "log", "sin", "cos",
    "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "abs", "sign", "sqrt", "gt", "ge", "leabs", "select",
    "detach", "custom",
)
DUAL_OP = {name: code for code, name in enumerate(DUAL_OPCODES)}
DUAL_MAX_INPUTS = 12
DUAL_MAX_INSTRS = 36

# value and derivative factor d of the unary opcodes: tangent = t * d(x, r),
# or t / d where the entry says so (the kernel divides at the same places).
_DUAL_UNARY = {
    "exp": (torch.exp, lambda x, r: r, False),
    "log": (torch.log, lambda x, r: x, True),
    "sin": (torch.sin, lambda x, r: torch.cos(x), False),
    "cos": (torch.cos, lambda x, r: -torch.sin(x), False),
    "tan": (torch.tan, lambda x, r: 1.0 + r * r, False),
    "arcsin": (torch.arcsin, lambda x, r: torch.sqrt(1.0 - x * x), True),
    "arccos": (torch.arccos, lambda x, r: -torch.sqrt(1.0 - x * x), True),
    "arctan": (torch.arctan, lambda x, r: 1.0 + x * x, True),
    "sinh": (torch.sinh, lambda x, r: torch.cosh(x), False),
    "cosh": (torch.cosh, lambda x, r: torch.sinh(x), False),
    "tanh": (torch.tanh, lambda x, r: 1.0 - r * r, False),
    "arcsinh": (torch.arcsinh, lambda x, r: torch.sqrt(x * x + 1.0), True),
    "arccosh": (torch.arccosh, lambda x, r: torch.sqrt(x * x - 1.0), True),
    "arctanh": (torch.arctanh, lambda x, r: 1.0 - x * x, True),
    "abs": (torch.abs, lambda x, r: torch.sign(x), False),
    "sqrt": (torch.sqrt, lambda x, r: 2.0 * r, True),
}


def _dual_add_t(ta, tb):
    if ta is None:
        return tb
    return ta if tb is None else ta + tb


def dual_ew(instrs, imm, inputs, batch: int):
    """One elementwise program on dual numbers: ``(value, tangents)`` of the
    last instruction of ``instrs`` (see :data:`DUAL_OPCODES`) for the
    ``inputs``, a list of ``(val, tan)`` with ``val`` of shape ``()``, ``(1,)``
    or ``(n,)`` and ``tan`` ``(batch, 1)`` or ``(batch, n)``, or ``None`` for a
    constant. A constant operand contributes no term to a tangent, so a zero
    never meets an ``inf`` of the other operand; ``pow`` with a constant
    exponent takes no logarithm; ``gt``, ``ge``, ``leabs`` (``|a| <= b``),
    ``sign`` and ``detach`` give constants; ``select`` takes ``b`` where
    ``a != 0`` else ``c``; ``custom`` has the value of ``a`` and the tangent
    ``b * tangent(c)``. With ``batch == 0`` only values are computed. The
    tangent is ``None`` when the output is a constant."""
    val, tan, shape = _dual_program(instrs, imm, inputs, batch, lambda v: v)
    val = val.expand(shape).contiguous()
    if tan is not None:
        tan = tan.expand((batch,) + (tuple(shape) or (1,))).contiguous()
    return val, tan


def dual_ew_scatter(instrs, imm, inputs, batch: int, gather_color, gather_row):
    """:func:`dual_ew` in the assembly's layout, as ``dual_ew_scatter``
    computes it: ``(rhs, data)`` with ``rhs`` the negated value and
    ``data[k]`` the tangent row ``gather_color[k]`` at element
    ``gather_row[k]`` (int32 ``(nnz,)``), each nonzero's tangent computed
    from its own entries of the inputs' tangents and its element's values by
    the operations of :func:`dual_ew` (so the pair equals ``dual_ew``
    followed by the gather, to the bit); zeros where the output is a
    constant, ``None`` for ``batch == 0``."""
    gc, gr = gather_color.long(), gather_row.long()
    picked = [
        (v, None if t is None or not batch else t[gc, gr if t.shape[1] > 1 else 0])
        for v, t in inputs
    ]
    val, tan, shape = _dual_program(
        instrs, imm, picked, batch, lambda v: v if v.numel() <= 1 else v[gr]
    )
    rhs = -val.expand(shape)
    if not batch:
        return rhs, None
    if tan is None:
        return rhs, torch.zeros(gc.shape[0], dtype=rhs.dtype, device=rhs.device)
    return rhs, tan.expand(gc.shape).contiguous()


def _dual_program(instrs, imm, inputs, batch: int, pick):
    """The value, the tangent (``None`` for a constant) and the broadcast
    shape of the values of :func:`dual_ew`'s program. ``pick`` takes a value
    (or a partial derivative) to the tangents' layout: the identity where
    tangents are ``(batch, n)`` rows, the nonzeros' elements where they are
    one entry a nonzero."""
    ref = inputs[0][0]
    dtype, dev = ref.dtype, ref.device
    regs: list = [None] * DUAL_MAX_INPUTS
    for k, (val, tan) in enumerate(inputs):
        regs[k] = (val, tan if batch else None)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for name_code, a, b, c in instrs:
        name = DUAL_OPCODES[name_code]
        if name == "loadi":
            regs.append((torch.tensor(imm[a], dtype=dtype, device=dev), None))
            continue
        va, ta = regs[a]
        if name in _DUAL_UNARY:
            fn, dfn, divide = _DUAL_UNARY[name]
            r = fn(va)
            t = None
            if ta is not None:
                d = pick(dfn(va, r))
                t = ta / d if divide else ta * d
            regs.append((r, t))
            continue
        if name == "neg":
            regs.append((-va, None if ta is None else -ta))
        elif name in ("sign", "detach"):
            regs.append((torch.sign(va) if name == "sign" else va, None))
        elif name in ("add", "sub"):
            vb, tb = regs[b]
            if name == "sub":
                regs.append((va - vb, _dual_add_t(ta, None if tb is None else -tb)))
            else:
                regs.append((va + vb, _dual_add_t(ta, tb)))
        elif name == "mul":
            vb, tb = regs[b]
            regs.append((
                va * vb,
                _dual_add_t(None if ta is None else ta * pick(vb), None if tb is None else pick(va) * tb),
            ))
        elif name == "div":
            vb, tb = regs[b]
            r = va / vb
            if tb is None:
                t = None if ta is None else ta / pick(vb)
            elif ta is None:
                t = -(tb * pick(r)) / pick(vb)
            else:
                t = (ta - tb * pick(r)) / pick(vb)
            regs.append((r, t))
        elif name == "pow":
            vb, tb = regs[b]
            r = torch.pow(va, vb)
            t = None
            if ta is not None:
                t = ta * pick(torch.where(vb == 0.0, zero, vb * torch.pow(va, vb - 1.0)))
            if tb is not None:
                w = torch.where((va == 0.0) & (vb >= 0.0), zero, r * torch.log(va))
                t = _dual_add_t(t, tb * pick(w))
            regs.append((r, t))
        elif name in ("gt", "ge", "leabs"):
            vb, _tb = regs[b]
            mask = va > vb if name == "gt" else va >= vb if name == "ge" else torch.abs(va) <= vb
            regs.append((mask.to(dtype), None))
        elif name == "select":
            (vb, tb), (vc, tc) = regs[b], regs[c]
            mask = va != 0.0
            t = None
            if tb is not None or tc is not None:
                t = torch.where(pick(mask), zero if tb is None else tb, zero if tc is None else tc)
            regs.append((torch.where(mask, vb, vc), t))
        elif name == "custom":
            (vb, _tb), (_vc, tc) = regs[b], regs[c]
            regs.append((va, None if tc is None else pick(vb) * tc))
        else:
            raise ValueError(f"dual_ew: unknown opcode {name_code}")
    val, tan = regs[-1]
    return val, tan, torch.broadcast_shapes(*(v.shape for v, _t in inputs))


def dual_seed_rows(idx, colors, batch: int):
    """The one-hot tangent rows of the unknowns ``x[idx]`` by color:
    ``(batch, n)`` with entry ``(c, i)`` 1 where ``colors[idx[i]] == c``,
    else 0. ``idx`` int64, ``colors`` int32 over all unknowns."""
    rows = torch.arange(batch, dtype=colors.dtype, device=colors.device)[:, None]
    return (colors[idx][None, :] == rows).to(torch.float64)


def dual_gather_var(x, idx, colors, batch: int):
    """The dual of the unknowns ``x[idx]`` under one-hot seeds by color:
    ``(val, tan)`` with ``val = x[idx]`` and ``tan`` the
    :func:`dual_seed_rows` (``None`` for ``batch == 0``)."""
    val = x[idx]
    if not batch:
        return val, None
    return val, dual_seed_rows(idx, colors, batch).to(x.dtype)


def dual_gather_copy(pieces, batch: int):
    """The concatenation of the duals ``pieces``, a list of ``(val, tan)``
    with ``val`` ``(n_k,)`` and ``tan`` ``(batch, n_k)`` or ``None`` (a
    constant, whose rows read 0): ``(val, tan)`` of length ``sum n_k``; ``tan``
    is ``None`` when every piece is a constant or ``batch == 0``."""
    val = torch.cat([v for v, _t in pieces])
    if not batch or all(t is None for _v, t in pieces):
        return val, None
    tan = torch.cat(
        [
            torch.zeros((batch, v.shape[0]), dtype=val.dtype, device=val.device) if t is None else t
            for v, t in pieces
        ],
        dim=1,
    )
    return val, tan


def jac_gather(vals, tans, gather_color, gather_row, nnz_offsets, row_offsets):
    """The Jacobian nonzeros of all equations in the global nonzero order and
    the negated, concatenated residual: nonzero ``k`` of equation ``e``
    (``nnz_offsets[e] <= k < nnz_offsets[e + 1]``) is ``tans[e][gather_color[k],
    gather_row[k]]`` (0 where ``tans[e]`` is ``None``), and rows
    ``row_offsets[e]:row_offsets[e + 1]`` of the right-hand side are
    ``-vals[e]``. Gathers only, in a fixed order."""
    ref = vals[0]
    data = torch.zeros(nnz_offsets[-1], dtype=ref.dtype, device=ref.device)
    for e, tan in enumerate(tans):
        lo, hi = nnz_offsets[e], nnz_offsets[e + 1]
        if tan is not None and hi > lo:
            data[lo:hi] = tan[gather_color[lo:hi].long(), gather_row[lo:hi].long()]
    return data, -torch.cat(list(vals))
