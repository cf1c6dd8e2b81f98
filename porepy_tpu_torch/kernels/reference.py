"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel in ``csrc/`` computes,
with ordinary tensor operations. The kernel wrappers in
:mod:`porepy_tpu_torch.kernels.ops` call these for tensors on the CPU; the
tests and ``chip_smoke.py`` hold each kernel against its plain version.
"""

from __future__ import annotations

import torch

__all__ = [
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
]


def ell_spmv(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A x`` for A in padded-row (ELL) form: ``val``/``col`` of shape
    ``(n_rows, K)``, padding columns equal to ``x.shape[-1]`` read zero.
    ``x`` is ``(n_cols,)`` or ``(B, n_cols)``."""
    pad = x.new_zeros(x.shape[:-1] + (1,))
    x_p = torch.cat([x, pad], dim=-1)
    return (val * x_p[..., col]).sum(dim=-1)


def ell_jacobi_sweep(
    val: torch.Tensor,
    col: torch.Tensor,
    sinv: torch.Tensor,
    r: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """One smoother sweep ``y + sinv * (r - A y)`` for square ELL ``A``."""
    return y + sinv * (r - ell_spmv(val, col, y))


def fgmres_givens(
    hcol: torch.Tensor,
    cs: torch.Tensor,
    sn: torch.Tensor,
    g: torch.Tensor,
    j: torch.Tensor,
    atol: torch.Tensor,
    flag: torch.Tensor,
) -> None:
    """In place: rotate the new Hessenberg column ``hcol`` by the ``j``
    previous Givens rotations, form rotation ``j``, update ``g``, set
    ``flag = (j + 1 < restart) & (|g[j + 1]| > atol)`` and advance ``j``.
    ``restart = hcol.numel() - 1``; ``j``/``flag`` are int32 scalars. A
    ``j`` outside ``[0, restart)`` only clears the flag."""
    jj = int(j)
    restart = hcol.shape[0] - 1
    if jj < 0 or jj >= restart:
        flag.fill_(0)
        return
    h = hcol
    for i in range(jj):
        hi = h[i].clone()
        hn = h[i + 1].clone()
        h[i] = cs[i] * hi + sn[i] * hn
        h[i + 1] = -sn[i] * hi + cs[i] * hn
    denom = torch.sqrt(h[jj] * h[jj] + h[jj + 1] * h[jj + 1])
    safe = torch.clamp(denom, min=1e-30)
    c = h[jj] / safe
    s = h[jj + 1] / safe
    cs[jj] = c
    sn[jj] = s
    h[jj] = denom
    h[jj + 1] = 0.0
    gj = g[jj].clone()
    g[jj + 1] = -s * gj
    g[jj] = c * gj
    flag.fill_(int(jj + 1 < restart and bool(torch.abs(g[jj + 1]) > atol)))
    j.fill_(jj + 1)


# -- K6 ---------------------------------------------------------------------------


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


def _density(p, coef):
    return coef[0] * torch.exp(coef[1] * (p - coef[3]))


def structured_residual(p, p_prev, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """Mass-balance residual of the 7-point TPFA stencil on an ``(nx, ny,
    nz)`` grid with Dirichlet ghost values ``pbc_*`` on the six sides;
    ``coef = [rho_ref, comp, visc, p_ref, dt]``. The upwind side follows
    the sign of the (detached) flux."""
    visc, dt = coef[2], coef[4]

    def axis_fluxes(t, ghosts, axis):
        pg = torch.cat([ghosts[0].unsqueeze(axis), p, ghosts[1].unsqueeze(axis)], axis)
        m = pg.shape[axis] - 1
        lo, hi = pg.narrow(axis, 0, m), pg.narrow(axis, 1, m)
        q = t * (lo - hi)
        w = torch.where(q.detach() >= 0, _density(lo, coef), _density(hi, coef)) / visc
        return w * q

    fx = axis_fluxes(tx, pbc_x, 0)
    fy = axis_fluxes(ty, pbc_y, 1)
    fz = axis_fluxes(tz, pbc_z, 2)
    div = (fx[:-1] - fx[1:]) + (fy[:, :-1] - fy[:, 1:]) + (fz[:, :, :-1] - fz[:, :, 1:])
    accumulation = pv * (_density(p, coef) - _density(p_prev, coef)) / dt
    return accumulation - div


def structured_jvp(p, dp, tx, ty, tz, pbc_x, pbc_y, pbc_z, pv, coef):
    """``J(p) dp`` of :func:`structured_residual`: its forward-mode
    derivative written out (upwind side fixed by the primal flux, ghost
    tangents 0). The tests hold it against ``torch.func.jvp`` of the
    residual, which costs ten times more per call."""
    comp, visc, dt = coef[1], coef[2], coef[4]

    def axis_tangent(t, ghosts, axis):
        zero = torch.zeros_like(ghosts[0]).unsqueeze(axis)
        pg = torch.cat([ghosts[0].unsqueeze(axis), p, ghosts[1].unsqueeze(axis)], axis)
        dg = torch.cat([zero, dp, zero], axis)
        m = pg.shape[axis] - 1
        lo, hi = pg.narrow(axis, 0, m), pg.narrow(axis, 1, m)
        dlo, dhi = dg.narrow(axis, 0, m), dg.narrow(axis, 1, m)
        q = t * (lo - hi)
        dq = t * (dlo - dhi)
        rlo, rhi = _density(lo, coef), _density(hi, coef)
        up = q >= 0
        w = torch.where(up, rlo, rhi) / visc
        dw = torch.where(up, comp * rlo * dlo, comp * rhi * dhi) / visc
        return dw * q + w * dq

    fx = axis_tangent(tx, pbc_x, 0)
    fy = axis_tangent(ty, pbc_y, 1)
    fz = axis_tangent(tz, pbc_z, 2)
    div = (fx[:-1] - fx[1:]) + (fy[:, :-1] - fy[:, 1:]) + (fz[:, :, :-1] - fz[:, :, 1:])
    return pv * (comp * _density(p, coef) * dp) / dt - div


# -- K13 --------------------------------------------------------------------------


def _tpfa_face_values(p, lo, hi, bc_val):
    lo_ok, hi_ok = lo >= 0, hi >= 0
    p_lo = torch.where(lo_ok, p[lo.clamp(min=0).long()], bc_val)
    p_hi = torch.where(hi_ok, p[hi.clamp(min=0).long()], bc_val)
    return p_lo, p_hi


def _tpfa_divergence(mass_flux, cell_ptr, cell_faces, nc):
    """Per cell, the sum of ``+m[f]`` over faces where it is ``lo`` and
    ``-m[f]`` where it is ``hi``, through the CSR."""
    cf = cell_faces.long()
    face = torch.where(cf >= 0, cf, -cf - 1)
    contrib = torch.where(cf >= 0, mass_flux[face], -mass_flux[face])
    cell = torch.repeat_interleave(
        torch.arange(nc, device=mass_flux.device), (cell_ptr[1:] - cell_ptr[:-1]).long()
    )
    div = torch.zeros(nc, dtype=mass_flux.dtype, device=mass_flux.device)
    return div.index_add(0, cell, contrib)


def tpfa_residual(p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    """Mass-balance residual of the unstructured TPFA flow step: face mass
    fluxes (Dirichlet ghosts from ``bc_val`` where ``lo``/``hi`` is -1,
    prescribed fluxes on ``is_neu`` faces, detached upwind choice), summed
    into each cell through the CSR ``cell_ptr``/``cell_faces`` (``f`` where
    the cell is ``lo[f]``, ``-f - 1`` where it is ``hi[f]``)."""
    visc, dt = coef[2], coef[4]
    p_lo, p_hi = _tpfa_face_values(p, lo, hi, bc_val)
    q = torch.where(is_neu, bc_val, t * (p_lo - p_hi))
    upstream = q.detach() >= 0
    w = torch.where(upstream, _density(p_lo, coef), _density(p_hi, coef)) / visc
    mass_flux = torch.where(is_neu, q, w * q)
    div = _tpfa_divergence(mass_flux, cell_ptr, cell_faces, pv.shape[0])
    accumulation = pv * (_density(p, coef) - _density(p_prev, coef)) / dt
    return accumulation + div


def tpfa_jvp(p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef):
    """``J(p) dp`` of :func:`tpfa_residual`: its forward-mode derivative
    written out (upwind side fixed by the primal flux, ghost tangents 0).
    The tests hold it against ``torch.func.jvp`` of the residual."""
    comp, visc, dt = coef[1], coef[2], coef[4]
    p_lo, p_hi = _tpfa_face_values(p, lo, hi, bc_val)
    d_lo, d_hi = _tpfa_face_values(dp, lo, hi, torch.zeros_like(bc_val))
    q = torch.where(is_neu, bc_val, t * (p_lo - p_hi))
    dq = torch.where(is_neu, torch.zeros_like(q), t * (d_lo - d_hi))
    r_lo, r_hi = _density(p_lo, coef), _density(p_hi, coef)
    up = q >= 0
    w = torch.where(up, r_lo, r_hi) / visc
    dw = torch.where(up, comp * r_lo * d_lo, comp * r_hi * d_hi) / visc
    dmass = torch.where(is_neu, dq, dw * q + w * dq)
    div = _tpfa_divergence(dmass, cell_ptr, cell_faces, pv.shape[0])
    return pv * (comp * _density(p, coef) * dp) / dt + div
