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
    "region_solve_contract",
    "KRYLOV_BLOCK",
    "block_partials",
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
    "rachford_rice",
    "interp_lookup",
    "block_inverse",
    "halo_pack",
    "ell_spmv_split",
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


# -- K10 --------------------------------------------------------------------------


def region_solve_contract(a: torch.Tensor, rhs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per region of the batch: ``W @ solve(A / s, RHS / s)``, with ``s``
    the row maxima of ``|A|`` (1 for a zero row). ``a`` is ``(B, n, n)``,
    ``rhs`` ``(B, n, m)``, ``w`` ``(B, q, n)``; returns ``(B, q, m)``."""
    scale = a.abs().amax(dim=2, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    x = torch.linalg.solve(a / scale, rhs / scale)
    return w @ x


# -- K18 --------------------------------------------------------------------------

#: Threads per block of the K18 kernels (``kBlock`` in ``csrc/krylov.cu``): a
#: dot product over ``n`` entries leaves ``ceil(n / KRYLOV_BLOCK)`` partials.
KRYLOV_BLOCK = 128

# Scalar slots of the BiCGStab state ``st`` and its stages.
BICG_RHO, BICG_ALPHA, BICG_OMEGA, BICG_RHO_NEW, BICG_BETA, BICG_ATOL2 = range(6)
BICG_ALPHA_NEW, BICG_OMEGA_NEW, BICG_EXIT, BICG_RR = range(6, 10)
BICG_SLOTS = 10
STAGE_INIT, STAGE_ALPHA, STAGE_OMEGA, STAGE_NEXT = range(4)
# Scalar slots of the GMRES state.
GMRES_ATOL, GMRES_RESNORM = range(2)
GMRES_SLOTS = 2

_EPS = torch.finfo(torch.float64).eps


def block_partials(v: torch.Tensor) -> torch.Tensor:
    """The per-block partial sums of ``v`` (length ``n``) in the kernels'
    blocking: ``ceil(n / KRYLOV_BLOCK)`` sums of consecutive entries."""
    nb = -(-v.shape[0] // KRYLOV_BLOCK)
    return torch.nn.functional.pad(v, (0, nb * KRYLOV_BLOCK - v.shape[0])).view(nb, KRYLOV_BLOCK).sum(1)


def bicgstab_p(r, q, dinv, st, p, phat) -> None:
    """In place: ``p <- r + beta (p - omega q)``, ``phat = dinv p``."""
    p.copy_(r + st[BICG_BETA] * (p - st[BICG_OMEGA] * q))
    phat.copy_(dinv * p)


def krylov_dots(a, b, c, d, partials, ndots: int) -> None:
    """Partials of ``<a, b>`` into ``partials[0]`` and, with ``ndots == 2``,
    of ``<c, d>`` into ``partials[1]``."""
    partials[0] = block_partials(a * b)
    if ndots > 1:
        partials[1] = block_partials(c * d)


def bicgstab_s(r, q, dinv, st, s, shat, partials) -> None:
    """In place: ``s = r - alpha_ q``, ``shat = dinv s``, partials of
    ``<s, s>`` into ``partials[0]``."""
    s.copy_(r - st[BICG_ALPHA_NEW] * q)
    shat.copy_(dinv * s)
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
    sums = partials.sum(1)
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


def cgs_project(av, dinv, V, w, partials, flags, k: int) -> None:
    """Arnoldi step ``k``, first pass: ``w = dinv av``; partials of
    ``<V[j], w>`` (rows ``j <= k``) and of ``<w, w>`` (row ``k + 1``).
    Nothing once ``flags[k]`` is set (a breakdown earlier in the restart)."""
    if bool(flags[k]):
        return
    w.copy_(dinv * av)
    partials[: k + 1] = torch.stack([block_partials(V[j] * w) for j in range(k + 1)])
    partials[k + 1] = block_partials(w * w)


def cgs_update(V, w, partials, flags, k: int) -> None:
    """``h = V[:k+1] w`` from the partials, ``w <- w - V[:k+1]^T h``,
    partials of ``<w, w>`` into row ``k + 2``."""
    if bool(flags[k]):
        return
    h = partials[: k + 1].sum(1)
    w.copy_(w - V[: k + 1].T @ h)
    partials[k + 2] = block_partials(w * w)


def cgs_normalize(w, V, H, partials, flags, k: int) -> None:
    """``V[k + 1] = w / |w|`` (0 at or below ``eps |w_0|``), Hessenberg row
    ``k`` and the breakdown flag ``flags[k + 1]``, as jax's
    ``_kth_arnoldi_iteration`` with ``_safe_normalize``."""
    restart = H.shape[0]
    if bool(flags[k]):
        V[k + 1] = 0.0
        flags[k + 1] = 1
        return
    sums = partials[: k + 3].sum(1)
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


def gmres_lstsq(H, st, y) -> None:
    """``y`` of jax's ``_lstsq(H^T, beta e_0)``: the normal equations
    ``H H^T y = beta H[:, 0]`` by Cholesky."""
    a2 = H @ H.T
    b2 = H[:, 0] * st[GMRES_RESNORM]
    L = torch.linalg.cholesky(a2)
    y.copy_(torch.cholesky_solve(b2[:, None], L)[:, 0])


def gmres_correct(V, y, x) -> None:
    """``x <- x + V[:restart]^T y``."""
    x.copy_(x + V[: y.shape[0]].T @ y)


def gmres_residual(b, ax, dinv, w, partials) -> None:
    """``w = dinv (b - ax)``, partials of ``<w, w>`` into row 0."""
    w.copy_(dinv * (b - ax))
    partials[0] = block_partials(w * w)


def gmres_restart(w, V, H, partials, flags, st, cont) -> None:
    """Start of a restart: ``V[0] = w / |w|`` (0 at or below eps), the
    residual norm, ``cont = |w| > atol``, ``H = eye``, flags cleared."""
    norm = torch.sqrt(partials[0].sum())
    use = bool(norm > _EPS)
    V[0] = w / norm if use else 0.0
    H.copy_(torch.eye(H.shape[0], H.shape[1], dtype=H.dtype, device=H.device))
    flags.zero_()
    st[GMRES_RESNORM] = norm if use else 0.0
    cont.fill_(int(bool(st[GMRES_RESNORM] > st[GMRES_ATOL])))


# -- K17 --------------------------------------------------------------------------


def rachford_rice(zs: torch.Tensor, K: torch.Tensor, max_iter: int, tol: float):
    """The constant-K Rachford-Rice flash of ``ConstantKFlash``: ``zs``
    ``(nc, N)``, ``K`` ``(nc,)``. Returns ``(V, x, y, converged, iters)``:
    the vapor fraction ``(N,)``, the normalised liquid and vapor
    compositions ``(nc, N)``, the convergence flags and, per point, the
    number of guarded Newton iterations until one left ``V`` unchanged
    (``max_iter`` if none did; the later iterations repeat it; 0 for a
    single-phase point, whose ``V`` the corners set)."""
    Kc = K[:, None]
    km1 = Kc - 1.0
    all_liquid = torch.sum(zs * Kc, dim=0) <= 1.0
    all_vapor = torch.sum(zs / Kc, dim=0) <= 1.0

    def h_fun(V):
        return torch.sum(zs * km1 / (1.0 + V * km1), dim=0)

    def dh_fun(V):
        return -torch.sum(zs * (km1 * km1) / ((1.0 + V * km1) * (1.0 + V * km1)), dim=0)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    one = torch.ones((), dtype=zs.dtype, device=zs.device)
    Kmax, Kmin = torch.max(Kc), torch.min(Kc)
    lo = torch.where(Kmax > 1.0, 1.0 / (1.0 - Kmax), -1e10 * one) + 1e-12
    hi = torch.where(Kmin < 1.0, 1.0 / (1.0 - Kmin), 1e10 * one) - 1e-12
    V = clip(torch.full((zs.shape[1],), 0.5, dtype=zs.dtype, device=zs.device), lo, hi)
    # A single-phase point's V is replaced by 0 or 1 after the iterations:
    # the kernel skips them there and counts 0.
    single = all_liquid | all_vapor
    iters = torch.where(single, 0, max_iter).to(torch.int32)
    running = ~single
    for it in range(max_iter):
        dh = dh_fun(V)
        step = h_fun(V) / torch.where(torch.abs(dh) > 1e-30, dh, -one)
        Vn = clip(V - step, lo, hi)
        fixed = running & (Vn == V)
        iters = torch.where(fixed, torch.full_like(iters, it + 1), iters)
        running = running & ~fixed
        V = Vn
    V = torch.where(all_liquid, 0.0 * one, torch.where(all_vapor, one, V))
    V = clip(V, 0.0 * one, one)
    x = zs / (1.0 + V[None] * km1)
    y = Kc * x
    x = x / torch.sum(x, dim=0)
    y = y / torch.sum(y, dim=0)
    resid = torch.abs(h_fun(clip(V, lo, hi)))
    two_phase = ~(all_liquid | all_vapor)
    converged = torch.where(two_phase, resid < tol, torch.ones_like(two_phase))
    return V, x, y, converged, iters


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
    and zero at the padding column ``n_own + x_halo.numel()``. Written as
    :func:`ell_spmv` on ``[x_own, x_halo]``, so that one shard holding every
    row gives :func:`ell_spmv`'s result bit for bit."""
    return ell_spmv(val, col, torch.cat([x_own, x_halo]))
