"""Dense stencil TPFA flow step for structured (Cartesian) grids.

The single-phase-flow Newton iteration on tensor-product grids: pressure
lives as an ``(nx, ny, nz)`` tensor, the residual and its Jacobian action
are one launch each of the hand-written stencil kernels
(:func:`~porepy_tpu_torch.kernels.structured_residual`,
:func:`~porepy_tpu_torch.kernels.structured_jvp`), and the linear solve is
a BiCGStab in float32 wrapped in float64 iterative refinement, as in
``porepy_tpu/parallel/structured_flow.py``. The float32 Jacobian is
written once a Newton step as a 7-point stencil
(:func:`~porepy_tpu_torch.kernels.structured_linearize`, one launch) and
each of the step's solves is two cooperative launches of
:class:`~porepy_tpu_torch.kernels.FlowCycle`, the matvecs inside. The
step's float64 residual writes the cell densities beside it, and each
refinement round's ``-r - J dx`` is one launch that reads them
(:class:`~porepy_tpu_torch.kernels.StructuredLauncher`), as
``jax.linearize`` keeps the primal's intermediates for its tangent map.

This is the structured-grid fast path behind the ``structured`` bench case
of ``porepy_tpu``; the general unstructured path is
:mod:`porepy_tpu_torch.parallel.flow_step`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Union

import numpy as np
import torch

from porepy_tpu_torch import kernels

__all__ = ["StructuredFlowKernel", "build_structured_flow_kernel"]


@dataclasses.dataclass(frozen=True)
class StructuredFlowKernel:
    """Tensors for a 3D Cartesian compressible single-phase TPFA step, all
    on one device.

    Transmissibility tensors are face-centered per axis and include the
    one-sided boundary transmissibilities; ``pbc_*`` hold Dirichlet values
    on the six sides (whole boundary Dirichlet). The fluid scalars are 0-d
    tensors.
    """

    tx: torch.Tensor  # (nx+1, ny, nz)
    ty: torch.Tensor  # (nx, ny+1, nz)
    tz: torch.Tensor  # (nx, ny, nz+1)
    pbc_x: torch.Tensor  # (2, ny, nz) west/east Dirichlet pressures
    pbc_y: torch.Tensor  # (2, nx, nz)
    pbc_z: torch.Tensor  # (2, nx, ny)
    pv: torch.Tensor  # (nx, ny, nz) pore volume

    rho_ref: torch.Tensor
    comp: torch.Tensor
    visc: torch.Tensor
    p_ref: torch.Tensor
    dt: torch.Tensor

    shape: tuple

    def density(self, p):
        return self.rho_ref * torch.exp(self.comp * (p - self.p_ref))

    def _coef(self) -> torch.Tensor:
        return torch.stack([self.rho_ref, self.comp, self.visc, self.p_ref, self.dt])

    def _arrays(self) -> tuple:
        return (self.tx, self.ty, self.tz, self.pbc_x, self.pbc_y, self.pbc_z, self.pv)

    def residual(self, p, p_prev):
        """Mass-balance residual, one launch of the stencil kernel."""
        return kernels.structured_residual(p, p_prev, *self._arrays(), self._coef())

    def jvp(self, p, dp):
        """``J(p) dp``, the Jacobian action at ``p`` (what ``jax.linearize``
        gives ``porepy_tpu``), one launch of the stencil kernel."""
        return kernels.structured_jvp(p, dp, *self._arrays(), self._coef())

    # -- Newton step with mixed-precision Krylov -----------------------------

    @functools.cached_property
    def _launcher(self) -> "kernels.StructuredLauncher":
        """The step's residual and refinement launches on these arrays,
        made at first use."""
        return kernels.StructuredLauncher(*self._arrays(), self._coef())

    @functools.cached_property
    def _solvers(self) -> dict:
        """Per dtype, made at first use: ``(args, cycle)``, the
        linearization's arguments (the kernel's arrays and fluid scalars in
        that dtype) and the :class:`~porepy_tpu_torch.kernels.FlowCycle`
        over the Jacobian's stencil ``(7, nx, ny, nz)`` and Jacobi diagonal,
        both rewritten each linearization."""
        return {}

    def _linearized(self, p, dtype):
        """The solver of ``J(p)`` in ``dtype``: one ``structured_linearize``
        launch at ``p`` cast to ``dtype`` (arrays in ``dtype``), and
        ``M = v / diag`` with the Jacobi diagonal at ``p`` cast to it."""
        solver = self._solvers.get(dtype)
        if solver is None:
            k = self if dtype == self.tx.dtype else self._as_dtype(dtype)
            dev = self.tx.device
            jac = torch.empty((7,) + tuple(self.shape), dtype=dtype, device=dev)
            diag = torch.empty(jac[0].numel(), dtype=dtype, device=dev)
            solver = self._solvers[dtype] = ((*k._arrays(), k._coef()), kernels.FlowCycle("stencil", (jac,), diag))
        args, cycle = solver
        kernels.structured_linearize(p.to(dtype), *args, cycle.op[0])
        cycle.diag.copy_(self._jacobi_diagonal(p).reshape(-1))
        return cycle

    def newton_step(
        self,
        p,
        p_prev,
        tol: float = 1e-9,
        inner_iter: int = 200,
        refine: int = 3,
        iterations: list | None = None,
    ):
        """One Newton iteration. The Jacobian action is taken at ``p`` in
        f64 and, for the Krylov inner iterations, at ``p`` cast to f32 with
        f32 coefficients (one linearization, four solves of two launches
        each); ``refine`` rounds of f64 iterative refinement recover f64
        accuracy. Each solve's iteration count is appended to
        ``iterations`` when a list is given. The residual launch also writes
        the cell densities, ``c = -r`` is formed once, and each refinement
        round is one launch of ``c - J(p) dx`` from those densities. Returns
        ``(p_new, |r(p)|)``."""
        launcher = self._launcher
        r64, rho = launcher.residual(p, p_prev)
        rnorm = torch.linalg.vector_norm(r64)
        cycle = self._linearized(p, torch.float32)

        def solve32(rhs64):
            # Normalize (guards f32 underflow / Krylov breakdown on ~zero
            # right-hand sides) and sanitize non-finite outcomes.
            nrm = torch.linalg.vector_norm(rhs64)
            scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            rhs32 = (rhs64 / scale).to(torch.float32).reshape(-1)
            x, k = cycle.solve(rhs32, tol=1e-6, atol=0.0, maxiter=inner_iter)
            if iterations is not None:
                iterations.append(k)
            x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
            return x.view(p.shape).to(torch.float64) * scale

        # Iterative refinement in f64.
        c = -r64
        dx = solve32(c)
        for _ in range(refine):
            dx = dx + solve32(launcher.refine(p, dx, c, rho))
        return p + dx, rnorm

    def newton_step_f64(self, p, p_prev, tol: float = 1e-9, maxiter: int = 400):
        """One Newton iteration with an f64 BiCGStab to ``tol`` on the f64
        linearization (two launches)."""
        r = kernels.structured_residual(p, p_prev, *self._arrays(), self._coef())
        cycle = self._linearized(p, torch.float64)
        dx, _ = cycle.solve((-r).reshape(-1), tol=tol, atol=0.0, maxiter=maxiter)
        return p + dx.view(p.shape), torch.linalg.vector_norm(r)

    def _jacobi_diagonal(self, p):
        w = self.density(p) / self.visc
        diag = (
            self.tx[:-1] + self.tx[1:] + self.ty[:, :-1] + self.ty[:, 1:]
            + self.tz[:, :, :-1] + self.tz[:, :, 1:]
        ) * w
        diag = diag + self.pv * self.comp * self.density(p) / self.dt
        return diag

    def _as_dtype(self, dtype):
        fields = {
            f.name: getattr(self, f.name).to(dtype)
            for f in dataclasses.fields(self)
            if f.name != "shape"
        }
        return StructuredFlowKernel(**fields, shape=self.shape)


def build_structured_flow_kernel(
    nx: tuple[int, int, int],
    physdims: tuple[float, float, float],
    permeability: float = 1.0,
    porosity: float = 0.1,
    viscosity: float = 1.0,
    compressibility: float = 1e-8,
    rho_ref: float = 1000.0,
    p_ref: float = 0.0,
    dt: float = 1.0,
    bc_pressure=None,
    device: Union[str, torch.device] = "cuda",
) -> tuple[StructuredFlowKernel, torch.Tensor]:
    """Build kernel tensors on ``device`` for a homogeneous Cartesian box,
    whole-boundary Dirichlet. ``bc_pressure(x, y, z)`` evaluates boundary
    pressures. Returns ``(kernel, p0)`` with ``p0`` filled with ``p_ref``."""
    nx_, ny_, nz_ = nx
    lx, ly, lz = physdims
    dx, dy, dz = lx / nx_, ly / ny_, lz / nz_

    def t_axis(n, d, area, shape):
        t = np.full(shape, permeability * area / d)
        # One-sided boundary faces: half distance.
        t_b = permeability * area / (d / 2.0)
        t[0] = t_b
        t[-1] = t_b
        return t

    tx = t_axis(nx_, dx, dy * dz, (nx_ + 1, ny_, nz_))
    ty = np.moveaxis(t_axis(ny_, dy, dx * dz, (ny_ + 1, nx_, nz_)), 0, 1)
    tz = np.moveaxis(t_axis(nz_, dz, dx * dy, (nz_ + 1, nx_, ny_)), 0, 2)

    xc = (np.arange(nx_) + 0.5) * dx
    yc = (np.arange(ny_) + 0.5) * dy
    zc = (np.arange(nz_) + 0.5) * dz
    if bc_pressure is None:
        bc_pressure = lambda x, y, z: np.zeros(np.broadcast(x, y, z).shape)  # noqa: E731

    Y, Z = np.meshgrid(yc, zc, indexing="ij")
    pbc_x = np.stack([bc_pressure(0.0 * Y, Y, Z), bc_pressure(lx + 0.0 * Y, Y, Z)])
    X, Z2 = np.meshgrid(xc, zc, indexing="ij")
    pbc_y = np.stack([bc_pressure(X, 0.0 * X, Z2), bc_pressure(X, ly + 0.0 * X, Z2)])
    X3, Y3 = np.meshgrid(xc, yc, indexing="ij")
    pbc_z = np.stack([bc_pressure(X3, Y3, 0.0 * X3), bc_pressure(X3, Y3, lz + 0.0 * X3)])

    def f64(a):
        return torch.tensor(np.array(a, dtype=np.float64, order="C"), device=device)

    kernel = StructuredFlowKernel(
        tx=f64(tx),
        ty=f64(ty),
        tz=f64(tz),
        pbc_x=f64(pbc_x),
        pbc_y=f64(pbc_y),
        pbc_z=f64(pbc_z),
        pv=f64(np.full((nx_, ny_, nz_), porosity * dx * dy * dz)),
        rho_ref=f64(rho_ref),
        comp=f64(compressibility),
        visc=f64(viscosity),
        p_ref=f64(p_ref),
        dt=f64(dt),
        shape=(nx_, ny_, nz_),
    )
    p0 = torch.full((nx_, ny_, nz_), float(p_ref), dtype=torch.float64, device=device)
    return kernel, p0
