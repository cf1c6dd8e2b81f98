"""Device-resident single-phase-flow Newton step on unstructured TPFA data.

The whole per-iteration work -- residual, Jacobian, Krylov solve, update
-- runs on fixed-shape tensors of one device. A Newton step makes one
launch of the hand-written TPFA kernel at ``p``
(:class:`~porepy_tpu_torch.kernels.TpfaLauncher`'s ``step``): the
residual, the Jacobian's values on a cell-cell pattern fixed by the
topology and the Jacobi diagonal, each cell walking its own faces; then
the norm, the scaled right-hand side and a Jacobi-preconditioned BiCGStab
in two cooperative launches of :class:`~porepy_tpu_torch.kernels.FlowCycle`
(the matvecs inside), one host read. The residual, the Jacobian action and
the Jacobian alone are one launch each of the same kernel
(:meth:`TpfaFlowKernel.residual`, :meth:`TpfaFlowKernel.jvp`,
:meth:`TpfaFlowKernel._linearized`).

Physics covered (matching the model-layer SinglePhaseFlow): compressible
single-phase Darcy flow, TPFA fluxes with Dirichlet ghost values / Neumann
prescribed fluxes, upwinded density-mobility advection weight, backward
Euler. ``porepy_tpu/parallel/flow_step.py`` scatters face fluxes into cells;
here each cell gathers its faces through a host-built cell-to-face CSR, so
the divergence is summed in one fixed order. Its sharding over a device
mesh is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Union

import numpy as np
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference

__all__ = ["TpfaFlowKernel", "build_cart_flow_kernel", "newton_step"]


def _cell_face_csr(lo: np.ndarray, hi: np.ndarray, num_cells: int):
    """Cell-to-face incidence as CSR ``(cell_ptr, cell_faces)``, int32:
    cell ``c``'s entries are ``f`` for each face with ``lo[f] == c`` (in
    face order), then ``-f - 1`` for each face with ``hi[f] == c`` (in face
    order)."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    faces = np.arange(lo.size)
    lo_ok, hi_ok = lo >= 0, hi >= 0
    cells = np.concatenate([lo[lo_ok], hi[hi_ok]])
    codes = np.concatenate([faces[lo_ok], -faces[hi_ok] - 1])
    order = np.argsort(cells, kind="stable")
    ptr = np.zeros(num_cells + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(np.bincount(cells, minlength=num_cells))
    return ptr.astype(np.int32), codes[order].astype(np.int32)


def _jacobian_pattern(lo, hi, cell_ptr, cell_faces, num_cells: int):
    """The Jacobian's cell-cell pattern from the cell-to-face CSR of
    :func:`_cell_face_csr`: each cell's row holds its diagonal and a column
    for each neighbour across a face, in increasing column order. Returns
    int32 ``(row_ptr, cols, slot, diag_slot)``: ``slot[e]`` the value index
    of entry ``e``'s neighbour (-1 on a boundary face), ``diag_slot[c]``
    that of cell ``c``'s diagonal."""
    lo, hi = np.asarray(lo, dtype=np.int64), np.asarray(hi, dtype=np.int64)
    cf = np.asarray(cell_faces, dtype=np.int64)
    face = np.where(cf >= 0, cf, -cf - 1)
    cell = np.repeat(np.arange(num_cells), np.diff(np.asarray(cell_ptr, dtype=np.int64)))
    other = np.where(cf >= 0, hi[face], lo[face])
    inner = other >= 0
    rows = np.concatenate([np.arange(num_cells), cell[inner]])
    cols = np.concatenate([np.arange(num_cells), other[inner]])
    keys, where = np.unique(rows * num_cells + cols, return_inverse=True)
    row_ptr = np.zeros(num_cells + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(keys // num_cells, minlength=num_cells))
    slot = np.full(cf.size, -1, dtype=np.int64)
    slot[inner] = where[num_cells:]
    return (row_ptr.astype(np.int32), (keys % num_cells).astype(np.int32),
            slot.astype(np.int32), where[:num_cells].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class TpfaFlowKernel:
    """Fixed-shape tensors for a compressible single-phase TPFA step, all
    on one device."""

    # Face topology/coefficients
    lo: torch.Tensor  # int32 (nf,) cell behind the face (-1: boundary)
    hi: torch.Tensor  # int32 (nf,) cell in front (-1: boundary)
    t: torch.Tensor  # (nf,) transmissibilities (harmonic; one-sided on bdry)
    is_neu: torch.Tensor  # bool (nf,)
    bc_val: torch.Tensor  # (nf,) dirichlet pressure / neumann total flux

    # Cell data
    pv: torch.Tensor  # (nc,) pore volume = cell_volume * porosity
    cell_ptr: torch.Tensor  # int32 (nc + 1,) CSR of _cell_face_csr
    cell_faces: torch.Tensor  # int32 (2 nf - boundary faces,)
    t_sum: torch.Tensor  # (nc,) sum of non-Neumann t over each cell's faces

    # Fluid (0-d tensors)
    rho_ref: torch.Tensor
    comp: torch.Tensor
    visc: torch.Tensor
    p_ref: torch.Tensor
    dt: torch.Tensor

    num_cells: int
    num_faces: int

    @classmethod
    def from_numpy(
        cls,
        lo,
        hi,
        t,
        is_neu,
        bc_val,
        pv,
        rho_ref,
        comp,
        visc,
        p_ref,
        dt,
        device: Union[str, torch.device] = "cuda",
    ) -> "TpfaFlowKernel":
        """The kernel from host arrays; builds the cell-to-face CSR and the
        transmissibility row sums of the Jacobi diagonal on the host."""
        lo = np.asarray(lo, dtype=np.int32)
        hi = np.asarray(hi, dtype=np.int32)
        t = np.asarray(t, dtype=np.float64)
        is_neu = np.asarray(is_neu, dtype=bool)
        pv = np.asarray(pv, dtype=np.float64)
        nc, nf = pv.size, t.size
        cell_ptr, cell_faces = _cell_face_csr(lo, hi, nc)
        t_eff = np.where(is_neu, 0.0, t)
        t_sum = np.zeros(nc)
        np.add.at(t_sum, lo[lo >= 0], t_eff[lo >= 0])
        np.add.at(t_sum, hi[hi >= 0], t_eff[hi >= 0])

        def dev(a, dtype=None):
            return torch.tensor(np.asarray(a, dtype=dtype), device=device)

        return cls(
            lo=dev(lo),
            hi=dev(hi),
            t=dev(t),
            is_neu=dev(is_neu),
            bc_val=dev(bc_val, np.float64),
            pv=dev(pv),
            cell_ptr=dev(cell_ptr),
            cell_faces=dev(cell_faces),
            t_sum=dev(t_sum),
            rho_ref=dev(rho_ref, np.float64),
            comp=dev(comp, np.float64),
            visc=dev(visc, np.float64),
            p_ref=dev(p_ref, np.float64),
            dt=dev(dt, np.float64),
            num_cells=nc,
            num_faces=nf,
        )

    # -- physics -------------------------------------------------------------

    def density(self, p):
        return self.rho_ref * torch.exp(self.comp * (p - self.p_ref))

    def face_flux(self, p):
        """Darcy flux per face with Dirichlet ghost values; Neumann faces
        carry their prescribed flux."""
        p_lo = torch.where(self.lo >= 0, p[self.lo.clamp(min=0).long()], self.bc_val)
        p_hi = torch.where(self.hi >= 0, p[self.hi.clamp(min=0).long()], self.bc_val)
        q = self.t * (p_lo - p_hi)
        return torch.where(self.is_neu, self.bc_val, q)

    def _coef(self) -> torch.Tensor:
        return torch.stack([self.rho_ref, self.comp, self.visc, self.p_ref, self.dt])

    def _arrays(self) -> tuple:
        return (
            self.lo, self.hi, self.t, self.is_neu, self.bc_val, self.pv,
            self.cell_ptr, self.cell_faces,
        )

    def residual(self, p, p_prev):
        """Mass-balance residual, one launch of the TPFA kernel (each cell
        walking its faces)."""
        return self._solver(p.dtype)[1].residual(p, p_prev)

    def jvp(self, p, dp):
        """``J(p) dp``, the Jacobian action at ``p`` (what ``jax.linearize``
        gives ``porepy_tpu``), one launch of the TPFA kernel."""
        return self._solver(p.dtype)[1].jvp(p, dp)

    # -- Newton step ---------------------------------------------------------

    @functools.cached_property
    def _solvers(self) -> dict:
        """Per dtype, made at first use: ``(args, launcher, cycle)``, the
        linearization's arguments (the kernel's arrays and fluid scalars in
        that dtype and the Jacobian's pattern slots, :func:`_jacobian_pattern`,
        built once on the host), the
        :class:`~porepy_tpu_torch.kernels.TpfaLauncher` over them (and the
        transmissibility row sums of the diagonal), and the
        :class:`~porepy_tpu_torch.kernels.FlowCycle` over the Jacobian's
        values and Jacobi diagonal, both rewritten each linearization."""
        return {}

    def _solver(self, dtype) -> tuple:
        solver = self._solvers.get(dtype)
        if solver is None:
            dev = self.t.device
            pattern = _jacobian_pattern(
                *(a.cpu().numpy() for a in (self.lo, self.hi, self.cell_ptr, self.cell_faces)),
                self.num_cells,
            )
            row_ptr, cols, slot, diag_slot = (torch.tensor(a, device=dev) for a in pattern)
            vals = torch.zeros(cols.shape[0], dtype=dtype, device=dev)
            diag = torch.empty(self.num_cells, dtype=dtype, device=dev)
            arrays = tuple(a.to(dtype) if a.is_floating_point() else a for a in self._arrays())
            args = (*arrays, self._coef().to(dtype), slot, diag_slot)
            launcher = kernels.TpfaLauncher(*args[:-2], self.t_sum.to(dtype), slot, diag_slot, cols.shape[0])
            solver = self._solvers[dtype] = (
                args, launcher, kernels.FlowCycle("tpfa", (row_ptr, cols, vals), diag),
            )
        return solver

    def _linearized(self, p, dtype):
        """The solver of ``J(p)`` in ``dtype``: one ``tpfa_linearize``
        launch at ``p`` cast to ``dtype``, and ``M = v / diag`` with the
        Jacobi diagonal at ``p`` (:meth:`_jacobi_diagonal`) cast to it."""
        _args, launcher, cycle = self._solver(dtype)
        launcher.linearize(p.to(dtype), cycle.op[-1])
        cycle.diag.copy_(self._jacobi_diagonal(p))
        return cycle

    def newton_step(self, p, p_prev, tol: float = 1e-10, maxiter: int = 200, iterations: list | None = None):
        """One Newton iteration in ``p``'s dtype: one ``tpfa_step`` launch
        at ``p`` writes the residual, the Jacobian's values and the Jacobi
        diagonal (into the :class:`~porepy_tpu_torch.kernels.FlowCycle`'s
        buffers), then BiCGStab on the Jacobian (two launches, one host
        read); the solve's iteration count is appended to ``iterations``
        when a list is given. Returns ``(p_new, residual_norm_before)``."""
        _args, launcher, cycle = self._solver(p.dtype)
        r = launcher.step(p, p_prev, cycle.op[-1], cycle.diag)
        nrm = torch.linalg.vector_norm(r)
        scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        dx, k = cycle.solve(-r / scale, tol=tol, atol=0.0, maxiter=maxiter)
        if iterations is not None:
            iterations.append(k)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) * scale
        return p + dx, nrm

    def _jacobi_diagonal(self, p):
        """Diagonal of the Jacobian: accumulation part analytically + flux
        part approximated by transmissibility row sums (exact for
        incompressible flow). The torch composition that ``tpfa_step``'s
        diagonal equals, :func:`~porepy_tpu_torch.kernels.reference.tpfa_jacobi_diagonal`."""
        return reference.tpfa_jacobi_diagonal(p, self.t_sum, self.pv, self._coef())


def build_cart_flow_kernel(
    nx,
    physdims=None,
    permeability: float = 1.0,
    porosity: float = 0.1,
    viscosity: float = 1.0,
    compressibility: float = 1e-8,
    rho_ref: float = 1000.0,
    p_ref: float = 0.0,
    dt: float = 1.0,
    bc_pressure=None,
    device: Union[str, torch.device] = "cuda",
) -> tuple[TpfaFlowKernel, np.ndarray]:
    """Host-side setup: build the kernel tensors on ``device`` for a
    Cartesian grid with Dirichlet pressure on the whole boundary. Returns
    ``(kernel, p_init)``; ``p_init`` is a host array."""
    from porepy_tpu_torch.grids.structured import CartGrid
    from porepy_tpu_torch.numerics.fv.fv_mesh import BoundaryMasks, FvMesh
    from porepy_tpu_torch.numerics.fv.tpfa import face_transmissibilities
    from porepy_tpu_torch.params.bc import BoundaryCondition

    g = CartGrid(list(nx), physdims=physdims)
    g.compute_geometry()
    mesh = FvMesh.from_grid(g)
    bc = BoundaryCondition(g, g.get_boundary_faces(), "dir")
    bnd = BoundaryMasks.from_bc(bc)

    perm = torch.tensor(permeability * np.ones(g.num_cells), dtype=torch.float64)
    t = face_transmissibilities(mesh, perm)

    cf = g.cell_faces_as_dense()
    bc_val = np.zeros(g.num_faces)
    bf = g.get_boundary_faces()
    if bc_pressure is not None:
        bc_val[bf] = bc_pressure(g.face_centers[:, bf])

    kernel = TpfaFlowKernel.from_numpy(
        lo=cf[0],
        hi=cf[1],
        t=t.numpy(),
        is_neu=bnd.is_neu.numpy(),
        bc_val=bc_val,
        pv=g.cell_volumes * porosity,
        rho_ref=rho_ref,
        comp=compressibility,
        visc=viscosity,
        p_ref=p_ref,
        dt=dt,
        device=device,
    )
    p0 = np.full(g.num_cells, p_ref, dtype=float)
    return kernel, p0


def newton_step(kernel: TpfaFlowKernel, p, p_prev):
    """One Newton iteration with the default tolerances (the counterpart of
    ``porepy_tpu``'s ``jitted_newton_step``)."""
    return kernel.newton_step(p, p_prev)
