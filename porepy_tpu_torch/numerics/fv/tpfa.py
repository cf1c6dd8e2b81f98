"""Two-point flux approximation (TPFA) for scalar elliptic equations.

Design
------
The discretization is a pure, differentiable torch function of the cell
permeability (:func:`face_transmissibilities`): half-face transmissibilities
are an elementwise expression over the half-face tensors of
:class:`~porepy_tpu_torch.numerics.fv.fv_mesh.FvMesh`, the harmonic average
a segment sum. A solution-dependent permeability therefore differentiates
through the discretization — the reference needs a dedicated
``DifferentiableTpfa`` (``numerics/fv/tpfa.py:281``) for that.

On the md path this runs once at setup for the 1d fracture grids
(``mpfa.py`` hands 1d MPFA to TPFA): on host CPU tensors, or on the card
when ``PPT_LOCAL_SOLVE_DEVICE=1`` asks for the discretization there (the
switch of the MPFA/MPSA region solves), where the segment sums run in the
K14 ``segment_sum_sorted`` kernel. Inside the residual the same expressions
run as the fused K14 kernels of ``models/darcys_law_ad.py``. The scipy matrices the
reference stores (``flux``, ``bound_flux``, ``bound_pressure_cell/face``,
``vector_source``, ``bound_pressure_vector_source`` — see reference
``numerics/fv/tpfa.py:55-67``) are produced by :meth:`Tpfa.discretize`.

Behavioral parity notes (reference ``numerics/fv/tpfa.py:32-280``):
- half transmissibility ``t_hf = (n·K·d) / |d|^2`` with ``n`` the
  outward area-weighted normal and ``d`` the face-center-to-cell-center
  vector; harmonic average over a face's half-faces.
- internal (fracture) boundary faces are forced Neumann.
- Neumann faces: ``t = 0``; ``bound_flux`` entry = ``sgn``; pressure trace
  uses ``-1/t_full`` face and unit cell contributions.
- Dirichlet faces: ``bound_flux`` entry = ``-t * sgn``; trace = boundary
  value.
- vector-source discretization: ``t * d * sgn`` per half-face
  (Starnoni et al. 2020).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch.numerics.fv.fv_mesh import BoundaryMasks, FvMesh
from porepy_tpu_torch.numerics.fv.fv_elliptic import FVElliptic
from porepy_tpu_torch.utils import common_constants as cc

__all__ = [
    "Tpfa",
    "half_face_transmissibilities",
    "face_transmissibilities",
    "apply_flux",
]


def half_face_transmissibilities(mesh: FvMesh, perm: torch.Tensor) -> torch.Tensor:
    """Half-face transmissibilities ``(n·K·d)/|d|^2``.

    Parameters:
        mesh: FV mesh tensors.
        perm: cell permeability, shape ``(3, 3, num_cells)`` (full tensor)
            or ``(num_cells,)`` (isotropic).

    Returns:
        ``(num_half_faces,)`` tensor.
    """
    n = mesh.face_normals[:, mesh.fi] * mesh.sgn  # outward
    d = mesh.fc_cc()
    if perm.dim() == 1:
        nk = perm[mesh.ci] * n
    else:
        k_hf = perm[:, :, mesh.ci]
        nk = torch.einsum("ijh,jh->ih", k_hf, n)
    t = torch.sum(nk * d, dim=0)
    dist2 = torch.sum(d * d, dim=0)
    return t / dist2


def face_transmissibilities(mesh: FvMesh, perm: torch.Tensor) -> torch.Tensor:
    """Harmonic-average face transmissibilities, shape ``(num_faces,)``."""
    t_hf = half_face_transmissibilities(mesh, perm)
    recip = mesh.face_sum(1.0 / t_hf)
    return 1.0 / recip


def effective_transmissibilities(
    mesh: FvMesh, perm: torch.Tensor, bnd: BoundaryMasks
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t, t_full)``: transmissibilities with Neumann faces zeroed, and the
    unmodified harmonic averages (used by pressure-trace reconstruction)."""
    t_full = face_transmissibilities(mesh, perm)
    t = torch.where(bnd.is_neu, torch.zeros_like(t_full), t_full)
    return t, t_full


def apply_flux(
    mesh: FvMesh,
    t: torch.Tensor,
    p: torch.Tensor,
    bound_flux_coeff: Optional[torch.Tensor] = None,
    bc_values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate the face flux ``flux @ p (+ bound_flux @ bc_values)``
    directly from half-face tensors (no matrices).

    ``flux[f] = t[f] * sum_halffaces sgn * p[cell]``.
    """
    cell_part = mesh.face_sum(mesh.sgn * p[mesh.ci])
    flux = t * cell_part
    if bound_flux_coeff is not None and bc_values is not None:
        flux = flux + bound_flux_coeff * bc_values
    return flux


def boundary_flux_coefficients(
    mesh: FvMesh, t: torch.Tensor, bnd: BoundaryMasks
) -> torch.Tensor:
    """Diagonal of the ``bound_flux`` operator as a face tensor.

    Dirichlet: ``-t * sgn``; Neumann: ``sgn`` (sign of the single adjacent
    cell's ``cell_faces`` entry). Zero on interior faces.
    """
    sgn_face = torch.zeros(mesh.num_faces, dtype=t.dtype, device=t.device)
    sgn_face[mesh.fi] = mesh.sgn
    zero = torch.zeros_like(t)
    coeff = torch.where(
        bnd.is_dir, -t * sgn_face, torch.where(bnd.is_neu, sgn_face, zero)
    )
    # Only boundary faces (one half-face) carry coefficients.
    n_adj = mesh.face_ptr[1:] - mesh.face_ptr[:-1]
    return torch.where(n_adj == 1, coeff, zero)


class Tpfa(FVElliptic):
    """Two-point flux discretization with the reference's matrix contract.

    ``discretize(sd, data)`` fills ``data[pp.DISCRETIZATION_MATRICES][kw]``
    with scipy matrices identical (to fp rounding) to the reference
    implementation, computed from the torch core above on the host CPU.
    """

    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.flux_matrix_key = "flux"
        self.bound_flux_matrix_key = "bound_flux"
        self.bound_pressure_cell_matrix_key = "bound_pressure_cell"
        self.bound_pressure_face_matrix_key = "bound_pressure_face"
        self.vector_source_matrix_key = "vector_source"
        self.bound_pressure_vector_source_matrix_key = "bound_pressure_vector_source"

    def ndof(self, sd) -> int:
        return sd.num_cells

    def update_discretization(self, sd, data: dict) -> None:
        """TPFA's stencil is face-local and the vectorized discretization
        is O(nnz); a full recompute on the (possibly updated) grid is both
        exact and cheaper than bookkeeping a partial map (reference
        ``numerics/fv/tpfa.py`` routes through the generic partial-update
        machinery instead)."""
        self.discretize(sd, data)

    def discretize(self, sd, data: dict) -> None:
        param = data[cc.PARAMETERS][self.keyword]
        matrices = data[cc.DISCRETIZATION_MATRICES][self.keyword]
        vs_dim: int = param.get("ambient_dimension", sd.dim)

        if sd.dim == 0:
            matrices[self.flux_matrix_key] = sps.csr_matrix((0, sd.num_cells))
            matrices[self.bound_flux_matrix_key] = sps.csr_matrix((0, 0))
            matrices[self.bound_pressure_cell_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells)
            )
            matrices[self.bound_pressure_face_matrix_key] = sps.csr_matrix((0, 0))
            matrices[self.vector_source_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells * max(vs_dim, 1))
            )
            matrices[self.bound_pressure_vector_source_matrix_key] = sps.csr_matrix(
                (0, sd.num_cells * max(vs_dim, 1))
            )
            return

        k = param["second_order_tensor"]
        bc = param["bc"]

        from porepy_tpu_torch.numerics.fv.local_solves import _use_device
        from porepy_tpu_torch.utils.device_policy import accelerator

        device = accelerator() if _use_device() else torch.device("cpu")
        mesh = FvMesh.from_grid(sd, device=device)
        bnd = BoundaryMasks.from_bc(bc, device=device)

        t, t_full = effective_transmissibilities(
            mesh,
            torch.tensor(np.asarray(k.values), dtype=torch.float64, device=device),
            bnd,
        )

        # Host-side assembly of the parity matrices.
        fi = mesh.fi.cpu().numpy()
        ci = mesh.ci.cpu().numpy()
        sgn = mesh.sgn.cpu().numpy()
        t_np = t.cpu().numpy()
        t_full_np = t_full.cpu().numpy()
        is_dir = bnd.is_dir.cpu().numpy()
        is_neu = bnd.is_neu.cpu().numpy()
        is_dir_raw = bnd.is_dir_raw.cpu().numpy()
        is_neu_raw = bnd.is_neu_raw.cpu().numpy()
        nf, nc = sd.num_faces, sd.num_cells

        flux = sps.coo_matrix(
            (t_np[fi] * sgn, (fi, ci)), shape=(nf, nc)
        ).tocsr()

        bndr_ind = sd.get_all_boundary_faces()
        sgn_face = np.zeros(nf)
        sgn_face[fi] = sgn  # boundary faces have one half-face
        t_b = np.where(is_dir, -t_np, np.where(is_neu, 1.0, 0.0))
        bound_flux = sps.coo_matrix(
            (t_b[bndr_ind] * sgn_face[bndr_ind], (bndr_ind, bndr_ind)),
            shape=(nf, nf),
        ).tocsr()

        matrices[self.flux_matrix_key] = flux
        matrices[self.bound_flux_matrix_key] = bound_flux

        # Pressure-trace reconstruction (raw dir/neu masks per reference
        # tpfa.py:235-246).
        v_cell = np.zeros(fi.size)
        v_cell[is_neu_raw[fi]] = 1.0
        v_face = np.zeros(nf)
        v_face[is_dir_raw] = 1.0
        v_face[is_neu_raw] = -1.0 / t_full_np[is_neu_raw]
        matrices[self.bound_pressure_cell_matrix_key] = sps.coo_matrix(
            (v_cell, (fi, ci)), shape=(nf, nc)
        ).tocsr()
        matrices[self.bound_pressure_face_matrix_key] = sps.dia_matrix(
            (v_face, 0), shape=(nf, nf)
        ).tocsr()

        # Vector source (gravity) discretization.
        fc_cc = mesh.fc_cc().cpu().numpy()
        vals = (t_np[fi] * fc_cc * sgn)[:vs_dim].ravel("F")
        rows = np.tile(fi, (vs_dim, 1)).ravel("F")
        cols = (ci[:, None] * vs_dim + np.arange(vs_dim)).ravel()
        matrices[self.vector_source_matrix_key] = sps.coo_matrix(
            (vals, (rows, cols)), shape=(nf, nc * vs_dim)
        ).tocsr()

        bp_vals = np.zeros((vs_dim, fi.size))
        neu_hf = is_neu_raw[fi]
        bp_vals[:, neu_hf] = fc_cc[:vs_dim, neu_hf]
        matrices[self.bound_pressure_vector_source_matrix_key] = sps.coo_matrix(
            (bp_vals.ravel("F"), (rows, cols)), shape=(nf, nc * vs_dim)
        ).tocsr()
