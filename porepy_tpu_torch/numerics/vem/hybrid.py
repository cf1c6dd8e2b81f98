"""Hybridized mixed virtual element method.

Counterpart of reference ``numerics/vem/hybrid.py:16`` (HybridDualVEM): the
MVEM saddle point is statically condensed onto face (Lagrange-multiplier)
unknowns, giving an SPD system of size ``num_faces``. Like the reference,
this is a fixed-dimensional method (no mortar coupling).

The per-cell condensation uses the same local H(div) mass matrices as
:class:`~porepy_tpu.numerics.vem.mvem.MVEM`; with one pressure per cell the
Schur complement of the local saddle block reduces to rank-one algebra:

    ``H_loc = inv(A) B s B^T inv(A) - inv(A)``,  ``s = 1 / (B^T inv(A) B)``

with ``B = -1`` (per face) the local divergence.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.params.tensor import SecondOrderTensor
from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["HybridDualVEM"]


class HybridDualVEM:
    def __init__(self, keyword: str = "flow") -> None:
        self.keyword = keyword

    def ndof(self, sd) -> int:
        return sd.num_faces

    # -- local machinery ---------------------------------------------------------

    def _cell_quantities(self, sd, data):
        """Iterate (cell, local faces, local mass matrix A)."""
        from porepy_tpu_torch.numerics.vem.dual_elliptic import DualElliptic
        from porepy_tpu_torch.numerics.vem.mvem import MVEM

        params = data[PARAMETERS][self.keyword]
        k = params["second_order_tensor"]

        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")
        faces, sign = cf.row[order], cf.data[order]
        indptr = sd.cell_faces.tocsc().indptr

        tol = data.get("deviation_from_plane_tol", 1e-5)
        c_centers, f_normals, f_centers, R, dim, _ = map_geometry.map_grid(
            sd, tol
        )
        if not data.get("is_tangential", False) and sd.dim < 3:
            k = k.copy()
            k.rotate(R)
            remove = np.where(~dim)[0]
            k.values = np.delete(
                np.delete(k.values, remove, axis=0), remove, axis=1
            )
        diams = sd.cell_diameters()
        weight = np.power(diams, 2 - sd.dim)
        inv_matrix = {
            1: DualElliptic._inv_matrix_1d,
            2: DualElliptic._inv_matrix_2d,
            3: DualElliptic._inv_matrix_3d,
        }[sd.dim]

        for c in range(sd.num_cells):
            loc = slice(indptr[c], indptr[c + 1])
            faces_loc = faces[loc]
            K_loc = k.values[: sd.dim, : sd.dim, c]
            A = MVEM.massHdiv(
                K_loc,
                inv_matrix(K_loc),
                c_centers[:, c],
                sd.cell_volumes[c],
                f_centers[:, faces_loc],
                sign[loc] * f_normals[:, faces_loc],
                np.ones(faces_loc.size),
                diams[c],
                weight[c],
            )[0]
            yield c, faces_loc, sign[loc], A

    # -- assembly ------------------------------------------------------------------

    def matrix_rhs(self, sd, data) -> tuple[sps.csr_matrix, np.ndarray]:
        """Hybridized SPD system on face multipliers.

        Parameter dict (under the discretization keyword):
        ``second_order_tensor``, ``source`` (cell-wise, optional), ``bc`` +
        ``bc_values`` (optional).
        """
        if sd.dim == 0:
            return sps.identity(self.ndof(sd), format="csr"), np.zeros(1)

        params = data[PARAMETERS][self.keyword]
        source = params.get("source", np.zeros(sd.num_cells))
        bc = params.get("bc")
        bc_val = params.get("bc_values")

        rows, cols, vals = [], [], []
        rhs = np.zeros(sd.num_faces)
        for c, faces_loc, _sgn, A in self._cell_quantities(sd, data):
            ones = np.ones(faces_loc.size)
            Ainv_1 = np.linalg.solve(A, ones)
            s = 1.0 / (ones @ Ainv_1)  # = 1/(B^T A^-1 B) with B = -1
            H_loc = np.outer(Ainv_1, Ainv_1) * s - np.linalg.inv(A)
            rhs[faces_loc] += -Ainv_1 * (s * source[c])
            grid_r, grid_c = np.meshgrid(faces_loc, faces_loc, indexing="ij")
            rows.append(grid_r.ravel())
            cols.append(grid_c.ravel())
            vals.append(H_loc.ravel())

        H = sps.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(sd.num_faces, sd.num_faces),
        ).tolil()

        if bc is not None and bc_val is not None:
            scale = abs(H).sum(axis=1).max()
            dir_faces = np.where(bc.is_dir)[0]
            if dir_faces.size:
                H[dir_faces, :] = 0.0
                H[dir_faces, dir_faces] = scale
                rhs[dir_faces] = scale * bc_val[dir_faces]
            neu_faces = np.where(bc.is_neu)[0]
            if neu_faces.size:
                cf = sps.coo_matrix(sd.cell_faces)
                sgn_face = np.zeros(sd.num_faces)
                sgn_face[cf.row] = cf.data
                rhs[neu_faces] += (
                    sgn_face[neu_faces]
                    * np.asarray(bc_val)[neu_faces]
                    * sd.face_areas[neu_faces]
                )
        return H.tocsr(), rhs

    def compute_up(self, sd, solution, data) -> tuple[np.ndarray, np.ndarray]:
        """Back-substitute: face fluxes and cell pressures from the hybrid
        face solution."""
        if sd.dim == 0:
            return np.zeros(0), np.atleast_1d(solution)[:1]

        params = data[PARAMETERS][self.keyword]
        source = params.get("source", np.zeros(sd.num_cells))
        p = np.zeros(sd.num_cells)
        u = np.zeros(sd.num_faces)
        for c, faces_loc, sgn_loc, A in self._cell_quantities(sd, data):
            ones = np.ones(faces_loc.size)
            lam = solution[faces_loc]
            Ainv_1 = np.linalg.solve(A, ones)
            Ainv_lam = np.linalg.solve(A, lam)
            s = 1.0 / (ones @ Ainv_1)
            p[c] = s * (source[c] + ones @ Ainv_lam)
            u[faces_loc] = -sgn_loc * (-Ainv_1 * p[c] + Ainv_lam)
        return u, p
