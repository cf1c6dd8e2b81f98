"""Mixed virtual element method of lowest order.

Parity counterpart of reference ``numerics/vem/mvem.py:18``: dual
(flux + pressure) discretization of the elliptic equation on general
polytopal grids, via cell-local H(div) mass matrices built from the
VEM projection onto linear monomials plus a stabilization term.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.numerics.vem.dual_elliptic import DualElliptic
from porepy_tpu_torch.params.tensor import SecondOrderTensor
from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["MVEM"]


class MVEM(DualElliptic):
    def __init__(self, keyword: str) -> None:
        super().__init__(keyword, "MVEM")

    def discretize(self, sd, data: dict) -> None:
        matrices = data[DISCRETIZATION_MATRICES].setdefault(self.keyword, {})
        if sd.dim == 0:
            matrices[self.mass_matrix_key] = sps.dia_matrix(
                ([1], 0), (sd.num_faces, sd.num_faces)
            )
            matrices[self.div_matrix_key] = sps.csr_matrix(
                (sd.num_faces, sd.num_cells)
            )
            matrices[self.vector_proj_key] = sps.csr_matrix((3, 0))
            return
        params = data[PARAMETERS][self.keyword]
        k = params["second_order_tensor"]
        identity = SecondOrderTensor(kxx=np.ones(sd.num_cells))

        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")
        faces, sign = cf.row[order], cf.data[order]

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

        indptr = sd.cell_faces.tocsc().indptr
        faces_per_cell = np.diff(indptr)
        rows_A, cols_A, data_A = [], [], []
        rows_P, cols_P, data_P = [], [], []
        idx_row_P = 0

        inv_matrix = {
            1: self._inv_matrix_1d,
            2: self._inv_matrix_2d,
            3: self._inv_matrix_3d,
        }[sd.dim]

        for c in range(sd.num_cells):
            loc = slice(indptr[c], indptr[c + 1])
            faces_loc = faces[loc]
            K_loc = k.values[: sd.dim, : sd.dim, c]
            A = self.massHdiv(
                K_loc,
                inv_matrix(K_loc),
                c_centers[:, c],
                sd.cell_volumes[c],
                f_centers[:, faces_loc],
                f_normals[:, faces_loc],
                sign[loc],
                diams[c],
                weight[c],
            )[0]
            P = np.zeros((3, faces_loc.size))
            P[dim, :] = self.massHdiv(
                identity.values[: sd.dim, : sd.dim, c],
                identity.values[: sd.dim, : sd.dim, c],
                c_centers[:, c],
                sd.cell_volumes[c],
                f_centers[:, faces_loc],
                f_normals[:, faces_loc],
                sign[loc],
                diams[c],
            )[1]
            P = (R.T @ P) / diams[c]
            cols = np.tile(faces_loc, (faces_loc.size, 1))
            rows_A.append(cols.T.ravel())
            cols_A.append(cols.ravel())
            data_A.append(A.ravel())
            cols_P.append(np.tile(faces_loc, 3))
            rows_P.append(
                np.repeat(np.arange(3), faces_loc.size) + idx_row_P
            )
            data_P.append(P.ravel())
            idx_row_P += 3

        mass = sps.coo_matrix(
            (
                np.concatenate(data_A),
                (np.concatenate(rows_A), np.concatenate(cols_A)),
            )
        )
        div = -sd.cell_faces.T
        proj = sps.coo_matrix(
            (
                np.concatenate(data_P),
                (np.concatenate(rows_P), np.concatenate(cols_P)),
            )
        )
        matrices[self.mass_matrix_key] = mass
        matrices[self.div_matrix_key] = div
        matrices[self.vector_proj_key] = proj

    @staticmethod
    def massHdiv(
        K: np.ndarray,
        inv_K: np.ndarray,
        c_center: np.ndarray,
        c_volume: float,
        f_centers: np.ndarray,
        normals: np.ndarray,
        sign: np.ndarray,
        diam: float,
        weight: float = 0.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Local H(div) mass matrix: VEM projection onto scaled linear
        monomials plus stabilization of the projection complement."""
        dim = K.shape[0]
        grad = np.eye(dim) / diam
        # D: evaluation of K grad(monomial) against face normals.
        D = np.array([normals.T @ (K @ g) for g in grad]).T
        G = grad @ (K @ grad.T) * c_volume
        # F: signed monomial values at face centers.
        F = np.array(
            [
                s * (f[i] - c_center[i]) / diam
                for i in range(dim)
                for s, f in zip(sign, f_centers.T)
            ]
        ).reshape((dim, -1))
        if not np.allclose(G, F @ D):
            raise ValueError("VEM consistency G == F D violated")
        Pi_s = np.linalg.solve(G, F)
        I_Pi = np.eye(f_centers.shape[1]) - D @ Pi_s
        w = weight * np.linalg.norm(inv_K, np.inf)
        A = Pi_s.T @ (G @ Pi_s) + w * (I_Pi.T @ I_Pi)
        return A, Pi_s

    @staticmethod
    def check_conservation(sd, u: np.ndarray) -> np.ndarray:
        return sd.cell_faces.T @ u
