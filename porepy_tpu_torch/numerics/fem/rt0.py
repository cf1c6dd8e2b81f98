"""Lowest-order Raviart-Thomas mixed finite elements on simplices.

Parity counterpart of reference ``numerics/fem/rt0.py:9``: dual
(flux + pressure) discretization with exact RT0 basis functions anchored
at the node opposite each face of a simplex.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.numerics.vem.dual_elliptic import DualElliptic
from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["RT0"]


class RT0(DualElliptic):
    def __init__(self, keyword: str) -> None:
        super().__init__(keyword, "RT0")
        self.cell_face_to_opposite_node = "rt0_class_cell_face_to_opposite_node"

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

        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")
        faces, sign = cf.row[order], cf.data[order]

        tol = data.get("deviation_from_plane_tol", 1e-5)
        c_centers, f_normals, f_centers, R, dim, node_coords = (
            map_geometry.map_grid(sd, tol)
        )
        node_coords = node_coords[: sd.dim, :]
        if not data.get("is_tangential", False) and sd.dim < 3:
            k = k.copy()
            k.rotate(R)
            remove = np.where(~dim)[0]
            k.values = np.delete(
                np.delete(k.values, remove, axis=0), remove, axis=1
            )

        # The characteristic matrix of the RT0 inner products on a simplex.
        size_HB = sd.dim * (sd.dim + 1)
        HB = np.zeros((size_HB, size_HB))
        for it in range(0, size_HB, sd.dim):
            HB += np.diagflat(np.ones(size_HB - it), it)
        HB += HB.T
        HB /= sd.dim * sd.dim * (sd.dim + 1) * (sd.dim + 2)

        inv_matrix = {
            1: self._inv_matrix_1d,
            2: self._inv_matrix_2d,
            3: self._inv_matrix_3d,
        }[sd.dim]

        self._compute_cell_face_to_opposite_node(sd, data)
        opposite_node = data[self.cell_face_to_opposite_node]

        indptr = sd.cell_faces.tocsc().indptr
        rows_A, cols_A, data_A = [], [], []
        rows_P, cols_P, data_P = [], [], []
        idx_row_P = 0
        for c in range(sd.num_cells):
            loc = slice(indptr[c], indptr[c + 1])
            faces_loc = faces[loc]
            coord_loc = node_coords[:, opposite_node[c]]
            A = RT0.massHdiv(
                inv_matrix(k.values[: sd.dim, : sd.dim, c]),
                sd.cell_volumes[c],
                coord_loc,
                sign[loc],
                sd.dim,
                HB,
            )
            P = RT0.faces_to_cell(
                c_centers[:, c],
                coord_loc,
                f_centers[:, faces_loc],
                f_normals[:, faces_loc],
                dim,
                R,
            )
            cols = np.tile(faces_loc, (faces_loc.size, 1))
            rows_A.append(cols.T.ravel())
            cols_A.append(cols.ravel())
            data_A.append(A.ravel())
            cols_P.append(np.tile(faces_loc, 3))
            rows_P.append(np.repeat(np.arange(3), faces_loc.size) + idx_row_P)
            data_P.append(P.ravel())
            idx_row_P += 3

        matrices[self.mass_matrix_key] = sps.coo_matrix(
            (
                np.concatenate(data_A),
                (np.concatenate(rows_A), np.concatenate(cols_A)),
            )
        )
        matrices[self.div_matrix_key] = -sd.cell_faces.T
        matrices[self.vector_proj_key] = sps.coo_matrix(
            (
                np.concatenate(data_P),
                (np.concatenate(rows_P), np.concatenate(cols_P)),
            )
        )

    @staticmethod
    def massHdiv(
        inv_K: np.ndarray,
        c_volume: float,
        coord: np.ndarray,
        sign: np.ndarray,
        dim: int,
        HB: np.ndarray,
    ) -> np.ndarray:
        """Exact local RT0 mass matrix on a simplex."""
        ind = np.eye(dim + 1)
        inv_K_exp = (
            ind[:, np.newaxis, :, np.newaxis]
            * inv_K[np.newaxis, :, np.newaxis, :]
            / c_volume
        )
        inv_K_exp.shape = (
            ind.shape[0] * inv_K.shape[0],
            ind.shape[1] * inv_K.shape[1],
        )
        N = coord.flatten("F").reshape((-1, 1)) * np.ones(
            (1, dim + 1)
        ) - np.concatenate((dim + 1) * [coord])
        C = np.diag(sign)
        return C.T @ (N.T @ (HB @ (inv_K_exp @ (N @ C))))

    @staticmethod
    def faces_to_cell(
        pt: np.ndarray,
        coord: np.ndarray,
        f_centers: np.ndarray,
        f_normals: np.ndarray,
        dim: np.ndarray,
        R: np.ndarray,
    ) -> np.ndarray:
        """Evaluate the RT0 basis at a point (usually the cell center)."""
        pt_rep = np.repeat(pt, coord.shape[1]).reshape((-1, coord.shape[1]))
        c_delta = pt_rep - coord
        f_delta = f_centers - coord
        P = np.zeros((3, coord.shape[1]))
        P[dim, :] = c_delta / np.einsum("ij,ij->j", f_delta, f_normals)
        return R.T @ P

    def _compute_cell_face_to_opposite_node(
        self, sd, data: dict, recompute: bool = False
    ) -> None:
        """For each cell, the node opposite each of its faces."""
        if data.get(self.cell_face_to_opposite_node) is not None and not recompute:
            return
        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")
        faces = cf.row[order]
        nodes = sd.face_nodes.indices
        indptr_fn = sd.face_nodes.indptr
        indptr_cf = sd.cell_faces.tocsc().indptr
        out = np.empty((sd.num_cells, sd.dim + 1), dtype=int)
        for c in range(sd.num_cells):
            faces_loc = faces[indptr_cf[c] : indptr_cf[c + 1]]
            face_nodes = np.array(
                [nodes[indptr_fn[f] : indptr_fn[f + 1]] for f in faces_loc]
            )
            nodes_loc = np.unique(face_nodes)
            opposite = np.array(
                [
                    np.setdiff1d(nodes_loc, f, assume_unique=True)
                    for f in face_nodes
                ]
            )
            out[c] = opposite.ravel()
        data[self.cell_face_to_opposite_node] = out
