"""Shared machinery for mixed (dual) discretizations of elliptic equations.

Parity counterpart of reference ``numerics/vem/dual_elliptic.py:75``: the
saddle-point assembly (flux mass matrix + divergence), Neumann/Robin
boundary modification, right-hand sides and flux projection shared by
MVEM and RT0.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["DualElliptic", "project_flux"]


def project_flux(mdg, discr, flux: str, P0_flux: str, mortar_key: str = "mortar_solution") -> None:
    """Project face fluxes to per-cell vector fields on every subdomain,
    storing the result under ``P0_flux`` (reference
    ``dual_elliptic.py:19``). Mortar contributions are added where stored."""
    for sd, data in mdg.subdomains(return_data=True):
        u = np.asarray(data[flux]) if flux in data else data["parameters"][
            discr.keyword
        ].get(flux)
        if u is None:
            continue
        data[P0_flux] = discr.project_flux(sd, np.asarray(u), data)


class DualElliptic:
    def __init__(self, keyword: str, name: str) -> None:
        self.keyword = keyword
        self.name = name
        self.mass_matrix_key = "mass"
        self.div_matrix_key = "div"
        self.vector_proj_key = "vector_proj"

    def ndof(self, sd) -> int:
        return sd.num_cells + sd.num_faces

    def assemble_matrix_rhs(self, sd, data: dict):
        M = self.assemble_matrix(sd, data)
        M, bc_weight = self.assemble_neumann_robin(sd, data, M, bc_weight=True)
        return M, self.assemble_rhs(sd, data, bc_weight)

    def assemble_matrix(self, sd, data: dict) -> sps.csr_matrix:
        matrices = data[DISCRETIZATION_MATRICES][self.keyword]
        mass = matrices[self.mass_matrix_key]
        div = matrices[self.div_matrix_key]
        return sps.bmat([[mass, div.T], [div, None]], format="csr")

    def assemble_neumann_robin(self, sd, data: dict, M, bc_weight: bool = False):
        matrices = data[DISCRETIZATION_MATRICES][self.keyword]
        mass = sps.csr_matrix(matrices[self.mass_matrix_key])
        if mass.shape[0] == 0:
            norm = 1.0
        else:
            norm = sps.linalg.norm(mass, np.inf) if bc_weight else 1.0
        bc = data[PARAMETERS][self.keyword]["bc"]
        M = M.tocsr()
        is_neu = bc.is_neu & ~bc.is_internal
        if np.any(is_neu):
            rows = np.where(is_neu)[0]
            for row in rows:
                M.data[M.indptr[row] : M.indptr[row + 1]] = 0.0
            d = M.diagonal()
            d[rows] = norm
            M.setdiag(d)
        is_rob = bc.is_rob & ~bc.is_internal
        if np.any(is_rob):
            rows = np.where(is_rob)[0]
            rob_val = np.zeros(self.ndof(sd))
            rob_val[rows] = 1.0 / (bc.robin_weight[rows] * sd.face_areas[rows])
            M = M + sps.dia_matrix(
                (rob_val, 0), shape=(rob_val.size, rob_val.size)
            )
        return M, norm

    def assemble_rhs(self, sd, data: dict, bc_weight: float = 1.0) -> np.ndarray:
        params = data[PARAMETERS][self.keyword]
        matrices = data[DISCRETIZATION_MATRICES][self.keyword]
        proj = matrices[self.vector_proj_key]
        rhs = np.zeros(self.ndof(sd))
        if sd.dim == 0:
            return rhs
        bc = params.get("bc")
        bc_val = params.get("bc_values")
        vector_source = params.get("vector_source", np.zeros(proj.shape[0]))
        rhs[: sd.num_faces] += proj.T @ vector_source
        if bc is None:
            return rhs
        cf = sps.coo_matrix(sd.cell_faces)
        order = np.argsort(cf.col, kind="stable")
        faces, sign = cf.row[order], cf.data[order]
        sign = sign[np.unique(faces, return_index=True)[1]]
        is_neu = bc.is_neu & ~bc.is_internal
        is_dir = bc.is_dir & ~bc.is_internal
        is_rob = bc.is_rob & ~bc.is_internal
        if np.any(is_dir):
            ind = np.where(is_dir)[0]
            rhs[ind] += -sign[ind] * bc_val[ind]
        if np.any(is_rob):
            ind = np.where(is_rob)[0]
            rhs[ind] += -sign[ind] * bc_val[ind] / bc.robin_weight[ind]
        if np.any(is_neu):
            ind = np.where(is_neu)[0]
            rhs[ind] = sign[ind] * bc_weight * bc_val[ind]
        return rhs

    def project_flux(self, sd, u: np.ndarray, data: dict) -> np.ndarray:
        if sd.dim == 0:
            return np.zeros(3).reshape((3, 1))
        proj = data[DISCRETIZATION_MATRICES][self.keyword][self.vector_proj_key]
        return (proj @ u).reshape((3, -1), order="F")

    def extract_flux(self, sd, solution: np.ndarray, data: dict) -> np.ndarray:
        return solution[: sd.num_faces]

    def extract_pressure(self, sd, solution: np.ndarray, data: dict) -> np.ndarray:
        return solution[sd.num_faces :]

    # -- local tensor inverses (2x2/3x3 closed forms) ------------------------

    @staticmethod
    def _inv_matrix_1d(K: np.ndarray) -> np.ndarray:
        return np.array([[1.0 / K[0, 0]]])

    @staticmethod
    def _inv_matrix_2d(K: np.ndarray) -> np.ndarray:
        det = K[0, 0] * K[1, 1] - K[0, 1] * K[1, 0]
        return np.array([[K[1, 1], -K[0, 1]], [-K[1, 0], K[0, 0]]]) / det

    @staticmethod
    def _inv_matrix_3d(K: np.ndarray) -> np.ndarray:
        return np.linalg.inv(K)
