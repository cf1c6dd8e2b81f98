"""L2 mass matrices for mixed (face-flux + cell-pressure) methods.

Parity counterpart of reference ``numerics/vem/mass_matrix.py:30,159``:
the bilinear form with piecewise-constant test/trial functions only
touches the cell block, so the matrix is diagonal with entries
``cell_volumes * mass_weight`` (zero on the face dofs). The inverse
variant stores the reciprocal on the cell block.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["MixedMassMatrix", "MixedInvMassMatrix"]


class MixedMassMatrix:
    """Mass matrix on the (faces + cells) mixed dof space."""

    def __init__(self, keyword: str = "flow") -> None:
        self.keyword = keyword
        self.mass_matrix_key = "mixed_mass"
        self.rhs_key = "bound_mixed_mass"

    def ndof(self, sd) -> int:
        return sd.num_faces + sd.num_cells

    def discretize(self, sd, data: dict) -> None:
        params = data[PARAMETERS][self.keyword]
        matrices = data[DISCRETIZATION_MATRICES].setdefault(self.keyword, {})
        w = params["mass_weight"]
        ndof = self.ndof(sd)
        coeff = np.hstack((np.zeros(sd.num_faces), sd.cell_volumes * w))
        matrices[self.mass_matrix_key] = sps.dia_matrix(
            (coeff, 0), shape=(ndof, ndof)
        )
        matrices[self.rhs_key] = np.zeros(ndof)

    def assemble_matrix_rhs(self, sd, data: dict):
        return self.assemble_matrix(sd, data), self.assemble_rhs(sd, data)

    def assemble_matrix(self, sd, data: dict):
        return data[DISCRETIZATION_MATRICES][self.keyword][
            self.mass_matrix_key
        ]

    def assemble_rhs(self, sd, data: dict) -> np.ndarray:
        return data[DISCRETIZATION_MATRICES][self.keyword][self.rhs_key]


class MixedInvMassMatrix:
    """Inverse of :class:`MixedMassMatrix` on the cell block."""

    def __init__(self, keyword: str = "flow") -> None:
        self.keyword = keyword
        self.mass_matrix_key = "inv_mixed_mass"
        self.rhs_key = "bound_inv_mixed_mass"

    def ndof(self, sd) -> int:
        return sd.num_faces + sd.num_cells

    def discretize(self, sd, data: dict) -> None:
        params = data[PARAMETERS][self.keyword]
        matrices = data[DISCRETIZATION_MATRICES].setdefault(self.keyword, {})
        w = params["mass_weight"]
        ndof = self.ndof(sd)
        cell_coeff = sd.cell_volumes * w
        coeff = np.hstack((np.zeros(sd.num_faces), 1.0 / cell_coeff))
        matrices[self.mass_matrix_key] = sps.dia_matrix(
            (coeff, 0), shape=(ndof, ndof)
        )
        matrices[self.rhs_key] = np.zeros(ndof)

    def assemble_matrix_rhs(self, sd, data: dict):
        return self.assemble_matrix(sd, data), self.assemble_rhs(sd, data)

    def assemble_matrix(self, sd, data: dict):
        return data[DISCRETIZATION_MATRICES][self.keyword][
            self.mass_matrix_key
        ]

    def assemble_rhs(self, sd, data: dict) -> np.ndarray:
        return data[DISCRETIZATION_MATRICES][self.keyword][self.rhs_key]
