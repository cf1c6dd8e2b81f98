"""Cell-wise scalar source for mixed (dual) discretizations.

Parity counterpart of reference ``numerics/vem/vem_source.py:18``
(``DualScalarSource``): the integrated source enters only the cell block
of the (faces + cells) mixed dof vector, with a sign flip matching the
dual saddle-point convention.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.utils.common_constants import (
    DISCRETIZATION_MATRICES,
    PARAMETERS,
)

__all__ = ["DualScalarSource"]


class DualScalarSource:
    def __init__(self, keyword: str = "flow") -> None:
        self.keyword = keyword
        self.matrix_key = "source"
        self.rhs_key = "bound_source"

    def ndof(self, sd) -> int:
        return sd.num_faces + sd.num_cells

    def discretize(self, sd, data: dict) -> None:
        matrices = data[DISCRETIZATION_MATRICES].setdefault(self.keyword, {})
        ndof = self.ndof(sd)
        matrices[self.matrix_key] = sps.csr_matrix((ndof, ndof))

    def assemble_matrix_rhs(self, sd, data: dict):
        return self.assemble_matrix(sd, data), self.assemble_rhs(sd, data)

    def assemble_matrix(self, sd, data: dict):
        return data[DISCRETIZATION_MATRICES][self.keyword][self.matrix_key]

    def assemble_rhs(self, sd, data: dict) -> np.ndarray:
        sources = np.asarray(data[PARAMETERS][self.keyword]["source"])
        if sources.size != sd.num_cells:
            raise ValueError("Source size must equal the number of cells")
        rhs = np.zeros(self.ndof(sd))
        rhs[sd.num_faces :] = -sources
        return rhs
