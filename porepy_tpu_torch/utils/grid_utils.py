"""Small grid-level helper operators (reference ``utils/grid_utils.py``)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

__all__ = ["switch_sign_if_inwards_normal"]


def switch_sign_if_inwards_normal(g, nd: int, faces: np.ndarray) -> sps.dia_matrix:
    """Diagonal operator flipping the sign of face quantities whose stored
    normal points INTO the grid; faces not listed get a zero diagonal.
    For ``nd > 1`` the first ``nd`` rows belong to the first face, etc.
    (reference ``grid_utils.py:22``)."""
    faces = np.asarray(faces)
    sgn, _ = g.signs_and_cells_of_boundary_faces(faces)
    diag = np.zeros(g.num_faces)
    diag[faces] = sgn
    diag = np.repeat(diag, nd)
    return sps.dia_matrix((diag, 0), shape=(diag.size, diag.size))
