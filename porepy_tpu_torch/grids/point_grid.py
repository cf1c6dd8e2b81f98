"""0d grid for fracture intersection points.

Parity counterpart of reference ``grids/point_grid.py:11``: a single cell,
no faces, no nodes in the incidence sense; the cell center is the point.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid

__all__ = ["PointGrid"]


class PointGrid(Grid):
    def __init__(self, pt: np.ndarray, name: str = "PointGrid") -> None:
        pt = np.asarray(pt, dtype=float).reshape(-1, 1)
        if pt.shape[0] < 3:
            pt = np.vstack([pt, np.zeros((3 - pt.shape[0], 1))])
        # Zero nodes (the point is the cell center, not a mesh node) —
        # parity with reference ``grids/point_grid.py:39-45``.
        face_nodes = sps.csc_matrix((0, 0), dtype=bool)
        cell_faces = sps.csc_matrix((0, 1))
        self.cell_centers = pt.copy()
        super().__init__(0, np.zeros((3, 0)), face_nodes, cell_faces, name)
