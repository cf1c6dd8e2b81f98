"""Boundary grid: lower-dimensional representation of a subdomain's domain
boundary.

Parity counterpart of reference ``grids/boundary_grid.py:19``. Each cell of
the boundary grid corresponds to one face of the parent grid tagged
``domain_boundary_faces``. Carries a projection (face values on the parent
-> cell values on the boundary) used by time-dependent boundary-condition
machinery.

TPU note: the projection is a pure gather by ``face_indices``; the scipy
matrix form is kept for API parity, device code uses the index array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

__all__ = ["BoundaryGrid"]


class BoundaryGrid:
    def __init__(self, g, name: Optional[str] = None) -> None:
        self._parent = g
        self.name = name if name is not None else f"Boundary of {g.name}"
        self.dim: int = g.dim - 1
        self.num_cells: int = int(np.sum(g.tags["domain_boundary_faces"]))
        self._projections: Optional[sps.csr_matrix] = None
        self.cell_centers: np.ndarray
        self.cell_volumes: np.ndarray
        self._id: int = g.id

    @property
    def id(self) -> int:
        return self._id

    @property
    def parent(self):
        return self._parent

    @property
    def face_indices(self) -> np.ndarray:
        """Parent-grid face index of each boundary cell."""
        return np.where(self._parent.tags["domain_boundary_faces"])[0]

    def compute_geometry(self) -> None:
        mask = self._parent.tags["domain_boundary_faces"]
        self.cell_centers = self._parent.face_centers[:, mask]
        self.cell_volumes = self._parent.face_areas[mask]

    def set_projections(self) -> None:
        faces = self.face_indices
        if faces.size != self.num_cells:
            raise NotImplementedError(
                "Parent boundary-face count changed after construction"
            )
        self._projections = sps.coo_matrix(
            (np.ones(faces.size), (np.arange(faces.size), faces)),
            shape=(self.num_cells, self._parent.num_faces),
        ).tocsr()

    def projection(self, nd: int = 1) -> sps.spmatrix:
        if self._projections is None:
            self.set_projections()
        assert self._projections is not None
        if nd == 1:
            return self._projections
        return sps.kron(self._projections, sps.eye(nd)).tocsr()

    def __repr__(self) -> str:
        return f"BoundaryGrid(of={self._parent.name!r}, cells={self.num_cells})"
