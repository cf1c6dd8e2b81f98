"""Shared base of the elliptic finite-volume discretizations (reference
``numerics/fv/fv_elliptic.py:16``): the keyword + matrix-key contract and
cell-centered dof count shared by TPFA and MPFA."""

from __future__ import annotations

__all__ = ["FVElliptic"]


class FVElliptic:
    """Base class for cell-centered elliptic FV discretizations; use a
    concrete subclass (``Tpfa``, ``Mpfa``)."""

    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.flux_matrix_key = "flux"
        self.bound_flux_matrix_key = "bound_flux"
        self.bound_pressure_cell_matrix_key = "bound_pressure_cell"
        self.bound_pressure_face_matrix_key = "bound_pressure_face"
        self.vector_source_matrix_key = "vector_source"
        self.bound_pressure_vector_source_matrix_key = (
            "bound_pressure_vector_source"
        )

    def ndof(self, sd) -> int:
        """One pressure dof per cell."""
        return sd.num_cells
