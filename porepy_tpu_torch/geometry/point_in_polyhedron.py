"""Robust point-in-polyhedron test for non-convex polyhedra.

Generalized winding numbers (Jacobson, Kavan & Sorkine-Hornung 2013,
doi:10.1145/2461912.2461916) over a consistently oriented triangulated
surface — reference ``geometry/point_in_polyhedron.py``. The solid angle
of each surface triangle, seen from the query point, is accumulated; the
total divided by 4π is 0 outside, ±1 inside.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PointInPolyhedron"]


class PointInPolyhedron:
    def __init__(
        self, vertices: np.ndarray, connectivity: np.ndarray, tol: float = 1e-10
    ) -> None:
        self.vertices = np.asarray(vertices, dtype=float)
        self.connectivity = np.asarray(connectivity, dtype=int)
        self.tol = tol

    def solid_angle(self, R: np.ndarray) -> float:
        """Solid angle subtended at the origin by the triangle with (already
        translated) vertices in the rows of ``R`` (Van Oosterom & Strackee
        / eq. (6) of the winding-number paper)."""
        r = np.linalg.norm(R, axis=1)
        if np.any(r < self.tol):
            raise ValueError("Origin point coincides with a vertex")
        edge_areas = 0.5 * np.array(
            [
                np.linalg.norm(np.cross(R[0], R[1])),
                np.linalg.norm(np.cross(R[1], R[2])),
                np.linalg.norm(np.cross(R[2], R[0])),
            ]
        )
        if np.any(edge_areas < self.tol):
            raise ValueError("Origin point is collinear with the vertices")
        volume = np.abs(np.dot(R[1], np.cross(R[0] - R[1], R[2] - R[1])))
        if volume < self.tol:
            raise ValueError("Origin point is coplanar with the vertices")
        numerator = np.dot(R[0], np.cross(R[1], R[2]))
        denominator = (
            np.prod(r)
            + np.dot(R[0], R[1]) * r[2]
            + np.dot(R[0], R[2]) * r[1]
            + np.dot(R[1], R[2]) * r[0]
        )
        return 2.0 * np.arctan2(numerator, denominator)

    def winding_number(self, point: np.ndarray) -> float:
        R = self.vertices - np.asarray(point, dtype=float)
        total = sum(self.solid_angle(R[tri]) for tri in self.connectivity)
        return total / (4.0 * np.pi)
