"""Fracture primitives: 2d line fractures and 3d planar polygon fractures.

Parity counterpart of reference ``fracs/fracture.py:14``,
``line_fracture.py:13`` and ``plane_fracture.py:19``.
"""

from __future__ import annotations

from typing import Generator, Optional

import numpy as np

__all__ = ["Fracture", "LineFracture", "PlaneFracture", "create_elliptic_fracture"]


class Fracture:
    """Common base: vertices (columns of ``pts``), tags, index, normal and
    centroid. Vertices may be re-sorted at construction."""

    def __init__(
        self,
        points,
        tags=None,
        index: Optional[int] = None,
        sort_points: bool = True,
    ) -> None:
        self.pts: np.ndarray = np.asarray(points, dtype=float)
        self._check_pts()
        if sort_points:
            self.sort_points()
        self.normal: np.ndarray = self.compute_normal()
        self.center: np.ndarray = self.compute_centroid()
        self.orig_pts: np.ndarray = self.pts.copy()
        self.index: Optional[int] = index
        if tags is None:
            self.tags = np.full((0,), -1, dtype=np.int32)
        else:
            self.tags = np.asarray(tags, dtype=np.int32)

    def __repr__(self) -> str:
        return str(self)

    def __str__(self) -> str:
        s = f"{type(self).__name__} with vertices:\n{self.pts}\n"
        if self.index is not None:
            s += f"Index: {self.index}\n"
        return s

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fracture) and self.index == other.index

    def __hash__(self) -> int:
        return id(self)

    def set_index(self, index: int) -> None:
        self.index = index

    def points(self) -> Generator[np.ndarray, None, None]:
        for i in range(self.pts.shape[1]):
            yield self.pts[:, i].reshape((-1, 1))

    def segments(self) -> Generator[np.ndarray, None, None]:
        n = self.pts.shape[1]
        for i in range(n):
            yield self.pts[:, [i, (i + 1) % n]]

    def is_vertex(self, p, tol: float = 1e-4):
        p = np.asarray(p).reshape((-1, 1))
        dist = np.sqrt(np.sum((self.pts - p) ** 2, axis=0))
        ind = np.argmin(dist)
        if dist[ind] < tol * np.sqrt(np.sum(self.pts**2)):
            return True, int(ind)
        return False, None

    def copy(self) -> "Fracture":
        out = type(self)(self.pts.copy(), index=self.index, sort_points=False)
        out.tags = self.tags.copy()
        return out

    # -- subclass contract --------------------------------------------------

    def sort_points(self) -> np.ndarray:
        raise NotImplementedError

    def local_coordinates(self) -> np.ndarray:
        raise NotImplementedError

    def compute_centroid(self) -> np.ndarray:
        raise NotImplementedError

    def compute_normal(self) -> np.ndarray:
        raise NotImplementedError

    def _check_pts(self) -> None:
        raise NotImplementedError


class LineFracture(Fracture):
    """2d fracture: a two-vertex segment."""

    def sort_points(self) -> np.ndarray:
        return np.arange(2)

    def local_coordinates(self) -> np.ndarray:
        return np.reshape([0, self.length()], (1, 2))

    def compute_centroid(self) -> np.ndarray:
        return np.mean(self.pts, axis=1)

    def compute_normal(self) -> np.ndarray:
        diff = np.diff(self.pts, axis=1)
        normal = np.array([diff[0], -diff[1]])
        return normal / np.linalg.norm(normal)

    def _check_pts(self) -> None:
        if self.pts.shape != (2, 2):
            raise ValueError(
                "pts defining a LineFracture should have dimensions 2 x 2."
            )
        if np.all(np.isclose(self.pts[:, 0], self.pts[:, 1])):
            raise ValueError("Need two distinct pts to define a LineFracture.")

    def length(self) -> float:
        return float(np.linalg.norm(np.diff(self.pts, axis=1)))


class PlaneFracture(Fracture):
    """3d fracture: a planar (assumed convex) polygon."""

    def __init__(
        self,
        points,
        index: Optional[int] = None,
        sort_points: bool = True,
    ) -> None:
        super().__init__(points, index=index, sort_points=sort_points)

    def sort_points(self) -> np.ndarray:
        points_2d = self.local_coordinates()
        points_2d = points_2d - np.mean(points_2d, axis=1).reshape((-1, 1))
        theta = np.arctan2(points_2d[1], points_2d[0])
        sort_ind = np.argsort(theta)
        self.pts = self.pts[:, sort_ind]
        return sort_ind

    def local_coordinates(self) -> np.ndarray:
        from porepy_tpu_torch.geometry import map_geometry

        rotation = map_geometry.project_plane_matrix(self.pts)
        return (rotation @ self.pts)[:2]

    def add_points(
        self, p: np.ndarray, check_convexity: bool = False, tol: float = 1e-4
    ) -> bool:
        """Extend the polygon with extra (coplanar) points; re-sorts."""
        self.pts = np.hstack((self.pts, np.atleast_2d(p)))
        # Uniquify.
        from porepy_tpu_torch.utils.array_operations import uniquify_point_set

        self.pts, _, _ = uniquify_point_set(self.pts, tol)
        self.sort_points()
        return self.is_planar(tol) and (
            self.is_convex() if check_convexity else True
        )

    def remove_points(self, ind, keep_orig: bool = False) -> None:
        self.pts = np.delete(self.pts, ind, axis=1)
        if not keep_orig:
            self.orig_pts = self.pts.copy()

    def is_convex(self) -> bool:
        from porepy_tpu_torch.geometry.geometry_property_checks import is_ccw_polygon

        p_2d = self.local_coordinates()
        if p_2d.shape[1] == 3:
            return True
        return bool(is_ccw_polygon(p_2d) or is_ccw_polygon(p_2d[:, ::-1]))

    def is_planar(self, tol: float = 1e-4) -> bool:
        from porepy_tpu_torch.geometry.geometry_property_checks import (
            points_are_planar,
        )

        return points_are_planar(self.pts, self.normal, tol)

    def compute_centroid(self) -> np.ndarray:
        """Area-weighted centroid of the polygon (fan triangulation in the
        local plane)."""
        from porepy_tpu_torch.geometry import map_geometry

        R = map_geometry.project_plane_matrix(self.pts)
        pts = R @ self.pts
        z = pts[2, 0]
        pts = pts[:2]
        center = np.mean(pts, axis=1).reshape((-1, 1))
        n = pts.shape[1]
        area_tot = 0.0
        c_acc = np.zeros(2)
        for i in range(n):
            a = pts[:, i] - center.ravel()
            b = pts[:, (i + 1) % n] - center.ravel()
            area = 0.5 * abs(a[0] * b[1] - a[1] * b[0])
            c_tri = center.ravel() + (a + b) / 3.0
            area_tot += area
            c_acc += area * c_tri
        c_local = np.append(c_acc / area_tot, z)
        return R.T @ c_local

    def compute_normal(self) -> np.ndarray:
        from porepy_tpu_torch.geometry import map_geometry

        return map_geometry.compute_normal(self.pts)

    def _check_pts(self) -> None:
        if self.pts.shape[0] != 3:
            raise ValueError(
                "pts defining a PlaneFracture should have 3 coordinates"
            )
        if self.pts.shape[1] < 3:
            raise ValueError("At least 3 points are needed to define a plane")


def create_elliptic_fracture(
    center: np.ndarray,
    major_axis: float,
    minor_axis: float,
    major_axis_angle: float,
    strike_angle: float,
    dip_angle: float,
    num_points: int = 16,
    index: Optional[int] = None,
) -> PlaneFracture:
    """Polygonal approximation of an elliptic 3d fracture (reference
    ``plane_fracture.py:262``): ellipse in the xy-plane, rotated by the
    major-axis angle, then dipped around the strike direction."""
    from porepy_tpu_torch.geometry import map_geometry

    center = np.asarray(center, dtype=float).reshape((-1, 1))
    angs = np.linspace(0, 2 * np.pi, num_points + 1, endpoint=True)[:-1]
    ref_pts = np.vstack(
        (
            major_axis * np.cos(angs),
            minor_axis * np.sin(angs),
            np.zeros_like(angs),
        )
    )
    major_rot = map_geometry.axis_angle_rotation(
        major_axis_angle, np.array([0.0, 0.0, 1.0])
    )
    rot_ref = major_rot @ ref_pts
    strike_rot = map_geometry.axis_angle_rotation(
        strike_angle, np.array([0.0, 0.0, 1.0])
    )
    strike_dir = strike_rot @ np.array([1.0, 0.0, 0.0])
    dip_rot = map_geometry.axis_angle_rotation(dip_angle, strike_dir)
    pts = center + dip_rot @ rot_ref
    return PlaneFracture(pts, index, sort_points=False)
