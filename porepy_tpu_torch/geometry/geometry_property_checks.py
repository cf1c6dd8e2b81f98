"""Geometric predicates (reference ``geometry/geometry_property_checks.py``).

Winding-number point-in-polygon (Dickinson's robust formulation),
ccw orientation tests, planarity/collinearity checks and the odd-even
in-cell test for concave polygons.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

__all__ = [
    "is_ccw_polygon",
    "is_ccw_polyline",
    "point_in_polygon",
    "point_in_polyhedron",
    "points_are_planar",
    "point_in_cell",
    "points_are_collinear",
    "polygon_hanging_nodes",
]


def is_ccw_polygon(poly: np.ndarray) -> bool:
    """True if the 2d polygon vertices are ordered counterclockwise (signed
    shoelace sum)."""
    x = np.append(poly[0], poly[0, 0])
    y = np.append(poly[1], poly[1, 0])
    return float(np.sum((y[1:] + y[:-1]) * (x[1:] - x[:-1]))) < 0


def is_ccw_polyline(
    p1: np.ndarray,
    p2: np.ndarray,
    p3: np.ndarray,
    tol: float = 0,
    default: bool = False,
) -> np.ndarray:
    """For each point in ``p3``: True if it lies to the left of the directed
    line ``p1 -> p2`` (within ``tol``, ``default`` decides)."""
    p3 = p3.reshape((-1, 1)) if p3.ndim == 1 else p3
    cross = (p2[0] - p1[0]) * (p3[1] - p1[1]) - (p2[1] - p1[1]) * (
        p3[0] - p1[0]
    )
    out = np.ones(p3.shape[1], dtype=bool)
    out[cross < -tol] = False
    out[np.abs(cross) <= tol] = default
    return out


def point_in_polygon(
    poly: np.ndarray, p: np.ndarray, default: bool = False
) -> np.ndarray:
    """Winding-number containment test for (possibly non-convex) 2d polygons.
    Points on a vertex or edge keep the ``default`` value."""
    pt = p.reshape((-1, 1)) if p.ndim == 1 else p
    nxt = np.roll(poly, -1, axis=1)
    inside = np.full(pt.shape[1], default, dtype=bool)
    for i in range(pt.shape[1]):
        ax = poly[0] - pt[0, i]
        ay = poly[1] - pt[1, i]
        bx = nxt[0] - pt[0, i]
        by = nxt[1] - pt[1, i]
        if np.any((ax == 0) & (ay == 0)) or np.any((bx == 0) & (by == 0)):
            continue  # on a vertex: keep default
        sgn_a = np.sign(ax)
        sgn_a[sgn_a == 0] = np.sign(ay)[sgn_a == 0]
        sgn_b = np.sign(bx)
        sgn_b[sgn_b == 0] = np.sign(by)[sgn_b == 0]
        edge_sgn = np.sign(ax * by - ay * bx)
        if np.any(edge_sgn == 0):
            continue  # on an edge: keep default
        crossing = sgn_b - sgn_a != 0
        winding = np.sum(edge_sgn[crossing]) / 2
        inside[i] = np.abs(winding) > 0
    return inside


def point_in_polyhedron(
    polyhedron: Union[np.ndarray, list],
    test_points: np.ndarray,
    tol: float = 1e-10,
) -> np.ndarray:
    """Winding-number containment for polyhedra given as a list of convex
    polygon sides (reference ``geometry_property_checks.py:237``)."""
    import scipy.spatial

    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.point_in_polyhedron import PointInPolyhedron
    from porepy_tpu_torch.geometry.sort_points import sort_triangle_edges
    from porepy_tpu_torch.utils.array_operations import uniquify_point_set

    tri = np.zeros((0, 3))
    points = np.zeros((3, 0))
    offset = 0
    for poly in polyhedron:
        if poly.shape[1] == 3:
            simplices = np.array([[0, 1, 2]])
        else:
            R = map_geometry.project_plane_matrix(poly)
            simplices = scipy.spatial.Delaunay((R @ poly)[:2].T).simplices
        tri = np.vstack((tri, offset + np.atleast_2d(simplices)))
        points = np.hstack((points, poly))
        offset += np.atleast_2d(simplices).max() + 1
    upoints, _, ib = uniquify_point_set(points, tol)
    ut = ib[tri.astype(int)]
    sorted_t = sort_triangle_edges(ut.T).T
    tester = PointInPolyhedron(upoints.T, sorted_t, tol)
    if test_points.size < 4:
        test_points = test_points.reshape((-1, 1))
    is_inside = np.zeros(test_points.shape[1], dtype=bool)
    for pi in range(test_points.shape[1]):
        try:
            is_inside[pi] = (
                np.abs(tester.winding_number(test_points[:, pi])) > tol
            )
        except ValueError as err:
            if "Origin point" in str(err):
                is_inside[pi] = False
            else:
                raise
    return is_inside


def points_are_planar(
    pts: np.ndarray, normal: Optional[np.ndarray] = None, tol: float = 1e-5
) -> bool:
    from porepy_tpu_torch.geometry import map_geometry

    if normal is None:
        normal = map_geometry.compute_normal(pts)
    else:
        normal = normal.flatten() / np.linalg.norm(normal)
    normal = np.asarray(normal).reshape((-1, 1))
    center = np.mean(pts, axis=1).reshape((-1, 1))
    dist = np.linalg.norm(np.sum(normal * (pts - center), axis=0))
    return bool(np.isclose(dist, 0, atol=tol, rtol=0))


def point_in_cell(
    poly: np.ndarray, p: np.ndarray, if_make_planar: bool = True
) -> bool:
    """Odd-even crossing test; handles concave cells. Boundary points may go
    either way."""
    from porepy_tpu_torch.geometry import map_geometry

    p = np.asarray(p).reshape((3, 1))
    if if_make_planar:
        R = map_geometry.project_plane_matrix(poly)
        poly = R @ poly
        p = R @ p
    j = poly.shape[1] - 1
    odd = False
    for i in range(poly.shape[1]):
        yi, yj = poly[1, i], poly[1, j]
        if (yi < p[1] <= yj) or (yj < p[1] <= yi):
            x_cross = poly[0, i] + (p[1] - yi) / (yj - yi) * (
                poly[0, j] - poly[0, i]
            )
            if x_cross < p[0]:
                odd = not odd
        j = i
    return odd


def points_are_collinear(pts: np.ndarray, tol: float = 1e-5) -> bool:
    if pts.shape[1] <= 2:
        return True
    origin = pts[:, 0].reshape((-1, 1))
    direction = pts[:, 1] - pts[:, 0]
    cross = np.cross(direction, (pts[:, 2:] - origin).T)
    return bool(np.allclose(cross, 0, atol=tol, rtol=0))


def polygon_hanging_nodes(p: np.ndarray, edges: np.ndarray, tol=1e-8) -> np.ndarray:
    """Indices of polygon vertices lying on the straight line between their
    neighbors (hanging nodes)."""
    num = edges.shape[1]
    hang = []
    for i in range(num):
        prev_pt = p[:, edges[0, i]]
        this_pt = p[:, edges[1, i]]
        next_pt = p[:, edges[1, (i + 1) % num]]
        v1 = this_pt - prev_pt
        v2 = next_pt - this_pt
        n1 = np.linalg.norm(v1)
        n2 = np.linalg.norm(v2)
        if n1 < tol or n2 < tol:
            continue
        if np.linalg.norm(np.cross(v1 / n1, v2 / n2)) < tol:
            hang.append(edges[1, i])
    return np.asarray(hang, dtype=int)
