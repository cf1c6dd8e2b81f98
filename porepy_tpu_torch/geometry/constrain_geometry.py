"""Constrain geometric objects to polygons/polyhedra, and point snapping.

Parity counterpart of reference ``geometry/constrain_geometry.py``, with
own convex clipping in place of shapely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["lines_by_polygon", "polygons_by_polyhedron", "snap_points_to_segments"]


def lines_by_polygon(
    poly_pts: np.ndarray, pts: np.ndarray, edges: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clip 2d line segments by a CONVEX polygon: returns the clipped
    points, the re-indexed edges (tags preserved) and the indices of the
    kept input edges. Segments running along the polygon boundary are
    dropped (reference ``constrain_geometry.py:15``)."""
    from porepy_tpu_torch.geometry.geometry_property_checks import is_ccw_polygon

    poly = np.asarray(poly_pts, dtype=float)[:2]
    if not is_ccw_polygon(poly):
        poly = poly[:, ::-1]
    n_poly = poly.shape[1]

    int_pts = np.empty((2, 0))
    kept = []
    new_edges = []
    next_ind = 0
    for ei, e in enumerate(edges.T):
        a = pts[:2, e[0]].astype(float)
        b = pts[:2, e[1]].astype(float)
        # Parametric clip of the segment by each polygon half-plane.
        t0, t1 = 0.0, 1.0
        d = b - a
        on_boundary = False
        ok = True
        for k in range(n_poly):
            p0 = poly[:, k]
            p1 = poly[:, (k + 1) % n_poly]
            edge = p1 - p0
            # >= 0 inside for ccw polygon.
            denom = edge[0] * d[1] - edge[1] * d[0]
            num = edge[0] * (a[1] - p0[1]) - edge[1] * (a[0] - p0[0])
            if np.abs(denom) < 1e-12:
                if num < -1e-12:
                    ok = False
                    break
                if np.abs(num) < 1e-12:
                    on_boundary = True
            else:
                t_hit = -num / denom
                if denom > 0:
                    t0 = max(t0, t_hit)
                else:
                    t1 = min(t1, t_hit)
        if not ok or t1 - t0 <= 1e-12 or on_boundary:
            continue
        pa = a + t0 * d
        pb = a + t1 * d
        int_pts = np.c_[int_pts, pa, pb]
        tags = e[2:]
        new_edges.append(np.hstack(([next_ind, next_ind + 1], tags)))
        next_ind += 2
        kept.append(ei)
    if new_edges:
        int_edges = np.array(new_edges, dtype=int).T
    else:
        int_edges = np.empty((edges.shape[0], 0), dtype=int)
    return int_pts, int_edges, np.asarray(kept, dtype=int)


def polygons_by_polyhedron(
    polygons, polyhedron, tol: float = 1e-8
) -> tuple[list[np.ndarray], np.ndarray]:
    """Constrain 3d polygons to the interior of a (possibly non-convex)
    polyhedron given by its polygon sides. Returns the clipped polygons and
    the index of the original polygon each came from."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        point_in_polyhedron,
    )
    from porepy_tpu_torch.geometry.intersections import polygons_3d
    from porepy_tpu_torch.utils.array_operations import uniquify_point_set

    if isinstance(polygons, np.ndarray):
        polygons = [polygons]

    constrained: list[np.ndarray] = []
    orig: list[int] = []
    for pi, poly in enumerate(polygons):
        poly = np.asarray(poly, dtype=float)
        # Intersect the polygon with every side of the polyhedron; collect
        # the polygon's vertices that are inside, plus boundary crossings.
        inside = point_in_polyhedron(polyhedron, poly, tol)
        all_polys = [poly] + [np.asarray(s, dtype=float) for s in polyhedron]
        isect = polygons_3d(all_polys, target_poly=np.array([0]), tol=tol)
        cut_pts = isect[0][:, isect[1][0].astype(int)] if isect[1][0].size else np.zeros((3, 0))
        cand = np.hstack((poly[:, inside], cut_pts))
        if cand.shape[1] < 3:
            continue
        cand, _, _ = uniquify_point_set(cand, tol)
        if cand.shape[1] < 3:
            continue
        # Keep only candidate points inside or on the polyhedron (cut points
        # are on the boundary; vertex points are strictly inside).
        center = cand.mean(axis=1).reshape((-1, 1))
        # Angular sort in the polygon plane.
        R = map_geometry.project_plane_matrix(poly)
        local = R @ (cand - center)
        order = np.argsort(np.arctan2(local[1], local[0]))
        constrained.append(cand[:, order])
        orig.append(pi)
    return constrained, np.asarray(orig, dtype=int)


def snap_points_to_segments(
    p_edges: np.ndarray,
    edges: np.ndarray,
    tol: float,
    p_to_snap: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Snap points closer than ``tol`` to a segment onto that segment
    (reference ``constrain_geometry.py:606``)."""
    from porepy_tpu_torch.geometry.distances import points_segments

    if p_to_snap is None:
        p_to_snap = p_edges
        mod_edges = True
    else:
        mod_edges = False
    pn = p_to_snap.copy().astype(float)
    for ei in range(edges.shape[1]):
        src = pn if mod_edges else p_edges
        p_start = src[:, edges[0, ei]].reshape((-1, 1))
        p_end = src[:, edges[1, ei]].reshape((-1, 1))
        d_segment, cp = points_segments(pn, p_start, p_end)
        hit = np.argwhere(d_segment[:, 0] < tol)
        for i in hit:
            if mod_edges and (i == edges[0, ei] or i == edges[1, ei]):
                continue
            pn[:, i] = cp[i, 0, :].reshape((-1, 1))
    return pn
