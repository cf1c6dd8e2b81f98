"""Intersection kernels for segments and polygons.

Parity counterpart of reference ``geometry/intersections.py``. Host-side
numpy: these run during meshing/preprocessing, not on the TPU compute
path.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

__all__ = [
    "segments_2d",
    "segments_3d",
    "split_intersecting_segments_2d",
    "polygons_3d",
    "segments_polygon",
    "segments_polyhedron",
    "triangulations",
    "line_tessellation",
    "surface_tessellations",
]


def segments_2d(
    start_1: np.ndarray,
    end_1: np.ndarray,
    start_2: np.ndarray,
    end_2: np.ndarray,
    tol: float = 1e-8,
) -> Optional[np.ndarray]:
    """Intersection of two 2d segments: a point (2,1), an overlap segment
    (2,2) with the first column closest to ``start_1``, or None."""
    start_1 = np.asarray(start_1, dtype=float)
    end_1 = np.asarray(end_1, dtype=float)
    start_2 = np.asarray(start_2, dtype=float)
    end_2 = np.asarray(end_2, dtype=float)

    d_1 = end_1 - start_1
    d_2 = end_2 - start_2
    length_1 = np.sqrt(np.sum(d_1 * d_1))
    length_2 = np.sqrt(np.sum(d_2 * d_2))
    d_s = start_2 - start_1

    # Solve start_1 + t_1 d_1 = start_2 + t_2 d_2 by Cramer's rule; the
    # determinant detects parallel segments (relative tolerance).
    discr = d_1[0] * (-d_2[1]) - d_1[1] * (-d_2[0])
    if np.abs(discr) < tol * length_1 * length_2:
        # Parallel. Only collinear segments can intersect.
        offset_cross = d_s[0] * d_1[1] - d_s[1] * d_1[0]
        if np.abs(offset_cross) >= tol * max(length_1, length_2):
            return None
        # Parameterize segment 2 endpoints on segment 1.
        if np.abs(d_1[0]) > tol * length_1:
            t_a = (start_2[0] - start_1[0]) / d_1[0]
            t_b = (end_2[0] - start_1[0]) / d_1[0]
        elif np.abs(d_1[1]) > tol * length_2:
            t_a = (start_2[1] - start_1[1]) / d_1[1]
            t_b = (end_2[1] - start_1[1]) / d_1[1]
        else:
            raise ValueError("Start and endpoint of line should be different")
        if (t_a < 0 and t_b < 0) or (t_a > 1 and t_b > 1):
            return None
        t_min = max(min(t_a, t_b), 0.0)
        t_max = min(max(t_a, t_b), 1.0)
        if t_max - t_min < tol:
            return (start_1 + d_1 * t_min).reshape((-1, 1))
        p_lo = start_1 + d_1 * t_min
        p_hi = start_1 + d_1 * t_max
        return np.array([[p_lo[0], p_hi[0]], [p_lo[1], p_hi[1]]])

    t_1 = (d_s[0] * (-d_2[1]) - d_s[1] * (-d_2[0])) / discr
    t_2 = (d_1[0] * d_s[1] - d_1[1] * d_s[0]) / discr
    if -tol <= t_1 <= 1 + tol and -tol <= t_2 <= 1 + tol:
        return (start_1 + t_1 * d_1).reshape((-1, 1))
    return None


def segments_3d(
    start_1: np.ndarray,
    end_1: np.ndarray,
    start_2: np.ndarray,
    end_2: np.ndarray,
    tol: float = 1e-8,
) -> Optional[np.ndarray]:
    """Intersection of two 3d segments: point (3,1), overlap (3,2) or None."""
    start_1 = np.asarray(start_1, dtype=float).ravel()
    end_1 = np.asarray(end_1, dtype=float).ravel()
    start_2 = np.asarray(start_2, dtype=float).ravel()
    end_2 = np.asarray(end_2, dtype=float).ravel()

    d1 = end_1 - start_1
    d2 = end_2 - start_2
    active = (np.abs(d1) > tol) | (np.abs(d2) > tol)
    # Pick two coordinate axes with variation for the 2x2 system; the third
    # is used as a consistency check.
    if active.sum() > 1:
        if active[0] and active[1]:
            axes, check_ax = np.array([0, 1]), 2
        elif active[0] and active[2]:
            axes, check_ax = np.array([0, 2]), 1
        else:
            axes, check_ax = np.array([1, 2]), 0
    else:
        axes, check_ax = np.arange(2), 2

    discr = d1[axes[0]] * d2[axes[1]] - d1[axes[1]] * d2[axes[0]]
    if np.abs(discr) < tol:
        # Parallel: check collinearity, then 1d overlap.
        mask1 = np.abs(d1) > tol
        mask2 = np.abs(d2) > tol
        if np.any(mask1 != mask2):
            return None
        t = d1[mask1] / d2[mask2]
        if t.size >= 2 and np.any(np.abs(t - t[0]) > tol):
            return None
        diff = start_2 - start_1
        if np.any(np.abs(np.cross(diff, d1)) > tol):
            return None
        if not np.allclose(start_1[~mask1], start_2[~mask1], tol):
            return None
        s_1, e_1 = start_1[mask1][0], end_1[mask1][0]
        s_2, e_2 = start_2[mask1][0], end_2[mask1][0]
        if max(s_1, e_1) < min(s_2, e_2) or max(s_2, e_2) < min(s_1, e_1):
            return None
        coords = np.array([s_1, e_1, s_2, e_2])
        middle_two = np.argsort(coords)[1:3]
        endpoints = np.vstack((start_1, end_1, start_2, end_2)).T
        return endpoints[:, middle_two]

    d_s = start_2 - start_1
    # Cramer's rule on [d1, -d2] [t_1, t_2]^T = d_s: the system determinant
    # is the NEGATION of the parallel-check determinant above.
    det = -discr
    t_1 = (d_s[axes[0]] * (-d2[axes[1]]) - d_s[axes[1]] * (-d2[axes[0]])) / det
    t_2 = (d1[axes[0]] * d_s[axes[1]] - d1[axes[1]] * d_s[axes[0]]) / det
    if t_1 < 0 or t_1 > 1 or t_2 < 0 or t_2 > 1:
        return None
    z1 = start_1[check_ax] + t_1 * d1[check_ax]
    z2 = start_2[check_ax] + t_2 * d2[check_ax]
    if np.abs(z1 - z2) < tol:
        out = np.zeros(3)
        out[axes] = start_1[axes] + t_1 * d1[axes]
        out[check_ax] = z1
        return out.reshape((-1, 1))
    return None


def split_intersecting_segments_2d(
    p: np.ndarray, e: np.ndarray, tol: float = 1e-8, return_argsort: bool = False
):
    """Resolve all pairwise intersections in a 2d segment set: returns an
    extended point set and non-intersecting (split) edges, with tags
    preserved (reference ``intersections.py:2111``)."""
    from porepy_tpu_torch.utils.array_operations import uniquify_point_set

    if p.dtype == int:
        p = p.astype(float)
    num_lines = e.shape[1]
    x_min, x_max, y_min, y_max = _axis_aligned_bounding_box_2d(p, e)
    for cmin, cmax in [(x_min, x_max), (y_min, y_max)]:
        flat = cmax - cmin < tol
        cmin[flat] -= 0.5 * tol
        cmax[flat] += 0.5 * tol
    pairs = _identify_overlapping_rectangles(x_min, x_max, y_min, y_max)

    isect_pt: list[list[int]] = [[] for _ in range(num_lines)]
    new_pts: list[np.ndarray] = []
    next_ind = p.shape[1]

    for main in np.unique(pairs[0]) if pairs.size else []:
        others = np.sort(pairs[1, pairs[0] == main])
        start_main = p[:, e[0, main]]
        end_main = p[:, e[1, main]]
        main_vec = end_main - start_main
        main_len = np.linalg.norm(main_vec)
        main_vec = main_vec / (main_len if main_len > tol else 1.0)

        start_others = p[:, e[0, others]].reshape((2, -1))
        end_others = p[:, e[1, others]].reshape((2, -1))

        def unit_cols(v):
            n = np.sqrt(np.sum(v**2, axis=0))
            return v / np.where(n < tol, 1.0, n)

        # Same-side prefilter. A coincident endpoint gives a zero vector,
        # whose cross product is 0 — counted as potentially relevant. The
        # midpoint fallback only engages when ALL other start/end points
        # coincide with start_main (reference quirk: its distance test is a
        # scalar over the whole set, ``intersections.py:2247``).
        if np.sqrt(np.sum((start_others - start_main[:, None]) ** 2)) > tol:
            va = unit_cols(start_others - start_main[:, None])
        else:
            va = unit_cols(
                0.5 * (start_others + end_others) - start_main[:, None]
            )
        if np.sqrt(np.sum((end_others - start_main[:, None]) ** 2)) > tol:
            vb = unit_cols(end_others - start_main[:, None])
        else:
            vb = unit_cols(
                0.3 * start_others + 0.7 * end_others - start_main[:, None]
            )

        def msign(v):
            s = np.sign(v)
            s[np.abs(v) < tol] = 0
            return s

        ca = msign(main_vec[0] * va[1] - main_vec[1] * va[0])
        cb = msign(main_vec[0] * vb[1] - main_vec[1] * vb[0])
        relevant = np.where(
            (ca * cb < 1) | np.any(np.isnan(va + vb), axis=0)
        )[0]

        for ri in relevant:
            other = others[ri]
            ipt = segments_2d(
                start_main, end_main, start_others[:, ri], end_others[:, ri], tol
            )
            if ipt is None:
                continue
            n_new = ipt.shape[1]
            inds = list(range(next_ind, next_ind + n_new))
            isect_pt[main].extend(inds)
            isect_pt[other].extend(inds)
            next_ind += n_new
            new_pts.append(ipt)

    if not new_pts:
        tag_info = (e[2:].copy(), np.arange(num_lines))
        if return_argsort:
            return p, e, tag_info, np.arange(num_lines)
        return p, e, tag_info

    all_pt = np.hstack((p, np.hstack(new_pts)))
    unique_pt, _, ib = uniquify_point_set(all_pt, tol)

    new_edge = np.empty((e.shape[0], 0), dtype=int)
    argsort = np.empty(0, dtype=int)
    for ei in range(num_lines):
        inds = np.unique(ib[np.hstack((e[:2, ei], isect_pt[ei])).astype(int)])
        loc_pts = unique_pt[:, inds].reshape((unique_pt.shape[0], -1))
        loc_start = unique_pt[:, ib[e[0, ei]]].reshape((-1, 1))
        order = np.argsort(np.sum((loc_pts - loc_start) ** 2, axis=0))
        chain = inds[order]
        num_branches = chain.size - 1
        loc_tags = e[2:, ei].reshape((-1, 1)) * np.ones(num_branches, dtype=int)
        new_edge = np.hstack(
            (new_edge, np.vstack((chain[:-1], chain[1:], loc_tags)))
        )
        argsort = np.hstack((argsort, [ei] * num_branches))
    new_edge[:2] = np.sort(new_edge[:2], axis=0)
    tags = new_edge[2:].copy().ravel()
    _, edge_map, all_2_unique = np.unique(
        new_edge[:2].astype(int), axis=1, return_index=True, return_inverse=True
    )
    tag_info = (tags, all_2_unique)
    new_edge = new_edge[:, edge_map]
    argsort = argsort[edge_map]
    if return_argsort:
        return unique_pt, new_edge.astype(int), tag_info, argsort
    return unique_pt, new_edge.astype(int), tag_info


def segments_polygon(
    start: np.ndarray, end: np.ndarray, poly: np.ndarray, tol: float = 1e-5
) -> tuple[np.ndarray, np.ndarray]:
    """Intersections of segments with the INTERIOR of a planar polygon:
    boolean hit-mask and the intersection points."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import point_in_polygon

    if start.size < 4:
        start = start.reshape((-1, 1))
    if end.size < 4:
        end = end.reshape((-1, 1))
    num_s = start.shape[1]
    nd = start.shape[0]
    cp = np.zeros((nd, num_s))

    center = np.mean(poly, axis=1).reshape((-1, 1))
    R = map_geometry.project_plane_matrix(poly - center)
    poly_rot = R @ (poly - center)
    if not np.all(np.abs(poly_rot[2]) < tol):
        raise ValueError("Polygon is not planar")
    s_rot = R @ (start - center)
    e_rot = R @ (end - center)

    dz = e_rot[2] - s_rot[2]
    inclined = np.abs(dz) > tol
    t = np.where(inclined, -s_rot[2] / np.where(inclined, dz, 1.0), 0.0)
    in_range = inclined & (t >= -tol) & (t <= 1 + tol)
    x0 = s_rot + (e_rot - s_rot) * t
    crosses = in_range & point_in_polygon(poly_rot[:2], x0[:2])
    # Guard: intersection must lie within the segment.
    dot = np.einsum("ij,ij->j", x0 - s_rot, e_rot - s_rot)
    sq_len = np.einsum("ij,ij->j", e_rot - s_rot, e_rot - s_rot)
    crosses &= (dot >= 0) & (dot <= sq_len + tol)
    x0[2, crosses] = 0
    cp[:, crosses] = center + R.T @ x0[:, crosses]
    return crosses, cp


def segments_polyhedron(
    start: np.ndarray, end: np.ndarray, poly, tol: float = 1e-5
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Intersection of segments with the interior of a polyhedron (faces
    given as polygons): boundary crossing points, endpoint-containment
    flags and the in-polyhedron length fraction of each segment."""
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        point_in_polyhedron,
    )
    from porepy_tpu_torch.geometry.sort_points import sort_point_plane

    if start.ndim == 1:
        start = start.reshape((start.shape[0], -1))
        end = end.reshape((end.shape[0], -1))
    in_start = point_in_polyhedron(poly, start, tol)
    in_end = point_in_polyhedron(poly, end, tol)
    extra = np.empty(start.shape[1], dtype=object)
    for i in range(extra.size):
        extra[i] = np.empty((3, 0))
    for face in poly:
        order = sort_point_plane(face, np.average(face, axis=1))
        hit, pts = segments_polygon(start, end, face[:, order], tol=tol)
        for i in np.flatnonzero(hit):
            extra[i] = np.c_[extra[i], pts[:, i]]
    length = np.zeros(start.shape[1])
    for seg in range(start.shape[1]):
        if in_start[seg] and in_end[seg]:
            length[seg] = np.linalg.norm(end[:, seg] - start[:, seg])
        elif in_start[seg] and extra[seg].shape[1] > 0:
            length[seg] = np.linalg.norm(start[:, seg] - extra[seg].flatten())
        elif in_end[seg] and extra[seg].shape[1] > 0:
            length[seg] = np.linalg.norm(end[:, seg] - extra[seg].flatten())
        elif extra[seg].shape[1] > 1:
            length[seg] = np.linalg.norm(extra[seg][:, 0] - extra[seg][:, 1])
    ratio = length / np.sqrt(np.einsum("ij,ij->j", end - start, end - start))
    return extra, in_start, in_end, ratio


def polygons_3d(
    polys: list,
    target_poly=None,
    tol: float = 1e-8,
    include_point_contact: bool = True,
):
    """Pairwise intersections between convex planar polygons embedded in 3d
    (reference ``intersections.py:380``).

    Instead of the reference's combinatorial case enumeration, each pair is
    resolved geometrically: the chord of each polygon along the common
    plane-intersection line is computed, the two chords are overlapped as
    1d intervals, and every resulting point is classified against each
    polygon (vertex / segment / interior) by distance.

    Returns (new_points, isect_pt, is_bound_isect, polygon_pairs,
    segment_vertex_intersection, is_point_contact) with the reference's
    container layout.
    """
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.distances import point_pointset, points_segments
    from porepy_tpu_torch.utils.array_operations import uniquify_point_set

    num_polys = len(polys)
    polys = [np.asarray(p, dtype=float) for p in polys]
    if target_poly is None:
        target_poly = np.arange(num_polys)
    else:
        target_poly = np.atleast_1d(np.asarray(target_poly))

    x_min, x_max, y_min, y_max, z_min, z_max = _axis_aligned_bounding_box_3d(
        polys
    )
    for cmin, cmax in [(x_min, x_max), (y_min, y_max), (z_min, z_max)]:
        flat = cmax - cmin < tol
        cmin[flat] -= 0.5 * tol
        cmax[flat] += 0.5 * tol
    pairs_xy = _identify_overlapping_rectangles(x_min, x_max, y_min, y_max)
    pairs_z = _identify_overlapping_intervals(z_min, z_max)
    pairs = _intersect_pairs(pairs_xy, pairs_z)

    isect_pt = np.empty(num_polys, dtype=object)
    is_bound_isect = np.empty(num_polys, dtype=object)
    seg_vert = np.empty(num_polys, dtype=object)
    is_point_contact = np.empty(num_polys, dtype=object)
    for i in range(num_polys):
        isect_pt[i] = []
        is_bound_isect[i] = []
        seg_vert[i] = []
        is_point_contact[i] = []
    new_pt: list[np.ndarray] = []
    new_pt_ind = 0
    polygon_pairs: list[tuple[int, int]] = []

    normals = [
        map_geometry.compute_normal(p, tol=tol).reshape((-1, 1)) for p in polys
    ]
    centers = [p.mean(axis=1).reshape((-1, 1)) for p in polys]

    def classify(pt, poly_ind):
        """Vertex / segment / interior classification of a point known to
        lie in the closed polygon."""
        poly = polys[poly_ind]
        dist_vert = point_pointset(pt, poly)
        if dist_vert.min() < tol:
            return [int(np.argmin(dist_vert)), False]
        start = poly
        end = np.roll(poly, -1, axis=1)
        dist_seg, _ = points_segments(pt, start, end)
        if dist_seg.min() < tol:
            return [int(np.argmin(dist_seg[0])), True]
        return []

    def on_boundary(p0, p1, poly_ind):
        """True if the segment p0-p1 runs along the boundary of the
        polygon (midpoint within tol of the boundary)."""
        mid = 0.5 * (p0 + p1)
        poly = polys[poly_ind]
        dist_seg, _ = points_segments(
            mid.reshape((-1, 1)), poly, np.roll(poly, -1, axis=1)
        )
        return bool(dist_seg.min() < tol)

    def chord(poly_ind, normal, center):
        """Points where the boundary of polygon ``poly_ind`` meets the
        plane (normal, center): 0, 1 or 2 points for a convex polygon."""
        poly = polys[poly_ind]
        n = poly.shape[1]
        d = np.sum(normal.ravel()[:, None] * (poly - center.ravel()[:, None]), axis=0)
        sgn = np.where(np.abs(d) < tol, 0.0, np.sign(d))
        pts = []
        for k in range(n):
            if sgn[k] == 0:
                pts.append(poly[:, k])
            k2 = (k + 1) % n
            if sgn[k] * sgn[k2] < 0:
                t = d[k] / (d[k] - d[k2])
                pts.append(poly[:, k] + t * (poly[:, k2] - poly[:, k]))
        if not pts:
            return np.zeros((3, 0)), sgn
        arr = np.array(pts).T
        uniq, _, _ = uniquify_point_set(arr, tol)
        return uniq, sgn

    def register_point_contact(pt, main, o):
        new_pt.append(pt.reshape((-1, 1)))
        nonlocal new_pt_ind
        isect_pt[main].append(new_pt_ind + np.arange(1))
        isect_pt[o].append(new_pt_ind + np.arange(1))
        new_pt_ind += 1
        polygon_pairs.append((main, o))
        for ind in (main, o):
            cls = classify(pt.reshape((-1, 1)), ind)
            seg_vert[ind].append(cls if cls else [])
            is_bound_isect[ind].append(bool(cls))
            is_point_contact[ind].append(True)

    start_inds = np.intersect1d(target_poly, pairs)
    for main in start_inds:
        others = pairs[1, pairs[0] == main]
        for o in others:
            n_m, c_m = normals[main], centers[main]
            n_o, c_o = normals[o], centers[o]
            cross_n = np.cross(n_m.ravel(), n_o.ravel())
            if np.linalg.norm(cross_n) < tol:
                # Parallel planes: either disjoint or coplanar.
                if np.abs(np.sum(n_m.ravel() * (c_o - c_m).ravel())) > tol:
                    continue
                # Coplanar: intersect the boundary segments pairwise.
                pm, po = polys[main], polys[o]
                isect = np.zeros((3, 0))
                bound_main = bound_other = False
                for sm in range(pm.shape[1]):
                    seg_hits = np.zeros((3, 0))
                    for so in range(po.shape[1]):
                        loc = segments_3d(
                            pm[:, sm],
                            pm[:, (sm + 1) % pm.shape[1]],
                            po[:, so],
                            po[:, (so + 1) % po.shape[1]],
                        )
                        if loc is not None:
                            isect = np.hstack((isect, loc))
                            seg_hits = np.hstack((seg_hits, loc))
                    uniq, _, _ = uniquify_point_set(seg_hits, tol)
                    if uniq.shape[1] > 1:
                        bound_main = True
                for so in range(po.shape[1]):
                    seg_hits = np.zeros((3, 0))
                    for sm in range(pm.shape[1]):
                        loc = segments_3d(
                            po[:, so],
                            po[:, (so + 1) % po.shape[1]],
                            pm[:, sm],
                            pm[:, (sm + 1) % pm.shape[1]],
                        )
                        if loc is not None:
                            seg_hits = np.hstack((seg_hits, loc))
                    uniq, _, _ = uniquify_point_set(seg_hits, tol)
                    if uniq.shape[1] > 1:
                        bound_other = True
                isect, _, _ = uniquify_point_set(isect, tol)
                if isect.shape[1] == 0:
                    continue
                if isect.shape[1] == 1:
                    if include_point_contact:
                        register_point_contact(isect[:, 0], main, o)
                    continue
                if isect.shape[1] > 2:
                    raise ValueError("There should be at most two intersections")
                p0, p1 = isect[:, 0], isect[:, 1]
                new_pt.append(isect)
                isect_pt[main].append(new_pt_ind + np.arange(2))
                isect_pt[o].append(new_pt_ind + np.arange(2))
                new_pt_ind += 2
                polygon_pairs.append((main, o))
                is_bound_isect[main].append(bound_main)
                is_bound_isect[o].append(bound_other)
                for ind in (main, o):
                    seg_vert[ind].append(classify(p0.reshape((-1, 1)), ind))
                    seg_vert[ind].append(classify(p1.reshape((-1, 1)), ind))
                    is_point_contact[ind] += [False, False]
                continue

            # Generic case: overlap the two chords along the common line.
            chord_o, sgn_o = chord(o, n_m, c_m)
            if chord_o.shape[1] == 0 or np.all(sgn_o > 0) or np.all(sgn_o < 0):
                continue
            chord_m, sgn_m = chord(main, n_o, c_o)
            if chord_m.shape[1] == 0:
                continue
            direction = cross_n / np.linalg.norm(cross_n)
            t_m = direction @ chord_m
            t_o = direction @ chord_o
            lo = max(t_m.min(), t_o.min())
            hi = min(t_m.max(), t_o.max())
            if hi < lo - tol:
                continue
            # Reconstruct the points from parameters (use whichever chord
            # attains the bound, to keep exact coordinates).
            def pt_at(tval):
                for tt, ch in ((t_m, chord_m), (t_o, chord_o)):
                    k = np.argmin(np.abs(tt - tval))
                    if np.abs(tt[k] - tval) < tol:
                        return ch[:, k]
                # Interior of both chords cannot attain an interval bound.
                raise RuntimeError("unreachable")

            if hi - lo < tol:
                # A degenerate (single-point) chord overlap counts as an
                # intersection only when one polygon touches the other's
                # PLANE at a single vertex (reference semantics: end-to-end
                # chord contact and vertex-vertex meetings are excluded).
                single_o = chord_o.shape[1] == 1 and not np.any(
                    sgn_o * np.roll(sgn_o, -1) < 0
                )
                single_m = chord_m.shape[1] == 1 and not np.any(
                    sgn_m * np.roll(sgn_m, -1) < 0
                )
                if include_point_contact and (single_o or single_m):
                    register_point_contact(pt_at(lo), main, o)
                continue
            p0, p1 = pt_at(lo), pt_at(hi)
            new_pt.append(np.vstack((p0, p1)).T)
            isect_pt[main].append(new_pt_ind + np.arange(2))
            isect_pt[o].append(new_pt_ind + np.arange(2))
            new_pt_ind += 2
            polygon_pairs.append((main, o))
            is_bound_isect[main].append(on_boundary(p0, p1, main))
            is_bound_isect[o].append(on_boundary(p0, p1, o))
            for ind in (main, o):
                seg_vert[ind].append(classify(p0.reshape((-1, 1)), ind))
                seg_vert[ind].append(classify(p1.reshape((-1, 1)), ind))
                is_point_contact[ind] += [False, False]

    if new_pt:
        new_points = np.hstack(new_pt)
        for i in range(num_polys):
            isect_pt[i] = (
                np.hstack(isect_pt[i]) if isect_pt[i] else np.empty(0)
            )
    else:
        new_points = np.empty((3, 0))
        for i in range(num_polys):
            isect_pt[i] = np.empty(0)
    return (
        new_points,
        isect_pt,
        is_bound_isect,
        polygon_pairs,
        seg_vert,
        is_point_contact,
    )


# -- convex polygon clipping (replaces the reference's shapely dependency) ---


def _clip_convex(subject: np.ndarray, clip: np.ndarray, tol: float = 1e-12):
    """Sutherland-Hodgman clip of (2, n) ``subject`` by convex ccw ``clip``.
    Returns the (2, m) clipped polygon (possibly empty)."""
    from porepy_tpu_torch.geometry.geometry_property_checks import is_ccw_polygon

    if not is_ccw_polygon(subject):
        subject = subject[:, ::-1]
    if not is_ccw_polygon(clip):
        clip = clip[:, ::-1]
    out = [subject[:, i] for i in range(subject.shape[1])]
    nc = clip.shape[1]
    for k in range(nc):
        if not out:
            break
        a = clip[:, k]
        b = clip[:, (k + 1) % nc]
        edge = b - a
        inp = out
        out = []

        def side(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0])

        for i in range(len(inp)):
            cur = inp[i]
            prev = inp[i - 1]
            s_cur, s_prev = side(cur), side(prev)
            if s_cur >= -tol:
                if s_prev < -tol:
                    t = s_prev / (s_prev - s_cur)
                    out.append(prev + t * (cur - prev))
                out.append(cur)
            elif s_prev >= -tol:
                t = s_prev / (s_prev - s_cur)
                out.append(prev + t * (cur - prev))
    if not out:
        return np.zeros((2, 0))
    arr = np.array(out).T
    # Drop consecutive duplicates.
    keep = [0]
    for i in range(1, arr.shape[1]):
        if np.linalg.norm(arr[:, i] - arr[:, keep[-1]]) > 1e-10:
            keep.append(i)
    if (
        len(keep) > 1
        and np.linalg.norm(arr[:, keep[-1]] - arr[:, keep[0]]) <= 1e-10
    ):
        keep = keep[:-1]
    return arr[:, keep]


def _polygon_area_2d(poly: np.ndarray) -> float:
    if poly.shape[1] < 3:
        return 0.0
    x, y = poly
    return 0.5 * abs(
        np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    )


def triangulations(
    p_1: np.ndarray, p_2: np.ndarray, t_1: np.ndarray, t_2: np.ndarray
) -> list[tuple[int, int, float]]:
    """Overlap areas between two 2d triangulations: list of
    ``(tri_1, tri_2, common area)`` (convex clipping, no shapely)."""
    out: list[tuple[int, int, float]] = []
    tri1 = [p_1[:2, t_1[:, i]] for i in range(t_1.shape[1])]
    tri2 = [p_2[:2, t_2[:, j]] for j in range(t_2.shape[1])]
    b1 = [(t.min(axis=1), t.max(axis=1)) for t in tri1]
    b2 = [(t.min(axis=1), t.max(axis=1)) for t in tri2]
    for i, a in enumerate(tri1):
        for j, b in enumerate(tri2):
            if np.any(b2[j][0] > b1[i][1]) or np.any(b2[j][1] < b1[i][0]):
                continue
            area = _polygon_area_2d(_clip_convex(a, b))
            if area > 0:
                out.append((i, j, area))
    return out


def line_tessellation(
    p1: np.ndarray, p2: np.ndarray, l1: np.ndarray, l2: np.ndarray
) -> list[tuple[int, int, float]]:
    """Overlap lengths between two 1d tessellations embedded in 3d."""
    out: list[tuple[int, int, float]] = []
    for i in range(l1.shape[1]):
        for j in range(l2.shape[1]):
            X = segments_3d(
                p1[:, l1[0, i]], p1[:, l1[1, i]], p2[:, l2[0, j]], p2[:, l2[1, j]]
            )
            if X is None:
                continue
            if X.shape[1] == 1:
                out.append((i, j, 0.0))
            elif X.shape[1] == 2:
                out.append((i, j, float(np.linalg.norm(X[:, 0] - X[:, 1]))))
            else:
                raise AssertionError()
    return out


def surface_tessellations(
    poly_sets: list, return_simplexes: bool = False
):
    """Mutual intersection of several 2d polygon tessellations: the
    subdivision polygons and, per input set, the mapping from its polygons
    to the subdivision (reference ``intersections.py:1849``; convex
    clipping instead of shapely)."""
    import scipy.sparse as sps

    current = [np.asarray(poly[:2], dtype=float) for poly in poly_sets[0]]
    nc = len(current)
    mappings = [
        sps.dia_matrix((np.ones(nc, dtype=int), 0), shape=(nc, nc)).tocsr()
    ]
    for s in range(1, len(poly_sets)):
        new_set = [np.asarray(poly[:2], dtype=float) for poly in poly_sets[s]]
        isect_polys = []
        rows_cur, cols_cur = [], []
        rows_new, cols_new = [], []
        counter = 0
        for j, pj in enumerate(current):
            bj = (pj.min(axis=1), pj.max(axis=1))
            for k, pk in enumerate(new_set):
                if np.any(pk.min(axis=1) > bj[1]) or np.any(
                    pk.max(axis=1) < bj[0]
                ):
                    continue
                clipped = _clip_convex(pj, pk)
                if _polygon_area_2d(clipped) <= 0:
                    continue
                isect_polys.append(clipped)
                rows_cur.append(counter)
                cols_cur.append(j)
                rows_new.append(counter)
                cols_new.append(k)
                counter += 1
        map_cur = sps.coo_matrix(
            (np.ones(counter, dtype=int), (rows_cur, cols_cur)),
            shape=(counter, len(current)),
        ).tocsr()
        map_new = sps.coo_matrix(
            (np.ones(counter, dtype=int), (rows_new, cols_new)),
            shape=(counter, len(new_set)),
        ).tocsr()
        mappings = [map_cur @ m for m in mappings] + [map_new]
        current = isect_polys

    if return_simplexes:
        import scipy.sparse as sps

        tri_polys = []
        rows, cols = [], []
        counter = 0
        for j, poly in enumerate(current):
            center = np.mean(poly, axis=1).reshape((-1, 1))
            n = poly.shape[1]
            for k in range(n):
                tri = np.vstack(
                    (
                        center.T,
                        poly[:, k].reshape(1, -1),
                        poly[:, (k + 1) % n].reshape(1, -1),
                    )
                ).T
                tri_polys.append(tri)
                rows.append(counter)
                cols.append(j)
                counter += 1
        tri_map = sps.coo_matrix(
            (np.ones(counter, dtype=int), (rows, cols)),
            shape=(counter, len(current)),
        ).tocsr()
        mappings = [tri_map @ m for m in mappings]
        current = tri_polys
    return current, mappings


# -- bounding-box sweep filters ---------------------------------------------


def _axis_aligned_bounding_box_2d(p, e):
    x0, x1 = p[0][e[0]], p[0][e[1]]
    y0, y1 = p[1][e[0]], p[1][e[1]]
    return (
        np.minimum(x0, x1),
        np.maximum(x0, x1),
        np.minimum(y0, y1),
        np.maximum(y0, y1),
    )


def _axis_aligned_bounding_box_3d(polys):
    mins = np.array([[poly[d].min() for poly in polys] for d in range(3)])
    maxs = np.array([[poly[d].max() for poly in polys] for d in range(3)])
    return mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]


def _identify_overlapping_intervals(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Pairs (2, n) of indices of overlapping 1d intervals, lowest index
    first, columns sorted."""
    n = left.size
    if n < 2:
        return np.empty((2, 0), dtype=int)
    i, j = np.triu_indices(n, k=1)
    hit = (left[i] <= right[j]) & (left[j] <= right[i])
    pairs = np.vstack((i[hit], j[hit]))
    order = np.lexsort((pairs[1], pairs[0]))
    return pairs[:, order]


def _identify_overlapping_rectangles(x_min, x_max, y_min, y_max) -> np.ndarray:
    """Pairs of rectangles overlapping in both coordinate directions."""
    n = x_min.size
    if n < 2:
        return np.empty((2, 0), dtype=int)
    i, j = np.triu_indices(n, k=1)
    hit = (
        (x_min[i] <= x_max[j])
        & (x_min[j] <= x_max[i])
        & (y_min[i] <= y_max[j])
        & (y_min[j] <= y_max[i])
    )
    pairs = np.vstack((i[hit], j[hit]))
    order = np.lexsort((pairs[1], pairs[0]))
    return pairs[:, order]


def _intersect_pairs(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Columns present in both pair arrays (2, n), sorted."""
    if p1.shape[1] == 0 or p2.shape[1] == 0:
        return np.empty((2, 0), dtype=int)
    set1 = {tuple(c) for c in p1.T}
    both = np.array([c for c in p2.T if tuple(c) in set1]).T
    if both.size == 0:
        return np.empty((2, 0), dtype=int)
    order = np.lexsort((both[1], both[0]))
    return both[:, order]
