"""Distance kernels: points, segments and polygons.

Parity counterpart of reference ``geometry/distances.py``. All host-side
numpy — these feed meshing and intersection preprocessing, not the TPU
compute path. Closest-point-between-segments follows the classic clamped
parametric formulation (geomalgorithms.com dist3D_Segment_to_Segment).
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = [
    "segment_set",
    "segment_segment_set",
    "points_segments",
    "point_pointset",
    "pointset",
    "points_polygon",
    "segments_polygon",
    "segment_overlap_segment_set",
]


def point_pointset(
    p: np.ndarray, pset: np.ndarray, exponent: Union[float, int] = 2
) -> np.ndarray:
    """p-norm distances from one point to each column of ``pset``."""
    pt = p.reshape((-1, 1)) if p.ndim == 1 else p
    if pset.size == 0:
        return np.zeros(0)
    pset = pset.reshape((pt.shape[0], -1)) if pset.ndim == 1 else pset
    return np.power(
        np.sum(np.power(np.abs(pt - pset), exponent), axis=0), 1.0 / exponent
    )


def pointset(p: np.ndarray, max_diag: bool = False) -> np.ndarray:
    """All-to-all distance matrix; optionally inflate the diagonal above
    every off-diagonal entry."""
    import scipy.spatial.distance as scidist

    if p.ndim == 1 or (p.ndim == 2 and p.shape[-1] == 1):
        return np.zeros((1, 1))
    d = scidist.cdist(p.T, p.T, "euclidean")
    if max_diag:
        d += 2 * np.diag(np.max(d, axis=1))
    return d


def points_segments(
    p: np.ndarray, start: np.ndarray, end: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Distances (num_p, num_seg) and closest points (num_p, num_seg, nd)
    between points and segments."""
    if start.size < 4:
        start = start.reshape((-1, 1))
        end = end.reshape((-1, 1))
    if p.size < 4:
        p = p.reshape((-1, 1))
    num_p = p.shape[1] if p.size else 0
    num_l = start.shape[1]
    nd = p.shape[0]
    d = np.zeros((num_p, num_l))
    cp = np.zeros((num_p, num_l, nd))
    line = end - start
    len2 = np.sum(line * line, axis=0)
    for pi in range(num_p):
        proj = np.sum((p[:, pi].reshape((-1, 1)) - start) * line, axis=0) / len2
        t = np.clip(proj, 0.0, 1.0)
        nearest = start + t * line
        d[pi] = point_pointset(p[:, pi], nearest)
        cp[pi] = nearest.T
    return d, cp


def segment_segment_set(
    start: np.ndarray, end: np.ndarray, start_set: np.ndarray, end_set: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distance from one segment to a set of segments, plus the closest
    points on the main segment and on each segment in the set."""
    start = start.reshape((-1, 1))
    end = end.reshape((-1, 1))
    if start_set.size < 4:
        start_set = start_set.reshape((-1, 1))
        end_set = end_set.reshape((-1, 1))

    d1 = end - start
    d2 = end_set - start_set
    w0 = start - start_set

    a = float(np.sum(d1 * d1))
    b = np.sum(d1 * d2, axis=0)
    c = np.sum(d2 * d2, axis=0)
    d = np.sum(d1 * w0, axis=0)
    e = np.sum(d2 * w0, axis=0)

    denom = a * c - b**2
    small = 1e-8 * min(a, float(np.min(c))) if c.size else 1e-8 * a

    # Parametric coordinates s (main segment) and t (set segments), each as
    # numerator/denominator pairs, clamped to [0, 1] region by region.
    sN = np.where(denom < small, 0.0, b * e - c * d)
    sD = np.where(denom < small, 1.0, denom)
    tN = np.where(denom < small, e, a * e - b * d)
    tD = np.where(denom < small, c, denom)

    # Clamp s to [0, 1].
    low = sN < 0
    sN = np.where(low, 0.0, sN)
    tN = np.where(low, e, tN)
    tD = np.where(low, c, tD)
    high = sN > sD
    sN = np.where(high, sD, sN)
    tN = np.where(high, e + b, tN)
    tD = np.where(high, c, tD)

    # Clamp t to [0, 1], re-clamping s where needed.
    t_low = tN < 0
    tN = np.where(t_low, 0.0, tN)
    s_new = np.clip(-d, 0.0, a)
    sN = np.where(t_low, s_new, sN)
    sD = np.where(t_low, a, sD)
    t_high = tN > tD
    tN = np.where(t_high, tD, tN)
    s_new = np.clip(-d + b, 0.0, a)
    sN = np.where(t_high, s_new, sN)
    sD = np.where(t_high, a, sD)

    sc = np.where(np.abs(sN) < small, 0.0, sN / sD)
    tc = np.where(np.abs(tN) < small, 0.0, tN / tD)

    cp_main = start + sc * d1
    cp_set = start_set + tc * d2
    dist = np.sqrt(np.sum((cp_main - cp_set) ** 2, axis=0))
    return dist, cp_main, cp_set


def segment_set(start: np.ndarray, end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All-to-all distances and closest points between a set of segments."""
    if start.size < 4:
        start = start.reshape((-1, 1))
    if end.size < 4:
        end = end.reshape((-1, 1))
    nd, ns = start.shape
    d = np.zeros((ns, ns))
    cp = np.zeros((ns, ns, nd))
    for i in range(ns):
        cp[i, i, :] = 0.5 * (start[:, i] + end[:, i])
        if i + 1 < ns:
            dl, cpi, cpj = segment_segment_set(
                start[:, i], end[:, i], start[:, i + 1 :], end[:, i + 1 :]
            )
            d[i, i + 1 :] = dl
            d[i + 1 :, i] = dl
            cp[i, i + 1 :] = cpi.T
            cp[i + 1 :, i] = cpj.T
    return d, cp


def points_polygon(
    p: np.ndarray, poly: np.ndarray, tol: float = 1e-5
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distance from points to a (planar) polygon, the closest polygon
    points, and whether the projection hits the interior."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import point_in_polygon

    if p.size < 4:
        p = p.reshape((-1, 1))
    num_p = p.shape[1]
    nd = p.shape[0]
    center = np.mean(poly, axis=1).reshape((-1, 1))
    R = map_geometry.project_plane_matrix(poly - center)
    poly_rot = R @ (poly - center)
    p_rot = R @ (p - center)
    in_poly = point_in_polygon(poly_rot[:2], p_rot[:2])

    d = np.zeros(num_p)
    cp = np.zeros((nd, num_p))
    d[in_poly] = np.abs(p_rot[2, in_poly])
    proj = p_rot[:, in_poly].reshape((nd, -1)).copy()
    proj[2] = 0
    cp[:, in_poly] = center + R.T @ proj
    if np.all(in_poly):
        return d, cp, in_poly

    num_vert = poly.shape[1]
    start = poly
    end = poly[:, (1 + np.arange(num_vert)) % num_vert]
    outside = np.where(~in_poly)[0]
    d_out, cp_out = points_segments(p[:, outside], start, end)
    for i, pi in enumerate(outside):
        mi = np.argmin(d_out[i])
        d[pi] = d_out[i, mi]
        cp[:, pi] = cp_out[i, mi]
    return d, cp, in_poly


def segments_polygon(
    start: np.ndarray, end: np.ndarray, poly: np.ndarray, tol: float = 1e-5
) -> tuple[np.ndarray, np.ndarray]:
    """Distance from segments to a planar polygon, with closest points."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import point_in_polygon

    if start.size < 4:
        start = start.reshape((-1, 1))
    if end.size < 4:
        end = end.reshape((-1, 1))
    num_s = start.shape[1]
    nd = start.shape[0]
    d = np.zeros(num_s)
    cp = np.zeros((nd, num_s))

    center = np.mean(poly, axis=1).reshape((-1, 1))
    R = map_geometry.project_plane_matrix(poly - center)
    poly_rot = R @ (poly - center)
    s_rot = R @ (start - center)
    e_rot = R @ (end - center)

    dz = e_rot[2] - s_rot[2]
    inclined = np.abs(dz) > tol
    t = np.where(inclined, -s_rot[2] / np.where(inclined, dz, 1.0), 0.0)
    hits_plane = inclined & (t >= 0) & (t <= 1)
    x0 = s_rot + (e_rot - s_rot) * t
    crosses = hits_plane & point_in_polygon(poly_rot[:2], x0[:2])
    in_plane = (np.abs(s_rot[2]) < tol) & ~inclined
    endpoint_inside = point_in_polygon(
        poly_rot[:2], s_rot[:2]
    ) | point_in_polygon(poly_rot[:2], e_rot[:2])
    intersects = crosses | (in_plane & endpoint_inside)
    x0[2, intersects] = 0
    cp[:, intersects] = center + R.T @ x0[:, intersects]
    if np.all(intersects):
        return d, cp

    d_s, cp_s, _ = points_polygon(start, poly)
    d_e, cp_e, _ = points_polygon(end, poly)
    poly_end = np.roll(poly, -1, axis=1)
    for si in np.where(~intersects)[0]:
        best_d, best_cp = d_s[si], cp_s[:, si]
        if d_e[si] < best_d:
            best_d, best_cp = d_e[si], cp_e[:, si]
        ds, cps, _ = segment_segment_set(
            start[:, si], end[:, si], poly, poly_end
        )
        mi = np.argmin(ds)
        if ds[mi] < best_d:
            best_d, best_cp = ds[mi], cps[:, mi]
        d[si] = best_d
        cp[:, si] = best_cp
    return d, cp


def segment_overlap_segment_set(
    start: np.ndarray,
    end: np.ndarray,
    start_set: np.ndarray,
    end_set: np.ndarray,
    return_indices: bool = False,
    tol: float = 1e-5,
):
    """Collinear-overlap detection between a 2d segment and a segment set:
    both cross products (direction x direction and offset x direction)
    vanish for overlapping segments."""
    start_set = np.atleast_2d(start_set)[:2].reshape((2, -1))
    end_set = np.atleast_2d(end_set)[:2].reshape((2, -1))
    start = np.asarray(start).reshape(-1)[:2]
    end = np.asarray(end).reshape(-1)[:2]
    norm = np.linalg.norm(start - end)
    dir_main = end - start
    dir_set = end_set - start_set
    cross_dir = (dir_set[0] * dir_main[1] - dir_set[1] * dir_main[0]) / norm
    off = start.reshape((-1, 1)) - start_set
    cross_off = (off[0] * dir_set[1] - off[1] * dir_set[0]) / norm
    overlap = (np.abs(cross_dir) < tol) & (np.abs(cross_off) < tol)
    if return_indices:
        return bool(np.any(overlap)), np.where(overlap)[0]
    return bool(np.any(overlap))
