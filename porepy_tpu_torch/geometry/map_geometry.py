"""Geometry mapping helpers: tangents, normals, plane rotations.

Host-side (numpy) setup-time kernels; parity counterpart of reference
``geometry/map_geometry.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "compute_tangent",
    "compute_normal",
    "project_plane_matrix",
    "project_line_matrix",
    "project_points_to_line",
    "rotation_matrix_from_vectors",
]


def axis_angle_rotation(angle: float, vect: np.ndarray) -> np.ndarray:
    """Rodrigues rotation about ``vect`` by ``angle``; the identity when
    ``vect`` is (close to) zero — including the anti-parallel case, matching
    the reference (``map_geometry.py:328,347``). That quirk is load-bearing
    for node orderings of embedded grids."""
    if np.allclose(vect, np.zeros(3)):
        return np.identity(3)
    vect = vect / np.linalg.norm(vect)
    W = np.array(
        [
            [0.0, -vect[2], vect[1]],
            [vect[2], 0.0, -vect[0]],
            [-vect[1], vect[0], 0.0],
        ]
    )
    return np.identity(3) + np.sin(angle) * W + (1.0 - np.cos(angle)) * (W @ W)


def project_points_to_line(
    p: np.ndarray, tol: float = 1e-4
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Project collinear points to 1d coordinates along their line.

    Returns ``(sorted_coordinates, rotation_matrix, active_dimension_mask,
    sort_index)`` — behavior-parity with reference
    ``geometry/map_geometry.py:140-213`` including its rotation and
    active-dimension conventions.
    """
    p = np.asarray(p, dtype=float)
    center = p.mean(axis=1, keepdims=True)
    p = p - center
    if p.shape[0] == 2:
        p = np.vstack([p, np.zeros(p.shape[1])])

    # The rotation target is the z-axis (the reference's
    # ``project_line_matrix`` default) — this, with the furthest-point
    # tangent sign, fixes the node ordering of embedded 1d grids.
    tangent = compute_tangent(p)
    reference = np.array([0.0, 0.0, 1.0])
    angle = np.arccos(np.clip(tangent @ reference, -1.0, 1.0))
    vect = np.cross(tangent, reference)
    rot = axis_angle_rotation(angle, vect)

    p1 = rot @ p
    sum_coord = np.sum(np.abs(p1), axis=1)
    sum_coord /= np.max(sum_coord)
    active_dimension = ~np.isclose(sum_coord, 0, atol=tol, rtol=0)
    if active_dimension.sum() != 1:
        raise ValueError("Points are not aligned on a line")
    coord_1d = p1[active_dimension]
    sort_ind = np.argsort(coord_1d)[0]
    return coord_1d[0, sort_ind], rot, active_dimension, sort_ind


def compute_tangent(pts: np.ndarray, check: bool = True) -> np.ndarray:
    """Unit tangent of a collinear point cloud ``(3, n)``.

    Deterministic sign convention matching the reference
    (``geometry/map_geometry.py:573``): the difference vector from the mean
    to the furthest point (first on ties), normalized. The sign is
    load-bearing for 1d-grid node orderings.
    """
    pts = np.asarray(pts, dtype=float)
    if pts.shape[0] == 2:
        pts = np.vstack([pts, np.zeros(pts.shape[1])])
    mean = pts.mean(axis=1, keepdims=True)
    diff = pts - mean
    tangent = diff[:, np.argmax(np.sum(diff**2, axis=0))]
    nrm = np.linalg.norm(tangent)
    if check and nrm < 1e-12:
        raise ValueError("Cannot compute tangent of coincident points")
    return tangent / nrm


def map_grid(g, tol: float = 1e-5, R: np.ndarray | None = None):
    """Map a grid to its natural dimension: for 1d/2d grids, rotate to the
    line/plane and drop inactive coordinates (reference
    ``map_geometry.py:43``).

    Returns ``(cell_centers, face_normals, face_centers, R, dim_mask,
    nodes)`` with the first three reduced to ``g.dim`` rows.
    """
    cell_centers = g.cell_centers
    face_normals = g.face_normals
    face_centers = g.face_centers
    nodes = g.nodes

    if g.dim == 0 or g.dim == 3:
        if R is None:
            R = np.eye(3)
        return cell_centers, face_normals, face_centers, R, np.ones(3, bool), nodes

    if R is None:
        if g.dim == 2:
            R = project_plane_matrix(g.nodes)
        else:
            R = project_line_matrix(g.nodes)
    face_centers = R @ face_centers
    check = np.sum(np.abs(face_centers.T - face_centers[:, 0]), axis=0)
    check = check / np.sum(check)
    dim = ~np.isclose(check, 0, atol=tol, rtol=0)
    if g.dim != int(dim.sum()):
        raise ValueError("Grid does not lie in a lower-dimensional plane")
    face_centers = face_centers[dim, :]
    cell_centers = (R @ cell_centers)[dim, :]
    face_normals = (R @ face_normals)[dim, :]
    nodes = (R @ nodes)[dim, :]
    return cell_centers, face_normals, face_centers, R, dim, nodes


def compute_normal(pts: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Unit normal of a (nearly) planar point cloud ``(3, n)``.

    Computed as the smallest principal direction of the centered cloud.
    """
    pts = np.asarray(pts, dtype=float)
    if pts.shape[1] < 3:
        raise ValueError("Need at least 3 points to compute a normal")
    v = pts - pts.mean(axis=1, keepdims=True)
    # Cross the longest center-to-point vector with the one giving the
    # longest cross product — numerically stable and sign-matching the
    # reference convention (``map_geometry.py:440``), on which downstream
    # angular sorts depend.
    nrm = np.linalg.norm(v, axis=0)
    i1 = int(np.argmax(nrm))
    v1 = v[:, i1]
    cross = np.cross(v1, v.T).T
    i2 = int(np.argmax(np.linalg.norm(cross, axis=0)))
    normal = cross[:, i2]
    if np.allclose(normal, 0.0, atol=tol * nrm[i1] * nrm[i2]):
        raise RuntimeError(
            "Unable to calculate normal from point set. Are all points collinear?"
        )
    return normal / np.linalg.norm(normal)


def rotation_matrix_from_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix R with R @ a || b for unit vectors a, b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        # 180-degree rotation about any axis orthogonal to a.
        axis = np.eye(3)[np.argmin(np.abs(a))]
        v = np.cross(a, axis)
        v /= np.linalg.norm(v)
        return 2.0 * np.outer(v, v) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def project_plane_matrix(
    pts: np.ndarray,
    normal: np.ndarray | None = None,
    reference: np.ndarray | None = None,
) -> np.ndarray:
    """Rotation matrix mapping the plane of ``pts`` onto the xy-plane."""
    if normal is None:
        normal = compute_normal(pts)
    else:
        normal = np.asarray(normal, dtype=float)
        normal = normal / np.linalg.norm(normal)
    if reference is None:
        reference = np.array([0.0, 0.0, 1.0])
    return rotation_matrix_from_vectors(normal, reference)


def project_line_matrix(pts: np.ndarray) -> np.ndarray:
    """Rotation matrix mapping the line of ``pts`` onto the x-axis."""
    tangent = compute_tangent(pts)
    return rotation_matrix_from_vectors(tangent, np.array([1.0, 0.0, 0.0]))
