"""Point/edge sorting utilities (reference ``geometry/sort_points.py``).

The numba-jitted circular sort of the reference is plain numpy here —
meshing is host-side preprocessing, not a TPU workload.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "sort_point_pairs",
    "sort_multiple_point_pairs",
    "sort_point_plane",
    "sort_points_on_line",
    "sort_triangle_edges",
]


def sort_point_pairs(
    lines: np.ndarray,
    check_circular: bool = True,
    is_circular: Optional[bool] = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Chain segments (columns of ``lines``, first two rows are endpoints)
    into a continuous polyline. Returns the sorted lines (rows possibly
    flipped) and the column permutation."""
    num_lines = lines.shape[1]
    sorted_lines = -np.ones(lines.shape, dtype=lines.dtype)
    found = np.zeros(num_lines, dtype=bool)
    sort_ind = np.zeros(num_lines, dtype=int)

    if not is_circular:
        # Start from a point that occurs only once (an endpoint of the
        # polyline).
        count = np.bincount(lines[:2].ravel())
        singles = np.where(count == 1)[0]
        start_col = np.where(
            np.isin(lines[0], singles) | np.isin(lines[1], singles)
        )[0][0]
        sorted_lines[:, 0] = lines[:, start_col]
        if np.count_nonzero(lines[:2] == sorted_lines[0, 0]) > 1:
            sorted_lines[:2, 0] = sorted_lines[1::-1, 0]
        found[start_col] = True
        sort_ind[0] = start_col
        check_circular = False
    else:
        sorted_lines[:, 0] = lines[:, 0]
        found[0] = True

    prev = sorted_lines[1, 0]
    for i in range(1, num_lines):
        hit0 = np.where(~found & (lines[0] == prev))[0]
        hit1 = np.where(~found & (lines[1] == prev))[0]
        if hit0.size:
            col = hit0[0]
            sorted_lines[:, i] = lines[:, col]
        elif hit1.size:
            col = hit1[0]
            sorted_lines[:, i] = lines[:, col]
            sorted_lines[:2, i] = lines[1::-1, col]
        else:
            raise ValueError("Point pairs do not form a connected polyline")
        found[col] = True
        sort_ind[i] = col
        prev = sorted_lines[1, i]
    if check_circular:
        if sorted_lines[1, -1] != sorted_lines[0, 0]:
            raise ValueError("Point pairs do not form a closed polyline")
    return sorted_lines, sort_ind


def sort_multiple_point_pairs(lines: np.ndarray) -> np.ndarray:
    """Sort many polylines at once: ``lines`` has a leading row of polyline
    (cell) indices followed by the two endpoint rows. Each block is sorted
    independently (reference ``sort_points.py:102``)."""
    lines = np.asarray(lines)
    out = lines.copy()
    for cell in np.unique(lines[0]):
        cols = np.where(lines[0] == cell)[0]
        sorted_block, _ = sort_point_pairs(lines[1:, cols])
        out[1:, cols] = sorted_block
    return out


def sort_point_plane(
    pts: np.ndarray,
    centre: np.ndarray,
    normal: Optional[np.ndarray] = None,
    tol: float = 1e-5,
) -> np.ndarray:
    """Angular (star-shaped) sort of points around ``centre`` in their
    common plane."""
    from porepy_tpu_torch.geometry import map_geometry

    centre = np.asarray(centre).reshape((-1, 1))
    R = map_geometry.project_plane_matrix(pts, normal)
    delta = R @ (pts - centre)
    spread = np.sum(np.abs(delta), axis=1)
    spread = spread / np.sum(spread)
    active = ~np.isclose(spread, 0, atol=tol, rtol=0)
    return np.argsort(np.arctan2(*delta[active]))


def sort_points_on_line(pts: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Order collinear points along their common line."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        points_are_collinear,
    )

    if pts.shape[1] == 1:
        return np.array([0])
    if not points_are_collinear(pts, tol):
        raise ValueError("Points are not collinear")
    rot = map_geometry.project_line_matrix(pts)
    p = rot @ pts
    p = p - np.mean(p, axis=1).reshape((-1, 1))
    spread = np.sum(np.abs(p), axis=1)
    active = np.argmax(spread)
    return np.argsort(p[active])


def sort_triangle_edges(t: np.ndarray) -> np.ndarray:
    """Reorder the nodes of each triangle (columns of ``t``, shape (3, nt))
    so that neighboring triangles traverse their shared edge in opposite
    directions — a consistent orientation of the triangulated surface,
    found by breadth-first propagation from the first triangle."""
    t = np.asarray(t).copy()
    nt = t.shape[1]
    ordered = np.zeros(nt, dtype=bool)
    ordered[0] = True
    # Directed edges of already-ordered triangles, as traversed.
    queue = [(t[0, 0], t[1, 0]), (t[1, 0], t[2, 0]), (t[2, 0], t[0, 0])]
    guard = 0
    while queue and guard < 3 * nt + 3:
        guard += 1
        a, b = queue.pop(0)
        # Unordered triangles containing both endpoints of this edge.
        cand = np.where(
            ~ordered & np.any(t == a, axis=0) & np.any(t == b, axis=0)
        )[0]
        for ci in cand:
            nodes = t[:, ci]
            third = nodes[(nodes != a) & (nodes != b)][0]
            # The neighbor must traverse the shared edge in reverse: (b, a).
            t[:, ci] = [b, a, third]
            ordered[ci] = True
            for pair in ((b, a), (a, third), (third, b)):
                rev = (pair[1], pair[0])
                if pair in queue:
                    queue.remove(pair)
                elif rev in queue:
                    queue.remove(rev)
                else:
                    queue.append(pair)
    if not np.all(ordered):
        raise ValueError("Triangulation is not edge-connected")
    return t
