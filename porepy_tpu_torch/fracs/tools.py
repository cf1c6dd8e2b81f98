"""Helpers for fracture meshing (reference ``fracs/tools.py``):

- :func:`determine_mesh_size`: per-point target mesh sizes for a 2d
  fracture line set, graded by fracture lengths and proximity between
  non-adjacent fractures, with auxiliary points inserted on segments
  that pass close to a foreign point (so the mesher can honor the local
  size).
- :func:`obtain_interdim_mappings`: match lower-dimensional cells to the
  higher-dimensional faces they coincide with, via global point indices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry.distances import points_segments
from porepy_tpu_torch.utils.array_operations import ismember_columns

__all__ = ["determine_mesh_size", "obtain_interdim_mappings"]


def determine_mesh_size(
    pts: np.ndarray,
    pts_on_boundary: Optional[np.ndarray] = None,
    lines: Optional[np.ndarray] = None,
    **kwargs,
):
    """Per-point mesh sizes for a 2d fracture/boundary line description
    (reference ``fracs/tools.py:19``).

    The size at each point is the minimum of the user target
    (``mesh_size_frac``; ``mesh_size_bound`` on boundary points), the
    lengths of the segments meeting at the point, and the distance to
    non-incident segments — floored at ``mesh_size_min``. Where a foreign
    point lies closer to a segment than the local target, an auxiliary
    point (the projection) is appended so the grading is representable.

    Returns ``(sizes, pts_out, lines_out)``.
    """
    if lines is None:
        lines = np.zeros((2, 0), dtype=int)
    lines = np.asarray(lines)
    pts = np.asarray(pts, dtype=float)
    num_pts = pts.shape[1]
    val = kwargs.get("mesh_size_frac", 1.0)
    val_bound = kwargs.get("mesh_size_bound", None)
    val_min = kwargs.get("mesh_size_min", 1e-8 * val)
    tol = kwargs.get("tol", 1e-5)

    targets = np.full(num_pts, float(val))
    if val_bound is not None and pts_on_boundary is not None:
        targets[np.asarray(pts_on_boundary)] = val_bound

    sizes = targets.copy()
    if lines.shape[1] == 0:
        return np.maximum(sizes, val_min), pts, lines

    seg = lines[:2, :]
    seg_len = np.linalg.norm(pts[:, seg[0]] - pts[:, seg[1]], axis=0)
    # Adjacent segment lengths bound the local size.
    for k in range(seg.shape[1]):
        for p in seg[:, k]:
            sizes[p] = min(sizes[p], seg_len[k])

    # Distances from every point to every non-incident segment; insert the
    # projection as an auxiliary sizing point when it undercuts the local
    # target.
    starts = pts[:, seg[0]]
    ends = pts[:, seg[1]]
    extra_pts = []
    extra_sizes = []
    extra_lines = []
    lines_out = lines.copy()
    for p in range(num_pts):
        d, cp = points_segments(pts[:, p], starts, ends)
        d = np.atleast_2d(d)[0]
        incident = (seg[0] == p) | (seg[1] == p)
        d[incident] = np.inf
        close = np.flatnonzero(d < sizes[p])
        sizes[p] = min(sizes[p], d[~np.isinf(d)].min() if np.any(~incident) else sizes[p])
        for k in close:
            if d[k] < tol:
                continue
            proj = np.atleast_3d(cp)[0, :, k]
            extra_pts.append(proj[: pts.shape[0]])
            extra_sizes.append(max(d[k], val_min))

    sizes = np.maximum(sizes, val_min)
    if extra_pts:
        pts_out = np.column_stack([pts] + [np.asarray(q) for q in extra_pts])
        sizes = np.concatenate([sizes, np.asarray(extra_sizes)])
    else:
        pts_out = pts
    return sizes, pts_out, lines_out


def obtain_interdim_mappings(
    g, fn: sps.spmatrix, n_per_face: int
) -> tuple[np.ndarray, np.ndarray]:
    """Match cells of the lower-dimensional grid ``g`` to faces of a
    higher-dimensional grid with face-node map ``fn`` (columns of
    node-sorted global indices), reference ``fracs/tools.py:337``."""
    if g.dim > 0:
        cn_local = g.cell_nodes().indices.reshape(
            (n_per_face, g.num_cells), order="F"
        )
        cn = np.sort(g.global_point_ind[cn_local], axis=0)
    else:
        cn = np.array([g.global_point_ind])
        if cn.ndim == 1:
            fn = np.asarray(fn).ravel()
    is_mem, cell_2_face = ismember_columns(
        np.atleast_2d(cn).astype(np.int64), np.atleast_2d(fn).astype(np.int64)
    )
    low_dim_cell = np.flatnonzero(is_mem)
    return np.asarray(cell_2_face), low_dim_cell
