"""Fracture list <-> points/edges conversions and small preprocessing
helpers (reference ``fracs/utils.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["linefractures_to_pts_edges", "pts_edges_to_linefractures"]


def linefractures_to_pts_edges(
    fractures: list, tol: float = 1e-8
) -> tuple[np.ndarray, np.ndarray]:
    """Unique endpoints of a list of LineFractures, plus index/tag edges."""
    pts_list: list[np.ndarray] = []
    edges_list: list[np.ndarray] = []
    for frac in fractures:
        pt_indices: list[int] = []
        for point in frac.points():
            matches = [
                np.allclose(point.squeeze(), x, atol=tol) for x in pts_list
            ]
            if not any(matches):
                pts_list.append(point.squeeze())
                pt_indices.append(len(pts_list) - 1)
            else:
                pt_indices.append(matches.index(True))
        edges_list.append(np.concatenate([np.array(pt_indices), frac.tags]))
    pts = np.stack(pts_list, axis=-1) if pts_list else np.zeros((2, 0))
    max_rows = max((e.shape[0] for e in edges_list), default=2)
    edges = np.full((max_rows, len(edges_list)), -1, dtype=np.int32)
    for i, e in enumerate(edges_list):
        edges[: e.shape[0], i] = e
    return pts, edges


def pts_edges_to_linefractures(pts: np.ndarray, edges: np.ndarray) -> list:
    """Inverse of :func:`linefractures_to_pts_edges`."""
    from porepy_tpu_torch.fracs.fracture import LineFracture

    fractures = []
    for e in edges.T:
        tags = e[2:]
        tags = tags[tags != -1] if tags.size else tags
        fractures.append(
            LineFracture(pts[:, e[:2].astype(int)], tags=e[2:] if e.size > 2 else None)
        )
    return fractures
