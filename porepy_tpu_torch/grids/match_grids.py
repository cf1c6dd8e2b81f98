"""Cell-overlap mappings between non-matching grids (reference
``grids/match_grids.py``): used when replacing grids in an md-grid (e.g.
non-matching mortars)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.geometry.intersections import line_tessellation, triangulations
from porepy_tpu_torch.utils.array_operations import expand_index_pointers

__all__ = ["match_1d", "match_2d", "match_grids_along_1d_mortar"]


def _scale_and_assemble(
    new_g, old_g, new_ind, old_ind, weights, tol, scaling
) -> sps.csr_matrix:
    new_ind = np.asarray(new_ind, dtype=int)
    old_ind = np.asarray(old_ind, dtype=int)
    weights = np.asarray(weights, dtype=float)
    if scaling == "averaged":
        weights = weights / new_g.cell_volumes[new_ind]
    elif scaling == "integrated":
        weights = weights / old_g.cell_volumes[old_ind]
    elif scaling is None:
        mask = weights > tol
        new_ind, old_ind = new_ind[mask], old_ind[mask]
        weights = np.ones_like(new_ind, dtype=float)
    else:
        raise ValueError(f"Unknown scaling {scaling!r}")
    return sps.coo_matrix(
        (weights, (new_ind, old_ind)),
        shape=(new_g.num_cells, old_g.num_cells),
    ).tocsr()


def match_1d(
    new_g, old_g, tol: float, scaling: Optional[str] = None
) -> sps.csr_matrix:
    """Overlap lengths between two aligned 1d grids as a mapping from old
    to new cells."""
    cn_new = new_g.cell_nodes()
    cn_old = old_g.cell_nodes()
    nodes_new = expand_index_pointers(cn_new.indptr[:-1], cn_new.indptr[1:])
    nodes_old = expand_index_pointers(cn_old.indptr[:-1], cn_old.indptr[1:])
    lines_new = cn_new.indices[nodes_new].reshape((2, -1), order="F")
    lines_old = cn_old.indices[nodes_old].reshape((2, -1), order="F")
    isect = line_tessellation(
        new_g.nodes, old_g.nodes, lines_new, lines_old
    )
    if not isect:
        return sps.csr_matrix((new_g.num_cells, old_g.num_cells))
    new_ind, old_ind, weights = map(np.asarray, zip(*isect))
    return _scale_and_assemble(
        new_g, old_g, new_ind, old_ind, weights, tol, scaling
    )


def match_2d(
    new_g, old_g, tol: float, scaling: Optional[str] = None
) -> sps.csr_matrix:
    """Overlap areas between two aligned 2d simplex grids as a mapping from
    old to new cells."""

    def proj_pts(p, center, normal):
        rot = map_geometry.project_plane_matrix(p - center, normal)
        return (rot @ (p - center))[:2]

    cn_new = new_g.cell_nodes().tocsc()
    cn_old = old_g.cell_nodes().tocsc()
    for cn, g in ((cn_new, new_g), (cn_old, old_g)):
        if not np.all(np.diff(cn.indptr) == g.dim + 1):
            raise ValueError(
                "Matching of 2d grids has only been implemented for simplex grids."
            )
    t_new = cn_new.indices.reshape((new_g.dim + 1, new_g.num_cells), order="F")
    t_old = cn_old.indices.reshape((old_g.dim + 1, old_g.num_cells), order="F")
    cc = np.mean(new_g.nodes, axis=1).reshape((3, 1))
    n = map_geometry.compute_normal(new_g.nodes - cc)
    n_old = map_geometry.compute_normal(old_g.nodes - cc)
    if not (np.allclose(n, n_old) or np.allclose(n, -n_old)):
        raise ValueError("The new and old grid must lie in the same plane")
    isect = triangulations(
        proj_pts(new_g.nodes, cc, n),
        proj_pts(old_g.nodes, cc, n),
        t_new,
        t_old,
    )
    if not isect:
        return sps.csr_matrix((new_g.num_cells, old_g.num_cells))
    new_ind, old_ind, weights = map(np.asarray, zip(*isect))
    return _scale_and_assemble(
        new_g, old_g, new_ind, old_ind, weights, tol, scaling
    )


def _boundary_cells_of_faces(g, faces: np.ndarray) -> np.ndarray:
    """The unique neighbor cell of each (boundary) face, aligned with
    ``faces``."""
    from porepy_tpu_torch.utils.array_operations import ismember_columns

    coo = g.cell_faces[faces].tocoo()
    if coo.row.size != faces.size:
        raise ValueError("Expected boundary faces (one neighbor cell each)")
    order = np.argsort(coo.row)
    return coo.col[order]


def _aux_1d_grid(nodes: np.ndarray, tol: float):
    """Collinear node cloud -> sorted 1d TensorGrid (+ the sort order)."""
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        points_are_collinear,
    )
    from porepy_tpu_torch.geometry.sort_points import sort_points_on_line
    from porepy_tpu_torch.grids.structured import TensorGrid
    from porepy_tpu_torch.utils.array_operations import uniquify_point_set

    if not points_are_collinear(nodes, tol=tol):
        raise ValueError("Nodes are not collinear")
    order = sort_points_on_line(nodes, tol=tol)
    uniq, *_ = uniquify_point_set(nodes[:, order], tol=tol)
    g = TensorGrid(np.arange(uniq.shape[1], dtype=float))
    g.nodes = uniq
    g.compute_geometry()
    return g, order


def _faces_to_aux_cells(g2, g1, faces: np.ndarray, sorted_nodes: np.ndarray):
    """Cell index in the auxiliary 1d grid for each 2d face on the segment
    (conforming: the two face nodes are a 1d cell's nodes)."""
    from porepy_tpu_torch.utils.array_operations import ismember_columns

    fn = g2.face_nodes.indices.reshape((2, g2.num_faces), order="F")[:, faces]
    if faces.size == 1:
        fn = fn.reshape((2, 1))
    local = np.zeros(g2.num_nodes, dtype=int)
    local[sorted_nodes] = np.arange(sorted_nodes.size)
    fn_local = local[fn]
    cn = g1.cell_nodes().indices.reshape((2, g1.num_cells), order="F")
    found, idx = ismember_columns(fn_local, cn)
    if not np.all(found):
        raise ValueError("Grids are not conforming along the segment")
    return idx


def match_grids_along_1d_mortar(
    mg, g_new, g_old, tol: float, scaling: str
) -> sps.csr_matrix:
    """Face-overlap weights between two 2d grids along a 1d mortar segment
    (reference ``grids/match_grids.py:234``): right-multiply
    ``mg._primary_to_mortar_int`` with the result to re-key the mortar
    projection from ``g_old``'s faces to ``g_new``'s.

    Both sides of the (split) segment are matched independently through
    auxiliary 1d grids and :func:`match_1d`.
    """
    from porepy_tpu_torch.geometry.distances import points_segments

    coo = mg._primary_to_mortar_int.tocoo()
    faces_old = np.unique(coo.col)
    nodes_old_mask = np.asarray(
        (g_old.face_nodes[:, faces_old]).sum(axis=1)
    ).ravel()
    nodes_old = np.flatnonzero(nodes_old_mask)
    seg_grid, _ = _aux_1d_grid(g_old.nodes[:, nodes_old], tol)
    start, end = seg_grid.nodes[:, 0], seg_grid.nodes[:, -1]
    midpoint = 0.5 * (start + end).reshape((3, 1))
    normal = g_old.face_normals[:, faces_old[0]].reshape((3, 1))

    def split_sides(g, faces):
        cells = _boundary_cells_of_faces(g, faces)
        side = np.sign(
            np.sum((g.cell_centers[:, cells] - midpoint) * normal, axis=0)
        )
        return [np.flatnonzero(side > 0), np.flatnonzero(side < 0)]

    sides_old = split_sides(g_old, faces_old)

    # Segment faces of the new grid: both face nodes on the line AND the
    # face tagged as a fracture face.
    dist, _ = points_segments(g_new.nodes, start, end)
    on_line = np.flatnonzero(dist.ravel() < tol)
    fn_new = g_new.face_nodes.indices.reshape(
        (2, g_new.num_faces), order="F"
    )
    all_on = np.all(np.isin(fn_new, on_line), axis=0)
    faces_new = np.intersect1d(
        np.flatnonzero(all_on),
        np.flatnonzero(g_new.tags["fracture_faces"].ravel()),
    )
    sides_new = split_sides(g_new, faces_new)

    out = sps.coo_matrix((g_old.num_faces, g_new.num_faces))
    for so, sn in zip(sides_old, sides_new):
        if so.size == 0 or sn.size == 0:
            continue
        f_old = faces_old[so]
        f_new = faces_new[sn]
        n_old = np.unique(
            g_old.face_nodes.indices.reshape(
                (2, g_old.num_faces), order="F"
            )[:, f_old]
        )
        n_new = np.unique(fn_new[:, f_new])
        aux_old, order_old = _aux_1d_grid(g_old.nodes[:, n_old], tol)
        aux_new, order_new = _aux_1d_grid(g_new.nodes[:, n_new], tol)

        cells_old = _faces_to_aux_cells(g_old, aux_old, f_old, n_old[order_old])
        cells_new = _faces_to_aux_cells(g_new, aux_new, f_new, n_new[order_new])

        between = match_1d(aux_old, aux_new, tol, scaling)

        f2c_old = sps.coo_matrix(
            (np.ones(f_old.size), (cells_old, np.arange(f_old.size))),
            shape=(aux_old.num_cells, f_old.size),
        )
        f2c_new = sps.coo_matrix(
            (np.ones(f_new.size), (cells_new, np.arange(f_new.size))),
            shape=(aux_new.num_cells, f_new.size),
        )
        restrict_old = sps.coo_matrix(
            (np.ones(f_old.size), (np.arange(f_old.size), f_old)),
            shape=(f_old.size, g_old.num_faces),
        )
        restrict_new = sps.coo_matrix(
            (np.ones(f_new.size), (np.arange(f_new.size), f_new)),
            shape=(f_new.size, g_new.num_faces),
        )
        out = out + (
            restrict_old.T @ (f2c_old.T @ between @ f2c_new) @ restrict_new
        )
    return out.tocsr()
