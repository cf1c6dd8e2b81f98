"""Extrusion of grids and mixed-dimensional grids in the z-direction.

Parity counterpart of reference ``grids/grid_extrusion.py``: a 2d mdg
(with fractures and interfaces) becomes a fully functional 3d prismatic
mdg, with cell/face maps between old and new grids.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.mortar_grid import MortarGrid, MortarSides
from porepy_tpu_torch.grids.structured import TensorGrid

__all__ = ["extrude_mdg", "extrude_grid"]


def extrude_mdg(mdg: MixedDimensionalGrid, z: np.ndarray):
    """Extrude every subdomain and rebuild the interfaces; returns the new
    mdg and a map {old grid: (new grid, cell_map, face_map)}."""
    mdg_new = MixedDimensionalGrid()
    Mapping = namedtuple("Mapping", ["grid", "cell_map", "face_map"])
    g_map: dict = {}
    for sd in mdg.subdomains():
        g_new, cell_map, face_map = extrude_grid(sd, z)
        if hasattr(sd, "frac_num"):
            g_new.frac_num = sd.frac_num
        mdg_new.add_subdomains([g_new])
        g_map[sd] = Mapping(g_new, cell_map, face_map)

    for intf, intf_data in mdg.interfaces(return_data=True):
        sd_primary, sd_secondary = mdg.interface_to_subdomain_pair(intf)
        primary_new = g_map[sd_primary].grid
        secondary_new = g_map[sd_secondary].grid
        face_cells_old = intf_data["face_cells"]
        coo = sps.coo_matrix(face_cells_old)
        cells, faces = coo.row, coo.col
        cell_map = g_map[sd_secondary].cell_map
        face_map = g_map[sd_primary].face_map
        # Vectorized expansion: each old (cell, face) pair maps to the full
        # stacks of extruded cells/faces (all maps have equal layer counts).
        rows = np.concatenate([cell_map[c] for c in cells]) if cells.size else (
            np.empty(0, dtype=int)
        )
        cols = np.concatenate([face_map[f] for f in faces]) if faces.size else (
            np.empty(0, dtype=int)
        )
        upper = faces > np.median(faces) if faces.size else np.zeros(0, bool)
        face_on_other_side = (
            np.concatenate([face_map[f] for f in faces[upper]])
            if upper.any()
            else np.empty(0, dtype=int)
        )
        face_cells_new = sps.coo_matrix(
            (np.ones(rows.size, dtype=bool), (rows, cols)),
            shape=(secondary_new.num_cells, primary_new.num_faces),
        ).tocsc()
        if face_on_other_side.size == 0:
            side_g = {MortarSides.LEFT_SIDE: secondary_new.copy()}
        else:
            side_g = {
                MortarSides.LEFT_SIDE: secondary_new.copy(),
                MortarSides.RIGHT_SIDE: secondary_new.copy(),
            }
        mg_new = MortarGrid(
            secondary_new.dim,
            side_g,
            face_cells_new,
            face_duplicate_ind=face_on_other_side,
        )
        mdg_new.add_interface(
            mg_new, (primary_new, secondary_new), face_cells_new
        )
    return mdg_new, g_map


def extrude_grid(g: Grid, z: np.ndarray):
    """Extrude a 0d/1d/2d grid in the z-direction (original z ignored)."""
    z = np.asarray(z, dtype=float)
    if np.any(z < 0) and np.any(z > 0):
        raise ValueError("Extrusion should be in either positive or negative direction")
    if g.dim == 0:
        return _extrude_0d(g, z)
    if g.dim == 1:
        return _extrude_1d(g, z)
    if g.dim == 2:
        return _extrude_2d(g, z)
    raise ValueError("The grid to be extruded should have dimension at most 2")


def _extrude_2d(g: Grid, z: np.ndarray):
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        is_ccw_polygon,
        is_ccw_polyline,
    )
    from porepy_tpu_torch.geometry.sort_points import sort_point_plane
    from porepy_tpu_torch.numerics.linalg.matrix_operations import rldecode

    g.compute_geometry()
    negative = np.all(z <= 0)
    num_node_layers = z.size
    num_cell_layers = num_node_layers - 1
    nc_2d, nf_2d, nn_2d = g.num_cells, g.num_faces, g.num_nodes
    nn_3d = nn_2d * num_node_layers
    nc_3d = nc_2d * num_cell_layers
    nf_3d = nf_2d * num_cell_layers + nc_2d * num_node_layers

    nodes = np.hstack(
        [
            np.vstack((g.nodes[0], g.nodes[1], zloc * np.ones(nn_2d)))
            for zloc in z
        ]
    )

    fn_2d = g.face_nodes.indices.reshape((2, nf_2d), order="F")
    # Vertical (quadrilateral) faces: consistent ccw orientation seen from
    # the side the normal points to.
    fn_layer = np.vstack(
        (fn_2d[0], fn_2d[1], fn_2d[1] + nn_2d, fn_2d[0] + nn_2d)
    )
    cf = sps.coo_matrix(g.cell_faces)
    order = np.argsort(cf.col, kind="stable")
    fi, ci, sgn = cf.row[order], cf.col[order], cf.data[order]
    _, idx = np.unique(fi, return_index=True)
    p0 = g.nodes[:, fn_2d[0, fi[idx]]]
    p1 = g.nodes[:, fn_2d[1, fi[idx]]]
    pc = g.cell_centers[:, ci[idx]]
    ccw = is_ccw_polyline(p0, p1, pc)
    flip = (sgn[idx] > 0) & ~ccw | (sgn[idx] < 0) & ccw
    if negative:
        flip = ~flip
    fn_layer[:, flip] = fn_layer[np.array([1, 0, 3, 2])][:, flip]
    fn_rows_vert = np.hstack(
        [fn_layer + nn_2d * k for k in range(num_cell_layers)]
    ).ravel("F")
    fn_cols_vert = np.arange(0, 4 * nf_2d * num_cell_layers, 4)

    # Horizontal (polygonal) faces: the 2d cells, sorted ccw.
    cn_2d = g.cell_nodes().tocsc()
    cn_ind = cn_2d.indices.copy()
    for c in range(nc_2d):
        start, stop = cn_2d.indptr[c], cn_2d.indptr[c + 1]
        ni = cn_ind[start:stop]
        coord = g.nodes[:2, ni]
        sort_ind = sort_point_plane(
            np.vstack((coord, np.zeros(coord.shape[1]))),
            g.cell_centers[:, c].reshape((-1, 1)),
        )
        if is_ccw_polygon(coord[:, sort_ind]):
            cn_ind[start:stop] = (
                ni[sort_ind[::-1]] if negative else ni[sort_ind]
            )
        elif is_ccw_polygon(coord[:, sort_ind[::-1]]):
            cn_ind[start:stop] = (
                ni[sort_ind] if negative else ni[sort_ind[::-1]]
            )
        else:
            raise ValueError("Non-convex cell encountered in extrusion")
    fn_rows_hor = np.hstack(
        [cn_ind + nn_2d * k for k in range(num_node_layers)]
    )
    fn_cols_hor = np.hstack(
        [np.array([0])]
        + [
            cn_2d.indptr[1:] + cn_ind.size * k
            for k in range(num_node_layers)
        ]
    )
    num_vert_faces = nf_2d * num_cell_layers
    fn_cols_hor = fn_cols_hor + num_vert_faces * 4
    indptr = np.hstack((fn_cols_vert, fn_cols_hor)).astype(int)
    indices = np.hstack((fn_rows_vert, fn_rows_hor)).astype(int)
    face_nodes = sps.csc_matrix(
        (np.ones(indices.size, dtype=int), indices, indptr),
        shape=(nn_3d, nf_3d),
    )

    # Cell-face map: vertical faces replicate the 2d cell_faces per layer;
    # horizontal faces glue consecutive layers.
    cf_csc = g.cell_faces.tocsc()
    cf_rows_vert = np.hstack(
        [cf_csc.indices + k * nf_2d for k in range(num_cell_layers)]
    )
    counts = np.tile(np.diff(cf_csc.indptr), num_cell_layers)
    cf_data_vert = np.tile(cf_csc.data, num_cell_layers)
    cf_cols_vert = rldecode(np.arange(nc_3d), counts)

    cf_rows_hor = num_vert_faces + np.arange(nc_2d)
    cf_cols_hor = np.arange(nc_2d)
    cf_data_hor = -np.ones(nc_2d, dtype=int)
    for k in range(1, num_cell_layers):
        cf_rows_hor = np.hstack(
            (
                cf_rows_hor,
                num_vert_faces + k * nc_2d + np.tile(np.arange(nc_2d), 2),
            )
        )
        cf_cols_hor = np.hstack(
            (
                cf_cols_hor,
                (k - 1) * nc_2d + np.arange(nc_2d),
                k * nc_2d + np.arange(nc_2d),
            )
        )
        cf_data_hor = np.hstack(
            (cf_data_hor, np.ones(nc_2d), -np.ones(nc_2d))
        )
    cf_rows_hor = np.hstack(
        (
            cf_rows_hor,
            num_vert_faces + num_cell_layers * nc_2d + np.arange(nc_2d),
        )
    )
    cf_cols_hor = np.hstack(
        (cf_cols_hor, (num_cell_layers - 1) * nc_2d + np.arange(nc_2d))
    )
    cf_data_hor = np.hstack((cf_data_hor, np.ones(nc_2d)))

    cell_faces = sps.coo_matrix(
        (
            np.hstack((cf_data_hor, cf_data_vert)),
            (
                np.hstack((cf_rows_hor, cf_rows_vert)),
                np.hstack((cf_cols_hor, cf_cols_vert)),
            ),
        ),
        shape=(nf_3d, nc_3d),
    ).tocsc()

    tags = _define_tags(g, num_cell_layers)
    g_new = Grid(
        3,
        nodes,
        face_nodes,
        cell_faces,
        name=f"{g.name} extruded 2d->3d",
        history=list(getattr(g, "history", [])) + ["Extrude 2d->3d"],
        external_tags=tags,
    )
    g_new.compute_geometry()
    cell_map, face_map = _create_mappings(g, g_new, num_cell_layers)
    return g_new, cell_map, face_map


def _extrude_1d(g, z: np.ndarray):
    num_cell_layers = z.size - 1
    x, y = g.nodes[0], g.nodes[1]
    x_2d, z_2d = np.meshgrid(x, z)
    y_2d, _ = np.meshgrid(y, z)
    nodes = np.vstack((x_2d.ravel(), y_2d.ravel(), z_2d.ravel()))
    nn_old, nc_old, nf_old = g.num_nodes, g.num_cells, g.num_faces
    nn_new = nn_old * (num_cell_layers + 1)
    nc_new = nc_old * num_cell_layers
    nf_new = nf_old * num_cell_layers + nc_old * (num_cell_layers + 1)

    fn_old = g.face_nodes.indices
    fn_vert = np.hstack(
        [
            k * nn_old + np.vstack((fn_old, nn_old + fn_old))
            for k in range(num_cell_layers)
        ]
    )
    cn_old = g.cell_nodes().indices.reshape((2, nc_old), order="F")
    fn_hor = np.hstack(
        [cn_old + k * nn_old for k in range(num_cell_layers + 1)]
    )
    fn_rows = np.hstack((fn_vert, fn_hor))
    fn_cols = np.tile(np.arange(fn_rows.shape[1]), (2, 1))
    fn = sps.coo_matrix(
        (
            np.ones(fn_cols.size, dtype=bool),
            (fn_rows.ravel("F"), fn_cols.ravel("F")),
        ),
        shape=(nn_new, nf_new),
    ).tocsc()

    cf_old = g.cell_faces.indices.reshape((2, -1), order="F")
    cf_rows = np.empty((4, 0), dtype=int)
    for k in range(num_cell_layers):
        cf_vert = nf_old * k + cf_old
        cf_hor = np.vstack(
            (np.arange(nc_old), np.arange(nc_old) + nc_old)
        ) + (nf_old * num_cell_layers + k * nc_old)
        cf_rows = np.hstack((cf_rows, np.vstack((cf_vert, cf_hor))))
    cf_rows = cf_rows.ravel("F")
    cf_cols = np.tile(np.arange(nc_new), (4, 1)).ravel("F")
    ones = np.ones(nc_new, dtype=int)
    cf_data = np.vstack((-ones, ones, -ones, ones)).ravel("F")
    cf = sps.coo_matrix(
        (cf_data, (cf_rows, cf_cols)), shape=(nf_new, nc_new)
    ).tocsc()

    tags = _define_tags(g, num_cell_layers)
    g_new = Grid(
        2,
        nodes,
        fn,
        cf,
        name=f"{g.name} extruded 1d->2d",
        history=list(getattr(g, "history", [])) + ["Extrude 1d->2d"],
        external_tags=tags,
    )
    g_new.compute_geometry()
    if hasattr(g, "frac_num"):
        g_new.frac_num = g.frac_num
    cell_map, face_map = _create_mappings(g, g_new, num_cell_layers)
    return g_new, cell_map, face_map


def _extrude_0d(g, z: np.ndarray):
    num_pt = z.size
    x = g.cell_centers[0, 0] * np.ones(num_pt)
    y = g.cell_centers[1, 0] * np.ones(num_pt)
    g_new = TensorGrid(x, name=f"{g.name} extruded 0d->1d")
    g_new.nodes = np.vstack((x, y, z))
    g_new.compute_geometry()
    cell_map = np.empty(1, dtype=object)
    cell_map[0] = np.arange(g_new.num_cells)
    face_map = np.empty(0, dtype=object)
    return g_new, cell_map, face_map


def _define_tags(g, num_cell_layers: int) -> dict:
    """Tags of the extruded grid from the original's (vertical faces come
    first, then horizontal; split faces/nodes carried over)."""
    nc_old, nn_old = g.num_cells, g.num_nodes
    tip_node = np.tile(g.tags["tip_nodes"], num_cell_layers + 1)
    fracture_node = np.tile(g.tags["fracture_nodes"], num_cell_layers + 1)
    boundary_node = np.ones(nn_old, dtype=bool)
    for _ in range(num_cell_layers - 1):
        boundary_node = np.hstack(
            (boundary_node, g.tags["domain_boundary_nodes"].copy())
        )
    boundary_node = np.hstack((boundary_node, np.ones(nn_old, dtype=bool)))

    fracture_face = np.tile(g.tags["fracture_faces"], num_cell_layers)
    tip_face = np.tile(g.tags["tip_faces"], num_cell_layers)
    boundary_face = np.tile(g.tags["domain_boundary_faces"], num_cell_layers)
    num_hor = nc_old * (num_cell_layers + 1)
    fracture_face = np.hstack((fracture_face, np.zeros(num_hor, dtype=bool)))
    tip_face = np.hstack((tip_face, np.zeros(num_hor, dtype=bool)))
    boundary_face = np.hstack(
        (
            boundary_face,
            np.ones(nc_old, dtype=bool),
            np.zeros(nc_old * (num_cell_layers - 1), dtype=bool),
            np.ones(nc_old, dtype=bool),
        )
    )
    return {
        "fracture_faces": fracture_face,
        "tip_faces": tip_face,
        "domain_boundary_faces": boundary_face,
        "fracture_nodes": fracture_node,
        "tip_nodes": tip_node,
        "domain_boundary_nodes": boundary_node,
    }


def _create_mappings(g, g_new, num_cell_layers: int):
    cell_map = np.empty(g.num_cells, dtype=object)
    for c in range(g.num_cells):
        cell_map[c] = np.arange(c, g_new.num_cells, g.num_cells)
    face_map = np.empty(g.num_faces, dtype=object)
    for f in range(g.num_faces):
        face_map[f] = np.arange(f, g.num_faces * num_cell_layers, g.num_faces)
    return cell_map, face_map
