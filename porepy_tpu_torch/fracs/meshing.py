"""Mixed-dimensional grid assembly from per-dimension grid lists.

Parity counterpart of reference ``fracs/meshing.py``: face tagging
(fracture/tip/domain-boundary), identification of face-cell couplings
between dimensions via shared global nodes, face/node splitting, and mortar
grid creation — the full structured (no-gmsh) meshing path via
:func:`cart_grid` / :func:`tensor_grid`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.fracs import split_grid, structured
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.mortar_grid import MortarGrid, MortarSides
from porepy_tpu_torch.utils.array_operations import (
    expand_index_pointers,
    ismember_columns,
)

__all__ = ["cart_grid", "tensor_grid", "subdomains_to_mdg", "create_interfaces"]


def cart_grid(fracs: list[np.ndarray], nx: np.ndarray, **kwargs) -> MixedDimensionalGrid:
    """Cartesian fractured mixed-dimensional grid in 2d/3d; axis-aligned
    fractures snap to grid faces (reference ``meshing.py:99``)."""
    ndim = np.asarray(nx).size
    physdims = kwargs.pop("physdims", None)
    if physdims is None:
        physdims = nx
    elif np.asarray(physdims).size != ndim:
        raise ValueError("Physical dimension must equal grid dimension")
    if ndim == 2:
        subdomains = structured._cart_grid_2d(fracs, nx, physdims=physdims)
    elif ndim == 3:
        subdomains = structured._cart_grid_3d(fracs, nx, physdims=physdims)
    else:
        raise ValueError("Only 2d and 3d supported")
    return subdomains_to_mdg(subdomains, **kwargs)


def tensor_grid(
    fracs: list[np.ndarray],
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    **kwargs,
) -> MixedDimensionalGrid:
    if y is None:
        raise NotImplementedError("Fractured tensor grids not implemented in 1d")
    if z is None:
        subdomains = structured._tensor_grid_2d(fracs, x, y)
    else:
        subdomains = structured._tensor_grid_3d(fracs, x, y, z)
    return subdomains_to_mdg(subdomains, **kwargs)


def subdomains_to_mdg(
    subdomains: list[list], **kwargs
) -> MixedDimensionalGrid:
    """Assemble per-dimension grid lists into a mixed-dimensional grid:
    tag faces, find couplings, split fractures, create interfaces."""
    check_highest_dim = kwargs.get("check_highest_dim", False)
    _tag_faces(subdomains, check_highest_dim)
    mdg, sd_pair_to_face_cell_map = _assemble_mdg(subdomains)
    mdg.compute_geometry()
    mdg, sd_pairs = split_grid.split_fractures(
        mdg, sd_pair_to_face_cell_map, **kwargs
    )
    create_interfaces(mdg, sd_pairs)
    mdg.set_boundary_grid_projections()
    return mdg


def _nodes_per_face(g) -> int:
    name = g.name if isinstance(g.name, str) else " ".join(g.name)
    is_tensor = "TensorGrid" in name or "CartGrid" in name
    if is_tensor and g.dim == 3:
        return 4
    if "TetrahedralGrid" in name:
        return 3
    if is_tensor and g.dim == 2:
        return 2
    if "TriangleGrid" in name:
        return 2
    if is_tensor and g.dim == 1:
        return 1
    raise ValueError(f"Unknown nodes-per-face for grid {name!r}")


def _tag_faces(grids: list[list], check_highest_dim: bool = True) -> None:
    """Tag domain-boundary/tip faces across the grid hierarchy (reference
    ``meshing.py:220``)."""
    if check_highest_dim and len(grids[0]) != 1:
        raise ValueError("There must be exactly one highest-dimensional grid")

    for g_h in grids[0]:
        bnd_faces = g_h.get_all_boundary_faces()
        tags = np.zeros(g_h.num_faces, dtype=bool)
        tags[bnd_faces] = True
        g_h.tags["domain_boundary_faces"] = tags

        fn_h = g_h.face_nodes[:, bnd_faces].tocsr()
        bnd_nodes = np.unique(g_h.face_nodes[:, bnd_faces].tocoo().row)
        bnd_nodes_glb = g_h.global_point_ind[bnd_nodes]

        global_node_as_tip = np.array([], dtype=int)
        num_occ_nodes = np.array([], dtype=int)

        for g_dim in grids[1:-1]:
            for g in g_dim:
                bnd_faces_l = g.get_all_boundary_faces()
                indptr = g.face_nodes.indptr
                fn_loc = expand_index_pointers(
                    indptr[bnd_faces_l], indptr[bnd_faces_l + 1]
                )
                nodes_loc = g.face_nodes.indices[fn_loc]
                nodes_glb = g.global_point_ind[nodes_loc]
                interior = ~np.isin(nodes_glb, bnd_nodes_glb)

                n_per_face = _nodes_per_face(g)
                is_tip_face = np.any(
                    interior.reshape((n_per_face, bnd_faces_l.size), order="F"),
                    axis=0,
                )

                if g.dim == 2:
                    # Fracture faces whose two nodes sit on different global
                    # boundary surfaces are tips despite both nodes being on
                    # the boundary.
                    not_tip = np.where(~is_tip_face)[0]
                    for fi in not_tip:
                        g1 = fn_h[nodes_glb[2 * fi]].indices
                        g2 = fn_h[nodes_glb[2 * fi + 1]].indices
                        if np.intersect1d(g1, g2).size == 0:
                            is_tip_face[fi] = True

                g.tags["tip_faces"][bnd_faces_l[is_tip_face]] = True
                db = np.zeros(g.num_faces, dtype=bool)
                db[bnd_faces_l[~is_tip_face]] = True
                g.tags["domain_boundary_faces"] = db

                tip_node = np.zeros(g.num_nodes, dtype=bool)
                tip_node[nodes_loc[interior]] = True
                g.tags["tip_nodes"] = tip_node

                if g.dim == g_h.dim - 1:
                    tip_glb = np.unique(
                        nodes_glb.reshape(
                            (n_per_face, bnd_faces_l.size), order="F"
                        )[:, is_tip_face]
                    )
                    global_node_as_tip = np.hstack(
                        (global_node_as_tip, tip_glb)
                    )
                    num_occ_nodes = np.hstack(
                        (num_occ_nodes, g.global_point_ind)
                    )

        if global_node_as_tip.size:
            may_be_tip = np.where(np.bincount(global_node_as_tip) == 1)[0]
            occurs_once = np.where(np.bincount(num_occ_nodes) == 1)[0]
            true_tip = np.intersect1d(may_be_tip, occurs_once)
            on_any_tip = np.where(np.bincount(global_node_as_tip) > 0)[0]
        else:
            true_tip = np.zeros(0, dtype=int)
            on_any_tip = np.zeros(0, dtype=int)

        def _local(globals_):
            found, loc = ismember_columns(
                np.atleast_2d(globals_).astype(np.int64),
                np.atleast_2d(g_h.global_point_ind).astype(np.int64),
            )
            return loc

        tip_tag = np.zeros(g_h.num_nodes, dtype=bool)
        tip_tag[_local(true_tip)] = True
        g_h.tags["node_is_fracture_tip"] = tip_tag
        any_tag = np.zeros(g_h.num_nodes, dtype=bool)
        any_tag[_local(on_any_tip)] = True
        g_h.tags["node_is_tip_of_some_fracture"] = any_tag


def _assemble_mdg(subdomains: list[list]):
    """Build the mdg container and find face-cell couplings between grids
    one dimension apart, matched by global node tuples (reference
    ``meshing.py:399``)."""
    mdg = MixedDimensionalGrid()
    for sd_d in subdomains:
        mdg.add_subdomains(sd_d)

    sd_pair_to_face_cell_map: dict = {}

    for dim in range(len(subdomains) - 1):
        if len(subdomains[dim + 1]) == 0:
            continue
        for g_h in subdomains[dim]:
            n_per_face = _nodes_per_face(g_h)
            fn_loc = g_h.face_nodes.indices.reshape(
                (n_per_face, g_h.num_faces), order="F"
            )
            fn = np.sort(g_h.global_point_ind[fn_loc], axis=0)

            if g_h.dim > 1:
                cn = []
                num_cn = [0]
                for lg in subdomains[dim + 1]:
                    cn_loc = lg.cell_nodes().indices.reshape(
                        (n_per_face, lg.num_cells), order="F"
                    )
                    cn.append(np.sort(lg.global_point_ind[cn_loc], axis=0))
                    num_cn.append(lg.num_cells)
                cn_all = np.hstack(cn)
                cell_node_offsets = np.cumsum(num_cn)
            else:
                cn_all = np.array(
                    [
                        np.atleast_1d(lg.global_point_ind)[0]
                        for lg in subdomains[dim + 1]
                    ]
                )
                cell_node_offsets = np.arange(cn_all.size + 1)
                fn = fn.ravel()

            is_mem, cell_2_face = ismember_columns(cn_all, fn, sort=False)
            if is_mem.size != cell_2_face.size:
                tmp = -np.ones(is_mem.size, dtype=int)
                tmp[is_mem] = cell_2_face
                cell_2_face = tmp

            for counter, lsd in enumerate(subdomains[dim + 1]):
                ind = slice(
                    cell_node_offsets[counter], cell_node_offsets[counter + 1]
                )
                loc_mem = is_mem[ind]
                if np.sum(loc_mem) == 0:
                    continue
                if not np.all(loc_mem):
                    raise ValueError(
                        "Inconsistent face-cell match between dimensions"
                    )
                face_cell_map = sps.csc_matrix(
                    (
                        np.ones(loc_mem.size, dtype=bool),
                        (np.arange(loc_mem.size), cell_2_face[ind]),
                    ),
                    shape=(lsd.num_cells, g_h.num_faces),
                )
                sd_pair_to_face_cell_map[(g_h, lsd)] = face_cell_map

    return mdg, sd_pair_to_face_cell_map


def create_interfaces(mdg: MixedDimensionalGrid, sd_pair_to_face_cell_map: dict) -> None:
    """Build one MortarGrid per coupled subdomain pair (reference
    ``meshing.py:544``)."""
    for sd_pair, face_cells in sd_pair_to_face_cell_map.items():
        sd_primary, sd_secondary = sd_pair
        num_sides = np.bincount(face_cells.tocoo().row)
        if num_sides.size and np.max(num_sides) > 2:
            raise ValueError(
                "A lower-dimensional cell matches too many higher-dimensional faces"
            )
        if num_sides.size and np.all(num_sides > 1):
            side_g = {
                MortarSides.LEFT_SIDE: sd_secondary.copy(),
                MortarSides.RIGHT_SIDE: sd_secondary.copy(),
            }
        else:
            side_g = {MortarSides.LEFT_SIDE: sd_secondary.copy()}
        mg = MortarGrid(sd_secondary.dim, side_g, face_cells)
        mdg.add_interface(mg, sd_pair, face_cells)
