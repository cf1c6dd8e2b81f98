"""Grid partitioning and subgrid extraction.

Parity counterpart of reference ``grids/partition.py``: structured and
coordinate-based coarse partitioning (METIS-backed partitioning when
pymetis is available), subgrid extraction with face/node maps (including
lower-dimensional grids from faces), overlap growth for domain
decomposition, and connectivity checks. On TPU these partitions become
the device-placement map for sharded assembly.
"""

from __future__ import annotations

import itertools
from typing import Optional
from warnings import warn

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid

__all__ = [
    "partition_metis",
    "partition_structured",
    "partition_coordinates",
    "partition",
    "determine_coarse_dimensions",
    "extract_subgrid",
    "partition_grid",
    "overlap",
    "grid_is_connected",
]


def partition_metis(g: Grid, num_part: int) -> np.ndarray:
    try:
        import pymetis
    except ImportError:
        warn("Could not import pymetis. Partitioning by metis will not work.")
        raise ImportError("Cannot partition by pymetis")
    c2c = g.cell_connection_map().tocsr()
    adjacency = [
        c2c.indices[c2c.indptr[i] : c2c.indptr[i + 1]].tolist()
        for i in range(c2c.shape[0])
    ]
    part = pymetis.part_graph(int(num_part), adjacency=adjacency)
    return np.array(part[1])


def partition_structured(
    g, num_part: int = 1, coarse_dims: Optional[np.ndarray] = None
) -> np.ndarray:
    """Coarse Cartesian partition of a structured grid (uses cart_dims)."""
    if coarse_dims is None and num_part is None:
        raise ValueError(
            "Either coarse dimensions or number of coarse cells must be "
            "specified"
        )
    nd = g.dim
    fine_dims = np.asarray(g.cart_dims)
    if coarse_dims is None:
        coarse_dims = determine_coarse_dimensions(num_part, fine_dims)
    fine_per_coarse = np.floor(fine_dims / coarse_dims)
    ind = []
    for i in range(nd):
        incr = np.arange(0, fine_dims[i], fine_per_coarse[i], dtype=int)
        if incr.size > coarse_dims[i]:
            incr = incr[:-1]
        loc = np.zeros(fine_dims[i])
        loc[incr] += 1
        ind.append(np.cumsum(loc) - 1)
    if nd == 1:
        return ind[0].astype(int)
    if nd == 2:
        xi, yi = np.meshgrid(ind[0], ind[1])
        return (xi + yi * coarse_dims[0]).ravel("C").astype(int)
    xi, yi, zi = np.meshgrid(ind[0], ind[1], ind[2])
    glob = xi + yi * coarse_dims[0] + zi * np.prod(coarse_dims[:2])
    return np.swapaxes(np.swapaxes(glob, 1, 2), 0, 1).ravel("C").astype(int)


def partition_coordinates(
    g: Grid, num_coarse: int, check_connectivity: bool = True
) -> np.ndarray:
    """Coarse partition from a Cartesian overlay on cell centers."""
    from porepy_tpu_torch.geometry import map_geometry

    if not hasattr(g, "cell_centers"):
        g.compute_geometry()
    if g.dim == 0:
        return np.zeros(g.num_cells, dtype=int)
    if g.dim in (1, 2):
        g = g.copy()
        cc, *_, nodes = map_geometry.map_grid(g)
        g.cell_centers = np.vstack((cc, np.zeros((3 - g.dim, g.num_cells))))
        g.nodes = np.vstack((nodes, np.zeros((3 - g.dim, g.num_nodes))))
    min_coord = np.min(g.nodes, axis=1)[: g.dim]
    max_coord = np.max(g.nodes, axis=1)[: g.dim]
    cc = g.cell_centers[: g.dim]
    delta = max_coord - min_coord
    delta_int = np.ceil(
        np.power(num_coarse, 1 / g.dim) * delta / np.min(delta)
    ).astype(int)
    coarse_dims = determine_coarse_dimensions(num_coarse, delta_int)
    nc = coarse_dims.prod()
    part = -np.ones(g.num_cells, dtype=int)
    dx = delta / coarse_dims
    for i in range(nc):
        ind = np.array(np.unravel_index(i, coarse_dims))
        lo = min_coord + dx * ind
        hi = min_coord + dx * (ind + 1)
        # Include the upper domain boundary in the last block.
        hi = np.where(ind + 1 == coarse_dims, hi + 1e-10, hi)
        hit = np.all((cc >= lo.reshape((-1, 1))) & (cc < hi.reshape((-1, 1))), axis=0)
        part[hit] = i
    if part.min() < 0:
        raise ValueError("Some cells were not assigned a partition")
    # Compress to consecutive numbering of nonempty blocks.
    _, part = np.unique(part, return_inverse=True)
    if check_connectivity:
        for p in np.unique(part):
            ok, _ = grid_is_connected(g, np.where(part == p)[0])
            if not ok:
                raise ValueError("Partitioning led to unconnected subgrids")
    return part


def partition(g: Grid, num_coarse: int) -> np.ndarray:
    """METIS if available, else coordinate-based partitioning."""
    try:
        return partition_metis(g, num_coarse)
    except ImportError:
        return partition_coordinates(g, num_coarse)


def determine_coarse_dimensions(target: int, fine_size: np.ndarray) -> np.ndarray:
    """Distribute ``target`` coarse cells over the dimensions as evenly as
    the fine sizes allow (reference ``partition.py:300``)."""
    fine_size = np.asarray(fine_size)
    nd = fine_size.size
    target = int(np.clip(target, 1, fine_size.prod()))
    optimum = np.ones(nd)
    found = np.zeros(nd, dtype=bool)
    for _it in range(nd + 1):
        if found.all():
            break
        # Ideal per-remaining-dimension factor of what is left of the target.
        remaining = nd - int(found.sum())
        ideal = (target / optimum.prod()) ** (1.0 / remaining)
        s_low = np.maximum(np.ones(nd), np.floor(ideal))
        s_high = np.minimum(fine_size, np.ceil(ideal))
        hit_ceil = np.squeeze(np.argwhere((s_high == fine_size) & ~found))
        optimum[hit_ceil] = s_high[hit_ceil]
        found[hit_ceil] = True
        if np.any(hit_ceil):
            continue
        s_low[found] = optimum[found]
        s_high[found] = optimum[found]
        coarse_size = np.vstack((s_low, s_high))
        dist = fine_size.prod()
        # First digit varies fastest (matches the reference's permutation
        # ordering, which breaks ties between equally-good distributions).
        for perm in (p[::-1] for p in itertools.product(range(2), repeat=nd)):
            size_now = np.array(
                [coarse_size[bit, i] for i, bit in enumerate(perm)]
            )
            if np.abs(target - size_now.prod()) < dist:
                dist = target - size_now.prod()
                optimum = size_now
        found[:] = True
    if not found.all():
        raise ValueError("Maximum number of iterations exceeded.")
    return optimum.astype(int)


def extract_subgrid(
    g: Grid,
    c: np.ndarray,
    sort: bool = True,
    faces: bool = False,
    is_planar: bool = True,
) -> tuple[Grid, np.ndarray, np.ndarray]:
    """Extract the subgrid of the given cells (or the lower-dimensional
    grid of the given faces); returns (grid, face map, node map)."""
    c = np.asarray(c)
    if c.dtype == bool:
        expected = g.num_faces if faces else g.num_cells
        if c.size != expected:
            raise IndexError("boolean index did not match entity count")
        c = np.where(c)[0]
    if sort:
        c = np.sort(np.atleast_1d(c))
    if faces:
        return _extract_cells_from_faces(g, c, is_planar)
    cf_sub, unique_faces = _extract_submatrix(g.cell_faces.tocsc(), c)
    fn_sub, unique_nodes = _extract_submatrix(g.face_nodes.tocsc(), unique_faces)
    h = Grid(
        g.dim,
        g.nodes[:, unique_nodes],
        fn_sub,
        cf_sub,
        name=g.name if isinstance(g.name, str) else g.name[0],
        history=list(getattr(g, "history", [])) + ["Extract subgrid"],
    )
    for attr, idx in (
        ("cell_centers", c),
        ("cell_volumes", c),
        ("face_centers", unique_faces),
        ("face_normals", unique_faces),
        ("face_areas", unique_faces),
    ):
        if hasattr(g, attr):
            val = getattr(g, attr)
            setattr(
                h, attr, val[:, idx] if np.ndim(val) == 2 else val[idx]
            )
    h.parent_cell_ind = c
    return h, unique_faces, unique_nodes


def _extract_submatrix(mat: sps.spmatrix, ind: np.ndarray):
    if mat.format != "csc":
        raise ValueError("To extract columns from a matrix, it must be csc")
    sub = mat[:, ind].tocsc()
    unique_rows, rows_sub = np.unique(sub.indices, return_inverse=True)
    shape = (unique_rows.size, sub.indptr.size - 1)
    return (
        sps.csc_matrix((sub.data, rows_sub, sub.indptr), shape),
        unique_rows,
    )


def _extract_cells_from_faces(g: Grid, f: np.ndarray, is_planar: bool):
    if g.dim == 1:
        from porepy_tpu_torch.grids.point_grid import PointGrid

        assert np.size(f) == 1
        node = np.argwhere(np.asarray(g.face_nodes.todense())[:, f])[:, 0]
        h = PointGrid(g.nodes[:, node].reshape((3, -1)))
        h.compute_geometry()
        return h, np.atleast_1d(f), node
    if g.dim == 2:
        return _extract_cells_from_faces_2d(g, f)
    return _extract_cells_from_faces_3d(g, f, is_planar)


def _extract_cells_from_faces_2d(g: Grid, f: np.ndarray):
    cell_nodes, unique_nodes = _extract_submatrix(g.face_nodes.tocsc(), f)
    indices = cell_nodes.indices
    data = -np.ones(indices.size)
    _, first = np.unique(indices, return_index=True)
    data[first] *= -1
    cell_faces = sps.csc_matrix(
        (data, indices, cell_nodes.indptr)
    )
    num_faces = cell_faces.shape[0]
    face_nodes = sps.coo_matrix(
        (
            np.ones(num_faces, dtype=bool),
            (np.arange(num_faces), np.arange(num_faces)),
        )
    ).tocsc()
    h = Grid(
        g.dim - 1,
        g.nodes[:, unique_nodes],
        face_nodes,
        cell_faces,
        name=g.name if isinstance(g.name, str) else g.name[0],
        history=list(getattr(g, "history", [])) + ["Extract subgrid"],
    )
    h.compute_geometry()
    h.cell_volumes = g.face_areas[f]
    h.cell_centers = g.face_centers[:, f]
    h.parent_face_ind = f
    return h, f, unique_nodes


def _extract_cells_from_faces_3d(g: Grid, f: np.ndarray, is_planar: bool = True):
    from porepy_tpu_torch.geometry.geometry_property_checks import points_are_planar
    from porepy_tpu_torch.numerics.linalg.matrix_operations import rldecode

    cell_nodes, unique_nodes = _extract_submatrix(g.face_nodes.tocsc(), f)
    if is_planar and not points_are_planar(g.nodes[:, unique_nodes]):
        raise ValueError("The faces extracted from a 3D grid must be planar")
    ptr = cell_nodes.indptr
    num_nodes_per_cell = np.diff(ptr)
    next_node = np.arange(cell_nodes.nnz) + 1
    next_node[ptr[1:] - 1] = ptr[:-1]
    edge_start = cell_nodes.indices
    edge_end = cell_nodes.indices[next_node]
    edges_sorted = np.sort(np.vstack((edge_start, edge_end)), axis=0)
    _, IA, IC = np.unique(
        edges_sorted, return_index=True, return_inverse=True, axis=1
    )
    IC = IC.ravel()
    fn_indices = np.vstack((edge_start, edge_end))[:, IA].ravel("F")
    face_nodes = sps.csc_matrix(
        (
            np.ones(fn_indices.size),
            fn_indices,
            np.arange(0, fn_indices.size + 1, 2),
        )
    )
    cell_idx = rldecode(np.arange(fn_indices.size), num_nodes_per_cell)
    data = np.ones(IC.shape)
    _, first = np.unique(IC, return_index=True)
    data[first] *= -1
    cell_faces = sps.coo_matrix((data, (IC, cell_idx))).tocsc()
    h = Grid(
        g.dim - 1,
        g.nodes[:, unique_nodes],
        face_nodes,
        cell_faces,
        name=g.name if isinstance(g.name, str) else g.name[0],
        history=list(getattr(g, "history", [])) + ["Extract subgrid"],
    )
    if is_planar:
        h.compute_geometry()
    h.cell_volumes = g.face_areas[f]
    h.cell_centers = g.face_centers[:, f]
    h.parent_face_ind = f
    return h, f, unique_nodes


def partition_grid(g: Grid, ind: np.ndarray):
    """Split a grid into the subgrids of a partition vector."""
    sub_grids, face_maps, node_maps = [], [], []
    for i in np.unique(ind):
        ci = np.where(ind == i)[0]
        sg, fm, nm = extract_subgrid(g, ci)
        sub_grids.append(sg)
        face_maps.append(fm)
        node_maps.append(nm)
    return sub_grids, face_maps, node_maps


def overlap(
    g: Grid, cell_ind: np.ndarray, num_layers: int, criterion: str = "node"
) -> np.ndarray:
    """Grow a cell set by ``num_layers`` node- or face-neighbor layers."""
    active_cells = np.zeros(g.num_cells, dtype=bool)
    active_cells[cell_ind] = True
    if criterion.lower().strip() == "node":
        cn = g.cell_nodes()
        active_nodes = np.zeros(g.num_nodes, dtype=bool)
        for _ in range(num_layers):
            active_nodes[(cn @ active_cells) > 0] = True
            active_cells[(cn.T @ active_nodes) > 0] = True
    elif criterion.lower().strip() == "face":
        cf = g.cell_faces
        cf = sps.csc_matrix((np.ones_like(cf.data), cf.indices, cf.indptr))
        active_faces = np.zeros(g.num_faces, dtype=bool)
        for _ in range(num_layers):
            active_faces[(cf @ active_cells) > 0] = True
            active_cells[(cf.T @ active_faces) > 0] = True
    else:
        raise ValueError(f"Unknown overlap criterion {criterion!r}")
    return np.where(active_cells)[0]


def grid_is_connected(
    g: Grid, cell_ind: Optional[np.ndarray] = None
) -> tuple[bool, list[np.ndarray]]:
    """Connectivity of (a cell subset of) a grid, with its components."""
    from scipy.sparse import csgraph

    if cell_ind is None:
        cell_ind = np.arange(g.num_cells)
    c2c = g.cell_connection_map().tocsr()[cell_ind, :].tocsc()[:, cell_ind]
    n_comp, labels = csgraph.connected_components(c2c, directed=False)
    components = [np.where(labels == i)[0] for i in range(n_comp)]
    return n_comp == 1, components
