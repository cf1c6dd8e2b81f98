"""Fractured Cartesian/tensor grids without gmsh.

Parity counterpart of reference ``fracs/structured.py``: axis-aligned
fractures snap to grid faces; lower-dimensional grids (lines in 2d,
rectangles in 3d, intersections) are built directly from the host grid's
node lattice.

2d (lines) and 3d (axis-aligned rectangles) are supported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs import msh_2_grid
from porepy_tpu_torch.grids.point_grid import PointGrid
from porepy_tpu_torch.grids.structured import CartGrid, TensorGrid

__all__ = ["_cart_grid_2d", "_cart_grid_3d", "_tensor_grid_2d", "_tensor_grid_3d"]


def _cart_grid_2d(
    fracs: list[np.ndarray], nx: np.ndarray, physdims: Optional[np.ndarray] = None
) -> list[list]:
    nx = np.asarray(nx)
    if physdims is None:
        physdims = nx
    g_2d = CartGrid(nx, physdims=np.asarray(physdims))
    return _create_lower_dim_grids_2d(g_2d, fracs, nx)


def _tensor_grid_2d(fracs: list[np.ndarray], x: np.ndarray, y: np.ndarray) -> list[list]:
    nx = np.asarray((x.size - 1, y.size - 1))
    g_2d = TensorGrid(x, y)
    return _create_lower_dim_grids_2d(g_2d, fracs, nx)


def _cart_grid_3d(
    fracs: list[np.ndarray], nx: np.ndarray, physdims: Optional[np.ndarray] = None
) -> list[list]:
    nx = np.asarray(nx)
    if physdims is None:
        physdims = nx
    g_3d = CartGrid(nx, physdims=np.asarray(physdims))
    return _create_lower_dim_grids_3d(g_3d, fracs, nx)


def _tensor_grid_3d(
    fracs: list[np.ndarray], x: np.ndarray, y: np.ndarray, z: np.ndarray
) -> list[list]:
    nx = np.asarray((x.size - 1, y.size - 1, z.size - 1))
    g_3d = TensorGrid(x, y, z)
    return _create_lower_dim_grids_3d(g_3d, fracs, nx)


# -- 2d ------------------------------------------------------------------------


def _create_lower_dim_grids_2d(g_2d, fracs: list[np.ndarray], nx: np.ndarray):
    g_2d.global_point_ind = np.arange(g_2d.num_nodes)
    g_2d.compute_geometry()
    g_1d = []
    g_0d = []

    shared_nodes = np.zeros(g_2d.num_nodes)
    for fi, f in enumerate(fracs):
        f = np.asarray(f, dtype=float)
        is_x_frac = f[1, 0] == f[1, 1]
        is_y_frac = f[0, 0] == f[0, 1]
        if is_x_frac == is_y_frac:
            raise ValueError("Fracture must align with the x- or y-axis")
        if f.shape[0] == 2:
            f = np.vstack((f, np.zeros(f.shape[1])))
        nodes = _find_nodes_on_line(g_2d, nx, f[:, 0], f[:, 1])
        loc_coord = g_2d.nodes[:, nodes]
        g = msh_2_grid.create_embedded_line_grid(loc_coord, nodes)
        g.frac_num = fi
        g_1d.append(g)
        shared_nodes[nodes] += 1

    for global_node in np.argwhere(shared_nodes > 1).ravel():
        g = PointGrid(g_2d.nodes[:, global_node])
        g.global_point_ind = np.atleast_1d(np.asarray(global_node))
        g_0d.append(g)

    return [[g_2d], g_1d, g_0d]


def _find_nodes_on_line(g, nx: np.ndarray, s_pt: np.ndarray, e_pt: np.ndarray):
    """Snap line endpoints to nearest nodes and collect the lattice nodes on
    the line (assumes tensor-grid node ordering: x fastest)."""
    dist_s = np.sum((g.nodes - s_pt.reshape(3, 1)) ** 2, axis=0)
    dist_e = np.sum((g.nodes - e_pt.reshape(3, 1)) ** 2, axis=0)
    s_node = int(np.argmin(dist_s))
    e_node = int(np.argmin(dist_e))
    if s_node > e_node:
        s_node, e_node = e_node, s_node

    if np.allclose(s_pt[1:], e_pt[1:]):
        nodes = np.arange(s_node, e_node + 1)
    elif np.allclose(s_pt[[0, 2]], e_pt[[0, 2]]):
        nodes = np.arange(s_node, e_node + 1, nx[0] + 1, dtype=int)
    elif nx.size == 3 and np.allclose(s_pt[0:2], e_pt[0:2]):
        nodes = np.arange(
            s_node, e_node + 1, (nx[0] + 1) * (nx[1] + 1), dtype=int
        )
    else:
        raise RuntimeError("Fracture line is not axis-aligned on the lattice")
    return nodes


# -- 3d ------------------------------------------------------------------------


def _create_lower_dim_grids_3d(g_3d, fracs: list[np.ndarray], nx: np.ndarray):
    """Axis-aligned rectangular fractures in a 3d lattice: 2d fracture
    grids, 1d fracture-intersection grids and 0d point grids."""
    g_3d.global_point_ind = np.arange(g_3d.num_nodes)
    g_3d.compute_geometry()
    g_2d: list = []
    g_1d: list = []
    g_0d: list = []

    # Snap each rectangle to the lattice and record its constant axis.
    frac_axes = []
    frac_nodes_list = []
    for fi, f in enumerate(fracs):
        f = np.asarray(f, dtype=float)
        if f.shape != (3, 4):
            raise ValueError("3d fractures must be (3, 4) rectangles")
        const_axis = [a for a in range(3) if np.allclose(f[a], f[a, 0])]
        if len(const_axis) != 1:
            raise ValueError("Fracture rectangle must be axis-aligned")
        axis = const_axis[0]
        in_plane = [a for a in range(3) if a != axis]

        nodes_mask = _nodes_in_rectangle(g_3d, f, axis, in_plane)
        nodes = np.where(nodes_mask)[0]
        loc_coord = g_3d.nodes[:, nodes]
        g = _create_embedded_plane_grid(loc_coord, nodes)
        g.frac_num = fi
        g_2d.append(g)
        frac_axes.append(axis)
        frac_nodes_list.append(nodes)

    g_1d, g_0d = lattice_intersection_grids(g_3d, frac_nodes_list)
    return [[g_3d], g_2d, g_1d, g_0d]


def lattice_intersection_grids(
    g_3d, frac_nodes_list: list[np.ndarray]
) -> tuple[list, list]:
    """1d intersection-line grids and 0d crossing-point grids from the
    per-fracture lattice-node sets of axis-aligned fractures (shared by the
    cartesian and structured-tetrahedral fracture meshers).

    Pairwise common lattice nodes form axis-aligned lines. Mirroring the
    reference's network-based processing (``fracs/structured.py`` via
    FractureNetwork3d), lines are split into sub-segments at points where
    intersection lines cross, and 0d grids are created at those points.
    """
    g_1d: list = []
    g_0d: list = []
    raw_lines: list[np.ndarray] = []
    for i in range(len(frac_nodes_list)):
        for j in range(i + 1, len(frac_nodes_list)):
            common = np.intersect1d(frac_nodes_list[i], frac_nodes_list[j])
            if common.size < 2:
                continue
            coords = g_3d.nodes[:, common]
            span = coords.max(axis=1) - coords.min(axis=1)
            if np.count_nonzero(span > 1e-12) != 1:
                continue
            run_axis = int(np.argmax(span))
            order = np.argsort(coords[run_axis], kind="stable")
            line_nodes = common[order]
            if not any(np.array_equal(line_nodes, prev) for prev in raw_lines):
                raw_lines.append(line_nodes)

    # Crossing points: nodes shared by at least two lines.
    node_line_count: dict[int, int] = {}
    for line_nodes in raw_lines:
        for n in line_nodes:
            node_line_count[int(n)] = node_line_count.get(int(n), 0) + 1
    crossing = {n for n, c in node_line_count.items() if c > 1}

    for line_nodes in raw_lines:
        # Split at interior crossing points.
        interior_breaks = [
            k
            for k in range(1, line_nodes.size - 1)
            if int(line_nodes[k]) in crossing
        ]
        bounds = [0] + interior_breaks + [line_nodes.size - 1]
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = line_nodes[a : b + 1]
            if seg.size < 2:
                continue
            coords = g_3d.nodes[:, seg]
            g = msh_2_grid.create_embedded_line_grid(coords, seg)
            g_1d.append(g)

    for global_node in sorted(crossing):
        g = PointGrid(g_3d.nodes[:, global_node])
        g.global_point_ind = np.atleast_1d(np.asarray(global_node))
        g_0d.append(g)

    return g_1d, g_0d


def _nodes_in_rectangle(g, f: np.ndarray, axis: int, in_plane: list[int]):
    """Boolean mask over lattice nodes inside the snapped rectangle."""
    # Snap rectangle coordinates to the nearest lattice coordinates.
    def snap(vals, coords):
        u = np.unique(coords)
        return u[np.argmin(np.abs(u[:, None] - vals[None, :]), axis=0)]

    plane_coord = snap(np.array([f[axis, 0]]), g.nodes[axis])[0]
    lo = []
    hi = []
    for a in in_plane:
        snapped = snap(np.array([f[a].min(), f[a].max()]), g.nodes[a])
        lo.append(snapped[0])
        hi.append(snapped[1])
    tol = 1e-10
    mask = np.abs(g.nodes[axis] - plane_coord) < tol
    for a, lo_a, hi_a in zip(in_plane, lo, hi):
        mask &= (g.nodes[a] >= lo_a - tol) & (g.nodes[a] <= hi_a + tol)
    return mask


def _plane_normal_by_cross_products(pts: np.ndarray) -> np.ndarray:
    """Plane normal with the reference's deterministic construction
    (``geometry/map_geometry.py:440``): cross products against the longest
    center-to-point vector, longest result wins. The *sign* of the result
    matters for parity of the embedded 2d grid's local axes."""
    center = pts.mean(axis=1, keepdims=True)
    v = pts - center
    nrm = np.linalg.norm(v, axis=0)
    v1 = v[:, np.argmax(nrm)]
    cross = np.array(
        [
            v1[1] * v[2] - v1[2] * v[1],
            v1[2] * v[0] - v1[0] * v[2],
            v1[0] * v[1] - v1[1] * v[0],
        ]
    )
    ci = np.argmax(np.linalg.norm(cross, axis=0))
    n = cross[:, ci]
    return n / np.linalg.norm(n)


def _axis_angle_rotation(angle: float, vect: np.ndarray) -> np.ndarray:
    if np.allclose(vect, 0):
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


def _create_embedded_plane_grid(loc_coord, glob_id):
    """Tensor grid on the rectangle's lattice nodes, embedded in 3d.

    Mirrors reference ``fracs/structured.py`` ``_create_embedded_2d_grid``:
    rotate the plane onto xy with the deterministic plane normal, detect
    the two active coordinates, lexsort nodes, build the TensorGrid."""
    loc_coord = np.array(loc_coord, dtype=float)
    loc_center = loc_coord.mean(axis=1, keepdims=True)
    loc_coord = loc_coord - loc_center

    normal = _plane_normal_by_cross_products(loc_coord)
    reference = np.array([0.0, 0.0, 1.0])
    angle = np.arccos(np.clip(normal @ reference, -1.0, 1.0))
    vect = np.array(
        [
            normal[1] * reference[2] - normal[2] * reference[1],
            normal[2] * reference[0] - normal[0] * reference[2],
            normal[0] * reference[1] - normal[1] * reference[0],
        ]
    )
    rot = _axis_angle_rotation(angle, vect)
    loc_coord_2d = rot @ loc_coord

    extent = loc_coord_2d.max(axis=1) - loc_coord_2d.min(axis=1)
    fracture_size = extent.max()
    sum_coord = np.sum(np.abs(loc_coord_2d), axis=1) / fracture_size
    active_dimension = ~np.isclose(sum_coord, 0)
    if active_dimension.sum() != 2:
        raise RuntimeError("Fracture plane rotation failed to flatten the cloud")

    coord_2d = loc_coord_2d[active_dimension]
    sort_ind = np.lexsort((coord_2d[0], coord_2d[1]))
    sorted_coord = np.round(coord_2d[:, sort_ind] * 1e10) / 1e10
    unique_x = np.unique(sorted_coord[0])
    unique_y = np.unique(sorted_coord[1])
    g = TensorGrid(unique_x, unique_y)
    if not np.all(g.nodes[0:2] - sorted_coord == 0):
        raise RuntimeError("Fracture nodes do not form a full lattice rectangle")

    nodes = np.zeros(g.nodes.shape)
    nodes[active_dimension] = g.nodes[0:2]
    g.nodes = rot.T @ nodes + loc_center
    g.global_point_ind = np.asarray(glob_id)[sort_ind]
    return g
