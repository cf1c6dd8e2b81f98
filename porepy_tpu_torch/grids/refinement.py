"""Grid refinement: 1d refinement/remeshing, triangle splitting, and
coarse-to-fine mappings for convergence studies.

Parity counterpart of reference ``grids/refinement.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid
from porepy_tpu_torch.grids.simplex import TriangleGrid
from porepy_tpu_torch.grids.structured import TensorGrid

__all__ = [
    "distort_grid_1d",
    "refine_grid_1d",
    "refine_triangle_grid",
    "remesh_1d",
    "structured_refinement",
    "mdg_refinement",
    "GridSequenceIterator",
    "GridSequenceFactory",
]


def distort_grid_1d(
    g: Grid, ratio: float = 0.1, fixed_nodes: Optional[np.ndarray] = None
) -> Grid:
    """Perturb interior nodes of a 1d grid along its axis (topology kept)."""
    if fixed_nodes is None:
        fixed = np.array([0, g.num_nodes - 1], dtype=int)
    else:
        fixed = np.unique(
            np.hstack((fixed_nodes, [0, g.num_nodes - 1]))
        ).astype(int)
    g.compute_geometry()
    r = ratio * (0.5 - np.random.random(g.num_nodes - 2))
    r *= np.minimum(g.cell_volumes[:-1], g.cell_volumes[1:])
    direction = (g.nodes[:, -1] - g.nodes[:, 0]).reshape((-1, 1))
    direction = direction / np.linalg.norm(direction)
    movement = r * direction
    movement[:, np.isin(np.arange(1, g.num_nodes - 1), fixed)] = 0
    g.nodes[:, 1:-1] += movement
    g.compute_geometry()
    return g


def refine_grid_1d(g: Grid, ratio: int = 2) -> Grid:
    """Split every cell of a 1d grid into ``ratio`` cells."""
    cell_nodes = g.cell_nodes().tocsc()
    frac_num = g.frac_num
    num_new_nodes = (ratio - 1) * g.num_cells + g.num_nodes
    x = np.zeros((3, num_new_nodes))
    theta = np.arange(1, ratio) / float(ratio)
    node_counter = 0
    _, first_occ = np.unique(cell_nodes.indices, return_index=True)
    is_new = np.zeros(cell_nodes.indices.size, dtype=bool)
    is_new[first_occ] = True
    old_2_new: dict[int, int] = {}
    new_indices: list[np.ndarray] = []
    template = np.repeat(np.arange(ratio - 1), 2)
    for c in range(g.num_cells):
        loc = slice(cell_nodes.indptr[c], cell_nodes.indptr[c + 1])
        start, end = cell_nodes.indices[loc]
        new_loc = is_new[loc]
        loc_ind = []
        if new_loc[0]:
            x[:, node_counter] = g.nodes[:, start]
            old_2_new[start] = node_counter
            loc_ind.append(node_counter)
            node_counter += 1
        else:
            loc_ind.append(old_2_new[start])
        x[:, node_counter : node_counter + ratio - 1] = g.nodes[
            :, start
        ].reshape((-1, 1)) * (1 - theta) + g.nodes[:, end].reshape(
            (-1, 1)
        ) * theta
        loc_ind += list(node_counter + template)
        node_counter += ratio - 1
        if new_loc[-1]:
            x[:, node_counter] = g.nodes[:, end]
            old_2_new[end] = node_counter
            loc_ind.append(node_counter)
            node_counter += 1
        else:
            loc_ind.append(old_2_new[end])
        new_indices.append(np.array(loc_ind))
    face_nodes = sps.identity(x.shape[1], format="csc")
    cell_face_ind = np.hstack(new_indices)
    _, first = np.unique(cell_face_ind, return_index=True)
    signs = np.full(cell_face_ind.size, -1)
    signs[first] = 1
    cell_faces = sps.csc_matrix(
        (signs, cell_face_ind, np.arange(0, cell_face_ind.size + 1, 2))
    )
    out = Grid(1, x, face_nodes, cell_faces, "Refined 1d grid")
    out.compute_geometry()
    out.frac_num = frac_num
    return out


def refine_triangle_grid(g: TriangleGrid) -> tuple[TriangleGrid, np.ndarray]:
    """Uniform red refinement: each triangle into four via edge midpoints.
    Returns the new grid and the fine-to-coarse cell map."""
    if not hasattr(g, "face_centers"):
        g.compute_geometry()
    nd = g.dim
    fn = g.face_nodes.indices.reshape((nd, g.num_faces), order="F")
    cf = g.cell_faces.indices.reshape((nd + 1, g.num_cells), order="F")
    new_nodes = np.hstack((g.nodes, g.face_centers))
    offset = g.num_nodes
    binom = ((1, 0), (2, 1), (0, 2))
    new_tri = np.empty((nd + 1, g.num_cells, nd + 2), dtype=int)
    for ti, b in enumerate(binom):
        # The corner shared by the two faces of this pair.
        loc_n = np.vstack((fn[:, cf[b[0]]], fn[:, cf[b[1]]]))
        loc_n.sort(axis=0)
        equal = np.argwhere(np.diff(loc_n, axis=0) == 0)
        corner = loc_n.ravel()[
            np.ravel_multi_index(equal.T, dims=loc_n.shape)
        ]
        new_tri[:, :, ti] = np.vstack(
            (corner, offset + cf[b[0]], offset + cf[b[1]])
        )
    new_tri[:, :, -1] = offset + cf
    new_tri = new_tri.reshape((nd + 1, (nd + 2) * g.num_cells))
    parent = np.tile(np.arange(g.num_cells), g.dim + 2)
    new_grid = TriangleGrid(
        new_nodes, tri=new_tri, name=g.name if isinstance(g.name, str) else g.name[0]
    )
    return new_grid, parent


def remesh_1d(g_old: Grid, num_nodes: int, tol: float = 1e-6) -> Grid:
    """Equi-spaced remeshing of a 1d grid, transferring face tags."""
    from porepy_tpu_torch.geometry.distances import point_pointset
    from porepy_tpu_torch.utils.tags import standard_face_tags

    theta = np.linspace(0, 1, num_nodes)
    start, end = g_old.get_all_boundary_nodes()
    nodes = g_old.nodes[:, start, np.newaxis] * theta + g_old.nodes[
        :, end, np.newaxis
    ] * (1.0 - theta)
    g = TensorGrid(nodes[0, :])
    g.nodes = nodes
    g.compute_geometry()
    for f_old in range(g_old.num_faces):
        dist = point_pointset(g_old.face_centers[:, f_old], g.face_centers)
        f_new = np.where(dist < tol)[0]
        if f_new.size == 1:
            for tag in standard_face_tags():
                g.tags[tag][f_new] = g_old.tags[tag][f_old]
        elif f_new.size > 1:
            raise ValueError("There cannot be more than one matching face")
    g.update_boundary_node_tag()
    return g


def structured_refinement(
    g: Grid, g_ref: Grid, point_in_poly_tol: float = 1e-8
) -> sps.csc_matrix:
    """Coarse-to-fine cell mapping for nested (splitting) refinements of
    simplex grids."""
    from porepy_tpu_torch.geometry import map_geometry
    from porepy_tpu_torch.geometry.geometry_property_checks import (
        point_in_polygon,
        point_in_polyhedron,
    )

    if g.dim == 0:
        return sps.csc_matrix((np.ones(1), ([0], [0])))
    if g.num_cells >= g_ref.num_cells:
        raise ValueError("Wrong order of input grids")
    if g.dim != g_ref.dim:
        raise ValueError("Grids must be of same dimension")
    cell_nodes = g.cell_nodes().tocsc()
    indptr = np.array([0])
    indices = np.empty(0)
    cells_ref = g_ref.cell_centers.copy()
    remaining = np.arange(g_ref.num_cells)
    nodes = g.nodes.copy()
    if g.dim == 1:
        R = map_geometry.project_line_matrix(nodes)
        nodes = (R @ nodes)[0]
        cells_ref = (R @ cells_ref)[0]
    elif g.dim == 2:
        R = map_geometry.project_plane_matrix(nodes)
        nodes = (R @ nodes)[:2]
        cells_ref = (R @ cells_ref)[:2]
    for c in range(g.num_cells):
        nodes_idx = cell_nodes.indices[
            cell_nodes.indptr[c] : cell_nodes.indptr[c + 1]
        ]
        if g.dim == 1:
            line = np.sort(nodes[nodes_idx])
            in_poly = (
                np.searchsorted(line, cells_ref[remaining], side="left") == 1
            )
        elif g.dim == 2:
            in_poly = point_in_polygon(
                nodes[:, nodes_idx], cells_ref[:, remaining]
            )
        else:
            coords = nodes[:, nodes_idx]
            ids = np.arange(nodes_idx.size)
            polyhedron = np.array(
                [coords[:, ids != i] for i in range(nodes_idx.size)]
            )
            in_poly = point_in_polyhedron(
                polyhedron, cells_ref[:, remaining], tol=point_in_poly_tol
            )
        hit = remaining[in_poly]
        remaining = remaining[~in_poly]
        indices = np.append(indices, hit)
        indptr = np.append(indptr, indptr[-1] + hit.size)
    if indices.size != g_ref.num_cells:
        raise ValueError(
            "Every fine cell should be inside exactly one coarse cell"
        )
    return sps.csc_matrix((np.ones(indices.size), indices, indptr))


def mdg_refinement(mdg, mdg_ref, tol: float = 1e-8, mode: str = "nested") -> None:
    """Store coarse-to-fine cell mappings in the coarse mdg's data dicts
    under ``'coarse_fine_cell_mapping'``."""
    if mode != "nested":
        raise NotImplementedError("Only nested refinement is supported")
    subdomains = mdg.subdomains()
    subdomains_ref = mdg_ref.subdomains()
    assert len(subdomains) == len(subdomains_ref)
    for sd, sd_ref in zip(subdomains, subdomains_ref):
        assert sd.dim == sd_ref.dim
        mapping = structured_refinement(sd, sd_ref, point_in_poly_tol=tol)
        mdg.subdomain_data(sd)["coarse_fine_cell_mapping"] = mapping


class GridSequenceIterator:
    def __init__(self, factory: "GridSequenceFactory") -> None:
        self._factory = factory
        self._counter = 0

    def __next__(self):
        if self._counter >= self._factory._num_refinements:
            self._factory.close()
            raise StopIteration()
        mdg = self._factory._generate(self._counter)
        self._counter += 1
        return mdg


class GridSequenceFactory:
    """Factory of successively refined mixed-dimensional grids for
    convergence studies. ``params`` keys: ``mode`` ('nested' or
    'unstructured'), ``num_refinements``, and meshing arguments."""

    def __init__(self, network, params: dict) -> None:
        self._network = network.copy()
        self._counter = 0
        self._set_parameters(params)
        if self._mode == "nested":
            self._prepare_initial_mdg()

    def __iter__(self) -> GridSequenceIterator:
        return GridSequenceIterator(self)

    def close(self) -> None:
        pass

    def _set_parameters(self, params: dict) -> None:
        self._mode = params.get("mode", "nested")
        self._num_refinements = params.get("num_refinements", 1)
        self._mesh_parameters = {
            k: v
            for k, v in params.items()
            if k not in ("mode", "num_refinements")
        }

    def _prepare_initial_mdg(self) -> None:
        self._mdg = self._network.mesh(self._mesh_parameters)

    def _generate(self, counter: int):
        if self._mode == "unstructured":
            pars = dict(self._mesh_parameters)
            for k in ("mesh_size_frac", "mesh_size_bound", "mesh_size_min"):
                if k in pars:
                    pars[k] = pars[k] / (2**counter)
            return self._network.mesh(pars)
        # Nested: refine the stored mdg by splitting.
        mdg = self._mdg
        for _ in range(counter):
            mdg = _refine_mdg_nested(mdg)
        return mdg


def _refine_mdg_nested(mdg):
    """One level of nested refinement of all subdomains (simplex 2d and 1d
    grids supported)."""
    from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid

    out = MixedDimensionalGrid()
    for sd in mdg.subdomains():
        if sd.dim == 2:
            new_sd, _ = refine_triangle_grid(sd)
        elif sd.dim == 1:
            new_sd = refine_grid_1d(sd)
        else:
            new_sd = sd.copy()
        new_sd.compute_geometry()
        out.add_subdomains(new_sd)
    return out
