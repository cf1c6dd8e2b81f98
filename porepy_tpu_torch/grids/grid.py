"""Core unstructured polytopal grid.

Design notes (TPU-first)
------------------------
Grid construction and geometry computation are *host-side, setup-time* work:
irregular, pointer-heavy, executed once per mesh. They therefore run in
numpy/scipy on the host, exactly like meshing. Everything that runs per
Newton iteration consumes the static-shape index arrays exported by
:meth:`Grid.fv_arrays` (see ``porepy_tpu/numerics/fv/mesh.py``), which live
on device as jax arrays.

Behavioral parity: the grid data model matches the reference framework
(``/root/reference/src/porepy/grids/grid.py:32``): topology is stored as
scipy CSC incidence matrices ``cell_faces`` (signed; the transpose is the
divergence operator) and ``face_nodes`` (column order of node indices is
meaningful and defines face orientation), node coordinates are always
``(3, num_nodes)``, and ``compute_geometry`` produces area-weighted face
normals whose direction is consistent with the ``cell_faces`` signs
(``+1`` = normal points out of the cell).

Geometric quantities follow the classical MRST-style sub-simplex
decomposition (cf. reference ``grids/grid.py:362-777``): faces and cells are
split into triangles/tetrahedra around temporary centroids; centroids and
volumes are area/volume-weighted sums over the decomposition. This
definition is required for parity with reference-computed discretizations.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["Grid"]

_counter = itertools.count()


class Grid:
    """Unstructured polytopal grid in 0-3 dimensions, possibly embedded in 3d.

    Parameters:
        dim: Topological dimension of the grid (0-3).
        nodes: ``(3, num_nodes)`` node coordinates.
        face_nodes: ``(num_nodes, num_faces)`` bool CSC incidence matrix. The
            per-column index order is significant: in 2d it is (start, end)
            defining the face tangent; in 3d it is the circular order of the
            polygon's vertices.
        cell_faces: ``(num_faces, num_cells)`` signed int CSC incidence
            matrix; +1 if the face normal points out of the cell.
        name: Human-readable grid name.
        history: Optional provenance strings.
    """

    def __init__(
        self,
        dim: int,
        nodes: np.ndarray,
        face_nodes: sps.csc_matrix,
        cell_faces: sps.csc_matrix,
        name: str = "Grid",
        history: Optional[list[str]] = None,
        external_tags: Optional[dict[str, np.ndarray]] = None,
    ) -> None:
        if dim not in (0, 1, 2, 3):
            raise ValueError("A grid has to be 0, 1, 2 or 3-dimensional")
        self.dim: int = dim
        self.nodes: np.ndarray = np.asarray(nodes, dtype=float)
        if self.nodes.ndim != 2 or self.nodes.shape[0] != 3:
            raise ValueError("nodes must have shape (3, num_nodes)")
        self.face_nodes: sps.csc_matrix = sps.csc_matrix(face_nodes, dtype=bool)
        self.cell_faces: sps.csc_matrix = sps.csc_matrix(cell_faces)
        self.name: str = name
        self.history: list[str] = list(history) if history is not None else [name]

        self.num_nodes: int = self.nodes.shape[1]
        self.num_faces: int = self.face_nodes.shape[1]
        self.num_cells: int = self.cell_faces.shape[1]

        # Geometry fields; filled by compute_geometry().
        self.cell_centers: np.ndarray
        self.cell_volumes: np.ndarray
        self.face_centers: np.ndarray
        self.face_normals: np.ndarray  # area-weighted
        self.face_areas: np.ndarray

        # Identity of nodes in an original "mother" grid; updated by fracture
        # splitting and mixed-dimensional bookkeeping.
        self.global_point_ind: np.ndarray = np.arange(self.num_nodes)

        # Pairs of faces created by splitting along fractures (set by
        # fracs.split_grid); empty for unsplit grids.
        self.frac_pairs: np.ndarray = np.zeros((2, 0), dtype=int)

        # Index of the fracture this grid represents (lower-dim grids only).
        self.frac_num: int = -1

        # Periodic face map, set via set_periodic_map.
        self.periodic_face_map: np.ndarray = np.zeros((2, 0), dtype=int)

        self.tags: dict[str, np.ndarray] = {}
        if external_tags is not None:
            self.tags = dict(external_tags)
            self._check_tags()
        else:
            self.initiate_face_tags()
            self.update_boundary_face_tag()
            self.initiate_node_tags()
            self.update_boundary_node_tag()

        self._id: int = next(_counter)

    # -- identity / copies -------------------------------------------------

    @property
    def id(self) -> int:
        """Unique id of this grid instance (counter-based)."""
        return self._id

    def copy(self) -> "Grid":
        h = self.copy_without_geometry()
        for attr in (
            "cell_centers",
            "cell_volumes",
            "face_centers",
            "face_normals",
            "face_areas",
        ):
            if hasattr(self, attr):
                setattr(h, attr, getattr(self, attr).copy())
        return h

    def copy_without_geometry(self) -> "Grid":
        h = Grid(
            self.dim,
            self.nodes.copy(),
            self.face_nodes.copy(),
            self.cell_faces.copy(),
            self.name,
            list(self.history),
        )
        h.tags = {
            k: v.copy() if hasattr(v, "copy") else v
            for k, v in self.tags.items()
        }
        h.global_point_ind = self.global_point_ind.copy()
        h.frac_pairs = self.frac_pairs.copy()
        h.frac_num = self.frac_num
        return h

    def __repr__(self) -> str:
        s = (
            f"{self.__class__.__name__}(dim={self.dim}, cells={self.num_cells}, "
            f"faces={self.num_faces}, nodes={self.num_nodes})"
        )
        return s

    __str__ = __repr__

    # -- geometry -----------------------------------------------------------

    def compute_geometry(self) -> None:
        """Compute face areas/centers/normals and cell volumes/centers.

        Face normals are area weighted and point out of the cell with a +1
        entry in ``cell_faces`` (parity with reference
        ``grids/grid.py:362``).
        """
        self.history.append("Compute geometry")
        if self.dim == 0:
            self._geometry_0d()
        elif self.dim == 1:
            self._geometry_1d()
        elif self.dim == 2:
            self._geometry_2d()
        else:
            self._geometry_3d()

    def _geometry_0d(self) -> None:
        self.face_areas = np.zeros(0)
        self.face_centers = self.nodes
        self.face_normals = np.zeros((3, 0))
        self.cell_volumes = np.ones(self.num_cells)
        if not hasattr(self, "cell_centers"):
            raise ValueError("0d grid needs externally assigned cell_centers")

    def _geometry_1d(self) -> None:
        from porepy_tpu_torch.geometry import map_geometry

        self.face_areas = np.ones(self.num_faces)
        fn = self.face_nodes.indices
        self.face_centers = self.nodes[:, fn]

        tangent = map_geometry.compute_tangent(self.nodes)
        self.face_normals = np.tile(tangent, (fn.size, 1)).T

        cf = self.cell_faces.indices
        xf0 = self.face_centers[:, cf[::2]]
        xf1 = self.face_centers[:, cf[1::2]]
        self.cell_volumes = np.linalg.norm(xf1 - xf0, axis=0)
        self.cell_centers = 0.5 * (xf0 + xf1)

        # Flip normals that disagree with the cell_faces sign convention:
        # a face normal must point away from the cell that carries +1.
        fi, ci, sgn = sps.find(self.cell_faces)
        # One (cell, sign) sample per face suffices.
        _, first = np.unique(fi, return_index=True)
        v = self.face_centers[:, fi[first]] - self.cell_centers[:, ci[first]]
        outward = np.einsum("ij,ij->j", v, self.face_normals[:, fi[first]]) > 0
        flip = outward != (sgn[first] > 0)
        self.face_normals[:, fi[first][flip]] *= -1.0

    def _geometry_2d(self) -> None:
        """2d geometry, also for planes embedded in 3d.

        Faces are segments; the area-weighted normal is the tangent rotated
        90 degrees within the grid plane. Cells are polygons, decomposed
        into triangles spanned by each face and a temporary cell center.
        Assumes consistently oriented cell boundaries (all grids produced by
        this package are) with a convex-cell fallback.
        """
        from porepy_tpu_torch.geometry import map_geometry

        nn = self.num_nodes

        # Signed face-node orientation: -1 at start node, +1 at end node of
        # each face (column order in face_nodes carries the orientation).
        fn = self.face_nodes
        start = fn.indices[::2]
        end = fn.indices[1::2]
        tangent = self.nodes[:, end] - self.nodes[:, start]
        self.face_areas = np.linalg.norm(tangent, axis=0)
        self.face_centers = 0.5 * (self.nodes[:, start] + self.nodes[:, end])

        fi, ci, cf_sgn = sps.find(self.cell_faces)
        order = np.argsort(ci, kind="stable")
        fi, ci, cf_sgn = fi[order], ci[order], cf_sgn[order]

        n_per_cell = np.bincount(ci, minlength=self.num_cells)
        tmp_cc = np.vstack(
            [
                np.bincount(ci, weights=self.face_centers[d, fi], minlength=self.num_cells)
                for d in range(3)
            ]
        ) / n_per_cell

        # Sub-triangle (cell-center, face) normals: 0.5 * h x (sgn * t).
        heights = self.face_centers[:, fi] - tmp_cc[:, ci]
        sub_normals = 0.5 * np.cross(heights, cf_sgn * tangent[:, fi], axis=0)

        # Loop-orientation check: every cell boundary should be a closed,
        # consistently oriented node loop. Net signed node incidence == 0.
        fn_sgn = fn.astype(np.int8).copy()
        fn_sgn.data = np.where(np.arange(fn_sgn.data.size) % 2 == 0, -1, 1).astype(
            np.int8
        )
        is_oriented = (fn_sgn @ self.cell_faces).nnz == 0

        plane_normal = None
        if is_oriented:
            pn = sub_normals.sum(axis=1)
            ln = np.linalg.norm(pn)
            if ln >= 1e-5 * np.mean(self.face_areas) ** 2:
                plane_normal = pn / ln
            else:
                is_oriented = False
        if plane_normal is None:
            plane_normal = map_geometry.compute_normal(self.nodes)

        # Face normal = tangent rotated into the plane (area weighted since
        # tangent has length face_area).
        self.face_normals = np.cross(tangent, plane_normal, axis=0)

        if is_oriented:
            sub_volumes = plane_normal @ sub_normals
            cell_volumes = np.bincount(ci, weights=sub_volumes, minlength=self.num_cells)
            if np.any(cell_volumes < 0):
                is_oriented = False
        if not is_oriented:
            # Convex/star-shaped fallback: unsigned areas; flip face normals
            # that disagree with the cell_faces sign convention.
            sub_volumes = np.linalg.norm(sub_normals, axis=0)
            disagree = (
                cf_sgn
                * np.einsum("ij,ij->j", heights, self.face_normals[:, fi])
            ) < 0
            flip = np.bincount(fi, weights=disagree, minlength=self.num_faces) > 0
            self.face_normals[:, flip] *= -1.0
            cell_volumes = np.bincount(ci, weights=sub_volumes, minlength=self.num_cells)

        self.cell_volumes = cell_volumes
        assert np.all(self.cell_volumes >= 0)

        sub_centroids = (tmp_cc[:, ci] + 2.0 * self.face_centers[:, fi]) / 3.0
        self.cell_centers = (
            np.vstack(
                [
                    np.bincount(
                        ci, weights=sub_volumes * sub_centroids[d], minlength=self.num_cells
                    )
                    for d in range(3)
                ]
            )
            / self.cell_volumes
        )
        _ = nn  # silence linters; kept for symmetry with other dims

    def _geometry_3d(self) -> None:
        """3d geometry via triangulation of faces about their node mean and
        tetrahedral decomposition of cells about their face-center mean.

        Mirrors the MRST-style definitions used by the reference
        (``grids/grid.py:584-777``) so that centroids/volumes agree to
        machine precision.
        """
        fn_ptr = self.face_nodes.indptr
        fn_ind = self.face_nodes.indices
        n_fn = fn_ind.size
        nodes_per_face = np.diff(fn_ptr)

        # Parent face of each face-node entry; each entry doubles as the edge
        # (node_i -> node_{i+1 cyclic within the face}).
        edge_face = np.repeat(np.arange(self.num_faces), nodes_per_face)
        nxt = np.arange(n_fn) + 1
        nxt[fn_ptr[1:] - 1] = fn_ptr[:-1]

        p0 = self.nodes[:, fn_ind]
        p1 = self.nodes[:, fn_ind[nxt]]

        # Temporary face centers: node means.
        tmp_fc = np.vstack(
            [
                np.bincount(edge_face, weights=p0[d], minlength=self.num_faces)
                for d in range(3)
            ]
        ) / nodes_per_face

        along = p1 - p0
        to_center = tmp_fc[:, edge_face] - p0
        # Triangle (p0, p1, tmp_fc) normal following circulation p0 -> p1.
        sub_normals = 0.5 * np.cross(along, to_center, axis=0)

        sub_areas = np.linalg.norm(sub_normals, axis=0)
        sub_centroids = (p0 + p1 + tmp_fc[:, edge_face]) / 3.0

        face_normals = np.vstack(
            [
                np.bincount(edge_face, weights=sub_normals[d], minlength=self.num_faces)
                for d in range(3)
            ]
        )
        face_areas = np.bincount(edge_face, weights=sub_areas, minlength=self.num_faces)
        sub_sign = np.sign(
            np.einsum("ij,ij->j", sub_normals, face_normals[:, edge_face])
        )
        face_centers = (
            np.vstack(
                [
                    np.bincount(
                        edge_face,
                        weights=sub_areas * sub_centroids[d],
                        minlength=self.num_faces,
                    )
                    for d in range(3)
                ]
            )
            / face_areas
        )

        self.face_normals = face_normals
        self.face_areas = face_areas
        self.face_centers = face_centers

        # Cells: iterate edges as seen from each adjacent cell.
        cf = self.cell_faces
        fi, ci, orientation = sps.find(cf)
        # Expand each (face, cell) pair to its edges.
        npf = nodes_per_face[fi]
        cell_of_edge = np.repeat(ci, npf)
        orient_of_edge = np.repeat(orientation, npf)
        # Edge ids within each face: fn_ptr[f] .. fn_ptr[f+1]
        edge_of_pair = (
            np.repeat(fn_ptr[fi], npf)
            + _ranges(npf)
        )
        face_of_edge = edge_face[edge_of_pair]

        n_cell_edges = np.bincount(cell_of_edge, minlength=self.num_cells)
        tmp_cc = np.vstack(
            [
                np.bincount(
                    cell_of_edge,
                    weights=face_centers[d, face_of_edge] / n_cell_edges[cell_of_edge],
                    minlength=self.num_cells,
                )
                for d in range(3)
            ]
        )

        dist = sub_centroids[:, edge_of_pair] - tmp_cc[:, cell_of_edge]
        outer = (
            sub_normals[:, edge_of_pair]
            * orient_of_edge
            * sub_sign[edge_of_pair]
        )
        tet_volumes = np.einsum("ij,ij->j", dist, outer) / 3.0
        if not np.all(tet_volumes > -1e-12):
            raise ValueError("Some tetrahedra have negative volume")

        cell_volumes = np.bincount(cell_of_edge, weights=tet_volumes, minlength=self.num_cells)
        tri_centroids = 0.75 * dist
        rel = (
            np.vstack(
                [
                    np.bincount(
                        cell_of_edge,
                        weights=tet_volumes * tri_centroids[d],
                        minlength=self.num_cells,
                    )
                    for d in range(3)
                ]
            )
            / cell_volumes
        )
        self.cell_centers = tmp_cc + rel
        self.cell_volumes = cell_volumes

    # -- topology queries ----------------------------------------------------

    def cell_nodes(self) -> sps.csc_matrix:
        """``(num_nodes, num_cells)`` bool map from cells to their nodes."""
        return ((self.face_nodes @ abs(self.cell_faces)) > 0).tocsc()

    def num_cell_nodes(self) -> np.ndarray:
        return np.asarray(self.cell_nodes().sum(axis=0)).ravel()

    def cell_faces_as_dense(self) -> np.ndarray:
        """Neighbor representation: ``(2, num_faces)`` array of cell indices.

        Row 0 holds the cell behind the face (normal points away from it,
        ``cell_faces`` entry +1), row 1 the cell in front; missing neighbors
        are -1.
        """
        n = self.cell_faces.tocsr()
        fi = np.repeat(np.arange(self.num_faces), np.diff(n.indptr))
        out = -np.ones((2, self.num_faces), dtype=int)
        # Entry +1: normal out of cell -> cell is "behind" the face (row 0).
        pos = n.data > 0
        out[0, fi[pos]] = n.indices[pos]
        out[1, fi[~pos]] = n.indices[~pos]
        return out

    def cell_connection_map(self) -> sps.csr_matrix:
        """Symmetric bool ``(num_cells, num_cells)`` cell-adjacency (via faces)."""
        cf = abs(self.cell_faces)
        c2c = (cf.T @ cf) > 0
        return c2c.tocsr()

    def signs_and_cells_of_boundary_faces(
        self, faces: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """For boundary faces, the sign of the (outward) normal and the
        neighboring cell."""
        fi, ci, sgn = sps.find(self.cell_faces[faces])
        if fi.size != faces.size:
            raise ValueError("signs_and_cells_of_boundary_faces: not boundary faces")
        order = np.argsort(fi, kind="stable")
        return sgn[order], ci[order]

    def divergence(self, dim: int = 1) -> sps.csr_matrix:
        """Divergence operator: ``(num_cells*dim, num_faces*dim)``.

        For dim=1 this is ``cell_faces.T``; for vector problems the scalar
        operator is Kronecker-expanded.
        """
        div = self.cell_faces.T.tocsr()
        if dim == 1:
            return div
        return sps.kron(div, sps.eye(dim)).tocsr()

    def trace(self, dim: int = 1) -> sps.csr_matrix:
        """Map cell values onto all boundary faces (fracture/tip/domain),
        Kronecker-expanded for vector quantities.

        Dimensions: ``dim * (num_faces, num_cells)``; parity with reference
        ``grids/grid.py:1268``.
        """
        bound_faces = self.get_all_boundary_faces()
        _, bound_cells = self.signs_and_cells_of_boundary_faces(bound_faces)
        rows = (bound_faces[:, None] * dim + np.arange(dim)).ravel()
        cols = (bound_cells[:, None] * dim + np.arange(dim)).ravel()
        return sps.coo_matrix(
            (np.ones(rows.size), (rows, cols)),
            shape=(self.num_faces * dim, self.num_cells * dim),
        ).tocsr()

    # -- boundaries & tags ----------------------------------------------------

    def initiate_face_tags(self) -> None:
        for key in cc.FACE_TAG_KEYS:
            self.tags[key] = np.zeros(self.num_faces, dtype=bool)

    def initiate_node_tags(self) -> None:
        for key in cc.NODE_TAG_KEYS:
            self.tags[key] = np.zeros(self.num_nodes, dtype=bool)

    def update_boundary_face_tag(self) -> None:
        self.tags["domain_boundary_faces"] = np.zeros(self.num_faces, dtype=bool)
        if self.dim > 0:
            csr = self.cell_faces.tocsr()
            bnd = np.diff(csr.indptr) == 1
            self.tags["domain_boundary_faces"][bnd] = True

    def update_boundary_node_tag(self) -> None:
        self.tags["domain_boundary_nodes"] = np.zeros(self.num_nodes, dtype=bool)
        for face_key, node_key in zip(cc.FACE_TAG_KEYS, cc.NODE_TAG_KEYS):
            faces = np.where(self.tags[face_key])[0]
            if faces.size:
                sub = self.face_nodes[:, faces]
                self.tags[node_key] = np.zeros(self.num_nodes, dtype=bool)
                self.tags[node_key][sub.indices] = True

    def get_all_boundary_faces(self) -> np.ndarray:
        t = self.tags
        return np.where(
            t["domain_boundary_faces"] | t["fracture_faces"] | t["tip_faces"]
        )[0]

    def get_all_boundary_nodes(self) -> np.ndarray:
        t = self.tags
        return np.where(
            t["domain_boundary_nodes"] | t["fracture_nodes"] | t["tip_nodes"]
        )[0]

    def get_boundary_faces(self) -> np.ndarray:
        return np.where(self.tags["domain_boundary_faces"])[0]

    def get_internal_faces(self) -> np.ndarray:
        return np.setdiff1d(
            np.arange(self.num_faces), self.get_all_boundary_faces(), assume_unique=True
        )

    def get_boundary_nodes(self) -> np.ndarray:
        return np.where(self.tags["domain_boundary_nodes"])[0]

    def set_periodic_map(self, periodic_face_map: np.ndarray) -> None:
        if periodic_face_map.ndim != 2 or periodic_face_map.shape[0] != 2:
            raise ValueError("periodic_face_map must have shape (2, n)")
        if np.any(periodic_face_map < 0):
            raise ValueError("periodic_face_map must be non-negative")
        self.periodic_face_map = periodic_face_map.copy()
        self.tags["domain_boundary_faces"][periodic_face_map.ravel()] = False

    # -- misc -----------------------------------------------------------------

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        return self.nodes.min(axis=1), self.nodes.max(axis=1)

    def cell_diameters(self) -> np.ndarray:
        """Maximum vertex-vertex distance per cell."""
        cn = self.cell_nodes()
        out = np.zeros(self.num_cells)
        for c in range(self.num_cells):
            pts = self.nodes[:, cn.indices[cn.indptr[c] : cn.indptr[c + 1]]]
            d = pts[:, :, None] - pts[:, None, :]
            out[c] = np.sqrt((d**2).sum(axis=0)).max()
        return out

    def closest_cell(self, p: np.ndarray) -> np.ndarray:
        """Index of cell with center closest to each point column in ``p``."""
        p = np.atleast_2d(p)
        if p.shape[0] < 3:
            p = np.vstack([p, np.zeros((3 - p.shape[0], p.shape[1]))])
        d = (
            (self.cell_centers[:, :, None] - p[:, None, :]) ** 2
        ).sum(axis=0)
        return np.argmin(d, axis=0)

    def _check_tags(self) -> None:
        for key in cc.FACE_TAG_KEYS:
            if key not in self.tags or self.tags[key].size != self.num_faces:
                raise ValueError(f"Inconsistent face tag {key}")
        for key in cc.NODE_TAG_KEYS:
            if key not in self.tags or self.tags[key].size != self.num_nodes:
                raise ValueError(f"Inconsistent node tag {key}")


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(c) for c in counts]`` without a Python loop."""
    counts = np.asarray(counts)
    if counts.size == 0:
        return np.zeros(0, dtype=int)
    total = int(counts.sum())
    starts = np.zeros(total, dtype=int)
    ends = np.cumsum(counts)
    starts[ends[:-1]] = counts[:-1]
    return np.arange(total) - np.cumsum(starts)
