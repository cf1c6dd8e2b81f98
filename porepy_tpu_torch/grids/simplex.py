"""Simplex grids: triangles (2d) and tetrahedra (3d).

Parity counterpart of reference ``grids/simplex.py:22,241,166,419``:
grids built from a point cloud plus connectivity (Delaunay if absent),
with structured right-triangle / six-tet-per-hex variants. Face ordering
and orientation conventions are matched so downstream discretizations are
bit-identical.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.grids.grid import Grid

__all__ = [
    "TriangleGrid",
    "TetrahedralGrid",
    "StructuredTriangleGrid",
    "StructuredTetrahedralGrid",
]


class TriangleGrid(Grid):
    """Triangular grid from points ``p (2|3, n_pts)`` and connectivity
    ``tri (3, n_cells)`` (counter-clockwise node order assumed; Delaunay
    applied when ``tri`` is None)."""

    def __init__(
        self,
        p: np.ndarray,
        tri: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        p = np.asarray(p, dtype=float)
        if tri is None:
            import scipy.spatial

            tri = scipy.spatial.Delaunay(p[:2].T).simplices.T
        tri = np.asarray(tri, dtype=int)
        if name is None:
            name = "TriangleGrid"
        num_nodes = p.shape[1]
        if num_nodes <= 2:
            raise ValueError("A triangle grid needs at least three points")
        nodes = np.vstack((p, np.zeros(num_nodes))) if p.shape[0] == 2 else p.copy()

        num_cells = tri.shape[1]
        # Faces of each triangle as directed node pairs, stacked so that the
        # first face of every cell comes first, then the second, etc.
        pairs = np.hstack((tri[[0, 1]], tri[[1, 2]], tri[[2, 0]])).T
        # Positive cell-face orientation when the traversal goes from low to
        # high node index.
        cf_sign = np.sign(pairs[:, 1] - pairs[:, 0]).astype(int)
        sorted_pairs = np.sort(pairs, axis=1)
        unique_faces, face_of_pair = np.unique(
            sorted_pairs, axis=0, return_inverse=True
        )
        face_of_pair = face_of_pair.ravel()
        num_faces = unique_faces.shape[0]

        # Consistency: the two neighbors of an interior face must carry
        # opposite signs. Flip the last occurrence where they do not (can
        # only happen for non-ccw input).
        weights = np.bincount(face_of_pair, weights=cf_sign, minlength=num_faces)
        for face in np.where(np.abs(weights) > 1)[0]:
            last = np.where(face_of_pair == face)[0][-1]
            cf_sign[last] = -cf_sign[last]

        indptr = np.arange(0, 2 * num_faces + 1, 2)
        face_nodes = sps.csc_matrix(
            (
                np.ones(2 * num_faces, dtype=bool),
                unique_faces.ravel(),
                indptr,
            ),
            shape=(num_nodes, num_faces),
        )

        # Cell-face map: pairs were stacked face-major, so reorder to
        # cell-major before assembling the csc structure.
        cf_indices = face_of_pair.reshape(3, num_cells).ravel("F")
        cf_data = cf_sign.reshape(3, num_cells).ravel("F")
        indptr = np.arange(0, 3 * num_cells + 1, 3)
        cell_faces = sps.csc_matrix(
            (cf_data, cf_indices, indptr), shape=(num_faces, num_cells)
        )
        super().__init__(2, nodes, face_nodes, cell_faces, name)

    def cell_node_matrix(self) -> np.ndarray:
        cn = self.face_nodes * np.abs(self.cell_faces) * sps.eye(self.num_cells)
        row, col = cn.nonzero()
        order = np.argsort(col)
        return row[order].reshape(self.num_cells, 3)


class StructuredTriangleGrid(TriangleGrid):
    """nx[0] x nx[1] quads, each split along the SW-NE diagonal."""

    def __init__(
        self,
        nx: np.ndarray,
        physdims: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        nx = np.asarray(nx, dtype=int)
        if nx.size != 2:
            raise ValueError("StructuredTriangleGrid is 2d")
        if name is None:
            name = "StructuredTriangleGrid"
        physdims = np.asarray(physdims if physdims is not None else nx, dtype=float)

        x = np.linspace(0, physdims[0], nx[0] + 1)
        y = np.linspace(0, physdims[1], nx[1] + 1)
        xc, yc = np.meshgrid(x, y)
        p = np.vstack((xc.ravel("C"), yc.ravel("C")))

        base = np.arange(nx[0])
        sw, se = base, base + 1
        ne, nw = nx[0] + 2 + base, nx[0] + 1 + base
        # Each quad yields (sw, se, ne) and (sw, ne, nw), interleaved so the
        # two triangles of the first quad are cells 0 and 1.
        tri_row = np.vstack((sw, se, ne, sw, ne, nw)).reshape((3, -1), order="F")
        rows = [tri_row + j * (nx[0] + 1) for j in range(nx[1])]
        super().__init__(p, np.hstack(rows), name=name)


class TetrahedralGrid(Grid):
    """Tetrahedral grid from points ``p (3, n_pts)`` and connectivity
    ``tet (4, n_cells)`` (Delaunay applied when ``tet`` is None). Node
    order per cell is permuted to a positive triple product."""

    def __init__(
        self,
        p: np.ndarray,
        tet: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        p = np.asarray(p, dtype=float)
        if tet is None:
            import scipy.spatial

            tet = scipy.spatial.Delaunay(p.T).simplices.T
        tet = np.asarray(tet, dtype=int).copy()
        if name is None:
            name = "TetrahedralGrid"
        num_nodes = p.shape[1]
        if num_nodes <= 3:
            raise ValueError("Not enough points to construct tetrahedral grid.")
        num_cells = tet.shape[1]

        # Enforce negative orientation by swapping the first two nodes of
        # positively-oriented cells (reference convention).
        v = self._triple_product(p, tet)
        flip = v > 0
        tet[:2, flip] = tet[1::-1, flip]

        # The four faces per cell, ordered and oriented so that outward
        # normals follow from the node traversal.
        quads = np.vstack(
            (tet[[1, 0, 2]], tet[[0, 1, 3]], tet[[2, 0, 3]], tet[[1, 2, 3]])
        ).reshape((3, 4 * num_cells), order="F")
        sort_ind = np.argsort(quads, axis=0)
        sorted_faces = np.sort(quads, axis=0)
        unique_faces, face_of_quad = np.unique(
            sorted_faces, axis=1, return_inverse=True
        )
        face_of_quad = face_of_quad.ravel("F")
        num_faces = unique_faces.shape[1]

        indptr = np.arange(0, 3 * num_faces + 1, 3)
        face_nodes = sps.csc_matrix(
            (
                np.ones(3 * num_faces, dtype=bool),
                unique_faces.ravel("F"),
                indptr,
            ),
            shape=(num_nodes, num_faces),
        )

        # Sign: cyclic (even) sort permutations traverse the face against
        # its stored orientation.
        data = np.ones(face_of_quad.shape, dtype=int)
        cyclic = np.any(np.diff(sort_ind, axis=0) == 1, axis=0)
        data[np.where(cyclic)[0]] = -1
        indptr = np.arange(0, 4 * num_cells + 1, 4)
        cell_faces = sps.csc_matrix(
            (data, face_of_quad, indptr), shape=(num_faces, num_cells)
        )
        super().__init__(3, p.copy(), face_nodes, cell_faces, name)

    @staticmethod
    def _triple_product(p: np.ndarray, t: np.ndarray) -> np.ndarray:
        x, y, z = p[0][t], p[1][t], p[2][t]
        dx, dy, dz = x[1:] - x[0], y[1:] - y[0], z[1:] - z[0]
        cx = dy[0] * dz[1] - dy[1] * dz[0]
        cy = dz[0] * dx[1] - dz[1] * dx[0]
        cz = dx[0] * dy[1] - dx[1] * dy[0]
        return dx[2] * cx + dy[2] * cy + dz[2] * cz


class StructuredTetrahedralGrid(TetrahedralGrid):
    """Cartesian box split into six tetrahedra per hex cell."""

    def __init__(
        self,
        nx: np.ndarray,
        physdims: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        nx = np.asarray(nx, dtype=int)
        if nx.size != 3:
            raise ValueError("StructuredTetrahedralGrid is 3d")
        if name is None:
            name = "StructuredTetrahedralGrid"
        physdims = np.asarray(physdims if physdims is not None else nx, dtype=float)

        x = np.linspace(0, physdims[0], nx[0] + 1)
        y = np.linspace(0, physdims[1], nx[1] + 1)
        z = np.linspace(0, physdims[2], nx[2] + 1)
        yc, xc, zc = np.meshgrid(y, x, z)
        p = np.vstack((xc.ravel("F"), yc.ravel("F"), zc.ravel("F")))

        base = np.arange(nx[0])
        i1, i2 = base, base + 1
        i3, i4 = nx[0] + 1 + base, nx[0] + 2 + base
        nxy = (nx[0] + 1) * (nx[1] + 1)
        i5, i6, i7, i8 = i1 + nxy, i2 + nxy, i3 + nxy, i4 + nxy
        # Six tets per hex (Kuhn subdivision pattern matching the reference).
        tet_base = np.vstack(
            (
                i1, i2, i3, i5,
                i2, i3, i5, i7,
                i2, i5, i6, i7,
                i2, i3, i4, i7,
                i2, i4, i6, i7,
                i4, i6, i7, i8,
            )
        ).reshape((4, -1), order="F")
        blocks = []
        for k in range(nx[2]):
            for j in range(nx[1]):
                blocks.append(tet_base + k * nxy + j * (nx[0] + 1))
        super().__init__(p, tet=np.hstack(blocks), name=name)
