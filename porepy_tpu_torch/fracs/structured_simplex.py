"""Fracture-conforming structured TETRAHEDRAL mixed-dimensional grids.

Native (gmsh-free) simplex meshing of axis-aligned rectangular fracture
networks in 3d: the host is a :class:`StructuredTetrahedralGrid` (six Kuhn
tetrahedra per lattice cube, consistent diagonals), so every axis-aligned
plane at a lattice coordinate is tiled by host triangle faces. Fracture
grids are :class:`TriangleGrid` subsets of those faces; 1d intersection and
0d crossing-point grids come from the shared lattice machinery
(:func:`porepy_tpu.fracs.structured.lattice_intersection_grids`), and the
generic ``subdomains_to_mdg`` pipeline (tag, couple by global node tuples,
split, build mortars) does the rest.

This is the in-image backend for the Berre et al. (2021) 3d benchmark case
2 (reference ``applications/md_grids/mdg_library.py:287`` meshes the same
geometry through gmsh; all nine fractures are axis-aligned, so a lattice
that resolves coordinate 1/16 meshes it conformingly with simplices).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs import meshing, structured
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.simplex import StructuredTetrahedralGrid, TriangleGrid

__all__ = ["tet_cart_grid"]


def tet_cart_grid(
    fracs: list[np.ndarray],
    nx: np.ndarray,
    physdims: Optional[list] = None,
    **kwargs,
) -> MixedDimensionalGrid:
    """Mixed-dimensional grid on a structured tetrahedral host.

    Parameters:
        fracs: Axis-aligned rectangles, each ``(3, 4)``; every coordinate
            must lie on the lattice defined by ``nx``/``physdims``.
        nx: Number of lattice cubes per axis (each becomes 6 tets).
        physdims: Physical box dimensions (default: unit per axis).
    """
    return meshing.subdomains_to_mdg(
        tet_subdomain_lists(fracs, nx, physdims), **kwargs
    )


def tet_subdomain_lists(
    fracs: list[np.ndarray],
    nx: np.ndarray,
    physdims: Optional[list] = None,
) -> list[list]:
    """The pristine (pre-split) per-dimension subdomain grid lists of
    :func:`tet_cart_grid` — also consumed directly by parity tests that
    mirror the identical mesh into the reference framework."""
    nx = np.asarray(nx, dtype=int)
    g_3d = StructuredTetrahedralGrid(nx, physdims=physdims)
    g_3d.global_point_ind = np.arange(g_3d.num_nodes)
    g_3d.compute_geometry()

    fn = g_3d.face_nodes.tocsc()
    face_nodes = fn.indices.reshape((3, g_3d.num_faces), order="F")

    g_2d: list = []
    frac_nodes_list: list[np.ndarray] = []
    for fi, f in enumerate(fracs):
        f = np.asarray(f, dtype=float)
        if f.shape != (3, 4):
            raise ValueError("3d fractures must be (3, 4) rectangles")
        const_axis = [a for a in range(3) if np.allclose(f[a], f[a, 0])]
        if len(const_axis) != 1:
            raise ValueError("Fracture rectangle must be axis-aligned")
        axis = const_axis[0]
        in_plane = [a for a in range(3) if a != axis]
        if not np.any(
            np.abs(np.unique(g_3d.nodes[axis]) - f[axis, 0]) < 1e-10
        ):
            raise ValueError(
                f"Fracture plane {f[axis, 0]} does not lie on the lattice; "
                "refine nx so every fracture coordinate is a lattice plane"
            )

        mask = structured._nodes_in_rectangle(g_3d, f, axis, in_plane)
        in_frac = np.flatnonzero(mask[face_nodes].all(axis=0))
        if in_frac.size == 0:
            raise ValueError(f"Fracture {fi} matches no lattice faces")
        tri_glob = face_nodes[:, in_frac]
        used = np.unique(tri_glob)
        local = np.full(g_3d.num_nodes, -1, dtype=int)
        local[used] = np.arange(used.size)
        tri = local[tri_glob]
        pts = g_3d.nodes[:, used]

        # Counter-clockwise connectivity in the projected plane.
        p2 = pts[in_plane]
        v1 = p2[:, tri[1]] - p2[:, tri[0]]
        v2 = p2[:, tri[2]] - p2[:, tri[0]]
        cw = v1[0] * v2[1] - v1[1] * v2[0] < 0
        tri[1:, cw] = tri[:0:-1, cw]

        g = TriangleGrid(pts, tri)
        g.global_point_ind = used
        g.frac_num = fi
        g.compute_geometry()
        g_2d.append(g)
        frac_nodes_list.append(used)

    g_1d, g_0d = structured.lattice_intersection_grids(g_3d, frac_nodes_list)
    return [[g_3d], g_2d, g_1d, g_0d]
