"""Native simplex meshing of 2d fractured domains.

The reference meshes fracture networks through gmsh (reference
``fracs/simplex.py:82``, ``fracs/gmsh_interface.py:305``,
``fracs/msh_2_grid.py:40``). gmsh is not installable in this image, so this
module provides the documented native fallback: a **conforming constrained
Delaunay triangulation** built from

1. sized point samples along the fracture polylines (split at mutual
   intersections so crossings/T-junctions become shared sample points),
2. sized samples along the domain-boundary box (including any fracture
   endpoints that touch it), and
3. a hexagonal background lattice, cleared in a protection band around the
   constraints,

followed by scipy Delaunay and a midpoint-insertion recovery loop for any
constraint edge the triangulation misses. The output feeds the same
md-assembly machinery as the structured path
(``fracs/meshing.py::subdomains_to_mdg``): a ``TriangleGrid`` with global
node indices, embedded 1d fracture grids along the recovered node chains,
and 0d point grids at fracture intersections.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs import msh_2_grid
from porepy_tpu_torch.geometry.intersections import split_intersecting_segments_2d
from porepy_tpu_torch.grids.point_grid import PointGrid
from porepy_tpu_torch.grids.simplex import TriangleGrid

__all__ = [
    "triangle_grid_fractured_2d",
    "triangle_grid_from_gmsh",
    "ConformingTriangulation2d",
]


def triangle_grid_from_gmsh(file_name: str):
    """Read a gmsh ``.msh`` file into per-dimension grid lists (native MSH
    4.1 parser; reference ``fracs/simplex.py:82`` uses gmsh/meshio)."""
    return msh_2_grid.create_grids_from_msh(file_name)


class ConformingTriangulation2d:
    """Builder for the fractured-domain triangulation. Collects the sized
    point samples, runs Delaunay, recovers constraint edges, and exposes the
    per-fracture node chains."""

    def __init__(
        self,
        domain_box: dict,
        frac_pts: np.ndarray,
        frac_edges: np.ndarray,
        mesh_size_frac: float,
        mesh_size_bound: Optional[float] = None,
        tol: float = 1e-8,
    ) -> None:
        self.box = domain_box
        self.h_frac = float(mesh_size_frac)
        self.h_bound = float(mesh_size_bound or mesh_size_frac)
        self.tol = tol
        self.frac_pts = np.asarray(frac_pts, dtype=float)
        self.frac_edges = np.asarray(frac_edges, dtype=int)

    # -- point sampling --------------------------------------------------------

    def _split_constraints(self):
        """Split fracture segments at mutual intersections; returns the split
        point set and edges tagged with the original fracture index."""
        e = np.vstack(
            [self.frac_edges[:2], np.arange(self.frac_edges.shape[1])]
        )
        up, ne, _tags = split_intersecting_segments_2d(
            self.frac_pts, e, tol=self.tol
        )
        return up, ne

    def build(self):
        box = self.box
        x0, x1 = box["xmin"], box["xmax"]
        y0, y1 = box["ymin"], box["ymax"]
        h = self.h_frac
        hb = self.h_bound

        up, ne = (
            self._split_constraints()
            if self.frac_edges.size
            else (np.zeros((2, 0)), np.zeros((3, 0), dtype=int))
        )
        pts = [up]
        next_id = up.shape[1]

        # Fracture subsegment chains: endpoint ids + interior samples.
        chains: list[dict] = []
        for si in range(ne.shape[1]):
            a, b = ne[0, si], ne[1, si]
            pa, pb = up[:, a], up[:, b]
            length = np.linalg.norm(pb - pa)
            k = max(1, int(round(length / h)))
            t = np.linspace(0.0, 1.0, k + 1)[1:-1]
            interior = pa[:, None] + t[None, :] * (pb - pa)[:, None]
            ids = list(range(next_id, next_id + interior.shape[1]))
            next_id += interior.shape[1]
            pts.append(interior)
            chains.append(
                {"nodes": [int(a)] + ids + [int(b)], "frac": int(ne[2, si])}
            )

        # Domain boundary chains (fracture points on a side join its chain).
        corners = np.array(
            [[x0, x1, x1, x0], [y0, y0, y1, y1]], dtype=float
        )
        corner_ids = list(range(next_id, next_id + 4))
        next_id += 4
        pts.append(corners)
        constraint_pts = np.hstack(pts[:-1]) if len(pts) > 1 else up
        sides = [
            (corner_ids[0], corner_ids[1], 1, y0),  # south: vary x at y0
            (corner_ids[1], corner_ids[2], 0, x1),  # east
            (corner_ids[2], corner_ids[3], 1, y1),  # north
            (corner_ids[3], corner_ids[0], 0, x0),  # west
        ]
        boundary_chains = []
        for ca, cb, fixed_ax, fixed_val in sides:
            var_ax = 1 - fixed_ax
            va = corners[var_ax, ca - corner_ids[0]]
            vb = corners[var_ax, cb - corner_ids[0]]
            lo, hi_ = min(va, vb), max(va, vb)
            k = max(1, int(round(abs(vb - va) / hb)))
            s = np.linspace(va, vb, k + 1)[1:-1]
            side_pts = np.zeros((2, s.size))
            side_pts[var_ax] = s
            side_pts[fixed_ax] = fixed_val
            # Fracture points lying on this side (touching fractures).
            on_side = np.where(
                (np.abs(constraint_pts[fixed_ax] - fixed_val) < self.tol)
                & (constraint_pts[var_ax] > lo - self.tol)
                & (constraint_pts[var_ax] < hi_ + self.tol)
            )[0]
            # Drop side samples too close to a touching fracture point.
            if on_side.size and s.size:
                d = np.abs(
                    side_pts[var_ax][:, None]
                    - constraint_pts[var_ax, on_side][None, :]
                )
                keep = d.min(axis=1) > 0.5 * hb
                side_pts = side_pts[:, keep]
            ids = list(range(next_id, next_id + side_pts.shape[1]))
            next_id += side_pts.shape[1]
            pts.append(side_pts)
            chain_ids = np.array([ca] + ids + [cb] + list(on_side), dtype=int)
            all_pts_so_far = np.hstack(pts)
            order = np.argsort(
                np.sign(vb - va) * all_pts_so_far[var_ax, chain_ids]
            )
            boundary_chains.append({"nodes": chain_ids[order].tolist()})

        # Hexagonal background lattice, cleared near constraints/boundary.
        all_constraint = np.hstack(pts)
        nx = max(2, int(round((x1 - x0) / h)))
        ny = max(2, int(round((y1 - y0) / (h * np.sqrt(3) / 2))))
        xs = np.linspace(x0, x1, nx + 1)
        ys = np.linspace(y0, y1, ny + 1)
        X, Y = np.meshgrid(xs, ys)
        X[1::2] += 0.5 * (xs[1] - xs[0])
        bg = np.vstack([X.ravel(), Y.ravel()])
        inside = (
            (bg[0] > x0 + 0.55 * hb)
            & (bg[0] < x1 - 0.55 * hb)
            & (bg[1] > y0 + 0.55 * hb)
            & (bg[1] < y1 - 0.55 * hb)
        )
        bg = bg[:, inside]
        if ne.shape[1]:
            dmin = np.full(bg.shape[1], np.inf)
            for si in range(ne.shape[1]):
                pa = up[:, ne[0, si]][:, None]
                pb = up[:, ne[1, si]][:, None]
                line = pb - pa
                len2 = float(line[0, 0] ** 2 + line[1, 0] ** 2)
                t = np.clip(
                    ((bg - pa) * line).sum(axis=0) / max(len2, 1e-300), 0, 1
                )
                nearest = pa + t[None, :] * line
                d = np.sqrt(((bg - nearest) ** 2).sum(axis=0))
                dmin = np.minimum(dmin, d)
            bg = bg[:, dmin > 0.6 * h]
        pts.append(bg)

        self.points = np.hstack(pts)
        self.chains = chains
        self.boundary_chains = boundary_chains
        self._dedupe()
        self._triangulate_with_recovery()
        return self

    def _dedupe(self):
        """Merge near-coincident points and remap all chains."""
        from porepy_tpu_torch.utils.array_operations import uniquify_point_set

        upts, _keep, inverse = uniquify_point_set(self.points, self.tol)
        self.points = upts
        for c in self.chains + self.boundary_chains:
            nodes = [int(inverse[i]) for i in c["nodes"]]
            c["nodes"] = [
                n for k, n in enumerate(nodes) if k == 0 or n != nodes[k - 1]
            ]

    def _triangulate_with_recovery(self, max_rounds: int = 12):
        import scipy.spatial

        for _round in range(max_rounds):
            tri = scipy.spatial.Delaunay(self.points.T)
            simplices = tri.simplices
            edges = set()
            for i, j in ((0, 1), (1, 2), (0, 2)):
                for a, b in zip(simplices[:, i], simplices[:, j]):
                    edges.add((min(a, b), max(a, b)))
            missing = []
            for c in self.chains + self.boundary_chains:
                nodes = c["nodes"]
                for a, b in zip(nodes[:-1], nodes[1:]):
                    if (min(a, b), max(a, b)) not in edges:
                        missing.append((c, a, b))
            if not missing:
                self.simplices = simplices
                return
            for c, a, b in missing:
                mid = 0.5 * (self.points[:, a] + self.points[:, b])
                new_id = self.points.shape[1]
                self.points = np.hstack([self.points, mid[:, None]])
                nodes = c["nodes"]
                pos = nodes.index(a)
                # a and b are consecutive (possibly b before a).
                if nodes[pos + 1 if pos + 1 < len(nodes) else pos] != b:
                    pos = nodes.index(b)
                nodes.insert(pos + 1, new_id)
        raise RuntimeError(
            "Constraint edge recovery did not converge; refine mesh size or "
            "check the fracture geometry for near-degenerate features"
        )


def triangle_grid_fractured_2d(
    domain_box: dict,
    frac_pts: np.ndarray,
    frac_edges: np.ndarray,
    mesh_size_frac: float,
    mesh_size_bound: Optional[float] = None,
    tol: float = 1e-8,
) -> list[list]:
    """Per-dimension grid lists ``[[g_2d], g_1d, g_0d]`` for
    ``fracs.meshing.subdomains_to_mdg``, from a conforming constrained
    Delaunay triangulation of the fractured box domain."""
    builder = ConformingTriangulation2d(
        domain_box, frac_pts, frac_edges, mesh_size_frac, mesh_size_bound, tol
    ).build()

    p = builder.points
    tri = builder.simplices.T
    # Enforce counter-clockwise orientation (TriangleGrid contract).
    v1 = p[:, tri[1]] - p[:, tri[0]]
    v2 = p[:, tri[2]] - p[:, tri[0]]
    cw = (v1[0] * v2[1] - v1[1] * v2[0]) < 0
    tri[1, cw], tri[2, cw] = tri[2, cw], tri[1, cw]

    g_2d = TriangleGrid(p, tri)
    g_2d.global_point_ind = np.arange(g_2d.num_nodes)
    g_2d.compute_geometry()

    # One 1d grid per original fracture, spanning all its subsegment chains.
    n_frac = int(frac_edges.shape[1]) if frac_edges.size else 0
    frac_nodes: list[set] = [set() for _ in range(n_frac)]
    for c in builder.chains:
        frac_nodes[c["frac"]].update(c["nodes"])
    g_1d = []
    node_use_count = np.zeros(p.shape[1], dtype=int)
    for fi in range(n_frac):
        nodes = np.array(sorted(frac_nodes[fi]), dtype=int)
        if nodes.size < 2:
            continue
        coords = np.vstack([p[:, nodes], np.zeros(nodes.size)])
        g = msh_2_grid.create_embedded_line_grid(coords, nodes)
        g.frac_num = fi
        g_1d.append(g)
        node_use_count[nodes] += 1

    g_0d = []
    for node in np.where(node_use_count > 1)[0]:
        pg = PointGrid(np.hstack([p[:, node], 0.0]))
        pg.global_point_ind = np.atleast_1d(node)
        g_0d.append(pg)

    return [[g_2d], g_1d, g_0d]
