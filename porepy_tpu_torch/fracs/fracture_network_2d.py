"""2d fracture networks: line fractures in a planar domain.

Parity counterpart of reference ``fracs/fracture_network_2d.py:26``:
snapping, intersection splitting, domain-boundary imposition and the
decomposition used for meshing. The gmsh-backed ``mesh()`` requires the
gmsh python package; the structured (cartesian/tensor) meshing path in
``fracs/meshing.py`` is gmsh-free.
"""

from __future__ import annotations

import copy as _copy
from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs.utils import (
    linefractures_to_pts_edges,
    pts_edges_to_linefractures,
)

__all__ = ["FractureNetwork2d"]


class FractureNetwork2d:
    def __init__(
        self,
        fractures: Optional[list] = None,
        domain=None,
        tol: float = 1e-8,
    ) -> None:
        self.tol = tol
        self.fractures = [] if fractures is None else list(fractures)
        if self.fractures:
            self._pts, self._edges = linefractures_to_pts_edges(
                self.fractures, tol
            )
        else:
            self._pts = np.zeros((2, 0))
            self._edges = np.zeros((2, 0), dtype=int)
        self.domain = domain
        self.tags: dict = {}
        self.bounding_box_imposed = False
        self._decomposition: dict = {}
        for i, f in enumerate(self.fractures):
            f.set_index(i)

    # -- basic queries -------------------------------------------------------

    def num_frac(self) -> int:
        return len(self.fractures)

    def copy(self) -> "FractureNetwork2d":
        fracs = [f.copy() for f in self.fractures]
        out = FractureNetwork2d(fracs, _copy.deepcopy(self.domain), self.tol)
        out.tags = {k: np.array(v) for k, v in self.tags.items()}
        return out

    def snapped_copy(self, tol: float) -> "FractureNetwork2d":
        """Copy with points snapped onto nearby segments."""
        from porepy_tpu_torch.geometry.constrain_geometry import (
            snap_points_to_segments,
        )

        p = self._pts.copy()
        e = self._edges.copy()
        p = snap_points_to_segments(p, e, tol)
        fracs = pts_edges_to_linefractures(p, e)
        return FractureNetwork2d(fracs, self.domain, self.tol)

    def copy_with_split_intersections(
        self, tol: Optional[float] = None
    ) -> "FractureNetwork2d":
        """Copy where all fracture crossings are split into separate
        non-intersecting branches."""
        from porepy_tpu_torch.geometry.intersections import (
            split_intersecting_segments_2d,
        )

        if tol is None:
            tol = self.tol
        p, e, _ = split_intersecting_segments_2d(
            self._pts, self._edges, tol=tol
        )
        fracs = pts_edges_to_linefractures(p, e.astype(np.int32))
        return FractureNetwork2d(fracs, self.domain, tol)

    # -- preprocessing -------------------------------------------------------

    def _snap_fracture_set(
        self,
        pts: np.ndarray,
        snap_tol: float,
        termination_tol: float = 1e-2,
        max_iter: int = 100,
    ) -> tuple[np.ndarray, bool]:
        from porepy_tpu_torch.geometry.constrain_geometry import (
            snap_points_to_segments,
        )

        edges = self._edges
        for _ in range(max_iter):
            pn = snap_points_to_segments(pts, edges, tol=snap_tol)
            diff = np.max(np.abs(pn - pts)) if pts.size else 0.0
            pts = pn
            if diff < termination_tol:
                return pts, True
        return pts, False

    def impose_external_boundary(
        self, domain=None, add_domain_edges: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Clip the network by the domain boundary; fractures fully outside
        are deleted. Returns (kept, deleted) fracture indices."""
        from porepy_tpu_torch.geometry.constrain_geometry import lines_by_polygon

        if domain is None:
            if not self.fractures:
                raise ValueError("No fractures given, domain cannot be imposed.")
            x = self._pts[0]
            y = self._pts[1]
            pad = 10 * self.tol
            dom_p = np.array(
                [
                    [x.min() - pad, x.max() + pad, x.max() + pad, x.min() - pad],
                    [y.min() - pad, y.min() - pad, y.max() + pad, y.max() + pad],
                ]
            )
        elif getattr(domain, "is_boxed", True):
            box = domain.bounding_box
            dom_p = np.array(
                [
                    [box["xmin"], box["xmax"], box["xmax"], box["xmin"]],
                    [box["ymin"], box["ymin"], box["ymax"], box["ymax"]],
                ]
            )
        else:
            dom_p = np.hstack(domain.polytope)[:, ::2]

        p, e, edges_kept = lines_by_polygon(dom_p, self._pts, self._edges)
        # Remove edges that degenerated to a point during clipping.
        lengths = np.sqrt(np.sum((p[:, e[0]] - p[:, e[1]]) ** 2, axis=0)) if e.size else np.zeros(0)
        keep = lengths > self.tol
        e = e[:, keep]
        edges_kept = edges_kept[keep]
        deleted = np.setdiff1d(np.arange(self._edges.shape[1]), edges_kept)

        num_frac_pts = p.shape[1]
        if add_domain_edges:
            idx = np.arange(dom_p.shape[1]) + num_frac_pts
            dom_lines = np.vstack((idx, np.roll(idx, -1)))
            extra_rows = np.full(
                (max(e.shape[0] - 2, 0), dom_lines.shape[1]), -1, dtype=int
            )
            all_p = np.hstack((p, dom_p))
            all_e = np.hstack((e, np.vstack((dom_lines, extra_rows))))
            boundary = np.zeros(all_e.shape[1], dtype=bool)
            boundary[e.shape[1] :] = True
            self._decomposition["domain_boundary_points"] = idx
        else:
            all_p, all_e = p, e
            boundary = np.zeros(all_e.shape[1], dtype=bool)
            self._decomposition["domain_boundary_points"] = np.zeros(0, dtype=int)
        self._pts = all_p
        self._edges = all_e.astype(int)
        self.tags["boundary"] = boundary
        self.bounding_box_imposed = True
        self.fractures = pts_edges_to_linefractures(
            p, e.astype(np.int32)
        )
        for i, f in enumerate(self.fractures):
            f.set_index(i)
        return edges_kept, deleted

    def constrain_to_domain(self, domain=None) -> "FractureNetwork2d":
        """Copy of the network restricted to the (given or own) domain."""
        out = self.copy()
        out.impose_external_boundary(
            domain if domain is not None else self.domain,
            add_domain_edges=False,
        )
        out.bounding_box_imposed = False
        return out

    def _find_and_split_intersections(self, constraints: np.ndarray) -> None:
        """Split all crossings and store the decomposition (points, edges,
        intersection points) used by meshing."""
        from porepy_tpu_torch.geometry.intersections import (
            split_intersecting_segments_2d,
        )
        from porepy_tpu_torch.utils.array_operations import uniquify_point_set

        edges = self._edges
        if not np.all(np.diff(edges[:2], axis=0) != 0):
            raise ValueError("Found a point edge in splitting of edges")
        tags = np.zeros((2, edges.shape[1]), dtype=int)
        boundary = self.tags.get(
            "boundary", np.zeros(edges.shape[1], dtype=bool)
        )
        from porepy_tpu_torch.fracs.gmsh_interface import Tags as GmshTags

        tags[0][~boundary] = GmshTags.FRACTURE.value
        tags[0][boundary] = GmshTags.DOMAIN_BOUNDARY_LINE.value
        tags[0][constraints] = GmshTags.AUXILIARY_LINE.value
        tags[1] = np.arange(edges.shape[1])
        edges = np.vstack((edges[:2], tags))

        pts_all, _, old_2_new = uniquify_point_set(self._pts, tol=self.tol)
        edges[:2] = old_2_new[edges[:2]]
        edges = edges[:, edges[0] != edges[1]]
        dbp = self._decomposition.get("domain_boundary_points", np.zeros(0, int))
        self._decomposition["domain_boundary_points"] = old_2_new[dbp] if dbp.size else dbp

        li = np.sort(edges[:2], axis=0)
        _, keep, _ = np.unique(li, axis=1, return_index=True, return_inverse=True)
        edges = edges[:, keep]

        pts_split, lines_split, *_ = split_intersecting_segments_2d(
            pts_all, edges, tol=self.tol
        )
        pts_split, _, old_2_new = uniquify_point_set(pts_split, tol=self.tol)
        lines_split[:2] = old_2_new[lines_split[:2]]
        dbp = self._decomposition["domain_boundary_points"]
        self._decomposition["domain_boundary_points"] = old_2_new[dbp] if dbp.size else dbp
        lines_split = lines_split[:, lines_split[0] != lines_split[1]]
        intersections = self._find_intersection_points(lines_split)
        self._decomposition.update(
            {
                "points": pts_split,
                "edges": lines_split,
                "intersections": intersections,
                "domain": self.domain,
            }
        )

    def _find_intersection_points(self, lines: np.ndarray) -> np.ndarray:
        """Points where fractures meet (shared by more than one fracture
        line), discounting points shared only with auxiliary or boundary
        lines (reference ``fracture_network_2d.py:589``)."""
        from porepy_tpu_torch.fracs.gmsh_interface import Tags as GmshTags

        frac_id = np.ravel(
            lines[:2, lines[2] == GmshTags.FRACTURE.value]
        )
        unique_ids, frac_ia, frac_count = np.unique(
            frac_id, return_index=True, return_counts=True
        )
        aux_mask = (lines[2] == GmshTags.AUXILIARY_LINE.value) | (
            lines[2] == GmshTags.DOMAIN_BOUNDARY_LINE.value
        )
        if np.any(aux_mask):
            aux_id = np.ravel(lines[:2, aux_mask])
            uniq_aux, aux_ia, aux_count = np.unique(
                aux_id, return_index=True, return_counts=True
            )
            for a in uniq_aux[aux_count > 1]:
                frac_count[unique_ids == a] -= 1
        return unique_ids[frac_count > 1]

    def prepare_for_gmsh(
        self,
        mesh_args: Optional[dict] = None,
        constraints: Optional[np.ndarray] = None,
        **kwargs,
    ):
        """Run the geometry pipeline (boundary imposition + intersection
        splitting); the gmsh handoff itself requires the gmsh package."""
        if constraints is None:
            constraints = np.zeros(0, dtype=int)
        if not self.bounding_box_imposed:
            self.impose_external_boundary(self.domain)
        self._find_and_split_intersections(constraints)
        return self._decomposition

    def mesh(self, mesh_args: dict, **kwargs):
        """Create a simplex mixed-dimensional grid.

        Counterpart of the reference's gmsh-backed ``mesh()`` (reference
        ``fracture_network_2d.py:198``, ``fracs/simplex.py:219``); gmsh is
        not installable in this image, so meshing runs through the native
        conforming constrained Delaunay triangulation
        (``fracs/simplex.py::triangle_grid_fractured_2d``).

        ``mesh_args``: ``mesh_size_frac`` (target size at fractures),
        ``mesh_size_bound`` (at the domain boundary, defaults to frac size);
        ``mesh_size_min`` is accepted for API parity (the native mesher has
        no separate minimum).
        """
        from porepy_tpu_torch.fracs import meshing, simplex

        if self.domain is None:
            raise ValueError("Simplex meshing requires a domain")
        h_frac = mesh_args.get("mesh_size_frac") or mesh_args.get("cell_size")
        if h_frac is None:
            raise ValueError("mesh_args must provide mesh_size_frac")
        h_bound = mesh_args.get("mesh_size_bound") or h_frac
        kwargs.pop("constraints", None)
        subdomains = simplex.triangle_grid_fractured_2d(
            self.domain.bounding_box,
            self._pts,
            self._edges,
            mesh_size_frac=h_frac,
            mesh_size_bound=h_bound,
            tol=max(self.tol, 1e-10),
        )
        return meshing.subdomains_to_mdg(subdomains, **kwargs)

    # -- IO / misc -----------------------------------------------------------

    def to_csv(self, file_name, with_header: bool = True) -> None:
        rows = []
        if with_header:
            rows.append("FID,START_X,START_Y,END_X,END_Y")
        for i, f in enumerate(self.fractures):
            s, e = f.pts[:, 0], f.pts[:, 1]
            rows.append(f"{i},{s[0]},{s[1]},{e[0]},{e[1]}")
        with open(file_name, "w") as fh:
            fh.write("\n".join(rows) + "\n")

    def plot(self, **kwargs) -> None:
        import matplotlib.pyplot as plt

        fig = kwargs.pop("fig", None)
        ax = fig.gca() if fig is not None else plt.gca()
        for f in self.fractures:
            ax.plot(f.pts[0], f.pts[1], "-", **kwargs)

    def __str__(self) -> str:
        return (
            f"Fracture set with {self.num_frac()} fractures, "
            f"{self._pts.shape[1]} points"
        )

    def __repr__(self) -> str:
        return self.__str__()
