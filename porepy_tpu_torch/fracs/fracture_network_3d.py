"""3d fracture networks: planar polygon fractures in a 3d domain.

Parity counterpart of reference ``fracs/fracture_network_3d.py:31``:
pairwise intersection finding (via ``intersections.polygons_3d``),
decomposition of the network into non-intersecting polygons
(``split_intersections``), and domain-boundary imposition. The
gmsh-backed ``mesh()`` requires the gmsh package.
"""

from __future__ import annotations

import copy as _copy
import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["FractureNetwork3d"]


class FractureNetwork3d:
    def __init__(
        self,
        fractures: Optional[list] = None,
        domain=None,
        tol: float = 1e-8,
        run_checks: bool = False,
    ) -> None:
        self.fractures = list(fractures) if fractures is not None else []
        for i, f in enumerate(self.fractures):
            f.set_index(i)
        self.intersections: dict = {
            "first": np.array([], dtype=object),
            "second": np.array([], dtype=object),
            "start": np.zeros((3, 0)),
            "end": np.zeros((3, 0)),
            "bound_first": np.array([], dtype=bool),
            "bound_second": np.array([], dtype=bool),
        }
        self.has_checked_intersections = False
        self.tol = tol
        self.run_checks = run_checks
        self.domain = domain
        self.tags: dict = {}
        self.auxiliary_points_added = False
        self.bounding_box_imposed = False

    # -- basics ---------------------------------------------------------------

    def num_frac(self) -> int:
        return len(self.fractures)

    def copy(self) -> "FractureNetwork3d":
        fracs = [f.copy() for f in self.fractures]
        out = FractureNetwork3d(fracs, _copy.deepcopy(self.domain), self.tol)
        return out

    def bounding_box(self) -> dict:
        if not self.fractures:
            return {}
        all_pts = np.hstack([f.pts for f in self.fractures])
        return {
            "xmin": all_pts[0].min(),
            "xmax": all_pts[0].max(),
            "ymin": all_pts[1].min(),
            "ymax": all_pts[1].max(),
            "zmin": all_pts[2].min(),
            "zmax": all_pts[2].max(),
        }

    def add(self, fracture) -> None:
        ind = np.array([f.index for f in self.fractures])
        if ind.size > 0:
            fracture.set_index(int(np.max(ind) + 1))
        else:
            fracture.set_index(0)
        self.fractures.append(fracture)

    # -- intersections ----------------------------------------------------------

    def _add_intersection(
        self, first, second, start, end, bound_first, bound_second
    ) -> None:
        if start.size < 4:
            start = start.reshape((-1, 1))
            end = end.reshape((-1, 1))
        new = {
            "first": first,
            "second": second,
            "start": start,
            "end": end,
            "bound_first": bound_first,
            "bound_second": bound_second,
        }
        for key, val in new.items():
            self.intersections[key] = np.hstack((self.intersections[key], val))

    def find_intersections(self, use_orig_points: bool = False) -> None:
        """Pairwise fracture intersections, stored in
        :attr:`intersections` (one entry per intersecting pair)."""
        from porepy_tpu_torch.geometry.intersections import polygons_3d
        from porepy_tpu_torch.utils.array_operations import ismember_columns

        self.has_checked_intersections = True
        if use_orig_points:
            for f in self.fractures:
                f.pts = f.orig_pts
        polys = [f.pts for f in self.fractures]
        isect, point_ind, bound_info, frac_pairs, *_ = polygons_3d(
            polys, include_point_contact=False, tol=self.tol
        )
        for pair in frac_pairs:
            ind_0, ind_1 = pair
            common, i0 = ismember_columns(
                point_ind[ind_1].reshape((1, -1)).astype(int),
                point_ind[ind_0].reshape((1, -1)).astype(int),
            )
            common_ind = point_ind[ind_1][np.where(common)[0]].astype(int)
            if common_ind.size != 2:
                continue
            self._add_intersection(
                self.fractures[ind_0],
                self.fractures[ind_1],
                isect[:, common_ind[0]],
                isect[:, common_ind[1]],
                bound_first=self._bound_flag(bound_info, frac_pairs, pair, ind_0),
                bound_second=self._bound_flag(bound_info, frac_pairs, pair, ind_1),
            )

    @staticmethod
    def _bound_flag(bound_info, frac_pairs, pair, poly_ind) -> bool:
        """Boundary flag of ``poly_ind`` for this specific pair: its
        position among the pairs involving poly_ind indexes bound_info."""
        involved = [k for k, pr in enumerate(frac_pairs) if poly_ind in pr]
        pos = involved.index(frac_pairs.index(pair))
        return bool(bound_info[poly_ind][pos])

    def intersections_of_fracture(self, frac) -> tuple[list, list]:
        """Indices of intersections involving the fracture, plus flags for
        the intersection being on its boundary."""
        fi = frac.index if hasattr(frac, "index") else frac
        isects = []
        is_bound = []
        for i in range(self.intersections["start"].shape[1]):
            if self.intersections["first"][i].index == fi:
                isects.append(i)
                is_bound.append(bool(self.intersections["bound_first"][i]))
            elif self.intersections["second"][i].index == fi:
                isects.append(i)
                is_bound.append(bool(self.intersections["bound_second"][i]))
        return isects, is_bound

    # -- decomposition ------------------------------------------------------

    def split_intersections(self) -> None:
        """Decompose the network into non-intersecting polygons; stores the
        result in :attr:`decomposition`.

        Provenance: the control flow (point/edge list collection, pairwise
        edge-intersection removal, per-fracture polygon extraction) follows
        the reference's algorithm at
        ``/root/reference/src/porepy/fracs/fracture_network_3d.py:382-520``
        in condensed form — this is deliberate host-side geometric
        preprocessing where the decomposition CONTRACT (the keys and
        layout of :attr:`decomposition` consumed by the gmsh writer and
        the splitting pipeline) must match the reference exactly; the
        numerics (intersection predicates, snapping) are this repo's own
        ``geometry/intersections.py`` kernels."""
        all_p, edges, edges_2_frac, is_boundary_edge = self._point_and_edge_lists()
        all_p, edges, edges_2_frac, is_boundary_edge = (
            self._remove_edge_intersections(
                all_p, edges, edges_2_frac, is_boundary_edge
            )
        )
        self.decomposition = {
            "points": all_p,
            "edges": edges.astype(int),
            "is_bound": is_boundary_edge,
            "edges_2_frac": edges_2_frac,
        }
        # Per-fracture edge lists (internal and boundary).
        polygons = []
        line_in_frac = []
        for fi in range(len(self.fractures)):
            ei = []
            ei_bound = []
            for i, (e2f, isb) in enumerate(zip(edges_2_frac, is_boundary_edge)):
                hit = np.where(np.asarray(e2f) == fi)[0]
                if hit.size == 1:
                    if np.asarray(isb)[hit][0]:
                        ei_bound.append(i)
                    else:
                        ei.append(i)
                elif hit.size > 1:
                    raise ValueError("Non-unique fracture edge relation")
            from porepy_tpu_torch.geometry.sort_points import sort_point_pairs

            poly, _ = sort_point_pairs(edges[:2, ei_bound])
            polygons.append(poly)
            line_in_frac.append(ei)
        self.decomposition["polygons"] = polygons
        self.decomposition["line_in_frac"] = line_in_frac

    def _point_and_edge_lists(self):
        from porepy_tpu_torch.utils.array_operations import uniquify_point_set

        all_p = np.empty((3, 0))
        edges = np.empty((2, 0))
        edges_2_frac: list = []
        is_boundary_edge: list = []
        for fi, frac in enumerate(self.fractures):
            num_p = all_p.shape[1]
            n_loc = frac.pts.shape[1]
            all_p = np.hstack((all_p, frac.pts))
            loc_e = num_p + np.vstack(
                (np.arange(n_loc), (np.arange(n_loc) + 1) % n_loc)
            )
            edges = np.hstack((edges, loc_e))
            for _ in range(n_loc):
                edges_2_frac.append([fi])
                is_boundary_edge.append([True])
        num_isect = self.intersections["start"].shape[1]
        num_p = all_p.shape[1]
        isect_pt = np.hstack(
            (self.intersections["start"], self.intersections["end"])
        )
        isect_edges = num_p + np.vstack(
            (np.arange(num_isect), num_isect + np.arange(num_isect))
        )
        all_p = np.hstack((all_p, isect_pt))
        edges = np.hstack((edges, isect_edges)).astype(int)
        for i in range(num_isect):
            edges_2_frac.append(
                [
                    self.intersections["first"][i].index,
                    self.intersections["second"][i].index,
                ]
            )
            is_boundary_edge.append(
                [
                    self.intersections["bound_first"][i],
                    self.intersections["bound_second"][i],
                ]
            )
        edges_2_frac = [np.asarray(i) for i in edges_2_frac]
        is_boundary_edge = [np.asarray(i) for i in is_boundary_edge]
        return self._uniquify_points_and_edges(
            all_p, edges, edges_2_frac, is_boundary_edge
        )

    def _uniquify_points_and_edges(
        self, all_p, edges, edges_2_frac, is_boundary_edge
    ):
        from porepy_tpu_torch.utils.array_operations import uniquify_point_set

        p_unique, _, all_2_unique_p = uniquify_point_set(
            all_p, tol=self.tol * np.sqrt(3)
        )
        edges = all_2_unique_p[edges]
        e_unique, unique_ind_e, all_2_unique_e = np.unique(
            np.sort(edges, axis=0), axis=1, return_index=True, return_inverse=True
        )
        new_e2f = [np.empty(0, dtype=int) for _ in range(e_unique.shape[1])]
        new_isb = [np.empty(0, dtype=bool) for _ in range(e_unique.shape[1])]
        for old_i, new_i in enumerate(all_2_unique_e):
            merged, ind = np.unique(
                np.hstack((new_e2f[new_i], edges_2_frac[old_i])),
                return_index=True,
            )
            new_e2f[new_i] = merged
            tmp = np.hstack((new_isb[new_i], is_boundary_edge[old_i]))
            new_isb[new_i] = tmp[ind]
        edges = e_unique
        keep = np.squeeze(np.diff(edges, axis=0)) != 0
        keep = np.atleast_1d(keep)
        edges = edges[:, keep]
        new_e2f = [e for e, k in zip(new_e2f, keep) if k]
        new_isb = [b for b, k in zip(new_isb, keep) if k]
        return p_unique, edges, new_e2f, new_isb

    def _points_2_plane(self, p_loc, edges_loc, p_ind_loc):
        from porepy_tpu_torch.geometry import map_geometry

        p_loc_c = np.mean(p_loc, axis=1).reshape((-1, 1))
        p_loc = p_loc - p_loc_c
        rot = map_geometry.project_plane_matrix(p_loc)
        p_2d = rot @ p_loc
        extent = p_2d.max(axis=1) - p_2d.min(axis=1)
        lateral = max(np.max(extent[:2]), 1.0)
        if extent[2] >= lateral * self.tol * 30:
            raise ValueError("Fracture points are not planar")
        p_2d = p_2d[:2]
        edges_2d = np.empty_like(edges_loc)
        for ei in range(edges_loc.shape[1]):
            edges_2d[0, ei] = np.argmax(p_ind_loc == edges_loc[0, ei])
            edges_2d[1, ei] = np.argmax(p_ind_loc == edges_loc[1, ei])
        return p_2d, edges_2d, p_loc_c, rot

    def _remove_edge_intersections(
        self, all_p, edges, edges_2_frac, is_boundary_edge
    ):
        from porepy_tpu_torch.geometry.intersections import (
            split_intersecting_segments_2d,
        )
        from porepy_tpu_torch.numerics.linalg.matrix_operations import rldecode
        from porepy_tpu_torch.utils.array_operations import (
            ismember_columns,
            uniquify_point_set,
        )

        for fi in range(len(self.fractures)):
            sizes = np.array([e.size for e in edges_2_frac])
            frac_expanded = rldecode(np.arange(len(edges_2_frac)), sizes)
            edges_loc_ind = frac_expanded[np.hstack(edges_2_frac) == fi]
            edges_loc = np.vstack((edges[:, edges_loc_ind], edges_loc_ind))
            p_ind_loc = np.unique(edges_loc[:2])
            p_loc = all_p[:, p_ind_loc]
            p_2d, edges_2d, p_loc_c, rot = self._points_2_plane(
                p_loc, edges_loc, p_ind_loc
            )
            edges_2d[2] = edges_loc[2]
            p_new, edges_new, tags = split_intersecting_segments_2d(
                p_2d, edges_2d, tol=self.tol
            )
            p_add = p_new[:, p_ind_loc.size :]
            p_add = np.vstack((p_add, np.zeros(p_add.shape[1])))
            p_add_3d = rot.T @ p_add + p_loc_c
            ind_p_add = all_p.shape[1] + np.arange(p_add_3d.shape[1])
            p_ind_exp = np.hstack((p_ind_loc, ind_p_add))
            all_p = np.hstack((all_p, p_add_3d))
            new_all_p, _, ia = uniquify_point_set(all_p, self.tol)
            if new_all_p.shape[1] < all_p.shape[1]:
                all_p = new_all_p
                p_ind_exp = ia[p_ind_exp]

            edges_new_glob = p_ind_exp[edges_new[:2]]
            edges = np.hstack((edges, edges_new_glob))
            edges_loc_ind = np.unique(edges_loc_ind)
            for ei in range(edges_new.shape[1]):
                is_old, old_loc = ismember_columns(
                    edges_new_glob[:, ei].reshape((-1, 1)),
                    edges[:2, edges_loc_ind],
                )
                if is_old[0]:
                    glob_ei = [edges_loc_ind[old_loc[0]]]
                else:
                    glob_ei = tags[0][tags[1] == ei]
                e2f = np.array([], dtype=int)
                ib = np.array([], dtype=bool)
                for gi in np.atleast_1d(glob_ei):
                    e2f = np.hstack((e2f, edges_2_frac[int(gi)]))
                    ib = np.hstack((ib, is_boundary_edge[int(gi)]))
                edges_2_frac.append(e2f)
                is_boundary_edge.append(ib)
            edges = np.delete(edges, edges_loc_ind, axis=1)
            for ei in np.sort(edges_loc_ind)[::-1]:
                del edges_2_frac[ei]
                del is_boundary_edge[ei]
        return self._uniquify_points_and_edges(
            all_p, edges, edges_2_frac, is_boundary_edge
        )

    # -- boundary -------------------------------------------------------------

    def impose_external_boundary(
        self, domain=None, keep_box: bool = True, **kwargs
    ) -> np.ndarray:
        """Clip all fractures by the (box) domain; fully external fractures
        are deleted. Returns indices of deleted fractures."""
        from porepy_tpu_torch.geometry.constrain_geometry import (
            polygons_by_polyhedron,
        )

        if domain is not None:
            self.domain = domain
        if self.domain is None:
            box = self.bounding_box()
            dx = 0.1 * max(box["xmax"] - box["xmin"], 1e-10)
            dy = 0.1 * max(box["ymax"] - box["ymin"], 1e-10)
            dz = 0.1 * max(box["zmax"] - box["zmin"], 1e-10)
            from porepy_tpu_torch.geometry.domain import Domain

            self.domain = Domain(
                {
                    "xmin": box["xmin"] - dx,
                    "xmax": box["xmax"] + dx,
                    "ymin": box["ymin"] - dy,
                    "ymax": box["ymax"] + dy,
                    "zmin": box["zmin"] - dz,
                    "zmax": box["zmax"] + dz,
                }
            )
        box = self.domain.bounding_box
        x0, x1 = box["xmin"], box["xmax"]
        y0, y1 = box["ymin"], box["ymax"]
        z0, z1 = box["zmin"], box["zmax"]
        sides = [
            np.array([[x0, x1, x1, x0], [y0, y0, y1, y1], [z0, z0, z0, z0]]),
            np.array([[x0, x1, x1, x0], [y0, y0, y1, y1], [z1, z1, z1, z1]]),
            np.array([[x0, x1, x1, x0], [y0, y0, y0, y0], [z0, z0, z1, z1]]),
            np.array([[x0, x1, x1, x0], [y1, y1, y1, y1], [z0, z0, z1, z1]]),
            np.array([[x0, x0, x0, x0], [y0, y1, y1, y0], [z0, z0, z1, z1]]),
            np.array([[x1, x1, x1, x1], [y0, y1, y1, y0], [z0, z0, z1, z1]]),
        ]
        clipped, orig = polygons_by_polyhedron(
            [f.pts for f in self.fractures], sides, self.tol
        )
        from porepy_tpu_torch.fracs.fracture import PlaneFracture

        old_fracs = self.fractures
        deleted = np.setdiff1d(np.arange(len(old_fracs)), orig)
        self.fractures = [
            PlaneFracture(poly, index=i, sort_points=False)
            for i, poly in enumerate(clipped)
        ]
        self.bounding_box_imposed = True
        return deleted

    # -- gmsh gate ------------------------------------------------------------

    def prepare_for_gmsh(
        self,
        mesh_args: dict,
        file_name: str = "gmsh_frac_file",
    ) -> str:
        """Process the network (intersections, decomposition) and write the
        standalone ``.geo`` geometry script; returns its path (reference
        ``fracture_network_3d.py:311`` drives the gmsh API directly
        instead)."""
        from porepy_tpu_torch.fracs.gmsh_interface import GmshWriter3d

        if not self.has_checked_intersections:
            self.find_intersections()
        self.split_intersections()
        writer = GmshWriter3d(
            self.domain.bounding_box,
            self.decomposition,
            mesh_size_frac=mesh_args.get("mesh_size_frac", 1.0),
            mesh_size_bound=mesh_args.get("mesh_size_bound"),
            tol=self.tol,
        )
        return writer.generate(file_name + ".geo")

    def mesh(self, mesh_args: dict, file_name: str = "gmsh_frac_file", **kwargs):
        """Mesh the network into a mixed-dimensional grid (reference
        ``fracture_network_3d.py:202``).

        Writes the ``.geo`` geometry with the native emitter, runs gmsh's
        3d mesher through its Python API when gmsh is importable, and
        assembles the resulting MSH 4.1 file with the native parser. In
        gmsh-free environments the ``.geo`` file is still produced and the
        raised error carries the offline meshing command; the produced
        ``.msh`` can then be assembled with
        ``porepy_tpu.fracs.msh_2_grid.create_grids_from_msh`` +
        ``meshing.subdomains_to_mdg``.
        """
        from porepy_tpu_torch.fracs import meshing as meshing_mod
        from porepy_tpu_torch.fracs.msh_2_grid import create_grids_from_msh

        geo_file = self.prepare_for_gmsh(mesh_args, file_name)
        msh_file = file_name + ".msh"
        try:
            import gmsh

            # Guard against placeholder modules (e.g. the test shim that
            # stubs gmsh for reference imports): require the real API.
            if not hasattr(gmsh, "initialize"):
                raise ImportError("gmsh module lacks the gmsh API")
        except ImportError:
            # gmsh-free environment: fall back to the native conforming
            # cut-tet mesher (fracs/cut_tet.py), which handles arbitrary
            # planar networks in-image. The .geo file stays on disk for
            # offline gmsh runs ('gmsh -3 {geo} -o {msh} -format msh41' +
            # create_grids_from_msh + meshing.subdomains_to_mdg) when an
            # unstructured boundary-graded mesh is wanted. The reference
            # has no gmsh-free path at all
            # (/root/reference/src/porepy/fracs/fracture_network_3d.py:202).
            logger.info(
                "gmsh not importable: meshing %d fractures with the native "
                "cut-tet mesher (geometry also written to %s)",
                self.num_frac(),
                geo_file,
            )
            return self._mesh_cut_tet(mesh_args, **kwargs)
        gmsh.initialize()
        try:
            gmsh.open(geo_file)
            gmsh.option.setNumber("Mesh.MshFileVersion", 4.1)
            gmsh.model.mesh.generate(3)
            gmsh.write(msh_file)
        finally:
            gmsh.finalize()
        grids = create_grids_from_msh(msh_file)
        mdg = meshing_mod.subdomains_to_mdg(grids)
        mdg.compute_geometry()
        return mdg

    def _mesh_cut_tet(self, mesh_args: dict, **kwargs):
        """Mesh through :func:`porepy_tpu.fracs.cut_tet.cut_tet_grid` —
        conforming plane cuts of a Kuhn-tet lattice sized from
        ``mesh_args`` — translating between the network's domain box
        (arbitrary min corner) and the mesher's origin-anchored box."""
        from porepy_tpu_torch.fracs.cut_tet import cut_tet_subdomain_lists
        from porepy_tpu_torch.fracs import meshing as meshing_mod

        sizes = [
            mesh_args.get(k)
            for k in ("mesh_size_frac", "mesh_size_min", "mesh_size_bound")
        ]
        sizes = [s for s in sizes if s is not None]
        if not sizes:
            raise ValueError(
                "mesh_args must provide mesh_size_frac (or _min/_bound)"
            )
        h = float(min(sizes))

        if self.domain is not None:
            box = self.domain.bounding_box
            mins = np.array([box["xmin"], box["ymin"], box["zmin"]])
            maxs = np.array([box["xmax"], box["ymax"], box["zmax"]])
        else:
            all_pts = np.hstack([f.pts for f in self.fractures])
            span = all_pts.max(axis=1) - all_pts.min(axis=1)
            mins = all_pts.min(axis=1) - 0.1 * span
            maxs = all_pts.max(axis=1) + 0.1 * span
        dims = maxs - mins
        nx = np.maximum(np.round(dims / h).astype(int), 1)

        fracs = [f.pts - mins[:, None] for f in self.fractures]
        lists = cut_tet_subdomain_lists(fracs, nx, physdims=list(dims))
        # Translate back to the domain's frame: pure shift, so volumes,
        # normals and connectivity are untouched.
        for dim_list in lists:
            for g in dim_list:
                if g.nodes.size:
                    g.nodes = g.nodes + mins[:, None]
                for attr in ("cell_centers", "face_centers"):
                    arr = getattr(g, attr, None)
                    if arr is not None and np.size(arr):
                        setattr(g, attr, arr + mins[:, None])
        mdg = meshing_mod.subdomains_to_mdg(lists, **kwargs)
        return mdg

    def to_csv(self, file_name, domain=None) -> None:
        rows = []
        for f in self.fractures:
            rows.append(
                ",".join(str(v) for v in f.pts.ravel(order="F"))
            )
        with open(file_name, "w") as fh:
            fh.write("\n".join(rows) + "\n")

    def __repr__(self) -> str:
        return (
            f"Three-dimensional fracture network with "
            f"{self.num_frac()} fractures"
        )
