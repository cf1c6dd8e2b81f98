"""Geometry mixin for models.

Parity counterpart of reference ``models/geometry.py:16``: builds the
mixed-dimensional grid from user hooks (``set_domain``/``set_fractures``/
``meshing_arguments``/``grid_type``), and provides grid-set utilities and
AD geometry helpers (basis vectors, boundary-side masks, grid-attribute
wrapping) used throughout the equation definitions.

Current meshing support: unfractured cartesian/tensor grids (the
gmsh-backed simplex path and fracture meshing arrive with the fracs layer).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from porepy_tpu_torch.geometry.domain import Domain, DomainSides
from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.grids.grid import Grid
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.structured import CartGrid
from porepy_tpu_torch.numerics import ad

__all__ = ["ModelGeometry"]


class ModelGeometry:
    """Geometry mixin: defines ``set_geometry`` and md-grid query helpers."""

    def set_geometry(self) -> None:
        self.set_domain()
        self.set_fractures()
        from porepy_tpu_torch.fracs.fracture_network import create_fracture_network

        try:
            self.fracture_network = create_fracture_network(
                [f for f in self.fractures if hasattr(f, "pts")], self.domain
            )
        except (TypeError, ValueError):
            self.fracture_network = None
        self.mdg = self.create_mdg()
        self.nd: int = self.mdg.dim_max()
        if self.mdg.subdomains(dim=self.nd - 1):
            from porepy_tpu_torch.utils.tangential_normal_projection import (
                set_local_coordinate_projections,
            )

            set_local_coordinate_projections(self.mdg)
        self.set_well_network()

    def set_domain(self) -> None:
        """Default: unit square/cube scaled by units."""
        size = self.units.convert_units(1.0, "m") if hasattr(self, "units") else 1.0
        box = {"xmin": 0.0, "xmax": size, "ymin": 0.0, "ymax": size}
        self._domain = Domain(box)

    @property
    def domain(self) -> Domain:
        return self._domain

    def set_fractures(self) -> None:
        self._fractures: list = []

    @property
    def fractures(self) -> list:
        return getattr(self, "_fractures", [])

    def set_well_network(self) -> None:
        self.well_network = None

    def grid_type(self) -> str:
        return self.params.get("grid_type", "cartesian")

    def meshing_arguments(self) -> dict:
        default_size = (
            self.units.convert_units(0.5, "m") if hasattr(self, "units") else 0.5
        )
        default_args = {"cell_size": default_size}
        default_args.update(self.params.get("meshing_arguments", {}))
        return default_args

    def create_mdg(self) -> MixedDimensionalGrid:
        gt = self.grid_type()
        if gt == "simplex":
            return self._create_simplex_mdg()
        if gt != "cartesian":
            raise NotImplementedError(f"Grid type {gt!r} not yet supported")
        args = self.meshing_arguments()
        box = self.domain.bounding_box
        lengths = self.domain.side_lengths()
        cs = args["cell_size"]
        n = [max(1, int(round(length / cs))) for length in lengths]
        origin = np.array([box["xmin"], box["ymin"], box.get("zmin", 0.0)])
        if self.fractures:
            from porepy_tpu_torch.fracs import meshing

            frac_arrays = [
                np.asarray(getattr(f, "pts", f), dtype=float)
                - origin[: len(lengths), None]
                for f in self.fractures
            ]
            mdg = meshing.cart_grid(
                frac_arrays, np.asarray(n), physdims=np.asarray(lengths)
            )
            for sd in mdg.subdomains():
                sd.nodes += origin[:, None]
            mdg.compute_geometry()
            return mdg
        g = CartGrid(n, physdims=lengths)
        g.nodes += origin[:, None]
        mdg = MixedDimensionalGrid()
        mdg.add_subdomains(g)
        mdg.compute_geometry()
        return mdg

    def _create_simplex_mdg(self) -> MixedDimensionalGrid:
        """Simplex md grid via the fracture network's native conforming
        Delaunay mesher (2d; 3d simplex meshing requires gmsh, reference
        ``fracs/simplex.py:82``)."""
        from porepy_tpu_torch.grids.mdg_generation import create_mdg as _create

        if self.domain.dim != 2:
            raise NotImplementedError(
                "Native simplex meshing is 2d-only (3d needs gmsh)"
            )
        from porepy_tpu_torch.fracs.fracture_network import create_fracture_network

        network = create_fracture_network(
            [f for f in self.fractures if hasattr(f, "pts")], self.domain
        )
        return _create(
            "simplex", self.meshing_arguments(), network
        )

    # -- grid-set queries ----------------------------------------------------

    def subdomains_to_interfaces(
        self, subdomains: Sequence[Grid], codims: Sequence[int]
    ) -> list:
        out = []
        for sd in subdomains:
            for intf in self.mdg.subdomain_to_interfaces(sd):
                if getattr(intf, "codim", 1) in codims and intf not in out:
                    out.append(intf)
        return self.mdg.sort_interfaces(out)

    def interfaces_to_subdomains(self, interfaces: Sequence) -> list[Grid]:
        out = []
        for intf in interfaces:
            for sd in self.mdg.interface_to_subdomain_pair(intf):
                if sd not in out:
                    out.append(sd)
        return self.mdg.sort_subdomains(out)

    def subdomains_to_boundary_grids(
        self, subdomains: Sequence[Grid]
    ) -> list[BoundaryGrid]:
        out = []
        for sd in subdomains:
            bg = self.mdg.subdomain_to_boundary_grid(sd)
            if bg is not None:
                out.append(bg)
        return out

    # -- AD geometry helpers -------------------------------------------------

    def wrap_grid_attribute(
        self, grids: Sequence, attr: str, dim: int
    ) -> ad.DenseArray:
        """Concatenated grid attribute as a constant operator. ``dim`` limits
        vector attributes (e.g. centers) to the first ``dim`` components,
        F-ravelled per entity (matching reference
        ``models/geometry.py:176``)."""
        vals = []
        for g in grids:
            v = np.asarray(getattr(g, attr), dtype=float)
            if v.ndim == 2:
                v = v[:dim].ravel("F")
            vals.append(v)
        return ad.DenseArray(
            np.concatenate(vals) if vals else np.zeros(0), name=f"{attr}"
        )

    def basis(self, grids: Sequence, dim: int) -> list[ad.SparseArray]:
        """List of dim prolongation matrices from scalar to vector space."""
        return [self.e_i(grids, i=i, dim=dim) for i in range(dim)]

    def e_i(self, grids: Sequence, *, i: int, dim: int) -> ad.SparseArray:
        """Cell-wise unit-basis prolongation: scalar cell values into
        component ``i`` of ``dim``-vectors."""
        import scipy.sparse as sps

        num_cells = int(sum(g.num_cells for g in grids))
        rows = np.arange(num_cells) * dim + i
        cols = np.arange(num_cells)
        mat = sps.csr_matrix(
            (np.ones(num_cells), (rows, cols)), shape=(num_cells * dim, num_cells)
        )
        return ad.SparseArray(mat, name=f"e_{i}")

    def domain_boundary_sides(
        self, domain: Union[Grid, BoundaryGrid], tol: float = 1e-10
    ) -> DomainSides:
        """Boolean masks for the box sides of the domain boundary.

        For subdomain grids the masks are face-wise; for boundary grids
        cell-wise (parity with reference ``models/geometry.py:503``).
        """
        if isinstance(domain, BoundaryGrid):
            face_centers = domain.cell_centers
            num = domain.num_cells
            all_bf = np.arange(num)
        else:
            face_centers = domain.face_centers
            num = domain.num_faces
            all_bf = domain.get_boundary_faces()
        box = self.domain.bounding_box
        mask_bf = np.zeros(num, dtype=bool)
        mask_bf[all_bf] = True
        east = mask_bf & (np.abs(face_centers[0] - box["xmax"]) <= tol)
        west = mask_bf & (np.abs(face_centers[0] - box["xmin"]) <= tol)
        north = mask_bf & (np.abs(face_centers[1] - box["ymax"]) <= tol)
        south = mask_bf & (np.abs(face_centers[1] - box["ymin"]) <= tol)
        if self.nd == 3 and "zmax" in box:
            top = mask_bf & (np.abs(face_centers[2] - box["zmax"]) <= tol)
            bottom = mask_bf & (np.abs(face_centers[2] - box["zmin"]) <= tol)
        else:
            top = np.zeros(num, dtype=bool)
            bottom = np.zeros(num, dtype=bool)
        return DomainSides(all_bf, east, west, north, south, top, bottom)

    def tangential_component(self, subdomains: Sequence[Grid]) -> ad.Operator:
        """Restrict cell-wise nd-vectors to the first nd-1 (tangential)
        components, expressed in the tangential basis (reference
        ``models/geometry.py:379``)."""
        op = ad.sum_operator_list(
            [
                self.e_i(subdomains, i=i, dim=self.nd - 1)
                @ self.e_i(subdomains, i=i, dim=self.nd).T
                for i in range(self.nd - 1)
            ]
        )
        op.set_name("tangential_component")
        return op

    def normal_component(self, subdomains: Sequence[Grid]) -> ad.SparseArray:
        """Restrict cell-wise nd-vectors to the final (normal) component."""
        e_n = self.e_i(subdomains, i=self.nd - 1, dim=self.nd)
        out = e_n.T
        out.set_name("normal_component")
        return out

    def local_coordinates(self, subdomains: Sequence[Grid]) -> ad.SparseArray:
        """Global-to-local rotation for fracture subdomains, from the stored
        tangential/normal projections (reference ``models/geometry.py:440``)."""
        import scipy.sparse as sps

        if not all(sd.dim == self.nd - 1 for sd in subdomains):
            raise ValueError("Local coordinates defined on fractures only")
        if subdomains:
            mats = [
                self.mdg.subdomain_data(sd)[
                    "tangential_normal_projection"
                ].project_tangential_normal(sd.num_cells)
                for sd in subdomains
            ]
            mat = sps.block_diag(mats, format="csr")
        else:
            mat = sps.csr_matrix((0, 0))
        return ad.SparseArray(mat, name="local_coordinates")

    def outwards_internal_boundary_normals(
        self, interfaces: Sequence, *, unitary: bool
    ) -> ad.Operator:
        """Outward normal vectors on internal (fracture) boundaries, as an
        nd-vector per mortar cell; ``unitary`` normalizes by mortar cell
        volume (reference ``models/geometry.py:647``)."""
        if len(interfaces) == 0:
            return ad.DenseArray(np.zeros(0))
        primary_subdomains = [
            self.mdg.interface_to_subdomain_pair(intf)[0] for intf in interfaces
        ]
        mortar_projection = ad.MortarProjections(
            self.mdg, primary_subdomains, interfaces, dim=self.nd
        )
        primary_face_normals = self.wrap_grid_attribute(
            primary_subdomains, "face_normals", dim=self.nd
        )
        flip = self.internal_boundary_normal_to_outwards(
            primary_subdomains, dim=self.nd
        )
        flipped_normals = flip @ primary_face_normals
        outwards_normals = (
            mortar_projection.primary_to_mortar_int() @ flipped_normals
        )
        outwards_normals.set_name("outwards_internal_boundary_normals")
        if unitary:
            cell_volumes_inv = ad.Scalar(1.0) / self.wrap_grid_attribute(
                interfaces, "cell_volumes", dim=1
            )
            cell_volumes_inv_nd = ad.sum_operator_list(
                [e @ cell_volumes_inv for e in self.basis(interfaces, self.nd)]
            )
            outwards_normals = cell_volumes_inv_nd * outwards_normals
            outwards_normals.set_name(
                "unitary_outwards_internal_boundary_normals"
            )
        return outwards_normals

    def internal_boundary_normal_to_outwards(
        self, subdomains: Sequence[Grid], *, dim: int
    ) -> ad.SparseArray:
        """Diagonal +-1 operator flipping face normal vectors that point
        away from the fracture on internal boundaries (reference
        ``models/geometry.py:590``)."""
        import scipy.sparse as sps

        if len(subdomains) == 0:
            return ad.SparseArray(sps.csr_matrix((0, 0)))
        mats = []
        for sd in subdomains:
            faces = np.where(sd.tags["fracture_faces"])[0]
            sgn, _ = sd.signs_and_cells_of_boundary_faces(faces)
            diag = np.zeros(sd.num_faces)
            diag[faces] = sgn
            diag_nd = np.tile(diag, (dim, 1)).ravel(order="F")
            mats.append(
                sps.dia_matrix(
                    (diag_nd, 0), shape=(diag_nd.size, diag_nd.size)
                )
            )
        flipper = sps.block_diag(mats, format="csr")
        out = ad.SparseArray(flipper, name="flip_normal_vectors")
        return out
