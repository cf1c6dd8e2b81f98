"""Mortar (interface) grids.

Parity counterpart of reference ``grids/mortar_grid.py:32``: an interface
between a ``d``-dimensional primary and ``d-codim``-dimensional secondary
subdomain, holding one or two side grids and the eight projection operators
(primary/secondary x to/from mortar x int/avg).

Currently implemented for matching grids (mortar cells coincide with
secondary cells / split primary faces) — the case produced by all in-house
meshing; the int and avg variants then coincide. Non-matching projections
arrive with grid replacement (``replace_subdomains_and_interfaces``).

TPU note: projections are permutation-like scipy matrices built once at
setup; the AD compiler turns them into device gathers.
"""

from __future__ import annotations

import enum
from itertools import count
from typing import Optional, Union

import numpy as np
import scipy.sparse as sps

__all__ = ["MortarSides", "MortarGrid"]


class MortarSides(enum.Enum):
    NONE_SIDE = 0
    LEFT_SIDE = 1
    RIGHT_SIDE = 2


class MortarGrid:
    _counter = count(0)

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj._id = next(cls._counter)
        return obj

    def __init__(
        self,
        dim: int,
        side_grids: dict[MortarSides, "object"],
        primary_secondary: Optional[sps.spmatrix] = None,
        codim: int = 1,
        name: Union[str, list[str]] = "",
        face_duplicate_ind: Optional[np.ndarray] = None,
        tol: float = 1e-6,
    ) -> None:
        if dim == 3:
            raise ValueError("A mortar grid cannot be 3d")
        if not all(g.dim == dim for g in side_grids.values()):
            raise ValueError("All side grids must share the mortar dimension")
        self.dim = dim
        self.codim = codim
        self.side_grids = dict(side_grids)
        self.sides = np.array(list(self.side_grids.keys()))
        if self.num_sides() not in (1, 2):
            raise ValueError("Number of sides must be 1 or 2")
        if face_duplicate_ind is not None and codim == 2:
            raise ValueError("Codim-2 interfaces have no faces to duplicate")
        self.name = list(name) if isinstance(name, list) else [name]
        self.name.append("mortar_grid")
        self.tol = tol

        self._refresh_geometry_attrs()

        if primary_secondary is not None:
            self._init_projections(primary_secondary, face_duplicate_ind)
            self._set_projections()

    # -- basic attributes ----------------------------------------------------

    @property
    def id(self) -> int:
        return self._id

    def num_sides(self) -> int:
        return len(self.side_grids)

    def _refresh_geometry_attrs(self) -> None:
        gs = list(self.side_grids.values())
        self.num_cells = int(sum(g.num_cells for g in gs))
        self.num_nodes = int(sum(g.num_nodes for g in gs))
        if all(hasattr(g, "cell_volumes") for g in gs):
            self.cell_volumes = np.hstack([g.cell_volumes for g in gs])
            self.cell_centers = np.hstack([g.cell_centers for g in gs])
        self.nodes = np.hstack([g.nodes for g in gs])

    def compute_geometry(self) -> None:
        for g in self.side_grids.values():
            g.compute_geometry()
        self._refresh_geometry_attrs()

    def __repr__(self) -> str:
        return (
            f"MortarGrid(dim={self.dim}, codim={self.codim}, "
            f"cells={self.num_cells}, sides={self.num_sides()})"
        )

    __str__ = __repr__

    # -- projection initialization -------------------------------------------

    def _init_projections(
        self,
        primary_secondary: sps.spmatrix,
        face_duplicate_ind: Optional[np.ndarray] = None,
    ) -> None:
        """Build mortar<->primary/secondary maps from the (secondary entity)
        x (primary face/cell) relation. Matching-grid case.

        Mortar cell ordering: all cells of side 1 (in secondary-cell order),
        then all of side 2 — matching the reference's convention
        (``mortar_grid.py:926``: ``ix = reshape(ix, (2, -1), order='F').
        ravel('C')``).
        """
        coo = sps.coo_matrix(primary_secondary)
        secondary_f, primary_f, data = coo.row, coo.col, coo.data
        # Deterministic column-major ordering: face_cells arrives as csc, so
        # the coo entries are sorted by primary face index. With split grids
        # the duplicated faces have the highest indices, which puts the
        # original side in the first half — the assumption behind
        # _ind_face_on_other_side below (reference ``mortar_grid.py:871``).
        order = np.lexsort((secondary_f, primary_f))
        secondary_f, primary_f, data = (
            secondary_f[order],
            primary_f[order],
            data[order],
        )

        if self.num_sides() == 2 and face_duplicate_ind is not None and self.codim < 2:
            second = np.isin(primary_f, face_duplicate_ind)
            secondary_f = np.r_[secondary_f[~second], secondary_f[second]]
            primary_f = np.r_[primary_f[~second], primary_f[second]]
            data = np.r_[data[~second], data[second]]

        if self.num_sides() == 2:
            sz = primary_f.size // 2
            self._ind_face_on_other_side = primary_f[sz:]

        ix = np.argsort(secondary_f, kind="stable")
        if self.num_sides() == 2 and self.codim < 2:
            if not np.all(np.bincount(secondary_f) == 2):
                raise ValueError(
                    "Each secondary cell must map to exactly two primary faces"
                )
            ix = np.reshape(ix, (2, -1), order="F").ravel("C")
        secondary_f = secondary_f[ix]
        primary_f = primary_f[ix]
        data = data[ix].astype(float)

        cells = np.arange(secondary_f.size)
        if self.num_cells != cells.size:
            raise ValueError("Mortar-secondary mapping must be one-to-one")

        self._primary_to_mortar_int = sps.csc_matrix(
            (data, (cells, primary_f)),
            shape=(self.num_cells, primary_secondary.shape[1]),
        )
        self._primary_to_mortar_avg = self._primary_to_mortar_int.copy()
        self._secondary_to_mortar_int = sps.csc_matrix(
            (data, (cells, secondary_f)),
            shape=(self.num_cells, primary_secondary.shape[0]),
        )
        self._secondary_to_mortar_avg = self._secondary_to_mortar_int.copy()

    def _set_projections(self, primary: bool = True, secondary: bool = True) -> None:
        if primary:
            self._mortar_to_primary_int = self._primary_to_mortar_avg.T.tocsc()
            self._mortar_to_primary_avg = self._primary_to_mortar_int.T.tocsc()
        if secondary:
            self._mortar_to_secondary_int = self._secondary_to_mortar_avg.T.tocsc()
            self._mortar_to_secondary_avg = self._secondary_to_mortar_int.T.tocsc()

    # -- projection accessors (Kronecker-expanded for vector dofs) -----------

    @staticmethod
    def _nd(mat: sps.spmatrix, nd: int) -> sps.spmatrix:
        if nd == 1:
            return mat
        return sps.kron(mat, sps.eye(nd)).tocsr()

    def primary_to_mortar_int(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._primary_to_mortar_int, nd)

    def primary_to_mortar_avg(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._primary_to_mortar_avg, nd)

    def secondary_to_mortar_int(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._secondary_to_mortar_int, nd)

    def secondary_to_mortar_avg(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._secondary_to_mortar_avg, nd)

    def mortar_to_primary_int(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._mortar_to_primary_int, nd)

    def mortar_to_primary_avg(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._mortar_to_primary_avg, nd)

    def mortar_to_secondary_int(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._mortar_to_secondary_int, nd)

    def mortar_to_secondary_avg(self, nd: int = 1) -> sps.spmatrix:
        return self._nd(self._mortar_to_secondary_avg, nd)

    def sign_of_mortar_sides(self, nd: int = 1) -> sps.dia_matrix:
        """Diagonal +-1 matrix: + on the first side's cells, - on the
        second's (defines the jump convention)."""
        nc = self.num_cells
        if self.num_sides() == 1:
            return sps.dia_matrix(
                (np.ones(nc * nd), 0), shape=(nd * nc, nd * nc)
            )
        vals = np.hstack(
            [
                -np.ones(nc // 2 * nd),
                np.ones(nc // 2 * nd),
            ]
        )
        return sps.dia_matrix((vals, 0), shape=(nd * nc, nd * nc))

    # -- updates (grid replacement) ------------------------------------------

    def update_mortar(self, new_side_grids, tol: Optional[float] = None) -> None:
        """Replace the mortar side grids (possibly refined/non-matching);
        both primary- and secondary-side projections are composed with the
        old-to-new overlap maps (reference ``mortar_grid.py:252``)."""
        from porepy_tpu_torch.grids import match_grids

        tol = self.tol if tol is None else tol
        if self.dim == 0:
            return
        match = {1: match_grids.match_1d, 2: match_grids.match_2d}[self.dim]

        avg_blocks, int_blocks = [], []
        for side, g_old in self.side_grids.items():
            g_new = new_side_grids.get(side)
            if g_new is None:
                eye = sps.identity(g_old.num_cells, format="csr")
                avg_blocks.append(eye)
                int_blocks.append(eye.copy())
                continue
            if g_new.dim != g_old.dim:
                raise ValueError("Grid dimension has to be the same")
            avg_blocks.append(match(g_new, g_old, tol, scaling="averaged"))
            int_blocks.append(match(g_new, g_old, tol, scaling="integrated"))
        remap_avg = sps.block_diag(avg_blocks, format="csc")
        remap_int = sps.block_diag(int_blocks, format="csc")

        self._primary_to_mortar_avg = (remap_avg @ self._primary_to_mortar_avg).tocsc()
        self._primary_to_mortar_int = (remap_int @ self._primary_to_mortar_int).tocsc()
        self._secondary_to_mortar_avg = (
            remap_avg @ self._secondary_to_mortar_avg
        ).tocsc()
        self._secondary_to_mortar_int = (
            remap_int @ self._secondary_to_mortar_int
        ).tocsc()
        self._set_projections()

        for side, g_new in new_side_grids.items():
            self.side_grids[side] = g_new.copy()
        self._refresh_geometry_attrs()
        self.compute_geometry()

    def update_secondary(self, new_g, tol: Optional[float] = None) -> None:
        """Rebuild the secondary-side projections after the secondary grid
        was replaced (matching or refined; reference
        ``mortar_grid.py:367``)."""
        from porepy_tpu_torch.grids import match_grids

        tol = self.tol if tol is None else tol
        if self.dim != new_g.dim:
            raise NotImplementedError(
                "update_secondary needs secondary and mortar of equal dimension"
            )
        if self.dim == 0:
            return
        match = {1: match_grids.match_1d, 2: match_grids.match_2d}[self.dim]
        avg_blocks, int_blocks = [], []
        for _side, g in self.side_grids.items():
            avg_blocks.append(match(g, new_g, tol, scaling="averaged"))
            int_blocks.append(match(g, new_g, tol, scaling="integrated"))
        self._secondary_to_mortar_avg = sps.vstack(avg_blocks).tocsc()
        self._secondary_to_mortar_int = sps.vstack(int_blocks).tocsc()
        self._set_projections(primary=False)

    def update_primary(self, g_new, g_old, tol: Optional[float] = None) -> None:
        """Re-key the primary-side projections after the primary
        (higher-dimensional) grid was replaced (reference
        ``mortar_grid.py:456``).

        Replacement grids need not match the old grid: for 1d mortars the
        old-to-new face weights come from tessellating both grids' fracture
        faces along the mortar line
        (:func:`~porepy_tpu.grids.match_grids.match_grids_along_1d_mortar`);
        0d mortars point-match the touched faces. 2d mortar updates (3d
        refinement across an interface) are not implemented, as in the
        reference.
        """
        tol = self.tol if tol is None else tol
        if self.dim == 0:
            old_faces = np.unique(self._primary_to_mortar_int.tocoo().col)
            pt = g_old.face_centers[:, old_faces]
            if np.any(
                np.linalg.norm(pt - pt[:, :1], axis=0) > tol
            ):
                raise ValueError(
                    "0d mortar faces must coincide in one physical point"
                )
            cand = g_new.get_all_boundary_faces()
            hit = cand[
                np.linalg.norm(
                    g_new.face_centers[:, cand] - pt[:, :1], axis=0
                )
                < tol
            ]
            split_int = sps.csc_matrix(
                (np.ones(old_faces.size), (old_faces, hit[: old_faces.size])),
                shape=(g_old.num_faces, g_new.num_faces),
            )
            split_avg = split_int.copy()
        elif self.dim == 1:
            from porepy_tpu_torch.grids import match_grids

            split_avg = match_grids.match_grids_along_1d_mortar(
                self, g_new, g_old, tol, scaling="averaged"
            )
            split_int = match_grids.match_grids_along_1d_mortar(
                self, g_new, g_old, tol, scaling="integrated"
            )
        else:
            raise NotImplementedError(
                "2d mortar primary updates are not implemented"
            )
        self._primary_to_mortar_avg = (
            self._primary_to_mortar_avg @ split_avg
        ).tocsc()
        self._primary_to_mortar_int = (
            self._primary_to_mortar_int @ split_int
        ).tocsc()
        self._set_projections(secondary=False)
