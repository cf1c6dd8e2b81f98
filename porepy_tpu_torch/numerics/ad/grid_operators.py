"""Mixed-dimensional grid operators as AD leaves.

Parity counterpart of reference ``numerics/ad/grid_operators.py:26-887``:
projections between the global md cell/face spaces and subsets of
subdomains, divergence/trace operators, boundary projections. All are
constant sparse matrices built once from the grids (on host, at setup);
under the compiler they become BCOO gathers on device.

MortarProjections are added together with the MortarGrid implementation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.numerics.ad.operators import SparseArray

__all__ = [
    "SubdomainProjections",
    "Divergence",
    "Trace",
    "BoundaryProjection",
    "MortarProjections",
]


class MortarProjections:
    """Projections between concatenated mortar space and concatenated
    subdomain face/cell spaces (reference ``grid_operators.py:229``).

    Rows: mortar cells of ``interfaces`` in order; columns: faces (primary)
    or cells (secondary) of ``subdomains`` in order. All eight directional
    maps plus the side-sign matrix are exposed as callables returning
    constant sparse operators.
    """

    def __init__(self, mdg, subdomains: Sequence, interfaces: Sequence, dim: int = 1) -> None:
        self.mdg = mdg
        self.dim = dim
        self._subdomains = list(subdomains)
        self._interfaces = list(interfaces)

        tot_faces = sum(sd.num_faces for sd in subdomains) * dim
        tot_cells = sum(sd.num_cells for sd in subdomains) * dim
        tot_mortar = sum(intf.num_cells for intf in interfaces) * dim
        self._shapes = (tot_mortar, tot_faces, tot_cells)

        face_offset = {}
        cell_offset = {}
        f = c = 0
        for sd in subdomains:
            face_offset[sd] = f
            cell_offset[sd] = c
            f += sd.num_faces * dim
            c += sd.num_cells * dim

        def build(matrix_of, to_primary: bool) -> sps.csr_matrix:
            """Stack per-interface projection matrices into the global
            (mortar x faces/cells) layout."""
            tot_cols = tot_faces if to_primary else tot_cells
            offset = face_offset if to_primary else cell_offset
            rows, cols, vals = [], [], []
            m_off = 0
            for intf in interfaces:
                sd_pair = mdg.interface_to_subdomain_pair(intf)
                sd = sd_pair[0] if to_primary else sd_pair[1]
                # A neighbor absent from the subdomain list contributes a
                # zero block (reference allows restricting the subdomain
                # side, e.g. matrix-only stress assembly).
                if sd in offset:
                    mat = matrix_of(intf).tocoo()
                    rows.append(mat.row + m_off)
                    cols.append(mat.col + offset[sd])
                    vals.append(mat.data)
                m_off += intf.num_cells * dim
            if not rows:
                return sps.csr_matrix((tot_mortar, tot_cols))
            return sps.csr_matrix(
                (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                shape=(tot_mortar, tot_cols),
            )

        d = dim
        self._primary_to_mortar_int = build(
            lambda i: i.primary_to_mortar_int(d), True
        )
        self._primary_to_mortar_avg = build(
            lambda i: i.primary_to_mortar_avg(d), True
        )
        self._secondary_to_mortar_int = build(
            lambda i: i.secondary_to_mortar_int(d), False
        )
        self._secondary_to_mortar_avg = build(
            lambda i: i.secondary_to_mortar_avg(d), False
        )
        self._sign = sps.block_diag(
            [i.sign_of_mortar_sides(d) for i in interfaces] or [sps.csr_matrix((0, 0))],
            format="csr",
        )

    def primary_to_mortar_int(self) -> SparseArray:
        return SparseArray(self._primary_to_mortar_int, "primary_to_mortar_int")

    def primary_to_mortar_avg(self) -> SparseArray:
        return SparseArray(self._primary_to_mortar_avg, "primary_to_mortar_avg")

    def secondary_to_mortar_int(self) -> SparseArray:
        return SparseArray(self._secondary_to_mortar_int, "secondary_to_mortar_int")

    def secondary_to_mortar_avg(self) -> SparseArray:
        return SparseArray(self._secondary_to_mortar_avg, "secondary_to_mortar_avg")

    def mortar_to_primary_int(self) -> SparseArray:
        return SparseArray(
            self._primary_to_mortar_avg.T.tocsr(), "mortar_to_primary_int"
        )

    def mortar_to_primary_avg(self) -> SparseArray:
        return SparseArray(
            self._primary_to_mortar_int.T.tocsr(), "mortar_to_primary_avg"
        )

    def mortar_to_secondary_int(self) -> SparseArray:
        return SparseArray(
            self._secondary_to_mortar_avg.T.tocsr(), "mortar_to_secondary_int"
        )

    def mortar_to_secondary_avg(self) -> SparseArray:
        return SparseArray(
            self._secondary_to_mortar_int.T.tocsr(), "mortar_to_secondary_avg"
        )

    def sign_of_mortar_sides(self) -> SparseArray:
        return SparseArray(self._sign, "sign_of_mortar_sides")


def _block_diag(mats: Sequence[sps.spmatrix], shape_if_empty=(0, 0)) -> sps.csr_matrix:
    if len(mats) == 0:
        return sps.csr_matrix(shape_if_empty)
    return sps.block_diag(mats, format="csr")


class SubdomainProjections:
    """Restriction/prolongation between the concatenated cell/face space of
    a fixed list of subdomains and any sub-list thereof.

    The global ordering is the order of ``subdomains`` as passed (callers
    use md-sorted lists).
    """

    def __init__(self, subdomains: Sequence, dim: int = 1) -> None:
        self._subdomains = list(subdomains)
        self.dim = dim
        self._tot_cells = sum(sd.num_cells for sd in subdomains) * dim
        self._tot_faces = sum(sd.num_faces for sd in subdomains) * dim
        # Offsets per subdomain.
        self._cell_offset = {}
        self._face_offset = {}
        c = f = 0
        for sd in subdomains:
            self._cell_offset[sd] = c
            self._face_offset[sd] = f
            c += sd.num_cells * dim
            f += sd.num_faces * dim

    def _restriction(
        self, subdomains: Sequence, offsets: dict, total: int, counts
    ) -> sps.csr_matrix:
        rows = []
        cols = []
        pos = 0
        for sd in subdomains:
            n = counts(sd) * self.dim
            rows.append(np.arange(pos, pos + n))
            start = offsets[sd]
            cols.append(np.arange(start, start + n))
            pos += n
        if not rows:
            return sps.csr_matrix((0, total))
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        return sps.csr_matrix((np.ones(r.size), (r, c)), shape=(pos, total))

    def cell_restriction(self, subdomains: Sequence) -> SparseArray:
        m = self._restriction(
            subdomains, self._cell_offset, self._tot_cells, lambda s: s.num_cells
        )
        return SparseArray(m, name="cell_restriction")

    def cell_prolongation(self, subdomains: Sequence) -> SparseArray:
        m = self._restriction(
            subdomains, self._cell_offset, self._tot_cells, lambda s: s.num_cells
        ).T
        return SparseArray(m.tocsr(), name="cell_prolongation")

    def face_restriction(self, subdomains: Sequence) -> SparseArray:
        m = self._restriction(
            subdomains, self._face_offset, self._tot_faces, lambda s: s.num_faces
        )
        return SparseArray(m, name="face_restriction")

    def face_prolongation(self, subdomains: Sequence) -> SparseArray:
        m = self._restriction(
            subdomains, self._face_offset, self._tot_faces, lambda s: s.num_faces
        ).T
        return SparseArray(m.tocsr(), name="face_prolongation")


class Divergence(SparseArray):
    """Block-diagonal md divergence: faces -> cells over the given
    subdomains (reference ``grid_operators.py:887``)."""

    def __init__(self, subdomains: Sequence, dim: int = 1) -> None:
        mat = _block_diag(
            [sd.divergence(dim) for sd in subdomains],
            shape_if_empty=(0, 0),
        )
        super().__init__(mat, name="divergence")
        self._domains = tuple(subdomains)


class Trace(SparseArray):
    """Block-diagonal md trace: cell values -> boundary-face values."""

    def __init__(self, subdomains: Sequence, dim: int = 1) -> None:
        mat = _block_diag([sd.trace(dim) for sd in subdomains])
        super().__init__(mat, name="trace")
        self._domains = tuple(subdomains)


class BoundaryProjection:
    """Projection between subdomain face space and boundary-grid cell space
    over a list of subdomains (reference ``grid_operators.py:772``)."""

    def __init__(self, mdg, subdomains: Sequence, dim: int = 1) -> None:
        mats = []
        for sd in subdomains:
            bg = mdg.subdomain_to_boundary_grid(sd)
            if bg is not None:
                mats.append(bg.projection(dim))
            else:
                mats.append(sps.csr_matrix((0, sd.num_faces * dim)))
        self._mat = _block_diag(mats)

    @property
    def subdomain_to_boundary(self) -> SparseArray:
        return SparseArray(self._mat, name="subdomain_to_boundary")

    @property
    def boundary_to_subdomain(self) -> SparseArray:
        return SparseArray(self._mat.T.tocsr(), name="boundary_to_subdomain")
