"""AD wrappers of stored discretization matrices.

Parity counterpart of reference ``numerics/ad/discretizations.py`` +
``ad_utils.MergedOperator``: a :class:`MergedOperator` leaf represents the
block-diagonal of one named discretization matrix over a list of
subdomains, fetched from the grid data dicts *at compile time* (i.e. after
``discretize()`` has run, lazily at the first assembly). After
rediscretization, call ``EquationSystem.clear_compiled()`` so kernels
rebuild with the fresh matrices.
"""

from __future__ import annotations

from typing import Sequence

import scipy.sparse as sps

from porepy_tpu_torch.numerics.ad.operators import Operator
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["MergedOperator", "TpfaAd", "MpfaAd", "UpwindAd"]


class MergedOperator(Operator):
    """Leaf resolving to ``block_diag(data[kw][key] for sd in grids)``.

    ``sub_key`` addresses keyed coupling-term dictionaries (Biot stores one
    matrix per coupled scalar keyword).
    """

    def __init__(
        self,
        mdg,
        keyword: str,
        matrix_key: str,
        grids: Sequence,
        sub_key: str = None,
    ) -> None:
        name = f"{keyword}.{matrix_key}" + (f"[{sub_key}]" if sub_key else "")
        super().__init__(name=name, domains=grids)
        self.mdg = mdg
        self.keyword = keyword
        self.matrix_key = matrix_key
        self.sub_key = sub_key

    def fetch(self) -> sps.csr_matrix:
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        mats = []
        for g in self.domains:
            if isinstance(g, MortarGrid):
                data = self.mdg.interface_data(g)
            else:
                data = self.mdg.subdomain_data(g)
            mat = data[cc.DISCRETIZATION_MATRICES][self.keyword][self.matrix_key]
            if self.sub_key is not None:
                mat = mat[self.sub_key]
            mats.append(mat)
        if not mats:
            return sps.csr_matrix((0, 0))
        if len(mats) == 1:
            return mats[0].tocsr()
        return sps.block_diag(mats, format="csr")


class _DiscretizationAd:
    """Base: expose each stored matrix as a MergedOperator factory."""

    matrix_keys: tuple[str, ...] = ()

    def __init__(self, keyword: str, subdomains: Sequence, mdg) -> None:
        self.keyword = keyword
        self.subdomains = list(subdomains)
        self.mdg = mdg

    def _op(self, key: str) -> MergedOperator:
        return MergedOperator(self.mdg, self.keyword, key, self.subdomains)


class TpfaAd(_DiscretizationAd):
    """Reference ``ad/discretizations.py:87`` equivalent."""

    def flux(self) -> MergedOperator:
        return self._op("flux")

    def bound_flux(self) -> MergedOperator:
        return self._op("bound_flux")

    def bound_pressure_cell(self) -> MergedOperator:
        return self._op("bound_pressure_cell")

    def bound_pressure_face(self) -> MergedOperator:
        return self._op("bound_pressure_face")

    def vector_source(self) -> MergedOperator:
        return self._op("vector_source")

    def bound_pressure_vector_source(self) -> MergedOperator:
        return self._op("bound_pressure_vector_source")


class MpfaAd(TpfaAd):
    """Same matrix contract as TPFA; backed by the MPFA discretization."""


class MpsaAd(_DiscretizationAd):
    """Reference ``ad/discretizations.py:153`` equivalent."""

    def stress(self) -> MergedOperator:
        return self._op("stress")

    def bound_stress(self) -> MergedOperator:
        return self._op("bound_stress")

    def bound_displacement_cell(self) -> MergedOperator:
        return self._op("bound_displacement_cell")

    def bound_displacement_face(self) -> MergedOperator:
        return self._op("bound_displacement_face")


class TpsaAd(_DiscretizationAd):
    """AD wrapper for the Tpsa three-field discretization (reference
    ``ad/discretizations.py:192``)."""

    def stress(self) -> MergedOperator:
        return self._op("stress")

    def bound_stress(self) -> MergedOperator:
        return self._op("bound_stress")

    def stress_rotation(self) -> MergedOperator:
        return self._op("stress_rotation")

    def stress_total_pressure(self) -> MergedOperator:
        return self._op("stress_total_pressure")

    def rotation_displacement(self) -> MergedOperator:
        return self._op("rotation_displacement")

    def bound_rotation_displacement(self) -> MergedOperator:
        return self._op("bound_rotation_displacement")

    def rotation_rotation(self) -> MergedOperator:
        return self._op("rotation_rotation")

    def solid_mass_displacement(self) -> MergedOperator:
        return self._op("solid_mass_displacement")

    def bound_mass_displacement(self) -> MergedOperator:
        return self._op("bound_mass_displacement")

    def solid_mass_total_pressure(self) -> MergedOperator:
        return self._op("solid_mass_total_pressure")

    def bound_displacement_cell(self) -> MergedOperator:
        return self._op("bound_displacement_cell")

    def bound_displacement_face(self) -> MergedOperator:
        return self._op("bound_displacement_face")

    def bound_displacement_rotation_cell(self) -> MergedOperator:
        return self._op("bound_displacement_rotation_cell")

    def bound_displacement_solid_pressure_cell(self) -> MergedOperator:
        return self._op("bound_displacement_solid_pressure_cell")


class BiotAd(MpsaAd):
    """Reference ``ad/discretizations.py:87`` equivalent: MPSA matrices plus
    the keyword-addressed poromechanical coupling terms."""

    def _keyed(self, key: str, sub_key: str) -> MergedOperator:
        return MergedOperator(
            self.mdg, self.keyword, key, self.subdomains, sub_key=sub_key
        )

    def displacement_divergence(self, sub_key: str) -> MergedOperator:
        return self._keyed("displacement_divergence", sub_key)

    def bound_displacement_divergence(self, sub_key: str) -> MergedOperator:
        return self._keyed("boundary_displacement_divergence", sub_key)

    def scalar_gradient(self, sub_key: str) -> MergedOperator:
        return self._keyed("scalar_gradient", sub_key)

    def consistency(self, sub_key: str) -> MergedOperator:
        return self._keyed("mpsa_consistency", sub_key)

    def bound_pressure(self, sub_key: str) -> MergedOperator:
        return self._keyed("bound_displacement_pressure", sub_key)


class UpwindCouplingAd(_DiscretizationAd):
    """Interface upwind matrices (reference ``ad/discretizations.py:226``);
    domains are mortar grids."""

    def upwind_primary(self) -> MergedOperator:
        return self._op("upwind_primary")

    def upwind_secondary(self) -> MergedOperator:
        return self._op("upwind_secondary")

    def trace(self) -> MergedOperator:
        return self._op("trace")

    def inv_trace(self) -> MergedOperator:
        return self._op("inv_trace")

    def flux(self) -> MergedOperator:
        return self._op("flux")

    def mortar_discr(self) -> MergedOperator:
        return self._op("mortar_discr")


class UpwindAd(_DiscretizationAd):
    def upwind(self) -> MergedOperator:
        return self._op("transport")

    def bound_transport_dir(self) -> MergedOperator:
        return self._op("rhs_dir")

    def bound_transport_neu(self) -> MergedOperator:
        return self._op("rhs_neu")
