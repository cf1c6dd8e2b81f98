"""Case 1 of the 2d flow benchmark of Flemisch et al. (2018), "Benchmarks
for single-phase flow in fractured porous media", Adv. Water Resources 111.

Counterpart of reference ``examples/flow_benchmark_2d_case_1.py``: six
regular fractures on the unit square, inflow on the west boundary and unit
pressure on the east; variants 1a (conductive fractures) and 1b (blocking
fractures) via the supplied solid constants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.md_grids import fracture_sets
from porepy_tpu_torch.compositional.materials import SolidConstants
from porepy_tpu_torch.models.constitutive_laws import DimensionDependentPermeability
from porepy_tpu_torch.numerics import ad

__all__ = [
    "FractureSolidConstants",
    "solid_constants_conductive_fractures",
    "solid_constants_blocking_fractures",
    "Geometry",
    "BoundaryConditions",
    "Permeability",
    "FluxDiscretization",
    "FlowBenchmark2dCase1Model",
]


@dataclass(kw_only=True, eq=False)
class FractureSolidConstants(SolidConstants):
    """Solid constants extended with a separate fracture permeability."""

    SI_units: ClassVar[dict[str, str]] = dict(**SolidConstants.SI_units)
    SI_units.update({"fracture_permeability": "m^2"})

    fracture_permeability: float = 1.0


solid_constants_conductive_fractures = FractureSolidConstants(
    residual_aperture=1e-4,
    fracture_permeability=1e4,
    normal_permeability=1e4,
)
solid_constants_blocking_fractures = FractureSolidConstants(
    residual_aperture=1e-4,
    fracture_permeability=1e-4,
    normal_permeability=1e-4,
)


class FluxDiscretization:
    """Choose the Darcy discretization via ``params["flux_discretization"]``
    (``"tpfa"`` or ``"mpfa"``, default mpfa) — counterpart of reference
    ``applications/discretizations/flux_discretization.py``."""

    def darcy_flux_discretization(self, subdomains):
        from porepy_tpu_torch.numerics.ad.discretizations import MpfaAd, TpfaAd

        scheme = self.params.get("flux_discretization", "mpfa")
        cls = TpfaAd if scheme == "tpfa" else MpfaAd
        return cls(self.darcy_keyword, subdomains, self.mdg)


class Geometry:
    def set_fractures(self) -> None:
        self._fractures = fracture_sets.benchmark_2d_case_1()


class BoundaryConditions:
    """Unit inflow west, unit pressure east."""

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.zeros(bg.num_cells)
        values[sides.east] = self.units.convert_units(1, "Pa")
        return values

    def bc_type_darcy_flux(self, sd) -> pt.BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return pt.BoundaryCondition(sd, sides.east, "dir")

    def bc_values_darcy_flux(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.zeros(bg.num_cells)
        val = self.units.convert_units(-1, "m * s^-1")
        values[sides.west] = val * bg.cell_volumes[sides.west]
        # The inflow boundary crosses a fracture: weight by specific volume.
        sd = bg.parent
        specific_volumes = np.asarray(
            self.equation_system.evaluate(self.specific_volume([sd]))
        )
        values *= bg.projection() @ sd.trace() @ specific_volumes
        return values

    def bc_type_fluid_flux(self, sd) -> pt.BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return pt.BoundaryCondition(sd, sides.east, "dir")

    def bc_values_fluid_flux(self, bg) -> np.ndarray:
        # Advected-mass inflow matches the volumetric inflow times density
        # (unit here).
        return self.bc_values_darcy_flux(bg)


class Permeability(DimensionDependentPermeability):
    """Matrix permeability from ``solid.permeability``, fracture and
    intersection permeability from ``solid.fracture_permeability``."""

    def fracture_permeability(self, subdomains) -> ad.Operator:
        size = sum(sd.num_cells for sd in subdomains)
        permeability = ad.wrap_as_dense_ad_array(
            self.solid.fracture_permeability, size, name="fracture_permeability"
        )
        return self.isotropic_second_order_tensor(subdomains, permeability)

    def intersection_permeability(self, subdomains) -> ad.Operator:
        return self.fracture_permeability(subdomains)


class FlowBenchmark2dCase1Model(
    FluxDiscretization,
    Geometry,
    Permeability,
    BoundaryConditions,
    pt.SinglePhaseFlow,
):
    """Complete model for case 1 of the 2d flow benchmark."""
