"""Case 3 of the 2d flow benchmark of Flemisch et al. (2018): ten
fractures, two of them blocking.

Counterpart of reference ``examples/flow_benchmark_2d_case_3.py``:
variants 3a (top-to-bottom flow) and 3b (left-to-right flow).
"""

from __future__ import annotations

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.boundary_conditions.model_boundary_conditions import (
    BoundaryConditionsMassDirNorthSouth,
    BoundaryConditionsMassDirWestEast,
)
from porepy_tpu_torch.applications.md_grids import fracture_sets
from porepy_tpu_torch.examples.flow_benchmark_2d_case_1 import FluxDiscretization
from porepy_tpu_torch.models.constitutive_laws import DimensionDependentPermeability
from porepy_tpu_torch.numerics import ad

__all__ = [
    "solid_constants",
    "Geometry",
    "Permeability",
    "Case3aBoundaryConditions",
    "Case3bBoundaryConditions",
    "FlowBenchmark2dCase3aModel",
    "FlowBenchmark2dCase3bModel",
]


solid_constants = pt.SolidConstants(residual_aperture=1e-4)


class Geometry:
    def set_fractures(self) -> None:
        self._fractures = fracture_sets.benchmark_2d_case_3()


class Case3aBoundaryConditions(BoundaryConditionsMassDirNorthSouth):
    """4 Pa at the inflow (north), 1 Pa at the outflow (south)."""

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.zeros(bg.num_cells)
        values[sides.north] = self.units.convert_units(4.0, "Pa")
        values[sides.south] = self.units.convert_units(1.0, "Pa")
        return values


class Case3bBoundaryConditions(BoundaryConditionsMassDirWestEast):
    """4 Pa at the inflow (west), 1 Pa at the outflow (east)."""

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.zeros(bg.num_cells)
        values[sides.west] = self.units.convert_units(4.0, "Pa")
        values[sides.east] = self.units.convert_units(1.0, "Pa")
        return values


class Permeability(DimensionDependentPermeability):
    """Per-fracture tangential permeabilities (fractures 4 and 5 are
    blocking); normal permeabilities by harmonic averaging at
    intersections."""

    @property
    def fracture_permeabilities(self) -> np.ndarray:
        return np.array([1, 1, 1, 1e-8, 1e-8, 1, 1, 1, 1, 1]) * 1e4

    def fracture_permeability(self, subdomains) -> ad.Operator:
        if len(subdomains) == 0:
            return ad.wrap_as_dense_ad_array(1.0, size=0)
        vals = np.concatenate(
            [
                self.units.convert_units(
                    self.fracture_permeabilities[sd.frac_num], "m^2"
                )
                * np.ones(sd.num_cells)
                for sd in subdomains
            ]
        )
        return self.isotropic_second_order_tensor(
            subdomains, ad.wrap_as_dense_ad_array(vals)
        )

    def intersection_permeability(self, subdomains) -> ad.Operator:
        if len(subdomains) == 0:
            return ad.wrap_as_dense_ad_array(1.0, size=0)
        vals = []
        for sd in subdomains:
            perms = self._parent_fracture_permeabilities(sd)
            harmonic = perms.size / np.sum(1.0 / perms)
            vals.append(harmonic * np.ones(sd.num_cells))
        return self.isotropic_second_order_tensor(
            subdomains,
            ad.wrap_as_dense_ad_array(
                self.units.convert_units(np.concatenate(vals), "m^2")
            ),
        )

    def _parent_fracture_permeabilities(self, sd) -> np.ndarray:
        intfs = self.subdomains_to_interfaces([sd], [1])
        parents = self.interfaces_to_subdomains(intfs)
        return np.unique(
            [
                self.fracture_permeabilities[p.frac_num]
                for p in parents
                if p.dim == sd.dim + 1
            ]
        )

    def normal_permeability(self, interfaces) -> ad.Operator:
        if len(interfaces) == 0:
            return ad.wrap_as_dense_ad_array(1.0, size=0)
        vals = []
        for intf in interfaces:
            _, sd_low = self.mdg.interface_to_subdomain_pair(intf)
            if intf.dim == 1:
                val = self.fracture_permeabilities[sd_low.frac_num]
            else:
                perms = self._parent_fracture_permeabilities(sd_low)
                val = perms.size / np.sum(1.0 / perms)
            vals.append(
                self.units.convert_units(val, "m^2") * np.ones(intf.num_cells)
            )
        return ad.wrap_as_dense_ad_array(
            np.concatenate(vals), name="normal_permeability"
        )


class FlowBenchmark2dCase3aModel(
    FluxDiscretization,
    Geometry,
    Permeability,
    Case3aBoundaryConditions,
    pt.SinglePhaseFlow,
):
    """Case 3a: top-to-bottom flow."""


class FlowBenchmark2dCase3bModel(
    FluxDiscretization,
    Geometry,
    Permeability,
    Case3bBoundaryConditions,
    pt.SinglePhaseFlow,
):
    """Case 3b: left-to-right flow."""
