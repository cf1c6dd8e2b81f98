"""Canned time-independent boundary-condition mixins (reference
``applications/boundary_conditions/model_boundary_conditions.py``)."""

from __future__ import annotations

import numpy as np

from porepy_tpu_torch.params.bc import BoundaryCondition

__all__ = [
    "BoundaryConditionsMassDirWestEast",
    "BoundaryConditionsMassDirNorthSouth",
    "BoundaryConditionsEnergyDirNorthSouth",
]


class BoundaryConditionsMassDirWestEast:
    """Dirichlet pressure on west (1) and east (0) boundaries, Neumann
    elsewhere."""

    def bc_type_darcy_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.west | sides.east, "dir")

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        vals = np.zeros(bg.num_cells)
        vals[sides.west] = self.units.convert_units(1.0, "Pa")
        return vals

    def bc_type_fluid_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.west | sides.east, "dir")


class BoundaryConditionsMassDirNorthSouth:
    """Dirichlet pressure on north (0) and south (1) boundaries."""

    def bc_type_darcy_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.north | sides.south, "dir")

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        vals = np.zeros(bg.num_cells)
        vals[sides.south] = self.units.convert_units(1.0, "Pa")
        return vals

    def bc_type_fluid_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.north | sides.south, "dir")


class BoundaryConditionsEnergyDirNorthSouth:
    """Dirichlet temperature on north (0) and south (1) boundaries."""

    def bc_type_fourier_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.north | sides.south, "dir")

    def bc_type_enthalpy_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        return BoundaryCondition(sd, sides.north | sides.south, "dir")

    def bc_values_temperature(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        vals = np.zeros(bg.num_cells)
        vals[sides.south] = self.units.convert_units(1.0, "K")
        return vals
