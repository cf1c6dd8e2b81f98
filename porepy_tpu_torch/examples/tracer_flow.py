"""Tracer transport as single-phase, two-component flow.

Counterpart of reference ``examples/tracer_flow.py``: water carrier plus a
passive tracer on a fractured unit square; pressure-driven north-to-south
flow advects the tracer entering at the north boundary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.boundary_conditions.model_boundary_conditions import (
    BoundaryConditionsMassDirNorthSouth,
)
from porepy_tpu_torch.applications.material_values.fluid_values import water
from porepy_tpu_torch.applications.md_grids.model_geometries import (
    SquareDomainOrthogonalFractures,
)
from porepy_tpu_torch.compositional.compositional_mixins import CompositionalVariables
from porepy_tpu_torch.models.compositional_flow import (
    BoundaryConditionsMulticomponent,
    ComponentMassBalanceEquations,
    InitialConditionsFractions,
)

__all__ = ["TracerFlowModel"]


class TracerFluid:
    """Water as the reference component plus a passive tracer."""

    def get_components(self) -> Sequence:
        return [pt.FluidComponent(**water), pt.FluidComponent(name="tracer")]


class TracerIC(InitialConditionsFractions):
    def ic_values_pressure(self, sd) -> np.ndarray:
        return np.ones(sd.num_cells) * self.units.convert_units(1e6, "Pa")

    def ic_values_overall_fraction(self, component, sd) -> np.ndarray:
        return np.zeros(sd.num_cells)


class TracerBC(BoundaryConditionsMassDirNorthSouth, BoundaryConditionsMulticomponent):
    """Pressure drop north to south; tracer-rich fluid enters at the north."""

    def bc_values_pressure(self, bg) -> np.ndarray:
        sides = self.domain_boundary_sides(bg)
        values = np.ones(bg.num_cells) * self.units.convert_units(1e6, "Pa")
        values[sides.north] = self.units.convert_units(1.5e6, "Pa")
        return values

    def bc_values_overall_fraction(self, component, bg) -> np.ndarray:
        z = np.zeros(bg.num_cells)
        if component.name == "tracer":
            sides = self.domain_boundary_sides(bg)
            z[sides.north] = 0.1 + 0.1 * (
                bg.cell_centers[0, sides.north] > 0.5
            )
        return z


class TracerFlowModel(
    SquareDomainOrthogonalFractures,
    TracerFluid,
    CompositionalVariables,
    ComponentMassBalanceEquations,
    TracerBC,
    TracerIC,
    pt.SinglePhaseFlow,
):
    """Tracer flow as single-phase two-component transport (reference
    ``tracer_flow.py:108``)."""


if __name__ == "__main__":
    time_manager = pt.TimeManager(
        schedule=[0, 20 * 60.0], dt_init=60.0, constant_dt=True
    )
    params = {
        "material_constants": {
            "solid": pt.SolidConstants(
                porosity=0.1, permeability=1e-7, normal_permeability=1e-19
            ),
        },
        "fracture_indices": [0, 1],
        "time_manager": time_manager,
        "max_iterations": 80,
        "nl_convergence_tol": 1e-6,
        "nl_convergence_tol_res": 1e-6,
        "meshing_arguments": {"cell_size": 0.1},
        "grid_type": "cartesian",
    }
    model = TracerFlowModel(params)
    pt.run_time_dependent_model(model, params)
