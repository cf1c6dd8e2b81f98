"""Single-phase fluid mass balance.

Parity counterpart of reference ``models/fluid_mass_balance.py``: the
equation structure (accumulation + div(upwinded advective flux) - source),
variable/BC/IC mixins, solution strategy, and the composed
:class:`SinglePhaseFlow` model. Interface (mortar) couplings activate when
the mdg carries interfaces (fracs layer).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models.abstract_equations import BalanceEquation, VariableMixin
from porepy_tpu_torch.models.boundary_condition import BoundaryConditionMixin
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.models.initial_condition import InitialConditionMixin
from porepy_tpu_torch.models.solution_strategy import SolutionStrategy
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.fv.tpfa import Tpfa
from porepy_tpu_torch.params.bc import BoundaryCondition
from porepy_tpu_torch.params.data import initialize_data
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = [
    "FluidMassBalanceEquations",
    "VariablesSinglePhaseFlow",
    "ConstitutiveLawsSinglePhaseFlow",
    "BoundaryConditionsSinglePhaseFlow",
    "InitialConditionsSinglePhaseFlow",
    "SolutionStrategySinglePhaseFlow",
    "SinglePhaseFlow",
]


class FluidMassBalanceEquations(BalanceEquation):
    """Mixed-dimensional fluid mass balance (reference
    ``fluid_mass_balance.py:28``)."""

    @staticmethod
    def primary_equation_name() -> str:
        return "mass_balance_equation"

    def set_equations(self) -> None:
        super().set_equations()
        subdomains = self.mdg.subdomains()
        sd_eq = self.mass_balance_equation(subdomains)
        self.equation_system.set_equation(sd_eq, subdomains, {"cells": 1})
        interfaces = self.mdg.interfaces(codim=1)
        if interfaces:
            intf_eq = self.interface_darcy_flux_equation(interfaces)
            self.equation_system.set_equation(intf_eq, interfaces, {"cells": 1})

    def mass_balance_equation(self, subdomains: Sequence) -> ad.Operator:
        accumulation = self.fluid_mass(subdomains)
        flux = self.fluid_flux(subdomains)
        source = self.fluid_source(subdomains)
        eq = self.balance_equation(subdomains, accumulation, flux, source, dim=1)
        # Explicit class reference: in multi-physics compositions `self`
        # would resolve to another physics' primary name.
        eq.set_name(FluidMassBalanceEquations.primary_equation_name())
        return eq

    def fluid_mass(self, subdomains: Sequence) -> ad.Operator:
        mass_density = self.fluid.density(subdomains) * self.porosity(subdomains)
        mass = self.volume_integral(mass_density, subdomains, dim=1)
        mass.set_name("fluid_mass")
        return mass

    def advection_weight_mass_balance(self, domains: Sequence) -> ad.Operator:
        return self.total_mass_mobility(domains)

    def fluid_flux(self, domains: Sequence) -> ad.Operator:
        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return self.create_boundary_operator(
                name=self.bc_data_fluid_flux_key, domains=domains
            )
        flux = self.advective_flux(
            list(domains),
            self.advection_weight_mass_balance(list(domains)),
            self.mobility_discretization(list(domains)),
            self.boundary_fluid_flux(list(domains)),
            self.interface_fluid_flux,
        )
        flux.set_name("fluid_flux")
        return flux

    def boundary_fluid_flux(self, subdomains: Sequence) -> ad.Operator:
        """Combined advected-entity boundary values: advection weight on
        Dirichlet faces, prescribed mass flux on Neumann faces — projected
        to the face space by the caller's upwind kernel."""
        boundary_grids = self.subdomains_to_boundary_grids(subdomains)
        op = self._combine_boundary_operators(
            subdomains=subdomains,
            dirichlet_operator=self.advection_weight_mass_balance,
            neumann_operator=self.fluid_flux,
            robin_operator=None,
            bc_type=self.bc_type_fluid_flux,
            name="bc_values_" + self.bc_data_fluid_flux_key,
        )
        _ = boundary_grids
        return op

    def interface_fluid_flux(self, interfaces: Sequence) -> ad.Operator:
        discr = self.interface_mobility_discretization(interfaces)
        weight = self.advection_weight_mass_balance(
            self.interfaces_to_subdomains(interfaces)
        )
        flux = self.interface_advective_flux(interfaces, weight, discr)
        flux.set_name("interface_fluid_flux")
        return flux

    def fluid_source(self, subdomains: Sequence) -> ad.Operator:
        """External sources plus influx from higher-dimensional neighbors
        through interfaces (reference ``fluid_mass_balance.py:343``)."""
        num_cells = sum(sd.num_cells for sd in subdomains)
        source = ad.DenseArray(np.zeros(num_cells), name="fluid_source")
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            intf_source = projection.mortar_to_secondary_int() @ (
                self.interface_fluid_flux(interfaces)
            )
            intf_source.set_name("interface_fluid_flux_source")
            source = source + intf_source
        return source


class VariablesSinglePhaseFlow(VariableMixin):
    """Pressure on subdomains; interface Darcy fluxes on interfaces
    (reference ``fluid_mass_balance.py:682``)."""

    pressure_variable: str = "pressure"
    interface_darcy_flux_variable: str = "interface_darcy_flux"

    def create_variables(self) -> None:
        super().create_variables()
        self.equation_system.create_variables(
            self.pressure_variable,
            subdomains=self.mdg.subdomains(),
            tags={"si_units": "Pa"},
        )
        if self.mdg.interfaces(codim=1):
            self.equation_system.create_variables(
                self.interface_darcy_flux_variable,
                interfaces=self.mdg.interfaces(codim=1),
                tags={"si_units": "m^2 * s^-1 * Pa"},
            )

    def pressure(self, domains: Sequence) -> ad.Operator:
        if len(domains) > 0 and all(isinstance(g, BoundaryGrid) for g in domains):
            return self.create_boundary_operator(
                name=self.pressure_variable, domains=domains
            )
        return self.equation_system.md_variable(self.pressure_variable, domains)

    def interface_darcy_flux(self, interfaces: Sequence) -> ad.Operator:
        return self.equation_system.md_variable(
            self.interface_darcy_flux_variable, interfaces
        )


class ConstitutiveLawsSinglePhaseFlow(
    constitutive_laws.ZeroGravityForce,
    constitutive_laws.DarcysLaw,
    constitutive_laws.DimensionReduction,
    constitutive_laws.AdvectiveFlux,
    constitutive_laws.ConstantPorosity,
    constitutive_laws.ConstantPermeability,
    constitutive_laws.SecondOrderTensorUtils,
    constitutive_laws.FluidDensityFromPressure,
    constitutive_laws.ConstantViscosity,
    constitutive_laws.FluidMobility,
):
    """Constitutive stack for single-phase flow (reference
    ``fluid_mass_balance.py:389``)."""


class BoundaryConditionsSinglePhaseFlow(BoundaryConditionMixin):
    bc_data_darcy_flux_key: str = "darcy_flux"
    bc_data_fluid_flux_key: str = "fluid_flux"

    def bc_type_darcy_flux(self, sd) -> BoundaryCondition:
        boundary_faces = self.domain_boundary_sides(sd).all_bf
        return BoundaryCondition(sd, boundary_faces, "dir")

    def bc_type_fluid_flux(self, sd) -> BoundaryCondition:
        boundary_faces = self.domain_boundary_sides(sd).all_bf
        return BoundaryCondition(sd, boundary_faces, "dir")

    def bc_values_pressure(self, bg: BoundaryGrid) -> np.ndarray:
        return self.reference_variable_values.pressure * np.ones(bg.num_cells)

    def bc_values_darcy_flux(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def bc_values_fluid_flux(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        self.update_boundary_condition(
            name=self.bc_data_darcy_flux_key, function=self.bc_values_darcy_flux
        )
        self.update_boundary_condition(
            name=self.bc_data_fluid_flux_key, function=self.bc_values_fluid_flux
        )

    def update_boundary_values_primary_variables(self) -> None:
        super().update_boundary_values_primary_variables()
        self.update_boundary_condition(
            name=self.pressure_variable, function=self.bc_values_pressure
        )


class InitialConditionsSinglePhaseFlow(InitialConditionMixin):
    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains():
            self.equation_system.set_variable_values(
                self.ic_values_pressure(sd),
                [self.equation_system.md_variable(self.pressure_variable, [sd])],
                iterate_index=0,
            )

    def ic_values_pressure(self, sd) -> np.ndarray:
        return self.reference_variable_values.pressure * np.ones(sd.num_cells)


class SolutionStrategySinglePhaseFlow(SolutionStrategy):
    """Strategy: scalar elliptic/parabolic problem, TPFA default
    (reference ``fluid_mass_balance.py:811``)."""

    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.darcy_keyword: str = "flow"
        self.mobility_keyword: str = "mobility"

    def update_discretization_parameters(self) -> None:
        self._discretizations = []
        super().update_discretization_parameters()
        subdomains = self.mdg.subdomains()
        discr = self._fv_discretizer(
            self.darcy_keyword, self.darcy_flux_discretization(subdomains)
        )
        for sd, data in self.mdg.subdomains(return_data=True):
            initialize_data(
                data,
                self.darcy_keyword,
                {
                    "bc": self.bc_type_darcy_flux(sd),
                    "second_order_tensor": self.operator_to_SecondOrderTensor(
                        sd, self.permeability([sd]), self.solid.permeability
                    ),
                    "ambient_dimension": self.nd,
                },
            )
            self._register_discretization(discr, sd, data)

    def _is_nonlinear_problem(self) -> bool:
        """Compressible flow is nonlinear; incompressible subclasses
        override."""
        return self.fluid.reference_component.compressibility > 0


class SinglePhaseFlow(
    FluidMassBalanceEquations,
    VariablesSinglePhaseFlow,
    ConstitutiveLawsSinglePhaseFlow,
    BoundaryConditionsSinglePhaseFlow,
    InitialConditionsSinglePhaseFlow,
    SolutionStrategySinglePhaseFlow,
    ModelGeometry,
    DataSavingMixin,
):
    """Single-phase flow in (mixed-dimensional) porous media."""
