"""Energy balance: conduction + enthalpy advection.

Parity counterpart of reference ``models/energy_balance.py``: total
(fluid + solid) internal energy accumulation, Fourier + enthalpy fluxes
with upwinding, interface Fourier/enthalpy equations, and the mixin stack
for temperature as a primary variable.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models.abstract_equations import BalanceEquation, VariableMixin
from porepy_tpu_torch.models.boundary_condition import BoundaryConditionMixin
from porepy_tpu_torch.models.initial_condition import InitialConditionMixin
from porepy_tpu_torch.models.solution_strategy import SolutionStrategy
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.fv.tpfa import Tpfa
from porepy_tpu_torch.params.bc import BoundaryCondition
from porepy_tpu_torch.params.data import initialize_data

__all__ = [
    "TotalEnergyBalanceEquations",
    "VariablesEnergyBalance",
    "ConstitutiveLawsEnergyBalance",
    "BoundaryConditionsEnergyBalance",
    "InitialConditionsEnergy",
    "SolutionStrategyEnergyBalance",
]


class TotalEnergyBalanceEquations(BalanceEquation):
    """Reference ``energy_balance.py:23``."""

    @staticmethod
    def primary_equation_name() -> str:
        return "energy_balance_equation"

    def set_equations(self) -> None:
        super().set_equations()
        subdomains = self.mdg.subdomains()
        self.equation_system.set_equation(
            self.energy_balance_equation(subdomains), subdomains, {"cells": 1}
        )
        interfaces = self.mdg.interfaces(codim=1)
        if interfaces:
            self.equation_system.set_equation(
                self.interface_fourier_flux_equation(interfaces),
                interfaces,
                {"cells": 1},
            )
            self.equation_system.set_equation(
                self.interface_enthalpy_flux_equation(interfaces),
                interfaces,
                {"cells": 1},
            )

    def energy_balance_equation(self, subdomains: Sequence) -> ad.Operator:
        accumulation = self.volume_integral(
            self.total_internal_energy(subdomains), subdomains, dim=1
        )
        flux = self.energy_flux(subdomains)
        source = self.energy_source(subdomains)
        eq = self.balance_equation(subdomains, accumulation, flux, source, dim=1)
        eq.set_name(TotalEnergyBalanceEquations.primary_equation_name())
        return eq

    def fluid_internal_energy(self, subdomains: Sequence) -> ad.Operator:
        energy = (
            self.fluid.density(subdomains) * self.fluid.specific_enthalpy(subdomains)
            - self.pressure(subdomains)
        ) * self.porosity(subdomains)
        energy.set_name("fluid_internal_energy")
        return energy

    def solid_internal_energy(self, subdomains: Sequence) -> ad.Operator:
        energy = (
            self.solid_density(subdomains)
            * self.solid_enthalpy(subdomains)
            * (ad.Scalar(1.0) - self.porosity(subdomains))
        )
        energy.set_name("solid_internal_energy")
        return energy

    def total_internal_energy(self, subdomains: Sequence) -> ad.Operator:
        energy = self.fluid_internal_energy(subdomains) + self.solid_internal_energy(
            subdomains
        )
        energy.set_name("total_energy")
        return energy

    def energy_flux(self, subdomains: Sequence) -> ad.Operator:
        flux = self.fourier_flux(subdomains) + self.enthalpy_flux(subdomains)
        flux.set_name("energy_flux")
        return flux

    def interface_energy_flux(self, interfaces: Sequence) -> ad.Operator:
        flux = self.interface_fourier_flux(interfaces) + self.interface_enthalpy_flux(
            interfaces
        )
        flux.set_name("interface_energy_flux")
        return flux

    def advection_weight_energy_balance(self, domains: Sequence) -> ad.Operator:
        op = (
            self.fluid.specific_enthalpy(domains)
            * self.fluid.density(domains)
            * self.mobility(domains)
        )
        op.set_name("advected_enthalpy")
        return op

    def enthalpy_flux(self, domains: Sequence) -> ad.Operator:
        if len(domains) == 0 or all(isinstance(g, BoundaryGrid) for g in domains):
            return self.create_boundary_operator(
                name=self.bc_data_enthalpy_flux_key, domains=domains
            )
        subdomains = list(domains)
        boundary_operator = self._combine_boundary_operators(
            subdomains=subdomains,
            dirichlet_operator=self.advection_weight_energy_balance,
            neumann_operator=self.enthalpy_flux,
            robin_operator=None,
            bc_type=self.bc_type_enthalpy_flux,
            name="bc_values_enthalpy",
        )
        discr = self.enthalpy_discretization(subdomains)
        flux = self.advective_flux(
            subdomains,
            self.advection_weight_energy_balance(subdomains),
            discr,
            boundary_operator,
            self.interface_enthalpy_flux,
            bc_type=self.bc_type_enthalpy_flux,
        )
        flux.set_name("enthalpy_flux")
        return flux

    def interface_enthalpy_flux_equation(self, interfaces: Sequence) -> ad.Operator:
        subdomains = self.interfaces_to_subdomains(interfaces)
        discr = self.interface_enthalpy_discretization(interfaces)
        flux = self.interface_advective_flux(
            interfaces, self.advection_weight_energy_balance(subdomains), discr
        )
        eq = self.interface_enthalpy_flux(interfaces) - flux
        eq.set_name("interface_enthalpy_flux_equation")
        return eq

    def energy_source(self, subdomains: Sequence) -> ad.Operator:
        num_cells = sum(sd.num_cells for sd in subdomains)
        source = ad.DenseArray(np.zeros(num_cells), name="energy_source")
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            intf_source = projection.mortar_to_secondary_int() @ (
                self.interface_energy_flux(interfaces)
            )
            intf_source.set_name("interface_energy_flux_source")
            source = source + intf_source
        return source


class VariablesEnergyBalance(VariableMixin):
    temperature_variable: str = "temperature"
    interface_fourier_flux_variable: str = "interface_fourier_flux"
    interface_enthalpy_flux_variable: str = "interface_enthalpy_flux"

    def create_variables(self) -> None:
        super().create_variables()
        self.equation_system.create_variables(
            self.temperature_variable,
            subdomains=self.mdg.subdomains(),
            tags={"si_units": "K"},
        )
        if self.mdg.interfaces(codim=1):
            self.equation_system.create_variables(
                self.interface_fourier_flux_variable,
                interfaces=self.mdg.interfaces(codim=1),
            )
            self.equation_system.create_variables(
                self.interface_enthalpy_flux_variable,
                interfaces=self.mdg.interfaces(codim=1),
            )

    def temperature(self, domains: Sequence) -> ad.Operator:
        if len(domains) > 0 and all(isinstance(g, BoundaryGrid) for g in domains):
            return self.create_boundary_operator(
                name=self.temperature_variable, domains=domains
            )
        return self.equation_system.md_variable(self.temperature_variable, domains)

    def interface_fourier_flux(self, interfaces: Sequence) -> ad.Operator:
        return self.equation_system.md_variable(
            self.interface_fourier_flux_variable, interfaces
        )

    def interface_enthalpy_flux(self, interfaces: Sequence) -> ad.Operator:
        return self.equation_system.md_variable(
            self.interface_enthalpy_flux_variable, interfaces
        )


class ConstitutiveLawsEnergyBalance(
    constitutive_laws.EnthalpyFromTemperature,
    constitutive_laws.SecondOrderTensorUtils,
    constitutive_laws.FouriersLaw,
    constitutive_laws.ThermalConductivityLTE,
    constitutive_laws.DimensionReduction,
    constitutive_laws.AdvectiveFlux,
    constitutive_laws.FluidDensityFromPressureAndTemperature,
    constitutive_laws.ConstantSolidDensity,
):
    """Reference ``energy_balance.py:673``."""


class BoundaryConditionsEnergyBalance(BoundaryConditionMixin):
    bc_data_fourier_flux_key: str = "fourier_flux"
    bc_data_enthalpy_flux_key: str = "enthalpy_flux"

    def bc_type_fourier_flux(self, sd) -> BoundaryCondition:
        return BoundaryCondition(sd, self.domain_boundary_sides(sd).all_bf, "dir")

    def bc_type_enthalpy_flux(self, sd) -> BoundaryCondition:
        return BoundaryCondition(sd, self.domain_boundary_sides(sd).all_bf, "dir")

    def bc_values_temperature(self, bg: BoundaryGrid) -> np.ndarray:
        return self.reference_variable_values.temperature * np.ones(bg.num_cells)

    def bc_values_fourier_flux(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def bc_values_enthalpy_flux(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        self.update_boundary_condition(
            name=self.bc_data_fourier_flux_key, function=self.bc_values_fourier_flux
        )
        self.update_boundary_condition(
            name=self.bc_data_enthalpy_flux_key,
            function=self.bc_values_enthalpy_flux,
        )

    def update_boundary_values_primary_variables(self) -> None:
        super().update_boundary_values_primary_variables()
        self.update_boundary_condition(
            name=self.temperature_variable, function=self.bc_values_temperature
        )


class InitialConditionsEnergy(InitialConditionMixin):
    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains():
            self.equation_system.set_variable_values(
                self.ic_values_temperature(sd),
                [self.equation_system.md_variable(self.temperature_variable, [sd])],
                iterate_index=0,
            )

    def ic_values_temperature(self, sd) -> np.ndarray:
        return self.reference_variable_values.temperature * np.ones(sd.num_cells)


class SolutionStrategyEnergyBalance(SolutionStrategy):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.fourier_keyword: str = "fourier_discretization"
        self.enthalpy_keyword: str = "enthalpy_flux_discretization"

    def update_discretization_parameters(self) -> None:
        super().update_discretization_parameters()
        if not hasattr(self, "_discretizations"):
            self._discretizations = []
        subdomains = self.mdg.subdomains()
        discr = self._fv_discretizer(
            self.fourier_keyword, self.fourier_flux_discretization(subdomains)
        )
        for sd, data in self.mdg.subdomains(return_data=True):
            initialize_data(
                data,
                self.fourier_keyword,
                {
                    "bc": self.bc_type_fourier_flux(sd),
                    "second_order_tensor": self.operator_to_SecondOrderTensor(
                        sd,
                        self.thermal_conductivity([sd]),
                        self.solid.thermal_conductivity,
                    ),
                    "ambient_dimension": self.nd,
                },
            )
            self._register_discretization(discr, sd, data)

    def _is_nonlinear_problem(self) -> bool:
        return True
