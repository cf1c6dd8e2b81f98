"""Compositional flow: multiphase, multicomponent transport templates.

Parity counterpart of reference ``models/compositional_flow.py`` (the CF/CFF
templates, ``:305-1927``): component mass balances on top of the total mass
(pressure) equation, an enthalpy-based energy balance, fractional-flow
variants, surrogate-backed phase properties, and the solution-strategy
orchestration that keeps the externally computed property values in sync with
the Newton iteration.

TPU-first notes: the nonlinear advective weights compile into the jitted
residual (in-kernel upwinding, no per-iteration upwind matrices); surrogate
phase properties enter through the env-argument mechanism of the compiler
(``numerics/ad/surrogate_operator.py``) so property updates never trigger
recompilation; the fractional-flow total-mobility tensor is refreshed on the
host per iteration (a rediscretization, matching the reference's lagged
treatment) while everything per-Newton-step stays on device.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np

from porepy_tpu_torch.compositional.compositional_mixins import (
    CompositionalVariables,
    FluidMixin,
)
from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models.abstract_equations import BalanceEquation, VariableMixin
from porepy_tpu_torch.models.boundary_condition import BoundaryConditionMixin
from porepy_tpu_torch.models.energy_balance import (
    BoundaryConditionsEnergyBalance,
    InitialConditionsEnergy,
    TotalEnergyBalanceEquations,
    VariablesEnergyBalance,
)
from porepy_tpu_torch.models.fluid_mass_balance import (
    BoundaryConditionsSinglePhaseFlow,
    FluidMassBalanceEquations,
    InitialConditionsSinglePhaseFlow,
    SolutionStrategySinglePhaseFlow,
    VariablesSinglePhaseFlow,
)
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.models.initial_condition import InitialConditionMixin
from porepy_tpu_torch.models.mass_and_energy_balance import (
    SolutionStrategyFluidMassAndEnergy,
)
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = [
    "update_phase_properties",
    "is_fractional_flow",
    "get_primary_equations_cf",
    "get_primary_variables_cf",
    "MassicPressureEquations",
    "ComponentMassBalanceEquations",
    "EnthalpyVariable",
    "EnthalpyBasedEnergyBalanceEquations",
    "PrimaryEquationsCF",
    "VariablesCF",
    "ConstitutiveLawsCF",
    "ConstitutiveLawsCFF",
    "BoundaryConditionsMulticomponent",
    "BoundaryConditionsPhaseProperties",
    "BoundaryConditionsFractionalFlow",
    "BoundaryConditionsCF",
    "InitialConditionsFractions",
    "InitialConditionsCF",
    "SolutionStrategyPhaseProperties",
    "SolutionStrategyCF",
    "CompositionalFlowTemplate",
    "CompositionalFractionalFlowTemplate",
]

logger = logging.getLogger(__name__)


def update_phase_properties(
    grid,
    phase,
    props,
    depth: int,
    update_derivatives: bool = True,
) -> None:
    """Push a :class:`~porepy_tpu.compositional.states.PhaseState` into the
    phase's surrogate factories on one grid (reference
    ``compositional_flow.py:117``). ``depth=0`` overwrites the current
    iterate; ``depth>0`` shifts the iterate ring first."""
    for attr, vals, diffs in (
        ("density", props.rho, props.drho),
        ("specific_enthalpy", props.h, props.dh),
        ("viscosity", props.mu, props.dmu),
        ("thermal_conductivity", props.kappa, props.dkappa),
    ):
        factory = getattr(phase, attr, None)
        if isinstance(factory, ad.SurrogateFactory):
            if depth > 0:
                factory.progress_iterate_values_on_grid(
                    np.asarray(vals), grid, depth=depth
                )
            else:
                factory.set_values_on_grid(np.asarray(vals), grid)
            if update_derivatives:
                factory.set_derivatives_on_grid(np.asarray(diffs), grid)


def is_fractional_flow(model) -> bool:
    """Whether the model treats advective weights as fractional mobilities
    with the total mobility inside the diffusive tensor (reference
    ``compositional_flow.py:192``)."""
    return bool(model.params.get("fractional_flow", False))


def get_primary_equations_cf(model) -> list[str]:
    """Default primary equations of the CF setting: total mass, total
    energy, component mass balances (reference ``compositional_flow.py:236``)."""
    names: list[str] = []
    if isinstance(model, FluidMassBalanceEquations):
        names.append(FluidMassBalanceEquations.primary_equation_name())
    if isinstance(model, TotalEnergyBalanceEquations):
        names.append(TotalEnergyBalanceEquations.primary_equation_name())
    if isinstance(model, ComponentMassBalanceEquations):
        names.extend(model.component_mass_balance_equation_names())
    return names


def get_primary_variables_cf(model) -> list[str]:
    """Default primary variables: pressure, enthalpy (or temperature),
    overall fractions (reference ``compositional_flow.py:268``)."""
    names: list[str] = []
    if isinstance(model, SolutionStrategySinglePhaseFlow):
        names.append(model.pressure_variable)
    if hasattr(model, "enthalpy_variable"):
        names.append(model.enthalpy_variable)
    elif hasattr(model, "temperature_variable"):
        names.append(model.temperature_variable)
    if isinstance(model, CompositionalVariables):
        names.extend(model.overall_fraction_variables)
    return names


# -- balance equations ----------------------------------------------------------


class MassicPressureEquations(FluidMassBalanceEquations):
    """Total mass balance whose flux is the (massic) Darcy flux itself — the
    mobility and density sit inside the nonlinear diffusive tensor
    (fractional-flow formulation; reference ``compositional_flow.py:305``)."""

    def fluid_flux(self, domains: Sequence) -> ad.Operator:
        return self.darcy_flux(domains)

    def interface_fluid_flux(self, interfaces: Sequence) -> ad.Operator:
        return self.interface_darcy_flux(interfaces)


class ComponentMassBalanceEquations(BalanceEquation):
    """Mass balance per independent component (reference
    ``compositional_flow.py:497``):

    ``d_t(phi rho z_c) + div(w_c q) = source_c``

    with advective weight ``w_c`` the component mass mobility (standard
    formulation) or the fractional component mass mobility (fractional
    flow). Requires the total mass balance in the system for the interface
    fluxes."""

    def _mass_balance_equation_name(self, component) -> str:
        return f"component_mass_balance_equation_{component.name}"

    def component_mass_balance_equation_names(self) -> list[str]:
        return [
            self._mass_balance_equation_name(c)
            for c in self.fluid.components
            if self.has_independent_fraction(c)
        ]

    def has_independent_fraction(self, component) -> bool:
        """True when the component's overall fraction is a genuine unknown
        (not the unity-eliminated reference component)."""
        if self.fluid.num_components == 1:
            return False
        if component is self.fluid.reference_component:
            return not self.params.get("eliminate_reference_component", True)
        return True

    def set_equations(self) -> None:
        super().set_equations()
        subdomains = self.mdg.subdomains()
        for component in self.fluid.components:
            if self.has_independent_fraction(component):
                eq = self.component_mass_balance_equation(component, subdomains)
                self.equation_system.set_equation(eq, subdomains, {"cells": 1})

    def component_mass_balance_equation(
        self, component, subdomains: Sequence
    ) -> ad.Operator:
        accumulation = self.volume_integral(
            self.component_mass(component, subdomains), subdomains, dim=1
        )
        flux = self.component_flux(component, subdomains)
        source = self.component_source(component, subdomains)
        eq = self.balance_equation(subdomains, accumulation, flux, source, dim=1)
        eq.set_name(self._mass_balance_equation_name(component))
        return eq

    def component_mass(self, component, subdomains: Sequence) -> ad.Operator:
        """``phi rho z_c`` (reference ``compositional_flow.py:645``)."""
        out = (
            self.porosity(subdomains)
            * self.fluid.density(subdomains)
            * component.fraction(subdomains)
        )
        out.set_name(f"component_mass_{component.name}")
        return out

    def advection_weight_component_mass_balance(
        self, component, domains: Sequence
    ) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if is_fractional_flow(self):
            if len(domains) > 0 and all(
                isinstance(g, BoundaryGrid) for g in domains
            ):
                return self.create_boundary_operator(
                    self.bc_data_fractional_flow_component_key(component), domains
                )
            return self.fractional_component_mass_mobility(component, domains)
        return self.component_mass_mobility(component, domains)

    def component_flux(self, component, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            if is_fractional_flow(self):
                return self.advection_weight_component_mass_balance(
                    component, domains
                ) * self.darcy_flux(domains)
            return self.create_boundary_operator(
                self.bc_data_component_flux_key(component), domains
            )
        flux = self.advective_flux(
            list(domains),
            self.advection_weight_component_mass_balance(component, list(domains)),
            self.mobility_discretization(list(domains)),
            self.boundary_component_flux(component, list(domains)),
            partial(self.interface_component_flux, component),
        )
        # Hybrid-upwinded counter-current buoyant flux (reference
        # ``compositional_flow.py:636``).
        if self.params.get("enable_buoyancy_effects", False):
            flux = flux + self.component_buoyancy(component, list(domains))
        flux.set_name(f"component_flux_{component.name}")
        return flux

    def boundary_component_flux(self, component, domains: Sequence) -> ad.Operator:
        return self._combine_boundary_operators(
            subdomains=domains,
            dirichlet_operator=partial(
                self.advection_weight_component_mass_balance, component
            ),
            neumann_operator=partial(self.component_flux, component),
            robin_operator=None,
            bc_type=self.bc_type_fluid_flux,
            name=f"bc_values_component_flux_{component.name}",
        )

    def boundary_fluid_flux(self, subdomains: Sequence) -> ad.Operator:
        """Total boundary mass flux = sum of component boundary fluxes
        (reference ``compositional_flow.py:795``); overrides the single-phase
        representation for consistency."""
        return ad.sum_operator_list(
            [
                self.boundary_component_flux(c, subdomains)
                for c in self.fluid.components
            ],
            "bc_values_total_fluid_flux",
        )

    def interface_component_flux(self, component, interfaces: Sequence) -> ad.Operator:
        subdomains = self.interfaces_to_subdomains(interfaces)
        discr = self.interface_mobility_discretization(interfaces)
        weight = self.advection_weight_component_mass_balance(component, subdomains)
        flux = self.interface_advective_flux(interfaces, weight, discr)
        flux.set_name(f"interface_component_flux_{component.name}")
        return flux

    def component_source(self, component, subdomains: Sequence) -> ad.Operator:
        """Interface component fluxes appearing as sources in
        lower-dimensional subdomains (reference ``compositional_flow.py:876``)."""
        num_cells = sum(sd.num_cells for sd in subdomains)
        source = ad.DenseArray(
            np.zeros(num_cells), name=f"component_source_{component.name}"
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            intf = projection.mortar_to_secondary_int() @ (
                self.interface_component_flux(component, interfaces)
            )
            intf.set_name(f"interface_component_flux_source_{component.name}")
            source = source + intf
        # Secondary-side jump of the interface buoyant coupling (reference
        # ``compositional_flow.py:909``).
        if self.params.get("enable_buoyancy_effects", False):
            source = source + self.component_buoyancy_jump(
                component, subdomains
            )
        return source


class EnthalpyVariable(VariableMixin):
    """Specific fluid enthalpy as an independent cell variable."""

    def create_variables(self) -> None:
        super().create_variables()
        self.equation_system.create_variables(
            self.enthalpy_variable,
            dof_info={"cells": 1},
            subdomains=self.mdg.subdomains(),
        )

    def enthalpy(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) > 0 and all(isinstance(g, BoundaryGrid) for g in domains):
            return self.create_boundary_operator(
                name=self.enthalpy_variable, domains=domains
            )
        return self.equation_system.md_variable(self.enthalpy_variable, domains)


class EnthalpyBasedEnergyBalanceEquations(TotalEnergyBalanceEquations):
    """Total energy balance with an independent enthalpy variable in the
    accumulation term and temperature in the Fourier flux (reference
    ``compositional_flow.py:365``). Needs a local equation closing T against
    (p, h, ...) — e.g. via :class:`~porepy_tpu.models.abstract_equations.
    LocalElimination`."""

    def fluid_internal_energy(self, subdomains: Sequence) -> ad.Operator:
        energy = self.porosity(subdomains) * (
            self.fluid.density(subdomains) * self.enthalpy(subdomains)
            - self.pressure(subdomains)
        )
        energy.set_name("fluid_internal_energy")
        return energy

    def advection_weight_energy_balance(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if is_fractional_flow(self):
            if len(domains) > 0 and all(
                isinstance(g, BoundaryGrid) for g in domains
            ):
                return self.create_boundary_operator(
                    self.bc_data_fractional_flow_energy_key, domains
                )
            op = ad.sum_operator_list(
                [
                    phase.specific_enthalpy(domains)
                    * self.fractional_phase_mass_mobility(phase, domains)
                    for phase in self.fluid.phases
                ]
            )
            op.set_name("advected_enthalpy")
            return op
        op = ad.sum_operator_list(
            [
                phase.specific_enthalpy(domains)
                * phase.density(domains)
                * self.phase_mobility(phase, domains)
                for phase in self.fluid.phases
            ]
        )
        op.set_name("advected_enthalpy")
        return op

    def enthalpy_flux(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if (
            len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains)
        ) and is_fractional_flow(self):
            return self.advection_weight_energy_balance(
                domains
            ) * self.darcy_flux(domains)
        flux = super().enthalpy_flux(domains)
        # Hybrid-upwinded buoyant enthalpy flux (reference
        # ``compositional_flow.py:482-487``).
        if self.params.get("enable_buoyancy_effects", False) and not all(
            isinstance(d, BoundaryGrid) for d in domains
        ):
            flux = flux + self.enthalpy_buoyancy(list(domains))
        return flux

    def energy_source(self, subdomains: Sequence) -> ad.Operator:
        source = super().energy_source(subdomains)
        # Secondary-side jump of the buoyant enthalpy coupling (reference
        # ``compositional_flow.py:489-493``).
        if self.params.get("enable_buoyancy_effects", False):
            source = source + self.enthalpy_buoyancy_jump(list(subdomains))
        return source


# -- aggregated mixins ------------------------------------------------------------


class PrimaryEquationsCF(
    EnthalpyBasedEnergyBalanceEquations,
    ComponentMassBalanceEquations,
    FluidMassBalanceEquations,
):
    """Total mass + total energy + component mass balances (reference
    ``compositional_flow.py:930``)."""


class PrimaryEquationsCFF(
    EnthalpyBasedEnergyBalanceEquations,
    ComponentMassBalanceEquations,
    MassicPressureEquations,
):
    """Fractional-flow variant: the pressure equation carries the massic
    Darcy flux (reference ``compositional_flow.py:948``)."""


class VariablesCF(
    EnthalpyVariable,
    VariablesEnergyBalance,
    VariablesSinglePhaseFlow,
    CompositionalVariables,
):
    """Pressure, enthalpy, temperature, interface fluxes, and the fractional
    unknowns of the fluid mixture (reference ``compositional_flow.py:966``)."""


class SurrogateFluidMixin(FluidMixin):
    """FluidMixin whose phase properties are surrogate factories when
    dependencies are declared (reference ``compositional_mixins.py:988``):
    override :meth:`dependencies_of_phase_properties` to activate; property
    values then come from :meth:`update_thermodynamic_properties_of_phases`
    via each phase's EoS."""

    def _surrogate_or_heuristic(self, prop: str, phase, heuristic):
        deps = self.dependencies_of_phase_properties(phase)
        if deps:
            return ad.SurrogateFactory(
                f"phase_{phase.name}_{prop}", self.mdg, deps
            )
        return heuristic()

    def density_of_phase(self, phase):
        return self._surrogate_or_heuristic(
            "density", phase, lambda: super(SurrogateFluidMixin, self).density_of_phase(phase)
        )

    def specific_enthalpy_of_phase(self, phase):
        return self._surrogate_or_heuristic(
            "enthalpy",
            phase,
            lambda: super(SurrogateFluidMixin, self).specific_enthalpy_of_phase(phase),
        )

    def viscosity_of_phase(self, phase):
        return self._surrogate_or_heuristic(
            "viscosity",
            phase,
            lambda: super(SurrogateFluidMixin, self).viscosity_of_phase(phase),
        )

    def thermal_conductivity_of_phase(self, phase):
        return self._surrogate_or_heuristic(
            "conductivity",
            phase,
            lambda: super(SurrogateFluidMixin, self).thermal_conductivity_of_phase(
                phase
            ),
        )


class ConstitutiveLawsCF(
    SurrogateFluidMixin,
    constitutive_laws.ConstantPorosity,
    constitutive_laws.ConstantSolidDensity,
    constitutive_laws.EnthalpyFromTemperature,
    constitutive_laws.FluidDensityFromPressureAndTemperature,
    constitutive_laws.ConstantViscosity,
    # FluidBuoyancy above the zero default: the fluid gravity force is the
    # fractionally weighted density unless 'enable_buoyancy_effects' is
    # False (reference ``compositional_flow.py:1014-1017``).
    constitutive_laws.FluidBuoyancy,
    constitutive_laws.ZeroGravityForce,
    constitutive_laws.FluidMobility,
    constitutive_laws.ThermalConductivityLTE,
    constitutive_laws.FouriersLaw,
    constitutive_laws.SecondOrderTensorUtils,
    constitutive_laws.ConstantPermeability,
    constitutive_laws.DarcysLaw,
    constitutive_laws.DimensionReduction,
    constitutive_laws.AdvectiveFlux,
):
    """Constitutive laws for CF (reference ``compositional_flow.py:1006``),
    with the surrogate-capable fluid mixin on top."""


# -- boundary / initial conditions ---------------------------------------------------


class BoundaryConditionsMulticomponent(BoundaryConditionMixin):
    """BC values for overall fractions and component fluxes (reference
    ``compositional_flow.py:1043``)."""

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        for component in self.fluid.components:
            if self.has_independent_fraction(component):
                self.update_boundary_condition(
                    self._overall_fraction_variable(component),
                    partial(self.bc_values_overall_fraction, component),
                )
            # Flux values for ALL components: the total boundary mass flux
            # is the sum of the per-component fluxes.
            self.update_boundary_condition(
                self.bc_data_component_flux_key(component),
                partial(self.bc_values_component_flux, component),
            )

    def bc_data_component_flux_key(self, component) -> str:
        return f"component_flux_{component.name}"

    def bc_values_overall_fraction(self, component, bg) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def bc_values_component_flux(self, component, bg) -> np.ndarray:
        return np.zeros(bg.num_cells)


class BoundaryConditionsFractionalFlow(BoundaryConditionMixin):
    """Explicit boundary values for the fractional-flow advective weights
    (reference ``compositional_flow.py:1303``)."""

    bc_data_fractional_flow_energy_key: str = "fractional_flow_energy"

    def bc_data_fractional_flow_component_key(self, component) -> str:
        return f"fractional_flow_component_{component.name}"

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        for component in self.fluid.components:
            self.update_boundary_condition(
                self.bc_data_fractional_flow_component_key(component),
                partial(self.bc_values_fractional_flow_component, component),
            )
        self.update_boundary_condition(
            self.bc_data_fractional_flow_energy_key,
            self.bc_values_fractional_flow_energy,
        )

    def bc_values_fractional_flow_component(self, component, bg) -> np.ndarray:
        return np.zeros(bg.num_cells)

    def bc_values_fractional_flow_energy(self, bg) -> np.ndarray:
        return np.zeros(bg.num_cells)


class BoundaryConditionsPhaseProperties(BoundaryConditionMixin):
    """Boundary values for surrogate-backed phase properties, evaluated
    through each phase's EoS from the boundary values of the declared
    dependencies (reference ``compositional_flow.py:1221``)."""

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        for phase in self.fluid.phases:
            deps = self.dependencies_of_phase_properties(phase)
            if not deps or phase.eos is None:
                continue
            for bg in self.mdg.boundaries():
                dep_vals = [
                    np.asarray(self.equation_system.evaluate(d([bg])))
                    for d in deps
                ]
                props = phase.eos.compute_phase_properties(
                    phase.state, *dep_vals
                )
                from porepy_tpu_torch.utils.solution_storage import (
                    set_solution_values,
                )

                data = self.mdg.boundary_grid_data(bg)
                for attr, vals in (
                    ("density", props.rho),
                    ("specific_enthalpy", props.h),
                    ("viscosity", props.mu),
                    ("thermal_conductivity", props.kappa),
                ):
                    factory = getattr(phase, attr, None)
                    if isinstance(factory, ad.SurrogateFactory):
                        set_solution_values(
                            factory.name,
                            np.asarray(vals),
                            data,
                            iterate_index=0,
                        )


class BoundaryConditionsCF(
    BoundaryConditionsPhaseProperties,
    BoundaryConditionsMulticomponent,
    BoundaryConditionsEnergyBalance,
    BoundaryConditionsSinglePhaseFlow,
):
    """Collected BC mixins for CF (reference ``compositional_flow.py:1414``).

    Also provides enthalpy boundary values consistent with temperature."""

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        self.update_boundary_condition(
            self.enthalpy_variable, self.bc_values_enthalpy
        )

    def bc_values_enthalpy(self, bg) -> np.ndarray:
        return np.zeros(bg.num_cells)


class BoundaryConditionsCFF(
    BoundaryConditionsFractionalFlow,
    BoundaryConditionsCF,
):
    """CF boundary conditions plus explicit fractional-flow weights."""


class InitialConditionsFractions(InitialConditionMixin):
    """Initial values for independent overall fractions (reference
    ``compositional_flow.py:1445``)."""

    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains():
            for component in self.fluid.components:
                if self.has_independent_fraction(component):
                    self.equation_system.set_variable_values(
                        self.ic_values_overall_fraction(component, sd),
                        [
                            self.equation_system.md_variable(
                                self._overall_fraction_variable(component), [sd]
                            )
                        ],
                        iterate_index=0,
                    )

    def ic_values_overall_fraction(self, component, sd) -> np.ndarray:
        return np.zeros(sd.num_cells)


class InitialConditionsSaturations(InitialConditionMixin):
    """Initial values for independent saturations."""

    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        if self.fluid.num_phases == 1:
            return
        for sd in self.mdg.subdomains():
            for phase in self.fluid.phases:
                if phase is self.fluid.reference_phase and self.params.get(
                    "eliminate_reference_phase", True
                ):
                    continue
                self.equation_system.set_variable_values(
                    self.ic_values_saturation(phase, sd),
                    [
                        self.equation_system.md_variable(
                            self._saturation_variable(phase), [sd]
                        )
                    ],
                    iterate_index=0,
                )

    def ic_values_saturation(self, phase, sd) -> np.ndarray:
        return np.zeros(sd.num_cells)


class InitialConditionsEnthalpy(InitialConditionMixin):
    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains():
            self.equation_system.set_variable_values(
                self.ic_values_enthalpy(sd),
                [self.equation_system.md_variable(self.enthalpy_variable, [sd])],
                iterate_index=0,
            )

    def ic_values_enthalpy(self, sd) -> np.ndarray:
        return np.zeros(sd.num_cells)


class InitialConditionsCF(
    InitialConditionsFractions,
    InitialConditionsSaturations,
    InitialConditionsEnthalpy,
    InitialConditionsEnergy,
    InitialConditionsSinglePhaseFlow,
):
    """Collected IC mixins for CF (reference ``compositional_flow.py:1580``)."""


# -- solution strategies ----------------------------------------------------------


class SolutionStrategyPhaseProperties:
    """Keeps surrogate-backed phase properties in sync with the Newton
    iteration (reference ``compositional_flow.py:1596``): re-evaluates each
    phase's EoS on every state update, and progresses values in time after
    convergence."""

    def update_derived_quantities(self) -> None:
        super().update_derived_quantities()
        self.update_thermodynamic_properties_of_phases()

    def update_thermodynamic_properties_of_phases(
        self, state: Optional[np.ndarray] = None
    ) -> None:
        for grid in self.mdg.subdomains():
            for phase in self.fluid.phases:
                deps = self.dependencies_of_phase_properties(phase)
                if not deps or phase.eos is None:
                    continue
                dep_vals = [
                    self.equation_system.evaluate(d([grid]), state=state)
                    for d in deps
                ]
                props = phase.eos.compute_phase_properties(
                    phase.state, *dep_vals
                )
                update_phase_properties(grid, phase, props, depth=0)

    def after_nonlinear_convergence(self) -> None:
        super().after_nonlinear_convergence()
        subdomains = self.mdg.subdomains()
        nt = len(self.time_step_indices)
        for phase in self.fluid.phases:
            for attr in ("density", "specific_enthalpy"):
                factory = getattr(phase, attr, None)
                if isinstance(factory, ad.SurrogateFactory):
                    factory.progress_values_in_time(subdomains, depth=nt)

    def initialize_previous_iterate_and_time_step_values(self) -> None:
        super().initialize_previous_iterate_and_time_step_values()
        # Phase properties must exist before the first assembly: evaluate
        # them from the initial state, then copy into the time rings.
        self.update_thermodynamic_properties_of_phases()
        subdomains = self.mdg.subdomains()
        nt = len(self.time_step_indices)
        for phase in self.fluid.phases:
            for attr in ("density", "specific_enthalpy"):
                factory = getattr(phase, attr, None)
                if isinstance(factory, ad.SurrogateFactory):
                    factory.progress_values_in_time(subdomains, depth=nt)


class SolutionStrategyCF(
    SolutionStrategyPhaseProperties,
    SolutionStrategyFluidMassAndEnergy,
):
    """Solution strategy for compositional flow (reference
    ``compositional_flow.py:1763-1840``): enthalpy variable bookkeeping and
    fractional-flow rediscretization of the total-mobility Darcy tensor."""

    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.enthalpy_variable: str = "enthalpy"
        self.enthalpy_keyword = self.mobility_keyword

    def set_nonlinear_discretizations(self) -> None:
        super().set_nonlinear_discretizations()
        if is_fractional_flow(self):
            # The total-mobility-weighted Darcy tensor is solution-dependent
            # on every grid (lagged; reference ``compositional_flow.py:1832``).
            self.add_nonlinear_discretization(self.darcy_keyword, max_dim=self.nd)
        # Thermal conductivity is a nonlinear fluid property in general.
        self.add_nonlinear_discretization(self.fourier_keyword, max_dim=self.nd)


# -- templates --------------------------------------------------------------------


class CompositionalFlowTemplate(
    ConstitutiveLawsCF,
    PrimaryEquationsCF,
    VariablesCF,
    BoundaryConditionsCF,
    InitialConditionsCF,
    SolutionStrategyCF,
    ModelGeometry,
    DataSavingMixin,
):
    """Skeleton for non-isothermal multiphase multicomponent flow (reference
    ``compositional_flow.py:1856``). Primary unknowns: pressure, fluid
    enthalpy, overall fractions. Secondary unknowns (saturations, partial
    fractions, temperature) must be closed with constitutive modelling —
    e.g. :class:`~porepy_tpu.models.abstract_equations.LocalElimination` or
    an equilibrium/flash model."""


class ConstitutiveLawsCFF(
    constitutive_laws.MassWeightedPermeability,
    ConstitutiveLawsCF,
):
    """CF laws with the total-mass-mobility-weighted Darcy tensor of the
    fractional-flow formulation."""


class CompositionalFractionalFlowTemplate(
    ConstitutiveLawsCFF,
    PrimaryEquationsCFF,
    VariablesCF,
    BoundaryConditionsCFF,
    InitialConditionsCF,
    SolutionStrategyCF,
    ModelGeometry,
    DataSavingMixin,
):
    """Fractional-flow variant of :class:`CompositionalFlowTemplate`
    (reference ``compositional_flow.py:1907``): advective weights are
    fractional mobilities; the total mass mobility belongs in the Darcy
    diffusive tensor (lagged, rediscretized per iteration)."""
