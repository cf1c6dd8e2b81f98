"""Model mixins wiring the compositional machinery into the AD framework.

Parity counterpart of reference
``compositional/compositional_mixins.py:533,960``:

- :class:`FluidMixin` creates the :class:`~porepy_tpu.compositional.base.
  Fluid` (single liquid phase with the model's fluid component by
  default) and assigns phase property functions, defaulting to the
  model's heuristic constitutive laws.
- :class:`CompositionalVariables` creates fractional variables (overall
  fractions, saturations, phase fractions, partial fractions) with
  reference-elimination by unity, and wires the callables onto the
  component/phase objects.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from porepy_tpu_torch.compositional._core import (
    COMPOSITIONAL_VARIABLE_SYMBOLS as SYMBOLS,
)
from porepy_tpu_torch.compositional._core import PhysicalState
from porepy_tpu_torch.compositional.base import Component, Fluid, Phase
from porepy_tpu_torch.compositional.utils import (
    CompositionalModellingError,
    safe_sum,
)

__all__ = ["FluidMixin", "CompositionalVariables"]


class FluidMixin:
    """Creates :attr:`fluid` and assigns phase properties."""

    def create_fluid(self) -> None:
        phases: list[Phase] = []
        components = list(self.get_components())
        for config in self.get_phase_configuration(components):
            if len(config) == 3:
                state, name, eos = config
            else:
                state, name = config
                eos = None
            phases.append(Phase(state, name, eos=eos))
        self.set_components_in_phases(components, phases)
        self.fluid = Fluid(components, phases)
        self._wire_trivial_fractions()

    def get_components(self) -> Sequence:
        """Default: the single fluid component from the material constants."""
        return [self._fluid_component]

    def get_phase_configuration(self, components):
        return [(PhysicalState.liquid, "liquid")]

    def set_components_in_phases(
        self, components: Sequence, phases: Sequence[Phase]
    ) -> None:
        """Default: all components in all phases."""
        for phase in phases:
            phase.components = list(components)

    def _wire_trivial_fractions(self) -> None:
        """Single-phase/component fractions are the constant one; genuine
        variables (multiphase) are wired by CompositionalVariables."""
        from porepy_tpu_torch.numerics.ad.operators import Scalar

        def one(domains):
            return Scalar(1.0, "one")

        if self.fluid.num_components == 1:
            self.fluid.reference_component.fraction = one
        if self.fluid.num_phases == 1:
            phase = self.fluid.reference_phase
            phase.fraction = one
            phase.saturation = one
            if self.fluid.num_components == 1:
                for comp in phase:
                    phase.partial_fraction_of[comp] = one
            else:
                # Single phase, several components: the partial fraction in
                # the (only) phase IS the overall fraction.
                for comp in phase:
                    phase.partial_fraction_of[comp] = (
                        lambda domains, _c=comp: _c.fraction(domains)
                    )

    def assign_thermodynamic_properties_to_phases(self) -> None:
        for phase in self.fluid.phases:
            phase.density = self.density_of_phase(phase)
            phase.specific_volume = self.specific_volume_of_phase(phase)
            phase.specific_enthalpy = self.specific_enthalpy_of_phase(phase)
            phase.viscosity = self.viscosity_of_phase(phase)
            phase.thermal_conductivity = self.thermal_conductivity_of_phase(
                phase
            )

    def dependencies_of_phase_properties(self, phase: Phase) -> Sequence:
        """Variables entering externally computed (surrogate) phase
        properties; empty when heuristic laws are mixed in."""
        return []

    # -- default heuristic wiring: delegate to the model's laws --------------

    def density_of_phase(self, phase: Phase) -> Callable:
        def density(domains):
            return self.fluid_density(domains)

        return density

    def specific_volume_of_phase(self, phase: Phase) -> Callable:
        from porepy_tpu_torch.numerics.ad.operators import Scalar

        def volume(domains):
            op = phase.density(domains) ** Scalar(-1.0)
            op.set_name(f"phase_{phase.name}_specific_volume")
            return op

        return volume

    def specific_enthalpy_of_phase(self, phase: Phase) -> Callable:
        def enthalpy(domains):
            return self.fluid_specific_enthalpy(domains)

        return enthalpy

    def viscosity_of_phase(self, phase: Phase) -> Callable:
        def viscosity(domains):
            return self.fluid_viscosity(domains)

        return viscosity

    def thermal_conductivity_of_phase(self, phase: Phase) -> Callable:
        def conductivity(domains):
            return self.fluid_thermal_conductivity(domains)

        return conductivity


from porepy_tpu_torch.models.abstract_equations import VariableMixin


class CompositionalVariables(VariableMixin):
    """Creates the fractional variables of multiphase, multicomponent
    fluids and wires the accessors onto components and phases. One
    arbitrary reference per family is eliminated by unity.

    Subclasses :class:`VariableMixin` so the cooperative
    ``create_variables`` super-chain of composed models reaches it (the
    mixin root's no-op ends the chain)."""

    @property
    def overall_fraction_variables(self) -> list[str]:
        if self.fluid.num_components == 1:
            return []
        return [
            self._overall_fraction_variable(c)
            for c in self.fluid.components
            if c is not self.fluid.reference_component
            or not self.params.get("eliminate_reference_component", True)
        ]

    @property
    def saturation_variables(self) -> list[str]:
        if self.fluid.num_phases == 1:
            return []
        return [
            self._saturation_variable(p)
            for p in self.fluid.phases
            if p is not self.fluid.reference_phase
            or not self.params.get("eliminate_reference_phase", True)
        ]

    def _overall_fraction_variable(self, component: Component) -> str:
        return f"{SYMBOLS['overall_fraction']}_{component.name}"

    def _saturation_variable(self, phase: Phase) -> str:
        return f"{SYMBOLS['phase_saturation']}_{phase.name}"

    def _phase_fraction_variable(self, phase: Phase) -> str:
        return f"{SYMBOLS['phase_fraction']}_{phase.name}"

    def _partial_fraction_variable(
        self, component: Component, phase: Phase
    ) -> str:
        return f"{SYMBOLS['phase_composition']}_{component.name}_{phase.name}"

    def create_variables(self) -> None:
        super().create_variables()
        if not hasattr(self, "fluid"):
            raise CompositionalModellingError(
                "Cannot create fractional variables before the fluid is set"
            )
        subdomains = self.mdg.subdomains()

        # Overall fractions (multicomponent).
        if self.fluid.num_components > 1:
            independent = [
                c
                for c in self.fluid.components
                if c is not self.fluid.reference_component
            ]
            for comp in independent:
                name = self._overall_fraction_variable(comp)
                self.equation_system.create_variables(
                    name, dof_info={"cells": 1}, subdomains=subdomains
                )
                comp.fraction = self._variable_accessor(name)
            # Reference eliminated by unity.
            ref = self.fluid.reference_component

            def ref_fraction(domains, _indep=independent):
                from porepy_tpu_torch.numerics.ad.operators import Scalar

                op = Scalar(1.0) - safe_sum(
                    [c.fraction(domains) for c in _indep]
                )
                op.set_name("reference_component_fraction_by_unity")
                return op

            ref.fraction = ref_fraction

        # Saturations and phase fractions (multiphase).
        if self.fluid.num_phases > 1:
            independent_phases = [
                p
                for p in self.fluid.phases
                if p is not self.fluid.reference_phase
            ]
            # Phase (molar) fractions are independent variables only when a
            # local equilibrium condition is part of the model (reference
            # ``compositional_mixins.py:484-492``); without equilibrium the
            # formulation must be saturation-based and evaluating a phase
            # fraction is a modelling error (reference
            # ``compositional_mixins.py:776-783``).
            has_equilibrium = (
                self.params.get("equilibrium_condition", None) is not None
            )
            for phase in independent_phases:
                s_name = self._saturation_variable(phase)
                self.equation_system.create_variables(
                    s_name, dof_info={"cells": 1}, subdomains=subdomains
                )
                phase.saturation = self._variable_accessor(s_name)
                if has_equilibrium:
                    y_name = self._phase_fraction_variable(phase)
                    self.equation_system.create_variables(
                        y_name, dof_info={"cells": 1}, subdomains=subdomains
                    )
                    phase.fraction = self._variable_accessor(y_name)
                else:

                    def _no_fraction(domains, _p=phase):
                        raise CompositionalModellingError(
                            "Phase fractions are not defined in a model "
                            "without equilibrium; re-formulate using "
                            "saturations."
                        )

                    phase.fraction = _no_fraction

            ref_phase = self.fluid.reference_phase

            def unity_of(attr, _phases=independent_phases):
                def closure(domains):
                    from porepy_tpu_torch.numerics.ad.operators import Scalar

                    op = Scalar(1.0) - safe_sum(
                        [getattr(p, attr)(domains) for p in _phases]
                    )
                    op.set_name(f"reference_phase_{attr}_by_unity")
                    return op

                return closure

            ref_phase.saturation = unity_of("saturation")
            if has_equilibrium:
                ref_phase.fraction = unity_of("fraction")
            else:

                def _no_ref_fraction(domains):
                    raise CompositionalModellingError(
                        "Phase fractions are not defined in a model "
                        "without equilibrium; re-formulate using "
                        "saturations."
                    )

                ref_phase.fraction = _no_ref_fraction

            # Partial fractions per phase (multicomponent, no equilibrium:
            # independent variables except the in-phase reference).
            if self.fluid.num_components > 1:
                for phase in self.fluid.phases:
                    independent_comps = [
                        c
                        for c in phase
                        if c is not phase.reference_component
                    ]
                    for comp in independent_comps:
                        x_name = self._partial_fraction_variable(comp, phase)
                        self.equation_system.create_variables(
                            x_name,
                            dof_info={"cells": 1},
                            subdomains=subdomains,
                        )
                        phase.partial_fraction_of[comp] = (
                            self._variable_accessor(x_name)
                        )

                    def ref_partial(domains, _phase=phase):
                        from porepy_tpu_torch.numerics.ad.operators import Scalar

                        others = [
                            _phase.partial_fraction_of[c](domains)
                            for c in _phase
                            if c is not _phase.reference_component
                        ]
                        op = Scalar(1.0) - safe_sum(others)
                        op.set_name(
                            "reference_partial_fraction_by_unity"
                        )
                        return op

                    phase.partial_fraction_of[phase.reference_component] = (
                        ref_partial
                    )

    def _variable_accessor(self, name: str) -> Callable:
        def accessor(domains):
            from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

            if len(domains) > 0 and all(
                isinstance(g, BoundaryGrid) for g in domains
            ):
                return self.create_boundary_operator(
                    name=name, domains=domains
                )
            return self.equation_system.md_variable(name, domains)

        return accessor
