"""Component, Phase and Fluid abstractions.

Parity counterpart of reference ``compositional/base.py:77,127,340,410,
706``: components carry thermodynamic constants and an overall-fraction
callable; phases carry saturation/fraction callables and property
functions; the fluid combines phases into thermodynamically consistent
mixture laws (saturation-weighted density, fraction-weighted enthalpy).
"""

from __future__ import annotations

from typing import Callable, Generator, Optional, Sequence

import numpy as np

from porepy_tpu_torch.compositional._core import PhysicalState

__all__ = ["Component", "Compound", "EquationOfState", "Phase", "Fluid"]


class Component:
    """A chemical component, identified by its overall fraction. The
    material-constant dataclasses (e.g. FluidComponent) act as components
    directly."""

    def __init__(self, *args, **kwargs) -> None:
        self.name: str = str(kwargs.get("name", "unnamed_component"))
        self.fraction: Callable  # assigned by CompositionalVariables


class Compound(Component):
    """A component with active tracers transported within it."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._active_tracers: list[Component] = []
        self.tracer_fraction_of: dict[Component, Callable] = {}

    def __iter__(self) -> Generator[Component, None, None]:
        yield from self._active_tracers

    @property
    def active_tracers(self) -> list[Component]:
        return self._active_tracers

    @active_tracers.setter
    def active_tracers(self, tracers: list[Component]) -> None:
        names = [t.name for t in tracers]
        if len(set(names)) != len(names):
            raise ValueError("Tracers must have unique names")
        self._active_tracers = list(tracers)


class EquationOfState:
    """Interface for external phase-property computations (flash
    backends). Subclasses implement :meth:`compute_phase_properties`."""

    def __init__(self, components: Sequence[Component]) -> None:
        self._components = list(components)

    @property
    def components(self) -> list[Component]:
        return list(self._components)

    def compute_phase_properties(self, phase_state, *thermodynamic_input):
        raise NotImplementedError(
            "EoS subclasses must implement compute_phase_properties"
        )


class Phase:
    """A physical state of matter occupying a saturation-weighted volume.

    Properties (``density``, ``specific_volume``, ``specific_enthalpy``,
    ``viscosity``, ``thermal_conductivity``) and fractional unknowns
    (``fraction``, ``saturation``, ``partial_fraction_of``) are assigned
    by the FluidMixin / CompositionalVariables machinery.
    """

    def __init__(
        self,
        state: PhysicalState,
        name: str,
        eos: Optional[EquationOfState] = None,
    ) -> None:
        self.state = state
        self.name = str(name)
        self.eos = eos
        self._ref_component_index = 0
        self.components: Sequence[Component] = []
        # Property callables; wired by FluidMixin.
        self.density: Callable
        self.specific_volume: Callable
        self.specific_enthalpy: Callable
        self.viscosity: Callable
        self.thermal_conductivity: Callable
        self.fugacity_coefficient_of: dict[Component, Callable] = {}
        # Fractional unknowns; wired by CompositionalVariables.
        self.fraction: Callable
        self.saturation: Callable
        self.extended_fraction_of: dict[Component, Callable] = {}
        self.partial_fraction_of: dict[Component, Callable] = {}

    def __iter__(self) -> Generator[Component, None, None]:
        yield from self.components

    @property
    def num_components(self) -> int:
        return len(self.components)

    @property
    def reference_component_index(self) -> int:
        return self._ref_component_index

    @reference_component_index.setter
    def reference_component_index(self, index: int) -> None:
        self._ref_component_index = int(index)

    @property
    def reference_component(self) -> Component:
        return self.components[self._ref_component_index]


class Fluid:
    """Mixture of components distributed across phases, with
    thermodynamically consistent mixture laws."""

    def __init__(
        self, components: Sequence[Component], phases: Sequence[Phase]
    ) -> None:
        if not components:
            raise ValueError("The fluid needs at least one component")
        if not phases:
            raise ValueError("The fluid needs at least one phase")
        names_c = [c.name for c in components]
        names_p = [p.name for p in phases]
        if len(set(names_c)) != len(names_c):
            raise ValueError("Components must have unique names")
        if len(set(names_p)) != len(names_p):
            raise ValueError("Phases must have unique names")
        self._components = list(components)
        self._phases = list(phases)
        self._ref_phase_index = 0
        self._ref_component_index = 0

    def __str__(self) -> str:
        return (
            f"Fluid with {self.num_components} components "
            f"({', '.join(c.name for c in self._components)}) and "
            f"{self.num_phases} phases "
            f"({', '.join(p.name for p in self._phases)})"
        )

    @property
    def num_components(self) -> int:
        return len(self._components)

    @property
    def num_phases(self) -> int:
        return len(self._phases)

    @property
    def components(self) -> list[Component]:
        return list(self._components)

    @property
    def phases(self) -> list[Phase]:
        return list(self._phases)

    @property
    def gas_phase_index(self) -> Optional[int]:
        for i, p in enumerate(self._phases):
            if p.state == PhysicalState.gas:
                return i
        return None

    @property
    def reference_phase_index(self) -> int:
        return self._ref_phase_index

    @reference_phase_index.setter
    def reference_phase_index(self, index: int) -> None:
        self._ref_phase_index = int(index)

    @property
    def reference_phase(self) -> Phase:
        return self._phases[self._ref_phase_index]

    @property
    def reference_component_index(self) -> int:
        return self._ref_component_index

    @reference_component_index.setter
    def reference_component_index(self, index: int) -> None:
        self._ref_component_index = int(index)

    @property
    def reference_component(self) -> Component:
        return self._components[self._ref_component_index]

    # -- mixture laws --------------------------------------------------------

    def density(self, domains):
        """``sum_j s_j rho_j`` (single phase: the reference phase density)."""
        from porepy_tpu_torch.numerics.ad.operators import sum_operator_list

        if self.num_phases > 1:
            op = sum_operator_list(
                [
                    phase.saturation(domains) * phase.density(domains)
                    for phase in self._phases
                ],
                "fluid_density",
            )
        else:
            op = self.reference_phase.density(domains)
            op.set_name("fluid_density")
        return op

    def specific_volume(self, domains):
        from porepy_tpu_torch.numerics.ad.operators import Scalar

        op = self.density(domains) ** Scalar(-1.0)
        op.set_name("fluid_specific_volume")
        return op

    def specific_enthalpy(self, domains):
        """``sum_j y_j h_j`` (single phase: the reference phase enthalpy)."""
        from porepy_tpu_torch.numerics.ad.operators import sum_operator_list

        if self.num_phases > 1:
            op = sum_operator_list(
                [
                    phase.fraction(domains) * phase.specific_enthalpy(domains)
                    for phase in self._phases
                ],
                "fluid_specific_enthalpy",
            )
        else:
            op = self.reference_phase.specific_enthalpy(domains)
            op.set_name("fluid_specific_enthalpy")
        return op

    def thermal_conductivity(self, domains):
        """``sum_j s_j kappa_j`` (single phase: the phase conductivity)."""
        from porepy_tpu_torch.numerics.ad.operators import sum_operator_list

        if self.num_phases > 1:
            op = sum_operator_list(
                [
                    phase.saturation(domains)
                    * phase.thermal_conductivity(domains)
                    for phase in self._phases
                ],
                "fluid_thermal_conductivity",
            )
        else:
            op = self.reference_phase.thermal_conductivity(domains)
            op.set_name("fluid_thermal_conductivity")
        return op

    def viscosity(self, domains):
        """Single-phase viscosity (multiphase flow uses per-phase
        mobilities rather than a mixture viscosity)."""
        op = self.reference_phase.viscosity(domains)
        op.set_name("fluid_viscosity")
        return op
