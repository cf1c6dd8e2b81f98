"""Typing protocol for the model framework (reference
``models/protocol.py:30``).

``PorePyModel`` declares, for static type checkers only, the API that the
model mixins collectively assume each other to provide: geometry, variable
creation, equation definition, boundary conditions, data saving and the
solution strategy. At runtime it degrades to a plain empty base class —
``typing.Protocol`` uses ``__slots__``, which breaks multiple inheritance
in the mixin framework (the reference degrades it the same way).

Usage mirrors the reference::

    class MyConstitutiveMixin(pp.PorePyModel):
        def my_term(self, subdomains):
            return self.specific_volume(subdomains) * ...

Type checkers then know ``self`` carries the full framework surface.
"""

from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Literal,
    Optional,
    Protocol,
    Sequence,
)

import numpy as np

__all__ = ["PorePyModel"]

if not TYPE_CHECKING:

    class PorePyModel:
        """Runtime stand-in: an empty, slot-free base class (see module
        docstring)."""

else:

    class _GeometryProtocol(Protocol):
        """Grid bookkeeping provided by ``ModelGeometry``."""

        mdg: Any
        nd: int
        fracture_network: Any
        well_network: Any

        @property
        def domain(self) -> Any: ...

        @property
        def fractures(self) -> list: ...

        def set_geometry(self) -> None: ...

        def set_well_network(self) -> None: ...

        def is_well(self, grid: Any) -> bool: ...

        def grid_type(
            self,
        ) -> Literal["simplex", "cartesian", "tensor_grid"]: ...

        def meshing_arguments(self) -> dict[str, float]: ...

        def meshing_kwargs(self) -> dict: ...

        def subdomains_to_interfaces(
            self, subdomains: list, codims: list[int]
        ) -> list: ...

        def interfaces_to_subdomains(self, interfaces: list) -> list: ...

        def subdomains_to_boundary_grids(
            self, subdomains: Sequence
        ) -> Sequence: ...

        def wrap_grid_attribute(
            self, grids: Sequence, attr: str, *, dim: int
        ) -> Any: ...

        def basis(self, grids: Sequence, dim: int) -> list: ...

        def e_i(self, grids: Sequence, *, i: int, dim: int) -> Any: ...

        def tangential_component(self, subdomains: list) -> Any: ...

        def normal_component(self, subdomains: list) -> Any: ...

        def local_coordinates(self, subdomains: list) -> Any: ...

        def subdomain_projections(self, dim: int) -> Any: ...

        def domain_boundary_sides(
            self, domain: Any, tol: float = 1e-10
        ) -> Any: ...

        def internal_boundary_normal_to_outwards(
            self, subdomains: list, *, dim: int
        ) -> Any: ...

        def outwards_internal_boundary_normal(
            self, interfaces: list, *, unitary: bool
        ) -> Any: ...

        def specific_volume(self, grids: list) -> Any: ...

        def aperture(self, subdomains: list) -> Any: ...

        def isotropic_second_order_tensor(
            self, subdomains: list, permeability: Any
        ) -> Any: ...

    class _VariableProtocol(Protocol):
        """Variable creation (``VariablesPoromechanics`` etc.)."""

        def create_variables(self) -> None: ...

        def perturbation_from_reference(
            self, name: str, grids: list
        ) -> Any: ...

    class _EquationProtocol(Protocol):
        """Equation definition mixins."""

        equation_system: Any

        def set_equations(self) -> None: ...

        def volume_integral(
            self, integrand: Any, grids: list, dim: int
        ) -> Any: ...

    class _BoundaryConditionProtocol(Protocol):
        """Boundary-condition mixins (``BoundaryConditionMixin``)."""

        def update_all_boundary_conditions(self) -> None: ...

        def update_boundary_condition(
            self, name: str, function: Callable
        ) -> None: ...

        def create_boundary_operator(self, name: str, domains: Sequence) -> Any: ...

    class _DataSavingProtocol(Protocol):
        """Exporting/restart (``DataSavingMixin``)."""

        exporter: Any
        restart_options: dict

        def save_data_time_step(self) -> None: ...

        def initialize_data_saving(self) -> None: ...

        def load_data_from_vtu(self, *args: Any, **kwargs: Any) -> None: ...

    class _SolutionStrategyProtocol(Protocol):
        """Lifecycle and solver orchestration (``SolutionStrategy``)."""

        params: dict
        units: Any
        fluid: Any
        solid: Any
        time_manager: Any
        linear_solver: str
        nonlinear_solver_statistics: Any
        convergence_status: bool
        restart_options: dict

        @property
        def time_step_indices(self) -> np.ndarray: ...

        @property
        def iterate_indices(self) -> np.ndarray: ...

        def prepare_simulation(self) -> None: ...

        def initial_condition(self) -> None: ...

        def before_nonlinear_loop(self) -> None: ...

        def before_nonlinear_iteration(self) -> None: ...

        def after_nonlinear_iteration(
            self, nonlinear_increment: np.ndarray
        ) -> None: ...

        def after_nonlinear_convergence(self) -> None: ...

        def after_nonlinear_failure(self) -> None: ...

        def after_simulation(self) -> None: ...

        def assemble_linear_system(self) -> None: ...

        def solve_linear_system(self) -> np.ndarray: ...

        def check_convergence(
            self,
            nonlinear_increment: np.ndarray,
            residual: np.ndarray,
            reference_residual: np.ndarray,
            nl_params: Optional[dict],
        ) -> tuple[bool, bool]: ...

        def rediscretize(self) -> None: ...

        def update_time_dependent_ad_arrays(self) -> None: ...

    class PorePyModel(  # type: ignore[no-redef]
        _GeometryProtocol,
        _VariableProtocol,
        _EquationProtocol,
        _BoundaryConditionProtocol,
        _DataSavingProtocol,
        _SolutionStrategyProtocol,
        Protocol,
    ):
        """The full model API as seen by any mixin (reference
        ``models/protocol.py:PorePyModel``)."""
