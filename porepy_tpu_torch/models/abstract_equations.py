"""Abstract equation and variable mixins.

Parity counterpart of reference ``models/abstract_equations.py``: the
balance-equation template ``d_t(accumulation) + div(surface_term) - source``
and the volume-integral helper including specific volumes; the variable
mixin hook; and :class:`LocalElimination` — pointwise closure of dangling
variables through externally-computed constitutive functions.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Optional, Sequence, Union

import numpy as np

from porepy_tpu_torch.numerics import ad

__all__ = [
    "EquationMixin",
    "BalanceEquation",
    "VariableMixin",
    "LocalElimination",
]


class EquationMixin:
    """Base for equation mixins; cooperative ``set_equations``."""

    def set_equations(self) -> None:
        pass


class BalanceEquation(EquationMixin):
    def balance_equation(
        self,
        subdomains: Sequence,
        accumulation: ad.Operator,
        surface_term: ad.Operator,
        source: ad.Operator,
        dim: int,
    ) -> ad.Operator:
        """``d_t(accumulation) + div(surface_term) - source``."""
        div = ad.Divergence(subdomains, dim=dim)
        return ad.dt(accumulation, self.ad_time_step) + div @ surface_term - source

    def volume_integral(
        self, integrand: ad.Operator, grids: Sequence, dim: int
    ) -> ad.Operator:
        """Cell-volume (and specific-volume) weighted integrand."""
        cell_volumes = self.wrap_grid_attribute(grids, "cell_volumes", dim=1)
        if dim == 1:
            return cell_volumes * self.specific_volume(grids) * integrand
        basis = self.basis(grids, dim=dim)
        volumes_nd = ad.sum_operator_list(
            [e @ (cell_volumes * self.specific_volume(grids)) for e in basis]
        )
        return volumes_nd * integrand


class LocalElimination(EquationMixin):
    """Close a model with dangling variables through local (pointwise)
    constitutive equations ``x - x̃(deps) = 0``.

    Parity counterpart of reference ``models/abstract_equations.py:169``:
    the eliminated variable is tied to a :class:`~porepy_tpu.numerics.ad.
    surrogate_operator.SurrogateFactory` whose values/derivatives are
    refreshed from a user-supplied numerical function before every nonlinear
    iteration (and, on boundaries, at every boundary-condition update).

    The numerical function runs on host or device at the user's choice — it
    receives the dependency value arrays and must return ``(values,
    derivatives)`` with shapes ``(N,)`` and ``(M, N)`` for ``M``
    dependencies. Everything downstream (Jacobian injection) is compiled
    into the jitted equation kernels; see ``surrogate_operator.py``.
    """

    @cached_property
    def _local_eliminations(self) -> dict:
        return {}

    def eliminate_locally(
        self,
        independent_quantity: Callable[[Sequence], ad.Operator],
        dependencies: Sequence[Callable[[Sequence], ad.Operator]],
        func: Callable[..., tuple[np.ndarray, np.ndarray]],
        domains: Sequence,
        equations_per_grid_entity: Optional[dict] = None,
    ) -> None:
        """Introduce the secondary equation ``x - x̃(deps) = 0`` on
        ``domains`` (reference ``abstract_equations.py:228``).

        ``func(*dep_values) -> (values, (M, N) derivatives)`` supplies the
        surrogate data; it is re-evaluated before each nonlinear iteration.
        Boundary grids in ``domains`` get consistent BC values for the
        eliminated variable computed through the same function.
        """
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if equations_per_grid_entity is None:
            equations_per_grid_entity = {"cells": 1}
        non_boundaries = [g for g in domains if not isinstance(g, BoundaryGrid)]
        boundaries = [g for g in domains if isinstance(g, BoundaryGrid)]

        sec_var = independent_quantity(non_boundaries)
        g_ids = [getattr(g, "id", id(g)) for g in non_boundaries]
        factory = ad.SurrogateFactory(
            name=f"surrogate_for_{sec_var.name}_on_grids_{g_ids}",
            mdg=self.mdg,
            dependencies=dependencies,
            dof_info=equations_per_grid_entity,
        )
        equ_name = f"elimination_of_{sec_var.name}_on_grids_{g_ids}"
        local_equ = sec_var - factory(non_boundaries)
        local_equ.set_name(equ_name)
        self.equation_system.set_equation(
            local_equ, non_boundaries, equations_per_grid_entity
        )
        self._local_eliminations[equ_name] = (
            sec_var,
            factory,
            func,
            non_boundaries,
            boundaries,
        )
        # Initialize surrogate values/derivatives from the current state so
        # the first assembly sees consistent data, and overwrite the
        # eliminated variable's iterate with the closure value (reference
        # ``abstract_equations.py:396-403``) — the secondary equation then
        # starts exactly satisfied.
        self._update_elimination(factory, func, non_boundaries)
        for grid in non_boundaries:
            X = [
                self.equation_system.evaluate(d([grid]))
                for d in factory._dependencies
            ]
            vals, _ = func(*X)
            sub = [v for v in sec_var.sub_vars if v.domain is grid]
            if sub:
                self.equation_system.set_variable_values(
                    np.asarray(vals, dtype=float), sub, iterate_index=0
                )

    def _update_elimination(self, factory, func, domains) -> None:
        for grid in domains:
            X = [
                self.equation_system.evaluate(d([grid]))
                for d in factory._dependencies
            ]
            vals, diffs = func(*X)
            factory.set_values_on_grid(np.asarray(vals), grid)
            factory.set_derivatives_on_grid(np.asarray(diffs), grid)

    def update_derived_quantities(self) -> None:
        """Refresh all surrogate values/derivatives from the current iterate
        (hooked into the solution strategy's pre-iteration update)."""
        super().update_derived_quantities()
        for _, factory, func, domains, _bgs in self._local_eliminations.values():
            self._update_elimination(factory, func, domains)

    def update_all_boundary_conditions(self) -> None:
        """Consistent BC values for eliminated variables on boundary grids."""
        super().update_all_boundary_conditions()
        for elim in self._local_eliminations.values():
            sec_var, factory, func, _domains, bgs = elim
            if not bgs:
                continue

            def bc_values(bg, factory=factory, func=func, bgs=bgs):
                if bg in bgs:
                    X = [
                        self.equation_system.evaluate(d([bg]))
                        for d in factory._dependencies
                    ]
                    vals, _ = func(*X)
                    return np.asarray(vals)
                return np.zeros(bg.num_cells)

            self.update_boundary_condition(sec_var.name, bc_values)


class VariableMixin:
    """Base for variable mixins; cooperative ``create_variables``."""

    def create_variables(self) -> None:
        pass

    def perturbation_from_reference(
        self, name: str, grids: Sequence
    ) -> ad.Operator:
        """``quantity - reference_value`` (reference
        ``abstract_equations.py:523``)."""
        quantity = getattr(self, name)(grids)
        ref = getattr(self.reference_variable_values, name)
        out = quantity - ad.Scalar(float(ref))
        out.set_name(f"{name}_perturbation")
        return out
