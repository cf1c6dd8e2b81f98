"""Boundary-condition mixin.

Parity counterpart of reference ``models/boundary_condition.py:18``:
time-dependent boundary values live on BoundaryGrids in the standard
solution rings; ``update_all_boundary_conditions`` shifts them in time and
refreshes the new-time values; Dirichlet/Neumann/Robin filters mask the
per-type value operators so a single combined operator feeds the
discretizations.
"""

from __future__ import annotations

from functools import cached_property
from typing import Callable, Optional, Sequence

import numpy as np

from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.utils import common_constants as cc
from porepy_tpu_torch.utils.solution_storage import (
    get_solution_values,
    set_solution_values,
    shift_solution_values,
)

__all__ = ["BoundaryConditionMixin"]


class BoundaryConditionMixin:
    def update_all_boundary_conditions(self) -> None:
        for name, bc_type_callable in self._bc_type_storage.items():
            self._update_bc_type_filter(name=name, bc_type_callable=bc_type_callable)
        self.update_boundary_values_primary_variables()

    def update_boundary_values_primary_variables(self) -> None:
        pass

    def update_boundary_condition(
        self, name: str, function: Callable[[BoundaryGrid], np.ndarray]
    ) -> None:
        """Shift stored boundary values in time and set new-time values."""
        for bg, data in self.mdg.boundaries(return_data=True):
            if cc.ITERATE_SOLUTIONS in data and name in data[cc.ITERATE_SOLUTIONS]:
                vals = get_solution_values(name, data, iterate_index=0)
            else:
                vals = function(bg)
            shift_solution_values(
                name, data, cc.TIME_STEP_SOLUTIONS, max_index=len(self.time_step_indices)
            )
            set_solution_values(name, vals, data, time_step_index=0)
            vals_new = function(bg)
            set_solution_values(name, vals_new, data, iterate_index=0)

    def create_boundary_operator(
        self, name: str, domains: Sequence[BoundaryGrid]
    ) -> ad.TimeDependentDenseArray:
        if not all(isinstance(x, BoundaryGrid) for x in domains):
            raise ValueError("domains must consist entirely of boundary grids")
        return ad.TimeDependentDenseArray(name=name, domains=domains)

    def _combine_boundary_operators(
        self,
        subdomains: Sequence,
        dirichlet_operator: Callable,
        neumann_operator: Callable,
        robin_operator: Optional[Callable],
        bc_type: Callable,
        name: str,
        dim: int = 1,
    ) -> ad.Operator:
        """Filtered Dirichlet + Neumann (+ Robin) values projected from the
        boundary grids to the subdomain face space."""
        boundary_grids = self.subdomains_to_boundary_grids(subdomains)
        operators = {
            "dirichlet": dirichlet_operator(boundary_grids),
            "neumann": neumann_operator(boundary_grids),
        }
        filters = {
            "dirichlet": ad.TimeDependentDenseArray(
                name=name + "_filter_dir", domains=boundary_grids
            ),
            "neumann": ad.TimeDependentDenseArray(
                name=name + "_filter_neu", domains=boundary_grids
            ),
        }
        if robin_operator is not None:
            operators["robin"] = robin_operator(boundary_grids)
            filters["robin"] = ad.TimeDependentDenseArray(
                name=name + "_filter_rob", domains=boundary_grids
            )
        self._bc_type_storage[name] = bc_type
        self._update_bc_type_filter(name=name, bc_type_callable=bc_type)

        boundary_to_subdomain = ad.BoundaryProjection(
            self.mdg, subdomains=subdomains, dim=dim
        ).boundary_to_subdomain

        combined = ad.sum_operator_list(
            [operators[key] * filters[key] for key in operators]
        )
        result = boundary_to_subdomain @ combined
        result.set_name(name)
        return result

    def _update_bc_type_filter(
        self, name: str, bc_type_callable: Callable
    ) -> None:
        def dirichlet(bg: BoundaryGrid) -> np.ndarray:
            is_dir = bc_type_callable(bg.parent).is_dir.T
            is_dir = bg.projection() @ is_dir
            return np.asarray(is_dir).T.ravel("F").astype(float)

        def neumann(bg: BoundaryGrid) -> np.ndarray:
            is_neu = bc_type_callable(bg.parent).is_neu.T
            is_neu = bg.projection() @ is_neu
            return np.asarray(is_neu).T.ravel("F").astype(float)

        def robin(bg: BoundaryGrid) -> np.ndarray:
            is_rob = bc_type_callable(bg.parent).is_rob.T
            is_rob = bg.projection() @ is_rob
            return np.asarray(is_rob).T.ravel("F").astype(float)

        self.update_boundary_condition(name=name + "_filter_dir", function=dirichlet)
        self.update_boundary_condition(name=name + "_filter_neu", function=neumann)
        self.update_boundary_condition(name=name + "_filter_rob", function=robin)

    @cached_property
    def _bc_type_storage(self) -> dict[str, Callable]:
        return {}
