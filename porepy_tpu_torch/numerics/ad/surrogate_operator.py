"""Surrogate operators: externally-computed quantities in the AD graph.

Parity counterpart of the reference's ``SurrogateFactory`` /
``SurrogateOperator`` (reference ``numerics/ad/surrogate_operator.py:141,366``):
a named quantity whose *values* and *derivatives w.r.t. declared first-order
dependencies* are supplied from outside the AD system (flash computations,
property correlations, lookup tables), yet participates in assembly with a
correct Jacobian.

Realization: instead of the reference's AdArray splicing, the surrogate
compiles into the traced residual as

    ``stored_values + sum_k  d_k * (x_k - x_k.detach())``

where ``stored_values`` and the per-dependency derivative rows ``d_k`` enter
through the env-argument mechanism (re-fetched each assembly, cached on
device between state changes) and ``x_k`` are the dependency variables. The
second term is identically zero in value, while its JVP is exactly
``sum_k d_k * dx_k`` — so one expression gives both the exact value and the
exact (diagonal, per-dependency) Jacobian contribution through forward-mode
differentiation, with no custom-JVP plumbing. The assembly's dual-number
pass evaluates the same expression as a ``dual_ew`` program (the function's
``dual_rule``, with the ``detach`` opcode).

Storage layout: values live in the grid data dicts' iterate/time rings under
the factory name (exactly like variables, so time shifting works the same);
derivatives per dependency ``k`` live under ``"{name}_der_{k}"``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from porepy_tpu_torch.numerics.ad.forward import elementwise
from porepy_tpu_torch.numerics.ad.operators import (
    DenseArray,
    Operations,
    Operator,
    TimeDependentDenseArray,
    Variable,
)
from porepy_tpu_torch.utils.solution_storage import (
    get_solution_values,
    set_solution_values,
    shift_solution_values,
)
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["SurrogateFactory", "SurrogateOperator"]


class SurrogateOperator(Operator):
    """AD node for a surrogate quantity on a set of subdomains/interfaces.

    An ``evaluate`` node whose children are ``[values_leaf, d_1..d_M,
    x_1..x_M]``; see module docstring for the compiled form. Created by
    :class:`SurrogateFactory.__call__`, not directly.
    """

    def __init__(
        self,
        name: str,
        domains: Sequence,
        dependencies: Sequence[Variable],
        factory: "SurrogateFactory",
    ) -> None:
        num_dep = len(dependencies)
        vals = TimeDependentDenseArray(name, domains)
        derivs = [
            TimeDependentDenseArray(f"{name}_der_{k}", domains)
            for k in range(num_dep)
        ]
        super().__init__(
            name=name,
            domains=domains,
            operation=Operations.evaluate,
            children=[vals, *derivs, *dependencies],
        )
        self._factory = factory
        self._dependencies = list(dependencies)

        def func(v, *rest):
            d = rest[:num_dep]
            x = rest[num_dep:]
            out = v
            for dk, xk in zip(d, x):
                out = out + dk * (xk - xk.detach())
            return out

        self.func = func

        def dual(E, v, *rest):
            # The value is the stored one; the tangent is ``sum_k d_k dx_k``.
            out = v
            for dk, xk in zip(rest[:num_dep], rest[num_dep:]):
                out = E.op("add", out, E.op("mul", dk, E.op("sub", xk, E.op("detach", xk))))
            return out

        func.dual_rule = elementwise(dual)

        def func_pattern(child_patterns, ndof):
            import scipy.sparse as sps

            # Rows = the surrogate's dofs; columns = union over dependencies
            # (pointwise, so dependency row i feeds surrogate row i).
            out = child_patterns[0]
            for p in child_patterns[1 + num_dep :]:
                out = (out + p).astype(bool)
            return out.tocsr()

        self.func_pattern = func_pattern

    # At historic states the surrogate is a plain stored array (constant
    # under AD) — matching the reference's re-tagging semantics (reference
    # ``surrogate_operator.py:219-233``).
    def previous_timestep(self, steps: int = 1) -> Operator:
        return TimeDependentDenseArray(
            self._name, self._domains, previous_timestep=True
        )

    def previous_iteration(self, steps: int = 1) -> Operator:
        return TimeDependentDenseArray(
            self._name, self._domains, iterate_index=steps
        )


class SurrogateFactory:
    """Factory and storage manager for one named surrogate quantity.

    Parameters mirror the reference (``surrogate_operator.py:446``):

    - ``name``: storage key and operator name.
    - ``mdg``: the mixed-dimensional grid whose data dicts hold the values.
    - ``dependencies``: callables ``domains -> Variable`` (typically model
      mixin methods like ``self.pressure``) declaring the first-order
      dependencies; their order fixes the derivative row order.
    - ``dof_info``: dofs per grid entity (default one per cell).
    """

    def __init__(
        self,
        name: str,
        mdg,
        dependencies: Sequence[Callable],
        dof_info: Optional[dict] = None,
    ) -> None:
        if len(dependencies) == 0:
            raise ValueError("Surrogate operators must have dependencies.")
        self._name = name
        self.mdg = mdg
        self._dependencies = list(dependencies)
        self._dof_info = dict(dof_info or {"cells": 1})

    # -- operator creation -----------------------------------------------------

    def __call__(self, domains: Sequence) -> Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        if len(domains) == 0:
            return DenseArray(np.zeros(0), name=self.name)
        if all(isinstance(g, BoundaryGrid) for g in domains):
            return TimeDependentDenseArray(self.name, domains)
        from porepy_tpu_torch.grids.grid import Grid

        if not (
            all(isinstance(g, Grid) for g in domains)
            or all(isinstance(g, MortarGrid) for g in domains)
        ):
            raise ValueError(
                "Surrogate operators take subdomains, interfaces or boundary "
                f"grids, not a mix: {[type(g) for g in domains]}"
            )
        children = [dep(domains) for dep in self._dependencies]
        flat: list[Variable] = []
        for c in children:
            sub = getattr(c, "sub_vars", None)
            if sub is not None:
                flat.append(c)
            elif isinstance(c, Variable):
                flat.append(c)
            else:
                raise ValueError(
                    "Surrogate dependencies must resolve to variables, got "
                    f"{type(c).__name__}"
                )
        return SurrogateOperator(self.name, domains, flat, self)

    # -- identification ----------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def num_dependencies(self) -> int:
        return len(self._dependencies)

    def num_dofs_on_grid(self, grid) -> int:
        n = self._dof_info.get("cells", 0) * grid.num_cells
        n += self._dof_info.get("faces", 0) * getattr(grid, "num_faces", 0)
        n += self._dof_info.get("nodes", 0) * getattr(grid, "num_nodes", 0)
        return int(n)

    def _data_of(self, grid) -> dict:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        if isinstance(grid, BoundaryGrid):
            return self.mdg.boundary_grid_data(grid)
        if isinstance(grid, MortarGrid):
            return self.mdg.interface_data(grid)
        return self.mdg.subdomain_data(grid)

    # -- per-grid get/set --------------------------------------------------------

    def get_values_on_grid(
        self,
        grid,
        iterate_index: Optional[int] = 0,
        time_step_index: Optional[int] = None,
    ) -> np.ndarray:
        return get_solution_values(
            self.name,
            self._data_of(grid),
            iterate_index=None if time_step_index is not None else iterate_index,
            time_step_index=time_step_index,
        )

    def get_derivatives_on_grid(self, grid) -> np.ndarray:
        data = self._data_of(grid)
        return np.vstack(
            [
                get_solution_values(f"{self.name}_der_{k}", data, iterate_index=0)
                for k in range(self.num_dependencies)
            ]
        )

    def set_values_on_grid(self, values: np.ndarray, grid) -> None:
        n = self.num_dofs_on_grid(grid)
        values = np.asarray(values, dtype=float)
        if values.shape != (n,):
            raise ValueError(
                f"Expected shape ({n},) for values on {grid}, got {values.shape}"
            )
        set_solution_values(self.name, values, self._data_of(grid), iterate_index=0)

    def set_derivatives_on_grid(self, values: np.ndarray, grid) -> None:
        n = self.num_dofs_on_grid(grid)
        values = np.atleast_2d(np.asarray(values, dtype=float))
        if values.shape != (self.num_dependencies, n):
            raise ValueError(
                f"Expected shape ({self.num_dependencies}, {n}) for "
                f"derivatives on {grid}, got {values.shape}"
            )
        data = self._data_of(grid)
        for k in range(self.num_dependencies):
            set_solution_values(
                f"{self.name}_der_{k}", values[k], data, iterate_index=0
            )

    # -- time/iterate progression --------------------------------------------------

    def progress_values_in_time(self, domains: Sequence, depth: int = 1) -> None:
        """Shift the stored time ring and enter the current iterate values at
        time index 0 (reference ``surrogate_operator.py:885``)."""
        for grid in domains:
            data = self._data_of(grid)
            shift_solution_values(
                self.name, data, cc.TIME_STEP_SOLUTIONS, max_index=depth
            )
            vals = get_solution_values(self.name, data, iterate_index=0)
            set_solution_values(self.name, vals, data, time_step_index=0)

    def progress_iterate_values_on_grid(
        self, values: np.ndarray, grid, depth: int = 1
    ) -> None:
        """Shift the iterate ring and set new current-iterate values."""
        data = self._data_of(grid)
        shift_solution_values(
            self.name, data, cc.ITERATE_SOLUTIONS, max_index=depth
        )
        self.set_values_on_grid(values, grid)

    # -- md-wide convenience properties (reference :670-880) -----------------------

    def _gather(self, grids, key: str) -> np.ndarray:
        out = [
            get_solution_values(key, self._data_of(g), iterate_index=0)
            for g in grids
        ]
        return np.concatenate(out) if out else np.zeros(0)

    def _scatter(self, grids, setter) -> None:
        pass

    @property
    def subdomain_values(self) -> np.ndarray:
        return self._gather(self.mdg.subdomains(), self.name)

    @subdomain_values.setter
    def subdomain_values(self, val: np.ndarray) -> None:
        i = 0
        for g in self.mdg.subdomains():
            n = self.num_dofs_on_grid(g)
            self.set_values_on_grid(np.asarray(val)[i : i + n], g)
            i += n

    @property
    def subdomain_derivatives(self) -> np.ndarray:
        return np.hstack(
            [self.get_derivatives_on_grid(g) for g in self.mdg.subdomains()]
        )

    @subdomain_derivatives.setter
    def subdomain_derivatives(self, val: np.ndarray) -> None:
        i = 0
        val = np.atleast_2d(np.asarray(val))
        for g in self.mdg.subdomains():
            n = self.num_dofs_on_grid(g)
            self.set_derivatives_on_grid(val[:, i : i + n], g)
            i += n

    @property
    def interface_values(self) -> np.ndarray:
        return self._gather(self.mdg.interfaces(), self.name)

    @interface_values.setter
    def interface_values(self, val: np.ndarray) -> None:
        i = 0
        for g in self.mdg.interfaces():
            n = self.num_dofs_on_grid(g)
            self.set_values_on_grid(np.asarray(val)[i : i + n], g)
            i += n

    @property
    def interface_derivatives(self) -> np.ndarray:
        return np.hstack(
            [self.get_derivatives_on_grid(g) for g in self.mdg.interfaces()]
        )

    @interface_derivatives.setter
    def interface_derivatives(self, val: np.ndarray) -> None:
        i = 0
        val = np.atleast_2d(np.asarray(val))
        for g in self.mdg.interfaces():
            n = self.num_dofs_on_grid(g)
            self.set_derivatives_on_grid(val[:, i : i + n], g)
            i += n

    @property
    def boundary_values(self) -> np.ndarray:
        return self._gather(self.mdg.boundaries(), self.name)

    @boundary_values.setter
    def boundary_values(self, val: np.ndarray) -> None:
        i = 0
        for g in self.mdg.boundaries():
            n = self.num_dofs_on_grid(g)
            set_solution_values(
                self.name,
                np.asarray(val)[i : i + n],
                self._data_of(g),
                iterate_index=0,
            )
            i += n
