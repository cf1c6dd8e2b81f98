"""Dof management and equation assembly.

Parity counterpart of reference ``numerics/ad/equation_system.py:94``:
manages named variables on md-grid entities (dof ordering clustered
grid-wise: grids in md iteration order, variables in creation order within a
grid — matching ``equation_system.py:838``), named equations, state rings
(time-step/iterate solution buffers in grid data dicts), and assembly of the
(Jacobian, -residual) pair.

Each named equation's operator DAG is traced once into a torch function of
the global dof vector (``compiler.build_function``); its structural
sparsity and column coloring are computed once; per-assembly work is one
hand-written forward-mode pass per equation over (value, tangent rows of
the color seeds) pairs (K8: the executor of ``numerics/ad/forward.py``),
whose root launch writes the equation's Jacobian nonzeros, in the global
nonzero order, and its rows of the right-hand side, on the equation
system's ``device``. Historic states flow through the ``env`` arguments, so
nothing is retraced across time steps/iterations.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.numerics.ad import compiler
from porepy_tpu_torch.numerics.ad.operators import (
    MixedDimensionalVariable,
    Operator,
    TimeDependentDenseArray,
    Variable,
)
from porepy_tpu_torch.utils import common_constants as cc
from porepy_tpu_torch.utils import device_policy
from porepy_tpu_torch.utils.solution_storage import get_solution_values, set_solution_values

__all__ = ["EquationSystem"]

VariableList = Union[str, Variable, MixedDimensionalVariable, Sequence]


class _CompiledEquation:
    def __init__(self, eq_sys: "EquationSystem", op: Operator) -> None:
        self.op = op
        fn, env_spec = compiler.build_function(op, eq_sys)
        self.fn = fn
        self.env_spec = env_spec
        self.pattern = compiler.sparsity_pattern(op, eq_sys)
        self.colors, self.n_colors = compiler.greedy_color(self.pattern)
        ndof = eq_sys.num_dofs()
        seeds = np.zeros((max(self.n_colors, 1), ndof))
        if ndof:
            seeds[self.colors, np.arange(ndof)] = 1.0
        # Host array; _CompiledSystem keeps its own device copy.
        self.seeds = seeds
        self.device = eq_sys.device
        self.rows, self.cols = self.pattern.nonzero()
        # Gather indices into the (n_colors, n_rows) compressed block.
        self.gather_color = self.colors[self.cols]
        self._colors_on: dict = {}

    def colors_on(self, device) -> torch.Tensor:
        """The int32 color of every unknown on ``device``: the one-hot seeds
        of the dual pass."""
        t = self._colors_on.get(device)
        if t is None:
            t = self._colors_on[device] = torch.tensor(
                self.colors, dtype=torch.int32, device=device
            )
        return t

    def _tensors(self, x, env):
        if not torch.is_tensor(x):
            x = compiler._to_tensor(x, self.device)
        env = [
            e if torch.is_tensor(e) else compiler._to_tensor(e, self.device)
            for e in env
        ]
        return x, env

    def residual(self, x, env) -> np.ndarray:
        x, env = self._tensors(x, env)
        return self.fn(x, *env).cpu().numpy()

    def residual_and_jacobian(
        self, x, env, ndof: int
    ) -> tuple[np.ndarray, sps.csr_matrix]:
        x, env = self._tensors(x, env)
        val, compressed = compiler.dual_jvps(
            self.fn, x, env, self.colors_on(x.device), self.n_colors
        )
        if compressed is None:
            data = np.zeros(self.rows.size)
        else:
            data = compressed.cpu().numpy()[self.gather_color, self.rows]
        jac = sps.csr_matrix(
            (data, (self.rows, self.cols)), shape=(self.pattern.shape[0], ndof)
        )
        return val.cpu().numpy(), jac


class _CompiledSystem:
    """All named equations assembled on the device: the concatenated
    Jacobian nonzeros (in the static global COO layout) and the negated
    residual — the device-resident Newton assembly. Counterpart of the
    reference's ``EquationSystem.assemble`` (ref
    ``equation_system.py:1450``), but with no host scipy matrix in the
    loop. One forward-mode pass per equation (K8), whose root program writes
    ``compressed[gc, rj]`` of its colored tangent rows into the equation's
    nonzeros and its negated value into its rows of the right-hand side
    (``DualExecutor.scatter``, one launch an equation)."""

    def __init__(self, eq_sys: "EquationSystem", names: Sequence[str]) -> None:
        self.names = tuple(names)
        self.ces = [eq_sys._get_compiled(n) for n in names]
        self.device = eq_sys.device
        dev = self.device
        ndof = eq_sys.num_dofs()
        idx_chunks = []
        row_offset = 0
        self.row_offsets = {}
        for name, ce in zip(names, self.ces):
            self.row_offsets[name] = row_offset
            idx_chunks.append(
                np.column_stack([ce.rows + row_offset, ce.cols]).astype(np.int64)
            )
            row_offset += ce.pattern.shape[0]
        self.num_rows = row_offset
        self.shape = (row_offset, ndof)
        indices = (
            np.concatenate(idx_chunks) if idx_chunks else np.zeros((0, 2), np.int64)
        )
        self.indices_np = indices
        self.indices = torch.tensor(indices, dtype=torch.int64, device=dev)
        # Where each equation's root writes: per nonzero its color and its
        # row within its equation, and the equations' offsets.
        self._nnz_offsets = [0]
        self._row_offsets = [0]
        self._targets = []
        for ce in self.ces:
            self._targets.append(kernels.RootScatter(
                ce.gather_color, ce.rows, ce.pattern.shape[0], self._row_offsets[-1],
                self._nnz_offsets[-1], dev,
            ))
            self._nnz_offsets.append(self._nnz_offsets[-1] + ce.rows.size)
            self._row_offsets.append(self._row_offsets[-1] + ce.pattern.shape[0])
        self._colors = [ce.colors_on(dev) for ce in self.ces]

    def _empty(self) -> torch.Tensor:
        return torch.zeros(0, dtype=torch.float64, device=self.device)

    def _data_and_rhs(self, x, envs) -> tuple[torch.Tensor, torch.Tensor]:
        """(nonzero data, -residual) at ``x`` for the given env tensors."""
        data = torch.empty(self._nnz_offsets[-1], dtype=torch.float64, device=x.device)
        rhs = torch.empty(self.num_rows, dtype=torch.float64, device=x.device)
        for ce, env, colors, target in zip(self.ces, envs, self._colors, self._targets):
            ce.fn.dual.scatter(x, env, colors, ce.n_colors, target, data, rhs)
        return data, rhs

    def _rhs_only(self, x, envs) -> torch.Tensor:
        rhs = torch.empty(self.num_rows, dtype=torch.float64, device=x.device)
        for ce, env, target in zip(self.ces, envs, self._targets):
            ce.fn.dual.scatter(x, env, None, 0, target, None, rhs)
        return rhs

    def _envs(self, eq_sys) -> tuple:
        return tuple(
            tuple(ce.env_spec.fetch_device(eq_sys)) for ce in self.ces
        )

    def assemble(self, eq_sys) -> tuple[torch.Tensor, torch.Tensor]:
        """(Jacobian nonzero data, -residual), both device tensors.
        Combine the data with the static ``indices``/``shape`` for the
        global sparse matrix."""
        x = compiler._to_tensor(eq_sys._global_vector(), self.device)
        return self._data_and_rhs(x, self._envs(eq_sys))

    def residual(self, eq_sys, x=None) -> torch.Tensor:
        """-residual as a device tensor (``x`` defaults to current iterate)."""
        if x is None:
            x = eq_sys._global_vector()
        x = compiler._to_tensor(np.asarray(x), self.device)
        return self._rhs_only(x, self._envs(eq_sys))

    def bcoo(self, data: torch.Tensor) -> torch.Tensor:
        """The assembled Jacobian as a sparse COO tensor (the name is kept
        from ``porepy_tpu``)."""
        return torch.sparse_coo_tensor(
            self.indices.T, data, size=self.shape, is_coalesced=True
        )


class EquationSystem:
    """Dofs, equations, state rings and assembly of one md problem.
    Compiled assembly runs on ``device`` (default: the CUDA device)."""

    def __init__(self, mdg, device=None) -> None:
        self.mdg = mdg
        self.device = device_policy.resolve(device)
        # Registry: (name, grid) -> Variable, insertion-ordered per grid.
        self._variables: list[Variable] = []
        self._variable_names: list[str] = []
        self._equations: dict[str, Operator] = {}
        self._compiled: dict[str, _CompiledEquation] = {}
        self._compiled_systems: dict[tuple, _CompiledSystem] = {}
        # Global dof bookkeeping, rebuilt on variable creation.
        self._dof_offsets: dict[tuple[str, int], tuple[int, int]] = {}
        self._num_dofs: int = 0

    # -- variables -----------------------------------------------------------

    @property
    def variables(self) -> list[Variable]:
        return list(self._variables)

    @property
    def variable_domains(self) -> list:
        seen = []
        for v in self._variables:
            if v.domain not in seen:
                seen.append(v.domain)
        return seen

    @property
    def equations(self) -> dict[str, Operator]:
        return dict(self._equations)

    def create_variables(
        self,
        name: str,
        dof_info: Optional[dict] = None,
        subdomains: Optional[Sequence] = None,
        interfaces: Optional[Sequence] = None,
        tags: Optional[dict] = None,
    ) -> MixedDimensionalVariable:
        if dof_info is None:
            dof_info = {"cells": 1}
        if subdomains is None and interfaces is None:
            raise ValueError("Provide subdomains and/or interfaces")
        grids = list(subdomains or []) + list(interfaces or [])
        if name in self._variable_names:
            raise ValueError(f"Variable {name!r} already exists")
        new_vars = []
        for g in grids:
            v = Variable(name, dof_info, g)
            self._variables.append(v)
            new_vars.append(v)
            # Initialize both rings at index 0 with zeros.
            data = self._grid_data(g)
            zeros = np.zeros(v.size())
            set_solution_values(name, zeros, data, time_step_index=0, iterate_index=0)
        self._variable_names.append(name)
        self._rebuild_dofs()
        self._compiled.clear()
        self._compiled_systems.clear()
        return MixedDimensionalVariable(new_vars)

    def md_variable(
        self, name: str, grids: Optional[Sequence] = None
    ) -> MixedDimensionalVariable:
        sub = [
            v
            for v in self._variables
            if v.name == name and (grids is None or v.domain in grids)
        ]
        if not sub:
            # An explicitly empty grid list is a valid (empty) restriction —
            # e.g. matrix porosity evaluated on a fracture-only subdomain
            # list. Only an unknown variable name is an error.
            if grids is not None and len(list(grids)) == 0 and any(
                v.name == name for v in self._variables
            ):
                return MixedDimensionalVariable([])
            raise ValueError(f"No variable named {name!r}")
        return MixedDimensionalVariable(sub)

    def get_variables(
        self,
        variables: Optional[VariableList] = None,
        grids: Optional[Sequence] = None,
    ) -> list[Variable]:
        out = []
        names = None
        if variables is not None:
            names = {
                v if isinstance(v, str) else v.name
                for v in (
                    variables if isinstance(variables, (list, tuple)) else [variables]
                )
            }
        for v in self._variables:
            if names is not None and v.name not in names:
                continue
            if grids is not None and v.domain not in grids:
                continue
            out.append(v)
        return out

    # -- dofs ----------------------------------------------------------------

    def _canonical_grids(self) -> list:
        return list(self.mdg.subdomains()) + list(self.mdg.interfaces())

    def _rebuild_dofs(self) -> None:
        """Cluster dofs grid-wise: grids in md order, variables in creation
        order within each grid."""
        offset = 0
        self._dof_offsets = {}
        for g in self._canonical_grids():
            for v in self._variables:
                if v.domain is g:
                    n = v.size()
                    self._dof_offsets[(v.name, id(g))] = (offset, n)
                    offset += n
        # Variables on grids not in the mdg (should not happen) — guard.
        for v in self._variables:
            if (v.name, id(v.domain)) not in self._dof_offsets:
                n = v.size()
                self._dof_offsets[(v.name, id(v.domain))] = (offset, n)
                offset += n
        self._num_dofs = offset

    def num_dofs(self) -> int:
        return self._num_dofs

    def dofs_of(self, variables: VariableList) -> np.ndarray:
        if not isinstance(variables, (list, tuple)):
            variables = [variables]
        chunks = []
        for v in variables:
            if isinstance(v, str):
                chunks.append(self.dofs_of(self.get_variables([v])))
            elif isinstance(v, MixedDimensionalVariable):
                chunks.extend(
                    np.arange(*_span(self._dof_offsets[(s.name, id(s.domain))]))
                    for s in v.sub_vars
                )
            elif isinstance(v, Variable):
                chunks.append(
                    np.arange(*_span(self._dof_offsets[(v.name, id(v.domain))]))
                )
            else:
                raise TypeError(f"Cannot resolve dofs of {v!r}")
        if not chunks:
            return np.zeros(0, dtype=int)
        return np.concatenate(chunks)

    def projection_to(self, variables: Optional[VariableList] = None) -> sps.csr_matrix:
        if variables is None:
            return sps.eye(self._num_dofs, format="csr")
        idx = self.dofs_of(variables)
        return sps.csr_matrix(
            (np.ones(idx.size), (np.arange(idx.size), idx)),
            shape=(idx.size, self._num_dofs),
        )

    def identify_dof(self, dof: int) -> Variable:
        for v in self._variables:
            start, n = self._dof_offsets[(v.name, id(v.domain))]
            if start <= dof < start + n:
                return v
        raise KeyError(f"Dof {dof} out of range")

    # -- state get/set -------------------------------------------------------

    def _grid_data(self, g) -> dict:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if isinstance(g, BoundaryGrid):
            return self.mdg.boundary_grid_data(g)
        if g in getattr(self.mdg, "_subdomain_data", {}):
            return self.mdg.subdomain_data(g)
        return self.mdg.interface_data(g)

    def get_variable_values(
        self,
        variables: Optional[VariableList] = None,
        time_step_index: Optional[int] = None,
        iterate_index: Optional[int] = None,
    ) -> np.ndarray:
        vs = self._resolve(variables)
        return np.concatenate(
            [
                get_solution_values(
                    v.name,
                    self._grid_data(v.domain),
                    time_step_index=time_step_index,
                    iterate_index=iterate_index,
                )
                for v in vs
            ]
            or [np.zeros(0)]
        )

    def set_variable_values(
        self,
        values: np.ndarray,
        variables: Optional[VariableList] = None,
        time_step_index: Optional[int] = None,
        iterate_index: Optional[int] = None,
        additive: bool = False,
    ) -> None:
        vs = self._resolve(variables)
        pos = 0
        for v in vs:
            n = v.size()
            set_solution_values(
                v.name,
                np.asarray(values)[pos : pos + n],
                self._grid_data(v.domain),
                time_step_index=time_step_index,
                iterate_index=iterate_index,
                additive=additive,
            )
            pos += n
        if pos != np.asarray(values).size:
            raise ValueError("Value vector size does not match variable dofs")

    def shift_time_step_values(
        self,
        max_index: Optional[int] = 1,
        variables: Optional[Sequence[str]] = None,
        exclude: Optional[Sequence[str]] = None,
    ) -> None:
        """Shift stored time-step rings one step back. ``max_index=None``
        keeps the whole history (the ring depth grows by one per call,
        reference ``equation_system.py:738``: 'called repeatedly with None,
        the depth keeps increasing'). ``variables``/``exclude`` restrict the
        shift by variable name."""
        self._shift(cc.TIME_STEP_SOLUTIONS, max_index, variables, exclude)

    def shift_iterate_values(self, max_index: int = 1) -> None:
        self._shift(cc.ITERATE_SOLUTIONS, max_index)

    def _shift(
        self,
        key: str,
        max_index: Optional[int],
        variables: Optional[Sequence[str]] = None,
        exclude: Optional[Sequence[str]] = None,
    ) -> None:
        from porepy_tpu_torch.utils.solution_storage import bump_state_version

        for v in self._variables:
            if variables is not None and v.name not in variables:
                continue
            if exclude is not None and v.name in exclude:
                continue
            ring = self._grid_data(v.domain).get(key, {}).get(v.name)
            if ring is None:
                continue
            mi = (max(ring.keys()) + 1) if max_index is None else max_index
            for i in range(mi, 0, -1):
                if (i - 1) in ring:
                    ring[i] = np.copy(ring[i - 1])
        bump_state_version()

    def _resolve(self, variables: Optional[VariableList]) -> list[Variable]:
        """Expand a variable spec into single-grid Variables in global dof
        order."""
        if variables is None:
            vs = list(self._variables)
        else:
            if not isinstance(variables, (list, tuple)):
                variables = [variables]
            vs = []
            for v in variables:
                if isinstance(v, str):
                    vs.extend(self.get_variables([v]))
                elif isinstance(v, MixedDimensionalVariable):
                    vs.extend(v.sub_vars)
                else:
                    vs.append(v)
        return sorted(
            vs, key=lambda v: self._dof_offsets[(v.name, id(v.domain))][0]
        )

    # -- compiler hooks ------------------------------------------------------

    def _global_vector(self) -> np.ndarray:
        """Current-iterate values of all variables in global dof order."""
        out = np.zeros(self._num_dofs)
        for v in self._variables:
            start, n = self._dof_offsets[(v.name, id(v.domain))]
            out[start : start + n] = get_solution_values(
                v.name, self._grid_data(v.domain), iterate_index=0
            )
        return out

    def _stored_values(self, v: Variable) -> np.ndarray:
        data = self._grid_data(v.domain)
        if v.time_step_index is not None:
            return get_solution_values(v.name, data, time_step_index=v.time_step_index)
        return get_solution_values(v.name, data, iterate_index=v.iterate_index)

    def _stored_time_dependent(self, op: TimeDependentDenseArray) -> np.ndarray:
        it = getattr(op, "iterate_index", 0)
        chunks = []
        for g in op.domains:
            data = self._grid_data(g)
            if op.prev_time:
                chunks.append(get_solution_values(op.name, data, time_step_index=0))
            else:
                chunks.append(get_solution_values(op.name, data, iterate_index=it))
        return np.concatenate(chunks or [np.zeros(0)])

    # -- equations -----------------------------------------------------------

    def set_equation(
        self,
        equation: Operator,
        grids: Optional[Sequence] = None,
        equations_per_grid_entity: Optional[dict] = None,
    ) -> None:
        name = equation.name
        self._equations[name] = equation
        self._compiled.pop(name, None)
        self._compiled_systems.clear()

    def remove_equation(self, name: str) -> Optional[Operator]:
        self._compiled.pop(name, None)
        self._compiled_systems.clear()
        return self._equations.pop(name, None)

    def update_equation(self, name: str, equation: Operator) -> None:
        equation.set_name(name)
        self._equations[name] = equation
        self._compiled.pop(name, None)
        self._compiled_systems.clear()

    def clear_compiled(self) -> None:
        """Drop compiled equations (call after rediscretization that
        changes constant matrices baked into operator DAGs)."""
        self._compiled.clear()
        self._compiled_systems.clear()

    def refresh_compiled_constants(self) -> None:
        """After a VALUE-ONLY rediscretization (same grids, same sparsity),
        swap the compiled equations' constant-matrix arguments in place
        instead of dropping them — ``clear_compiled`` forces a retrace of
        every equation at every nonlinear iteration for models with
        nonlinear discretizations. Falls back to :meth:`clear_compiled` if
        any constant's sparsity layout changed."""
        for ce in self._compiled.values():
            if not ce.env_spec.refresh_constants():
                self.clear_compiled()
                return

    def _get_compiled(self, name: str) -> _CompiledEquation:
        ce = self._compiled.get(name)
        if ce is None:
            ce = _CompiledEquation(self, self._equations[name])
            self._compiled[name] = ce
        return ce

    # -- evaluation / assembly -----------------------------------------------

    def evaluate(self, op: Operator, state=None) -> np.ndarray:
        return compiler.evaluate(op, self, state=state)

    def assemble(
        self,
        equations: Optional[Sequence[str]] = None,
        variables: Optional[VariableList] = None,
        evaluate_jacobian: bool = True,
    ) -> Union[tuple[sps.csr_matrix, np.ndarray], np.ndarray]:
        """Assemble the (Jacobian, -residual) of the named equations (all by
        default), restricted to the named variable columns (all by default).
        """
        names = list(equations) if equations is not None else list(self._equations)
        x = compiler._to_tensor(self._global_vector(), self.device)
        vals = []
        jacs = []
        for name in names:
            ce = self._get_compiled(name)
            env = ce.env_spec.fetch(self)
            if evaluate_jacobian:
                val, jac = ce.residual_and_jacobian(x, env, self._num_dofs)
                jacs.append(jac)
            else:
                val = ce.residual(x, env)
            vals.append(val)
        b = -np.concatenate(vals) if vals else np.zeros(0)
        if not evaluate_jacobian:
            return b
        A = sps.vstack(jacs).tocsr() if jacs else sps.csr_matrix((0, self._num_dofs))
        if variables is not None:
            A = A @ self.projection_to(variables).T
        return A, b

    def assemble_subsystem(
        self,
        equations: Optional[Sequence[str]] = None,
        variables: Optional[VariableList] = None,
    ) -> tuple[sps.csr_matrix, np.ndarray]:
        return self.assemble(equations=equations, variables=variables)

    # -- device-resident assembly ---------------------------------------------

    def compiled_system(
        self, equations: Optional[Sequence[str]] = None
    ) -> _CompiledSystem:
        """The device assembly of the named equations (all by default):
        one call yields the global Jacobian's nonzero data (static COO
        layout) and the negated residual, with no host scipy matrix."""
        names = tuple(equations) if equations is not None else tuple(self._equations)
        cs = self._compiled_systems.get(names)
        if cs is None:
            cs = _CompiledSystem(self, names)
            self._compiled_systems[names] = cs
        return cs

    def assemble_device(
        self, equations: Optional[Sequence[str]] = None
    ) -> tuple[torch.Tensor, torch.Tensor, _CompiledSystem]:
        """(Jacobian nonzero data, -residual, system structure) on device."""
        cs = self.compiled_system(equations)
        data, b = cs.assemble(self)
        return data, b, cs

    # -- Schur complement ----------------------------------------------------

    def assemble_schur_complement_system(
        self,
        primary_equations: Sequence[str],
        primary_variables: VariableList,
        inverter=None,
    ) -> tuple[sps.csr_matrix, np.ndarray]:
        """Assemble the Schur complement after eliminating the complementary
        (secondary) equations/variables:
        ``A_pp - A_ps inv(A_ss) A_sp``; rhs ``b_p - A_ps inv(A_ss) b_s``.
        """
        if inverter is None:
            inverter = self.default_schur_complement_inverter
        all_eqs = list(self._equations)
        sec_eqs = [n for n in all_eqs if n not in primary_equations]
        prim_vars = self._resolve(primary_variables)
        sec_vars = [v for v in self._variables if v not in prim_vars]

        A, b = self.assemble()
        pe_rows = self._equation_rows(primary_equations, all_eqs)
        se_rows = self._equation_rows(sec_eqs, all_eqs)
        pv = self.dofs_of(prim_vars)
        sv = self.dofs_of(sec_vars)

        A_pp = A[pe_rows][:, pv]
        A_ps = A[pe_rows][:, sv]
        A_sp = A[se_rows][:, pv]
        A_ss = A[se_rows][:, sv]
        b_p = b[pe_rows]
        b_s = b[se_rows]

        inv_ss = inverter(A_ss.tocsr())
        S = (A_pp - A_ps @ inv_ss @ A_sp).tocsr()
        rhs = b_p - A_ps @ (inv_ss @ b_s)
        self._schur_cache = (inv_ss, A_sp, b_s, pv, sv)
        return S, rhs

    def expand_schur_complement_solution(self, reduced_solution: np.ndarray) -> np.ndarray:
        inv_ss, A_sp, b_s, pv, sv = self._schur_cache
        x = np.zeros(self._num_dofs)
        x[pv] = reduced_solution
        x[sv] = inv_ss @ (b_s - A_sp @ reduced_solution)
        return x

    @staticmethod
    def default_schur_complement_inverter(A: sps.spmatrix) -> sps.spmatrix:
        """Invert the secondary block by independent diagonal sub-blocks.

        Secondary equations eliminated through the Schur complement are
        local (cell-wise closures, contact conditions), so ``A_ss``
        decomposes into many small decoupled blocks: find them as connected
        components of the symmetrized sparsity graph and invert each
        densely (reference ``equation_system.py:1954`` uses the same
        block-structure-aware strategy; a dense global inverse is unusable
        beyond toy sizes)."""
        from scipy.sparse.csgraph import connected_components

        A = A.tocsr()
        n = A.shape[0]
        if n == 0:
            return A
        sym = ((A != 0) + (A != 0).T).tocsr()
        n_comp, labels = connected_components(sym, directed=False)
        if n_comp == 1:
            return sps.csr_matrix(sps.linalg.inv(A.tocsc()))
        order = np.argsort(labels, kind="stable")
        sizes = np.bincount(labels, minlength=n_comp)
        rows_out, cols_out, vals_out = [], [], []
        pos = 0
        Ad = A.tocsc()
        for b in range(n_comp):
            idx = order[pos : pos + sizes[b]]
            pos += sizes[b]
            block = Ad[idx][:, idx].toarray()
            inv = np.linalg.inv(block)
            rr, cc = np.nonzero(inv)
            rows_out.append(idx[rr])
            cols_out.append(idx[cc])
            vals_out.append(inv[rr, cc])
        return sps.csr_matrix(
            (
                np.concatenate(vals_out),
                (np.concatenate(rows_out), np.concatenate(cols_out)),
            ),
            shape=A.shape,
        )

    def _equation_rows(self, names: Sequence[str], all_names: Sequence[str]) -> np.ndarray:
        offsets = {}
        pos = 0
        for n in all_names:
            ce = self._get_compiled(n)
            nrows = ce.pattern.shape[0]
            offsets[n] = (pos, nrows)
            pos += nrows
        return np.concatenate(
            [np.arange(*_span(offsets[n])) for n in names] or [np.zeros(0, dtype=int)]
        )

    def discretize(self) -> None:
        """Re-run any discretizations referenced by the equations. Handled by
        the model layer in this framework; kept for API parity."""

    def __repr__(self) -> str:
        return (
            f"EquationSystem(dofs={self._num_dofs}, "
            f"variables={len(self._variables)}, equations={len(self._equations)})"
        )


def _span(t: tuple[int, int]) -> tuple[int, int]:
    return t[0], t[0] + t[1]
