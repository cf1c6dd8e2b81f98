"""Operator graph: lazy symbolic expressions over grid-attached variables.

Parity counterpart of the reference operator layer
(``numerics/ad/operators.py:106-1945``): operators are DAG nodes combined by
Python dunders; leaves are constants (scalars, dense/sparse arrays),
variables, and time-dependent arrays; ``previous_timestep()`` /
``previous_iteration()`` re-tag variable leaves to historic state.

TPU-first difference: the reference *interprets* the DAG each assembly with
scipy forward-mode AD. Here the DAG is *compiled once* into a pure jax
function of the global dof vector (see
``porepy_tpu/numerics/ad/compiler.py``); values come from ``jit``, Jacobians
from coloring-compressed forward-mode jvps with static sparsity. The DAG is
therefore a front-end only — evaluation cost does not depend on graph
(interpretation) overhead.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sps

__all__ = [
    "Operator",
    "SparseArray",
    "DenseArray",
    "TimeDependentDenseArray",
    "Scalar",
    "Variable",
    "MixedDimensionalVariable",
    "AdArray",
    "sum_operator_list",
    "wrap_as_dense_ad_array",
    "wrap_as_sparse_ad_array",
]


class Operations(enum.Enum):
    void = "void"
    add = "add"
    sub = "sub"
    mul = "mul"
    div = "div"
    pow = "pow"
    matmul = "matmul"
    neg = "neg"
    evaluate = "evaluate"
    concat = "concat"


class AdArray:
    """Evaluation result: value + sparse Jacobian (host scipy csr).

    Mirrors the reference ``AdArray`` (``numerics/ad/forward_mode.py:48``) as
    a *result* container; it is not used to propagate derivatives (jax is).
    """

    __slots__ = ("val", "jac")

    def __init__(self, val: np.ndarray, jac: sps.spmatrix) -> None:
        self.val = val
        self.jac = jac

    def __repr__(self) -> str:
        return f"AdArray(n={self.val.size}, jac nnz={self.jac.nnz})"


class Operator:
    """Node in the operator DAG."""

    def __init__(
        self,
        name: Optional[str] = None,
        domains: Optional[Sequence] = None,
        operation: Operations = Operations.void,
        children: Optional[Sequence["Operator"]] = None,
    ) -> None:
        self._name = name
        self._domains = tuple(domains) if domains is not None else ()
        self.operation = operation
        self.children: list[Operator] = list(children) if children else []
        # Optional callable for `evaluate` nodes (elementwise functions).
        self.func: Optional[Callable] = None

    # -- identification ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name or self.__class__.__name__

    @property
    def domains(self) -> tuple:
        return self._domains

    @property
    def subdomains(self) -> tuple:
        return self._domains

    @property
    def interfaces(self) -> tuple:
        return self._domains

    def set_name(self, name: str) -> None:
        self._name = name

    def __repr__(self) -> str:
        if self.operation is Operations.void:
            return f"{self.__class__.__name__}({self.name})"
        return (
            f"Operator({self.operation.value}, "
            f"children={[c.name for c in self.children]})"
        )

    # -- history re-tagging ---------------------------------------------------

    def previous_timestep(self, steps: int = 1) -> "Operator":
        """Operator with every variable leaf replaced by its value at the
        ``steps``-most-recent completed time step (constant under AD).
        Time-dependent arrays shift to their stored time-step ring too."""
        return _retag(
            self, lambda v: v.at_time_step(steps - 1), shift_tda=True, steps=steps
        )

    def previous_iteration(self, steps: int = 1) -> "Operator":
        """Operator with every variable leaf at a previous Newton iterate."""
        return _retag(
            self, lambda v: v.at_iterate(steps), shift_tda=False, steps=steps
        )

    # -- evaluation -----------------------------------------------------------

    def value(self, equation_system) -> np.ndarray:
        from porepy_tpu_torch.numerics.ad import compiler

        return compiler.evaluate(self, equation_system)

    def value_and_jacobian(self, equation_system) -> AdArray:
        from porepy_tpu_torch.numerics.ad import compiler

        return compiler.evaluate_with_jacobian(self, equation_system)

    # -- algebra --------------------------------------------------------------

    def _binop(self, other: Any, op: Operations, reflexive: bool = False) -> "Operator":
        other_op = _wrap(other)
        if other_op is NotImplemented:
            return NotImplemented
        a, b = (other_op, self) if reflexive else (self, other_op)
        return Operator(operation=op, children=[a, b])

    def __add__(self, other):
        return self._binop(other, Operations.add)

    def __radd__(self, other):
        return self._binop(other, Operations.add, reflexive=True)

    def __sub__(self, other):
        return self._binop(other, Operations.sub)

    def __rsub__(self, other):
        return self._binop(other, Operations.sub, reflexive=True)

    def __mul__(self, other):
        return self._binop(other, Operations.mul)

    def __rmul__(self, other):
        return self._binop(other, Operations.mul, reflexive=True)

    def __truediv__(self, other):
        return self._binop(other, Operations.div)

    def __rtruediv__(self, other):
        return self._binop(other, Operations.div, reflexive=True)

    def __pow__(self, other):
        return self._binop(other, Operations.pow)

    def __rpow__(self, other):
        return self._binop(other, Operations.pow, reflexive=True)

    def __matmul__(self, other):
        return self._binop(other, Operations.matmul)

    def __rmatmul__(self, other):
        return self._binop(other, Operations.matmul, reflexive=True)

    def __neg__(self):
        return Operator(operation=Operations.neg, children=[self])


def _wrap(x: Any) -> Union[Operator, Any]:
    if isinstance(x, Operator):
        return x
    if isinstance(x, (int, float, np.floating, np.integer)):
        return Scalar(float(x))
    if isinstance(x, np.ndarray):
        return DenseArray(x)
    if sps.issparse(x):
        return SparseArray(x)
    return NotImplemented


def _retag(
    op: Operator,
    fn: Callable[["Variable"], "Variable"],
    shift_tda: bool,
    steps: int = 1,
) -> Operator:
    # Surrogate operators collapse to stored constants at historic states
    # (their own previous_* methods encode the storage semantics).
    if type(op).__name__ == "SurrogateOperator":
        return (
            op.previous_timestep(steps) if shift_tda else op.previous_iteration(steps)
        )
    if isinstance(op, MixedDimensionalVariable):
        return MixedDimensionalVariable([fn(v) for v in op.sub_vars])
    if isinstance(op, Variable):
        return fn(op)
    if isinstance(op, TimeDependentDenseArray):
        if shift_tda:
            return TimeDependentDenseArray(
                op._name, op._domains, previous_timestep=True
            )
        return op
    if not op.children:
        return op
    new = Operator(
        name=op._name,
        domains=op._domains,
        operation=op.operation,
        children=[_retag(c, fn, shift_tda, steps) for c in op.children],
    )
    new.func = op.func
    if hasattr(op, "func_pattern"):
        new.func_pattern = op.func_pattern
    return new


# -- leaves -------------------------------------------------------------------


class Scalar(Operator):
    """Scalar leaf. The value is fetched per evaluation (not baked into
    compiled kernels), so :meth:`set_value` takes effect without
    recompilation — used by the time-step scalar ``ad_time_step``."""

    def __init__(self, value: float, name: Optional[str] = None) -> None:
        super().__init__(name=name)
        self.value = float(value)

    def set_value(self, value: float) -> None:
        self.value = float(value)


class DenseArray(Operator):
    def __init__(self, values: np.ndarray, name: Optional[str] = None) -> None:
        super().__init__(name=name)
        self.values = np.asarray(values, dtype=float)


class SparseArray(Operator):
    def __init__(self, mat: sps.spmatrix, name: Optional[str] = None) -> None:
        super().__init__(name=name)
        self.mat = sps.csr_matrix(mat)

    @property
    def T(self) -> "SparseArray":
        return SparseArray(self.mat.T, name=f"{self.name}.T")

    def transpose(self) -> "SparseArray":
        return self.T


class TimeDependentDenseArray(Operator):
    """Array fetched from grid data dicts at evaluation time, re-read every
    assembly (boundary values, sources updated per time step).

    ``previous_timestep=True`` reads from the stored time-step ring instead
    of the current iterate ring; ``iterate_index`` selects an entry of the
    iterate ring (0 = current).
    """

    def __init__(
        self,
        name: str,
        domains: Sequence,
        previous_timestep: bool = False,
        iterate_index: int = 0,
    ) -> None:
        super().__init__(name=name, domains=domains)
        self.prev_time = previous_timestep
        self.iterate_index = iterate_index

    def previous_timestep(self, steps: int = 1) -> "TimeDependentDenseArray":
        return TimeDependentDenseArray(
            self._name, self._domains, previous_timestep=True
        )

    def previous_iteration(self, steps: int = 1) -> "TimeDependentDenseArray":
        return TimeDependentDenseArray(
            self._name, self._domains, iterate_index=self.iterate_index + steps
        )


class Variable(Operator):
    """Scalar/vector unknown on a single grid.

    ``time_step_index is None`` means the variable represents the current
    iterate (the quantity differentiated); integer indices address the
    stored solution rings (0 = most recent).
    """

    def __init__(
        self,
        name: str,
        dof_info: dict,
        domain,
        time_step_index: Optional[int] = None,
        iterate_index: int = 0,
    ) -> None:
        super().__init__(name=name, domains=(domain,))
        self.dof_info = dict(dof_info)
        self.domain = domain
        self.time_step_index = time_step_index
        self.iterate_index = iterate_index

    @property
    def is_current_iterate(self) -> bool:
        return self.time_step_index is None and self.iterate_index == 0

    def at_time_step(self, index: int) -> "Variable":
        return Variable(self._name, self.dof_info, self.domain, time_step_index=index)

    def at_iterate(self, index: int) -> "Variable":
        return Variable(
            self._name, self.dof_info, self.domain, iterate_index=index
        )

    def previous_timestep(self, steps: int = 1) -> "Variable":
        return self.at_time_step(steps - 1)

    def previous_iteration(self, steps: int = 1) -> "Variable":
        return self.at_iterate(steps)

    def size(self) -> int:
        g = self.domain
        n = 0
        n += self.dof_info.get("cells", 0) * g.num_cells
        n += self.dof_info.get("faces", 0) * getattr(g, "num_faces", 0)
        n += self.dof_info.get("nodes", 0) * getattr(g, "num_nodes", 0)
        return n

    def __repr__(self) -> str:
        tag = ""
        if self.time_step_index is not None:
            tag = f"@t-{self.time_step_index + 1}"
        elif self.iterate_index != 0:
            tag = f"@i-{self.iterate_index}"
        return f"Variable({self.name}{tag}, {self.domain})"


class MixedDimensionalVariable(Variable):
    """Concatenation of the same named variable over several grids, ordered
    by the grids' md iteration order."""

    def __init__(self, sub_vars: Sequence[Variable]) -> None:
        self.sub_vars = list(sub_vars)
        if self.sub_vars:
            v0 = self.sub_vars[0]
            Operator.__init__(
                self, name=v0._name, domains=tuple(v.domain for v in sub_vars)
            )
            self.dof_info = v0.dof_info
            self.time_step_index = v0.time_step_index
            self.iterate_index = v0.iterate_index
        else:
            Operator.__init__(self, name="empty_md_variable", domains=())
            self.dof_info = {}
            self.time_step_index = None
            self.iterate_index = 0
        self.domain = None

    def previous_timestep(self, steps: int = 1) -> "MixedDimensionalVariable":
        return MixedDimensionalVariable(
            [v.previous_timestep(steps) for v in self.sub_vars]
        )

    def previous_iteration(self, steps: int = 1) -> "MixedDimensionalVariable":
        return MixedDimensionalVariable(
            [v.previous_iteration(steps) for v in self.sub_vars]
        )

    def size(self) -> int:
        return sum(v.size() for v in self.sub_vars)

    def __repr__(self) -> str:
        return f"MixedDimensionalVariable({self.name}, {len(self.sub_vars)} grids)"


# -- convenience --------------------------------------------------------------


def concat(operators: Sequence[Operator], name: Optional[str] = None) -> Operator:
    """Concatenation of operator values along their single axis."""
    ops = []
    for o in operators:
        w = _wrap(o)
        if w is NotImplemented:
            raise TypeError(f"Cannot concatenate {o!r}")
        ops.append(w)
    return Operator(name=name or "concat", operation=Operations.concat, children=ops)


def sum_operator_list(
    operators: Sequence[Operator], name: Optional[str] = None
) -> Operator:
    if len(operators) == 0:
        raise ValueError("Cannot sum an empty operator list")
    out = operators[0]
    for op in operators[1:]:
        out = out + op
    if name is not None:
        out.set_name(name)
    return out


def wrap_as_dense_ad_array(
    values: Union[float, np.ndarray], size: Optional[int] = None, name: Optional[str] = None
) -> DenseArray:
    if np.isscalar(values):
        if size is None:
            raise ValueError("size required when wrapping a scalar")
        values = np.full(size, float(values))
    return DenseArray(np.asarray(values), name=name)


def wrap_as_sparse_ad_array(mat: sps.spmatrix, name: Optional[str] = None) -> SparseArray:
    return SparseArray(mat, name=name)
