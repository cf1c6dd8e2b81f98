"""Hand-written forward-mode pass of the assembly on dual numbers (K8).

``porepy_tpu`` differentiates each equation's residual with
``jax.linearize`` and pushes the colored seeds through it with ``jax.vmap``
(``numerics/ad/equation_system.py:132-135``); XLA fuses the result into one
program. This module does the same work by hand: :class:`DualExecutor` walks
one equation's operator DAG once, when the equation is compiled, and turns
it into a list of steps on :class:`Dual` values ``(val, tan)`` with ``tan``
the ``(B, n)`` block ``J @ seeds[c]`` of the ``B`` color seeds, or ``None``
for a constant. At every assembly the steps run in order:

- the unknowns enter through the step's
  :class:`~porepy_tpu_torch.kernels.DualGatherVar` (the seeds are one-hot by
  color, so the tangent rows are written from the colors, once per color
  set into a buffer the launcher keeps, and no seed array exists; an
  assembly writes the value row alone);
- a maximal subtree of ``add, sub, mul, div, pow, neg`` nodes and elementwise
  functions whose inner nodes have one consumer is one
  :class:`~porepy_tpu_torch.kernels.DualProgram`, run by the step's
  :class:`~porepy_tpu_torch.kernels.DualEwLauncher` (``dual_ew``) in one
  launch (a node with several consumers is materialized, as is a subtree
  that outgrows the program's registers);
- a constant sparse matrix is applied to value and tangent rows by the K1
  kernel (the matrix's :class:`~porepy_tpu_torch.kernels.EllOperator`, the
  launch without the dispatcher) in one stacked launch;
- the root, when the system assembles, writes the equation's Jacobian
  nonzeros and right-hand side rows itself
  (:meth:`DualExecutor.scatter`: the root program's launch in the
  assembly's layout, ``dual_ew_scatter``; a root that is not a fused
  program gets an identity program);
- concatenations go through the step's
  :class:`~porepy_tpu_torch.kernels.DualGatherCopy`;
- an ``evaluate`` node runs the *dual rule* of its function (the function's
  ``dual_rule`` attribute, set where the function is built): either an
  :func:`elementwise` emitter, which joins the fused program, or a callable
  ``rule(run, *duals) -> Dual`` that calls the function's own kernels (K14,
  K15, K16) on values and tangent rows;
- a function with no rule is differentiated by ``torch.func`` on that node
  alone; the executor lists such nodes in :attr:`DualExecutor.ruleless` and
  warns when it compiles one. An elementwise rule that outgrows one program
  is an error, not a reason to take that route.

Constants (env slots, dense arrays, scalars, historic variables) carry no
tangent and cost no tangent work. A buffer is dropped after its last
consumer; the unknowns' buffers outlive the pass, so a result that is a
view of one is returned as a copy. With no colors the pass computes the
value alone. On CPU tensors the kernels' plain versions run instead, by the
wrappers' own rule.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad.operators import (
    DenseArray,
    MixedDimensionalVariable,
    Operations,
    Operator,
    Scalar,
    SparseArray,
    TimeDependentDenseArray,
    Variable,
)

__all__ = [
    "Dual",
    "DualExecutor",
    "Elementwise",
    "ExprOps",
    "elementwise",
    "compile_expr",
    "run_program",
    "mul",
    "neg",
    "concat",
    "jvp_node",
]


class Dual:
    """A value with the tangent rows of the color seeds: ``val`` of shape
    ``(n,)`` or ``()``, ``tan`` of shape ``(B, n)`` (``(B, 1)`` beside a
    ``()`` value), or ``None`` for a constant."""

    __slots__ = ("val", "tan")

    def __init__(self, val: torch.Tensor, tan: Optional[torch.Tensor] = None) -> None:
        self.val = val
        self.tan = tan

    def pair(self) -> tuple:
        return self.val, self.tan

    def stacked(self) -> Optional[torch.Tensor]:
        """The ``(B + 1, n)`` buffer holding ``val`` as row 0 and ``tan`` as
        the rows below it, when both are views of one (the K8 kernels' output
        layout), else ``None``."""
        val, tan = self.val, self.tan
        if tan is None or val.dim() != 1:
            return None
        base = val._base
        if (
            base is None
            or tan._base is not base
            or base.dim() != 2
            or base.shape != (tan.shape[0] + 1, val.shape[0])
            or not base.is_contiguous()
            or val.data_ptr() != base.data_ptr()
            or tan.data_ptr() != base.data_ptr() + 8 * base.shape[1]
        ):
            return None
        return base


# -- elementwise programs ---------------------------------------------------------


class _Expr:
    """A node of an elementwise expression: an opcode of
    :data:`~porepy_tpu_torch.kernels.reference.DUAL_OPCODES` on other
    expressions, a constant (``loadi``) or an input (``in``, a DAG node)."""

    __slots__ = ("op", "args", "value")

    def __init__(self, op: str, args: tuple = (), value: Any = None) -> None:
        self.op = op
        self.args = args
        self.value = value


class ExprOps:
    """What an :func:`elementwise` emitter makes its expression with."""

    @staticmethod
    def op(name: str, *args: _Expr) -> _Expr:
        if name not in reference.DUAL_OP or name == "loadi":
            raise ValueError(f"unknown elementwise opcode {name!r}")
        return _Expr(name, tuple(args))

    @staticmethod
    def imm(value: float) -> _Expr:
        return _Expr("loadi", (), float(value))


class Elementwise:
    """The dual rule of an elementwise function: ``emit(E, *args)`` returns
    the function's expression over its arguments' expressions, built with
    the :class:`ExprOps` ``E``."""

    __slots__ = ("emit",)

    def __init__(self, emit: Callable) -> None:
        self.emit = emit


def elementwise(emit: Callable) -> Elementwise:
    return Elementwise(emit)


def _expr_stats(roots: Sequence[_Expr]) -> tuple[int, int]:
    """``(instructions, inputs)`` that the expressions need together."""
    seen: set[int] = set()
    instrs = inputs = 0
    stack = list(roots)
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if e.op == "in":
            inputs += 1
        else:
            instrs += 1
            stack.extend(e.args)
    return instrs, inputs


def _fits(expr: _Expr) -> bool:
    instrs, inputs = _expr_stats([expr])
    return instrs <= reference.DUAL_MAX_INSTRS and 1 <= inputs <= reference.DUAL_MAX_INPUTS


def compile_expr(expr: _Expr) -> tuple[ops.DualProgram, list]:
    """The :class:`~porepy_tpu_torch.kernels.DualProgram` of ``expr`` and
    the values of its inputs in register order."""
    regs: dict[int, int] = {}
    inputs: list = []
    instrs: list = []
    imm: list[float] = []
    n_max = reference.DUAL_MAX_INPUTS

    def visit(e: _Expr) -> int:
        if id(e) in regs:
            return regs[id(e)]
        if e.op == "in":
            reg = len(inputs)
            inputs.append(e.value)
        else:
            if e.op == "loadi":
                if e.value not in imm:
                    imm.append(e.value)
                abc = (imm.index(e.value), 0, 0)
            else:
                args = [visit(a) for a in e.args]
                abc = tuple(args + [0] * (3 - len(args)))
            reg = n_max + len(instrs)
            instrs.append((e.op,) + abc)
        regs[id(e)] = reg
        return reg

    visit(expr)
    return ops.DualProgram(instrs, imm, len(inputs)), inputs


def run_program(program: ops.DualProgram, duals: Sequence[Dual], batch: int) -> Dual:
    """``program`` on ``duals`` through the ``dual_ew`` kernel (the program's
    own launcher, made at its first run)."""
    return Dual(*ops.dual_ew(program, [d.pair() for d in duals], batch))


_E = ExprOps
_IN = [_Expr("in", (), k) for k in range(3)]
_MUL2 = compile_expr(_E.op("mul", _IN[0], _IN[1]))[0]
_MUL3 = compile_expr(_E.op("mul", _E.op("mul", _IN[0], _IN[1]), _IN[2]))[0]
_NEG = compile_expr(_E.op("neg", _IN[0]))[0]
# The root program of an equation whose root is not a fused program: x * 1
# keeps the value's and the tangent's bits.
_IDENTITY = compile_expr(_E.op("mul", _IN[0], _E.imm(1.0)))[0]


def mul(run: "_Run", *duals: Dual) -> Dual:
    """The product of two or three duals (one ``dual_ew`` launch)."""
    return run_program(_MUL2 if len(duals) == 2 else _MUL3, duals, run.batch)


def neg(run: "_Run", a: Dual) -> Dual:
    return run_program(_NEG, [a], run.batch)


def concat(run: "_Run", duals: Sequence[Dual], gather: ops.DualGatherCopy) -> Dual:
    """The concatenation of ``duals`` through the caller's launcher
    ``gather`` (one :class:`~porepy_tpu_torch.kernels.DualGatherCopy` per
    step or rule, made once)."""
    if not duals:
        return Dual(torch.zeros(0, dtype=run.x.dtype, device=run.x.device))
    if len(duals) == 1 and duals[0].val.dim() == 1:
        return duals[0]
    pieces = [(torch.atleast_1d(d.val), d.tan) for d in duals]
    return Dual(*gather(pieces, run.batch))


def jvp_node(func: Callable, duals: Sequence[Dual]) -> Dual:
    """``func`` on duals by ``torch.func`` (``vmap`` over ``jvp`` of this one
    function): the route of a function that has no dual rule. Plain tensors
    go in and come out."""
    vals = [d.val for d in duals]
    live = [i for i, d in enumerate(duals) if d.tan is not None]
    if not live:
        return Dual(func(*vals))

    def partial(*args):
        full = list(vals)
        for i, a in zip(live, args):
            full[i] = a
        return func(*full)

    def one(*tangents):
        return torch.func.jvp(partial, tuple(vals[i] for i in live), tangents)

    seeds = [duals[i].tan.reshape((duals[i].tan.shape[0],) + tuple(vals[i].shape)) for i in live]
    val, tan = torch.func.vmap(one)(*seeds)
    val = val[0]
    return Dual(val, tan.reshape(tan.shape[0], -1) if val.dim() == 0 else tan)


# -- the executor -----------------------------------------------------------------

_ARITHMETIC = {
    Operations.add: "add",
    Operations.sub: "sub",
    Operations.mul: "mul",
    Operations.div: "div",
    Operations.pow: "pow",
    Operations.neg: "neg",
}


class _Run:
    """One pass: the state ``x``, the equation's env tensors, the int32
    colors of the unknowns and their number ``batch`` (0: values only)."""

    __slots__ = ("x", "env", "colors", "batch")

    def __init__(self, x, env, colors, batch) -> None:
        self.x = x
        self.env = env
        self.colors = colors
        self.batch = batch


def _is_merged(node) -> bool:
    return type(node).__name__ == "MergedOperator" and hasattr(node, "fetch")


class DualExecutor:
    """One equation's residual as a list of steps on duals; see the module
    docstring. ``executor(x, env, colors, n_colors)`` returns ``(val,
    compressed)`` with ``compressed[c] = J @ seeds[c]`` for the one-hot seeds
    of ``colors`` (``None`` where the residual does not depend on ``x``), as
    :func:`~porepy_tpu_torch.numerics.ad.compiler.colored_jvps` does;
    ``executor(x, env)`` returns ``(val, None)``. :meth:`scatter` writes the
    equation's nonzeros and right-hand side rows instead, from its root
    program."""

    def __init__(self, op: Operator, eq_sys, env_spec, const_mats: dict) -> None:
        self.eq_sys = eq_sys
        self.env_spec = env_spec
        self.const_mats = const_mats
        #: Names of the nodes whose function has no dual rule.
        self.ruleless: list[str] = []
        self._consts: dict[tuple, Any] = {}
        self._slot: dict[int, int] = {}
        self._steps: list = []
        self._inputs: dict[int, _Expr] = {}
        self._exprs: dict[int, _Expr] = {}
        self._keep: list = []  # nodes whose ids key the tables above
        self._gathers: list[ops.DualGatherVar] = []  # the unknowns' launchers
        self._programs: dict[int, tuple] = {}  # slot -> (launcher, input slots) of a fused step
        self._consumers = self._count_consumers(op)
        self._root = self._materialize(op)
        self._plan_frees()
        self._plan_root()

    # -- compile time ---------------------------------------------------------

    def _is_leaf(self, node) -> bool:
        return (
            isinstance(
                node,
                (Scalar, DenseArray, SparseArray, MixedDimensionalVariable, Variable,
                 TimeDependentDenseArray),
            )
            or _is_merged(node)
            or id(node) in self.const_mats
        )

    def _count_consumers(self, root) -> dict[int, int]:
        count: dict[int, int] = {}
        seen: set[int] = set()
        stack = [root]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if self._is_leaf(node):
                continue
            for child in node.children:
                count[id(child)] = count.get(id(child), 0) + 1
                stack.append(child)
        return count

    def _fusable(self, node) -> bool:
        if self._is_leaf(node):
            return False
        if node.operation in _ARITHMETIC:
            return True
        return node.operation is Operations.evaluate and isinstance(
            getattr(node.func, "dual_rule", None), Elementwise
        )

    def _input(self, node) -> _Expr:
        e = self._inputs.get(id(node))
        if e is None:
            e = self._inputs[id(node)] = _Expr("in", (), node)
            self._keep.append(node)
        return e

    def _expr(self, node) -> Optional[_Expr]:
        """The fused expression rooted at the fusable ``node``: a child joins
        it when it is fusable itself, has this node as its only consumer and
        the whole still fits one program; the largest children are turned
        into inputs until it does. ``None`` when the node alone does not
        fit."""
        if id(node) in self._exprs:
            return self._exprs[id(node)]
        inline: dict[int, _Expr] = {}
        for child in node.children:
            if self._fusable(child) and self._consumers.get(id(child), 0) == 1:
                sub = self._expr(child)
                if sub is not None:
                    inline[id(child)] = sub

        def build() -> _Expr:
            args = [inline.get(id(ch)) or self._input(ch) for ch in node.children]
            if node.operation in _ARITHMETIC:
                return _E.op(_ARITHMETIC[node.operation], *args)
            return node.func.dual_rule.emit(_E, *args)

        expr = build()
        while not _fits(expr) and inline:
            largest = max(inline, key=lambda k: _expr_stats([inline[k]])[0])
            del inline[largest]
            expr = build()
        result = expr if _fits(expr) else None
        self._exprs[id(node)] = result
        self._keep.append(node)
        return result

    def _new_slot(self, node, step, inputs: Sequence[int] = ()) -> int:
        slot = len(self._steps)
        self._steps.append((step, slot, tuple(inputs)))
        self._slot[id(node)] = slot
        self._keep.append(node)
        return slot

    def _const_tensor(self, key, device, make: Callable):
        hit = self._consts.get((key, device))
        if hit is None:
            hit = self._consts[(key, device)] = make(device)
        return hit

    def _materialize(self, node) -> int:
        from porepy_tpu_torch.numerics.ad import compiler

        if id(node) in self._slot:
            return self._slot[id(node)]
        env_spec = self.env_spec

        if isinstance(node, Scalar):
            slot_e = env_spec.slot(
                ("scalar", id(node)), lambda _es, _op=node: np.float64(_op.value)
            )
            return self._new_slot(node, lambda R, run, s=slot_e: Dual(run.env[s]))
        if isinstance(node, DenseArray):
            def dense(R, run, node=node):
                return Dual(self._const_tensor(
                    id(node), run.x.device, lambda dev: compiler._to_tensor(node.values, dev)
                ))

            return self._new_slot(node, dense)
        if isinstance(node, SparseArray) or _is_merged(node):
            if id(node) in self.const_mats:
                ref = self.const_mats[id(node)]
                return self._new_slot(node, lambda R, run: compiler._resolve_const(ref, run.env))

            def matrix(R, run, node=node):
                return self._const_tensor(
                    id(node), run.x.device,
                    lambda dev: compiler._device_const_matrix(
                        node.mat if isinstance(node, SparseArray) else node.fetch(), dev
                    ),
                )

            return self._new_slot(node, matrix)
        if isinstance(node, MixedDimensionalVariable):
            subs = node.sub_vars
            if subs and all(v.is_current_iterate for v in subs):
                return self._unknowns(node, subs)
            slots = [self._materialize(v) for v in subs]
            return self._new_slot(
                node, lambda R, run, g=ops.DualGatherCopy(): concat(run, [R[s] for s in slots], g),
                slots,
            )
        if isinstance(node, Variable):
            if node.is_current_iterate:
                return self._unknowns(node, [node])
            slot_e = env_spec.slot(compiler._var_key(node), compiler._fetch_variable(node))
            return self._new_slot(node, lambda R, run: Dual(run.env[slot_e]))
        if isinstance(node, TimeDependentDenseArray):
            slot_e = env_spec.slot(
                ("tda", node.name, node.domains, node.prev_time,
                 getattr(node, "iterate_index", 0)),
                compiler._fetch_tda(node),
            )
            return self._new_slot(node, lambda R, run: Dual(run.env[slot_e]))
        if id(node) in self.const_mats:
            ref = self.const_mats[id(node)]
            return self._new_slot(node, lambda R, run: compiler._resolve_const(ref, run.env))

        op = node.operation
        if self._fusable(node):
            expr = self._expr(node)
            if expr is not None:
                return self._fused(node, expr)
        if op in _ARITHMETIC:
            raise NotImplementedError(f"arithmetic node {node!r} does not fit a program")
        if op is Operations.matmul:
            left, right = (self._materialize(ch) for ch in node.children)
            return self._new_slot(
                node, lambda R, run: _matmul(run, R[left], R[right]), (left, right)
            )
        if op is Operations.concat:
            slots = [self._materialize(ch) for ch in node.children]
            return self._new_slot(
                node, lambda R, run, g=ops.DualGatherCopy(): concat(run, [R[s] for s in slots], g),
                slots,
            )
        if op is Operations.evaluate:
            if node.func is None:
                raise ValueError(f"evaluate node {node.name!r} without function")
            slots = [self._materialize(ch) for ch in node.children]
            rule = getattr(node.func, "dual_rule", None)
            if isinstance(rule, Elementwise):
                # _expr gave up on it above: the rule alone outgrows a program.
                raise NotImplementedError(
                    f"the elementwise dual rule of {node.name!r} does not fit one dual_ew "
                    f"program ({reference.DUAL_MAX_INPUTS} inputs, "
                    f"{reference.DUAL_MAX_INSTRS} instructions): build it from several "
                    "functions, or give it a callable rule(run, *duals)"
                )
            if rule is not None:
                return self._new_slot(
                    node, lambda R, run: rule(run, *(R[s] for s in slots)), slots
                )
            # A function built without a rule: this node alone goes through
            # torch.func, and says so once.
            self.ruleless.append(node.name)
            warnings.warn(
                f"ad function {node.name!r} has no dual rule: the assembly differentiates "
                "it by torch.func on its node alone (see Function's dual_rule)",
                stacklevel=2,
            )
            func = node.func
            return self._new_slot(
                node, lambda R, run: _ruleless(func, run, [R[s] for s in slots]), slots
            )
        raise NotImplementedError(f"Operation {op} not supported by the dual executor")

    def _unknowns(self, node, variables) -> int:
        idx = np.asarray(self.eq_sys.dofs_of(list(variables)), dtype=np.int64)

        def launcher(dev):
            gather = ops.DualGatherVar(torch.tensor(idx, dtype=torch.int64, device=dev))
            self._gathers.append(gather)
            return gather

        def step(R, run):
            gather = self._const_tensor(("dofs", id(node)), run.x.device, launcher)
            return Dual(*gather(run.x, run.colors, run.batch))

        return self._new_slot(node, step)

    def _fused(self, node, expr: _Expr) -> int:
        program, input_nodes = compile_expr(expr)
        slots = [self._materialize(n) for n in input_nodes]
        launch = program.launcher()

        def step(R, run):
            return Dual(*launch([R[s].pair() for s in slots], run.batch))

        slot = self._new_slot(node, step, slots)
        self._programs[slot] = (launch, slots)
        return slot

    def _plan_frees(self) -> None:
        """After which step each slot's buffer can go: its last consumer."""
        last: dict[int, int] = {}
        for i, (_step, _slot, inputs) in enumerate(self._steps):
            for s in inputs:
                last[s] = i
        frees: list[list[int]] = [[] for _ in self._steps]
        for s, i in last.items():
            if s != self._root:
                frees[i].append(s)
        self._frees = frees

    def _plan_root(self) -> None:
        """The program :meth:`scatter` launches as the root and the steps
        before it: the root step's own program when the root is a fused
        step (the last one), else :data:`_IDENTITY` on the root's result
        after every step."""
        last = len(self._steps) - 1
        if self._root == last and last in self._programs:
            self._root_program, self._root_steps = self._programs[last], last
        else:
            self._root_program, self._root_steps = (_IDENTITY.launcher(), (self._root,)), len(self._steps)

    # -- run time --------------------------------------------------------------

    def _run(self, run: _Run, n_steps: int) -> list:
        R: list = [None] * len(self._steps)
        for (step, slot, _inputs), frees in zip(self._steps[:n_steps], self._frees):
            R[slot] = step(R, run)
            for s in frees:
                R[s] = None
        return R

    def __call__(self, x, env, colors=None, n_colors: int = 0):
        run = _Run(x, env, colors, n_colors if colors is not None else 0)
        out = self._run(run, len(self._steps))[self._root]
        if any(g.holds(t) for g in self._gathers for t in (out.val, out.tan) if t is not None):
            # A view of an unknowns' buffer, which the next pass overwrites.
            return out.val.clone(), None if out.tan is None else out.tan.clone()
        return out.val, out.tan

    def scatter(self, x, env, colors, n_colors: int, target: ops.RootScatter, data, rhs) -> None:
        """The pass with the root program in the assembly's layout
        (:meth:`~porepy_tpu_torch.kernels.DualEwLauncher.scatter`): the
        negated residual into ``rhs``'s rows of ``target`` and, with
        ``colors``, the Jacobian's nonzeros of ``target`` into ``data`` (as
        ``compressed[gather_color, gather_row]`` of :meth:`__call__`, to the
        bit; zeros where the residual does not depend on ``x``)."""
        run = _Run(x, env, colors, n_colors if colors is not None else 0)
        R = self._run(run, self._root_steps)
        launch, slots = self._root_program
        launch.scatter([R[s].pair() for s in slots], run.batch, target, data, rhs)


def _ruleless(func, run: _Run, duals) -> Dual:
    if not run.batch:
        return Dual(func(*(d.val for d in duals)))
    return jvp_node(func, duals)


def _matmul(run: _Run, left, right: Dual) -> Dual:
    """``left @ right`` for a constant matrix ``left`` (ELL through the K1
    kernel; CSR and dense through ``torch``) and the dual ``right``."""
    from porepy_tpu_torch.numerics.ad.compiler import _CsrMat, _EllMat

    mat = left.val if isinstance(left, Dual) else left
    val, tan = right.val, right.tan
    n_cols = mat.shape[1]
    # Matrix @ scalar: the scalar is broadcast over the domain.
    if val.dim() == 0 or (tuple(val.shape) == (1,) and n_cols != 1):
        val = val.reshape(()).expand(n_cols).contiguous()
        if tan is not None:
            tan = tan.reshape(-1, 1).expand(-1, n_cols).contiguous()
    if isinstance(mat, _EllMat):
        op = mat.op
        if tan is None:
            return Dual(op(val.contiguous()))
        buf = Dual(val, tan).stacked()
        if buf is not None:
            out = op(buf)
            return Dual(out[0], out[1:])
        return Dual(op(val.contiguous()), op(tan.contiguous()))
    if isinstance(mat, _CsrMat):
        out = torch.mv(mat.mat, val)
        return Dual(out, None if tan is None else torch.matmul(mat.mat, tan.T).T)
    out = torch.matmul(mat, val)
    return Dual(out, None if tan is None else torch.matmul(tan, mat.T))
