"""Elementwise AD function library.

Parity counterpart of reference ``numerics/ad/functions.py:60-487``. Each
function takes operators and returns an ``evaluate`` DAG node whose payload
is a torch function that carries the function's *dual rule* (its
``dual_rule`` attribute): the chain rule written by hand for the assembly's
forward-mode pass (:mod:`porepy_tpu_torch.numerics.ad.forward`). Every
function here but :func:`l2_norm` is elementwise, so its rule is an
expression over the opcodes of the ``dual_ew`` kernel and joins the fused
program of the nodes around it. The torch function stays the plain version
(``torch.func`` differentiates it in ``compiler.colored_jvps``). ``maximum``
(the basis of contact complementarity equations) follows the reference's
derivative convention: where the arguments tie, the derivative follows the
*first* argument.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from porepy_tpu_torch.numerics.ad import forward
from porepy_tpu_torch.numerics.ad.operators import Operations, Operator, _wrap

__all__ = [
    "exp",
    "log",
    "sign",
    "abs",
    "sin",
    "cos",
    "tan",
    "arcsin",
    "arccos",
    "arctan",
    "sinh",
    "cosh",
    "tanh",
    "arcsinh",
    "arccosh",
    "arctanh",
    "heaviside",
    "heaviside_smooth",
    "maximum",
    "characteristic_function",
    "l2_norm",
]


def _fn_op(
    func: Callable,
    args: tuple,
    name: str,
    pattern_fn: Optional[Callable] = None,
    dual=None,
) -> Operator:
    children = []
    for a in args:
        w = _wrap(a)
        if w is NotImplemented:
            raise TypeError(f"Cannot use {a!r} in ad function {name}")
        children.append(w)
    op = Operator(name=name, operation=Operations.evaluate, children=children)
    op.func = func
    if pattern_fn is not None:
        op.func_pattern = pattern_fn
    if dual is not None:
        func.dual_rule = dual
    return op


def _unary(torch_fn: Callable, name: str):
    def f(x):
        return torch_fn(x)

    f.dual_rule = forward.elementwise(lambda E, x: E.op(name, x))

    def wrapper(var: Union[Operator, np.ndarray, float]) -> Operator:
        return _fn_op(f, (var,), name)

    wrapper.__name__ = name
    return wrapper


exp = _unary(torch.exp, "exp")
log = _unary(torch.log, "log")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
arcsin = _unary(torch.arcsin, "arcsin")
arccos = _unary(torch.arccos, "arccos")
arctan = _unary(torch.arctan, "arctan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
arcsinh = _unary(torch.arcsinh, "arcsinh")
arccosh = _unary(torch.arccosh, "arccosh")
arctanh = _unary(torch.arctanh, "arctanh")
abs = _unary(torch.abs, "abs")  # noqa: A001 - mirrors reference export
sign = _unary(torch.sign, "sign")


def heaviside(var, zerovalue: float = 0.5) -> Operator:
    """Step function with configurable value at zero; zero derivative."""

    def f(x):
        x = x.detach()
        return torch.where(
            x > 0,
            torch.full_like(x, 1.0),
            torch.where(x < 0, torch.full_like(x, 0.0), torch.full_like(x, zerovalue)),
        )

    def dual(E, x):
        zero = E.imm(0.0)
        below = E.op("select", E.op("gt", zero, x), zero, E.imm(zerovalue))
        return E.op("select", E.op("gt", x, zero), E.imm(1.0), below)

    return _fn_op(f, (var,), "heaviside", dual=forward.elementwise(dual))


def heaviside_smooth(var, eps: float = 1e-3) -> Operator:
    """Smooth (arctan-based) regularized step function with true derivative
    (reference ``functions.py:289``: 0.5 + 1/pi * arctan(x/eps))."""

    def f(x):
        return 0.5 + torch.arctan(x / eps) / np.pi

    def dual(E, x):
        angle = E.op("arctan", E.op("div", x, E.imm(eps)))
        return E.op("add", E.imm(0.5), E.op("div", angle, E.imm(np.pi)))

    return _fn_op(f, (var,), "heaviside_smooth", dual=forward.elementwise(dual))


def maximum(var1, var2) -> Operator:
    """Elementwise max. Derivative convention at ties: follows the first
    argument (matches reference ``functions.py:360`` which checks
    ``val2 > val1`` to switch rows)."""

    def f(a, b):
        a_arr, b_arr = torch.broadcast_tensors(a, b)
        take_second = (b_arr > a_arr).detach()
        return torch.where(take_second, b_arr, a_arr)

    def dual(E, a, b):
        return E.op("select", E.op("gt", b, a), b, a)

    return _fn_op(f, (var1, var2), "maximum", dual=forward.elementwise(dual))


class _SafePower(torch.autograd.Function):
    """``x ** power`` where ``|x| > tol``, ``zero_val`` elsewhere, with the
    derivative weight ``power * out ** (power - 1)`` everywhere."""

    generate_vmap_rule = True

    @staticmethod
    def _val(x, power, zero_val, tol):
        nz = torch.abs(x) > tol
        xs = torch.where(nz, x, torch.ones_like(x))
        return torch.where(nz, xs**power, torch.full_like(x, zero_val))

    @staticmethod
    def forward(x, power, zero_val, tol):
        return _SafePower._val(x, power, zero_val, tol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.power = inputs[1]
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, dx, _dp, _dz, _dt):
        (out,) = ctx.saved_tensors
        return ctx.power * out ** (ctx.power - 1.0) * dx


def safe_power(power: float, zero_val: float, tol: float, var) -> Operator:
    """``x ** power`` for entries with ``|x| > tol``, ``zero_val``
    elsewhere — negative powers without division by zero (reference
    ``functions.py:145``). The derivative weight is
    ``power * out**(power-1)`` everywhere, matching the reference's
    Jacobian convention."""

    def f(x):
        return _SafePower.apply(x, power, zero_val, tol)

    def dual(E, x):
        # Value and weight from the detached argument; the tangent is
        # ``power * out**(power - 1) * dx`` everywhere (``custom``).
        xd = E.op("detach", x)
        nz = E.op("gt", E.op("abs", xd), E.imm(tol))
        xs = E.op("select", nz, xd, E.imm(1.0))
        out = E.op("select", nz, E.op("pow", xs, E.imm(power)), E.imm(zero_val))
        weight = E.op("mul", E.imm(power), E.op("pow", out, E.imm(power - 1.0)))
        return E.op("custom", out, weight, x)

    return _fn_op(f, (var,), "safe_power", dual=forward.elementwise(dual))


def characteristic_function(tol: float, var) -> Operator:
    """1 where ``|x| <= tol`` else 0; zero derivative (reference
    ``functions.py:422``)."""

    def f(x):
        x = x.detach()
        return torch.where(
            torch.abs(x) <= tol, torch.full_like(x, 1.0), torch.full_like(x, 0.0)
        )

    dual = forward.elementwise(lambda E, x: E.op("leabs", x, E.imm(tol)))
    return _fn_op(f, (var,), "characteristic_function", dual=dual)


class _SafeL2(torch.autograd.Function):
    """Cell-wise Euclidean norm of ``x.reshape(-1, nd)``. Zero vectors get
    unit Jacobian weight on every component instead of the undefined 0/0
    (reference ``functions.py:120``: semismooth Newton needs a valid
    subgradient at the sticking state)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, nd):
        return torch.linalg.vector_norm(x.reshape(-1, nd), dim=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.nd = inputs[1]
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def jvp(ctx, dx, _dnd):
        x, val = ctx.saved_tensors
        nd = ctx.nd
        xr = x.reshape(-1, nd)
        safe = val > 1e-12
        w = torch.where(
            safe[:, None],
            xr / torch.where(safe, val, torch.ones_like(val))[:, None],
            torch.ones_like(xr),
        )
        return (w * dx.reshape(-1, nd)).sum(dim=1)


def l2_norm(nd: int, var: Operator) -> Operator:
    """Cell-wise Euclidean norm of a vector quantity stored
    component-major per cell (F-order: ``[x0, y0, x1, y1, ...]``), matching
    reference ``functions.py:447``. Output has ``n/nd`` rows."""

    def f(x):
        return _SafeL2.apply(x, nd)

    def pattern_fn(child_patterns, ndof):
        import scipy.sparse as sps

        p = child_patterns[0].tocsr()
        n = p.shape[0] // nd
        # Row-compression: OR the nd component rows of each cell.
        rows = np.repeat(np.arange(n), nd)
        compress = sps.csr_matrix(
            (np.ones(n * nd, dtype=bool), (rows, np.arange(n * nd))),
            shape=(n, n * nd),
        )
        return (compress @ p).astype(bool).tocsr()

    program = _l2_norm_program(nd)

    def dual(run, x):
        # A constant argument, or a pass without seeds, takes the same
        # program: it then computes the value alone.
        parts = [
            forward.Dual(x.val[k::nd], None if x.tan is None else x.tan[:, k::nd])
            for k in range(nd)
        ]
        return forward.run_program(program, parts, run.batch)

    return _fn_op(f, (var,), "l2_norm", pattern_fn=pattern_fn, dual=dual)


def _l2_norm_program(nd: int):
    """The ``dual_ew`` program of :class:`_SafeL2` on the ``nd`` components
    (strided views of the argument): the norm, with the tangent ``sum_k w_k
    dx_k``, ``w_k = x_k / norm`` where ``norm > 1e-12`` else 1."""
    E = forward.ExprOps
    xs = [forward._Expr("in", (), k) for k in range(nd)]
    sq = None
    for x in xs:
        term = E.op("mul", x, x)
        sq = term if sq is None else E.op("add", sq, term)
    norm = E.op("detach", E.op("sqrt", sq))
    safe = E.op("gt", norm, E.imm(1e-12))
    denom = E.op("select", safe, norm, E.imm(1.0))
    out = None
    for k, x in enumerate(xs):
        w = E.op("select", safe, E.op("div", E.op("detach", x), denom), E.imm(1.0))
        term = E.op("custom", norm if k == 0 else E.imm(0.0), w, x)
        out = term if out is None else E.op("add", out, term)
    return forward.compile_expr(out)[0]

