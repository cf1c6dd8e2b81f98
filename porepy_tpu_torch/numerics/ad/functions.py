"""Elementwise AD function library.

Parity counterpart of reference ``numerics/ad/functions.py:60-487``. Each
function takes operators and returns an ``evaluate`` DAG node whose payload
is a torch function — derivatives come from ``torch.func`` forward mode,
so no hand-written chain rules. ``maximum`` (the basis of contact
complementarity equations) follows the reference's derivative convention:
where the arguments tie, the derivative follows the *first* argument.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

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
    func: Callable, args: tuple, name: str, pattern_fn: Optional[Callable] = None
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
    return op


def _unary(torch_fn: Callable, name: str):
    def wrapper(var: Union[Operator, np.ndarray, float]) -> Operator:
        return _fn_op(torch_fn, (var,), name)

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

    return _fn_op(f, (var,), "heaviside")


def heaviside_smooth(var, eps: float = 1e-3) -> Operator:
    """Smooth (arctan-based) regularized step function with true derivative
    (reference ``functions.py:289``: 0.5 + 1/pi * arctan(x/eps))."""

    def f(x):
        return 0.5 + torch.arctan(x / eps) / np.pi

    return _fn_op(f, (var,), "heaviside_smooth")


def maximum(var1, var2) -> Operator:
    """Elementwise max. Derivative convention at ties: follows the first
    argument (matches reference ``functions.py:360`` which checks
    ``val2 > val1`` to switch rows)."""

    def f(a, b):
        a_arr, b_arr = torch.broadcast_tensors(a, b)
        take_second = (b_arr > a_arr).detach()
        return torch.where(take_second, b_arr, a_arr)

    return _fn_op(f, (var1, var2), "maximum")


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

    return _fn_op(f, (var,), "safe_power")


def characteristic_function(tol: float, var) -> Operator:
    """1 where ``|x| <= tol`` else 0; zero derivative (reference
    ``functions.py:422``)."""

    def f(x):
        x = x.detach()
        return torch.where(
            torch.abs(x) <= tol, torch.full_like(x, 1.0), torch.full_like(x, 0.0)
        )

    return _fn_op(f, (var,), "characteristic_function")


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

    return _fn_op(f, (var,), "l2_norm", pattern_fn=pattern_fn)

