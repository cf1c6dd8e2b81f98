"""User-defined operator functions (reference
``numerics/ad/operator_functions.py:43``).

:class:`Function` wraps a torch-traceable callable into a factory of
``evaluate`` DAG nodes. The assembly differentiates a node by its function's
*dual rule* (``dual_rule``: the chain rule written by hand for the
forward-mode pass of :mod:`porepy_tpu_torch.numerics.ad.forward`); a
function given without one is differentiated by ``torch.func`` on its node
alone, rather than by the reference's AdArray-aware callables.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.numerics.ad import forward
from porepy_tpu_torch.numerics.ad.operators import Operations, Operator, _wrap

__all__ = ["Function", "DiagonalJacobianFunction", "InterpolatedFunction"]


class Function:
    """Elementwise (or pattern-annotated) function applicable to operators.

    Parameters:
        func: callable on torch tensors, differentiable by ``torch.func``.
        name: Display name.
        pattern_fn: Optional structural-sparsity rule
            ``(child_patterns, ndof) -> pattern`` for non-elementwise
            functions; defaults to the union of argument patterns.
        dual_rule: Optional forward-mode rule: a callable ``rule(run, *duals)
            -> Dual`` on :class:`~porepy_tpu_torch.numerics.ad.forward.Dual`
            arguments, or an :func:`~porepy_tpu_torch.numerics.ad.forward.elementwise`
            emitter for an elementwise function. Without one the assembly
            differentiates ``func`` by ``torch.func`` on this node.
    """

    def __init__(
        self,
        func: Callable,
        name: str = "Function",
        pattern_fn: Optional[Callable] = None,
        dual_rule=None,
    ) -> None:
        if dual_rule is not None:
            # The rule travels with the callable (as its ``dual_rule``
            # attribute), so that re-tagged copies of a node keep it.
            inner = func

            def func(*args):
                return inner(*args)

            func.dual_rule = dual_rule
        self.func = func
        self.name = name
        self.pattern_fn = pattern_fn

    def __call__(self, *args) -> Operator:
        children = []
        for a in args:
            w = _wrap(a)
            if w is NotImplemented:
                raise TypeError(f"Cannot apply {self.name} to {a!r}")
            children.append(w)
        op = Operator(
            name=self.name, operation=Operations.evaluate, children=children
        )
        op.func = self.func
        if self.pattern_fn is not None:
            op.func_pattern = self.pattern_fn
        return op

    def __repr__(self) -> str:
        return f"Function({self.name})"


class DiagonalJacobianFunction(Function):
    """Function with a user-declared diagonal Jacobian scaling per argument
    (reference ``operator_functions.py:284``). With forward-mode tracing the
    true derivative is computed automatically; the multipliers are applied
    as fixed scalings of each argument's contribution. ``dual_rule`` is the
    forward-mode rule of ``func`` itself; the (scalar) scalings are applied
    to the duals before it, as ``mul`` by a constant in a ``dual_ew``
    program: inside the function's own program for an elementwise rule, one
    launch per argument before a callable ``rule(run, *duals)``."""

    def __init__(self, func: Callable, name: str, multipliers, dual_rule=None) -> None:
        multipliers = list(multipliers) if isinstance(multipliers, (list, tuple)) else [multipliers]

        def scaled(*args):
            scaled_args = [m * a for m, a in zip(multipliers, args)]
            return func(*scaled_args)

        if isinstance(dual_rule, forward.Elementwise):
            scaled_rule = forward.elementwise(
                lambda E, *args: dual_rule.emit(
                    E, *(E.op("mul", E.imm(m), a) for m, a in zip(multipliers, args))
                )
            )
        elif dual_rule is not None:
            x = forward._Expr("in", (), 0)
            scalings = [
                forward.compile_expr(forward.ExprOps.op("mul", forward.ExprOps.imm(m), x))[0]
                for m in multipliers
            ]

            def scaled_rule(run, *duals):
                scaled_duals = [
                    forward.run_program(program, [d], run.batch)
                    for program, d in zip(scalings, duals)
                ]
                return dual_rule(run, *scaled_duals)

        super().__init__(scaled, name, dual_rule=None if dual_rule is None else scaled_rule)
        self.multipliers = multipliers


class _InterpLookup(torch.autograd.Function):
    """The multilinear lookup through the K16 kernel. Its tangent is the
    K16 tangent at the same points (the cell index carries none), and the
    batch of tangents of the assembly's colored JVP seeds (``vmap`` over
    ``jvp``) runs as one batched launch: the pattern of ``_EllMatvec``."""

    generate_vmap_rule = False

    @staticmethod
    def forward(values, fgeom, igeom, x):
        return kernels.interp_lookup(values, fgeom, igeom, x.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, _dvalues, _dfgeom, _digeom, dx):
        values, fgeom, igeom, x = ctx.saved_tensors
        return _InterpTangent.apply(values, fgeom, igeom, x, dx)

    @staticmethod
    def vmap(info, in_dims, values, fgeom, igeom, x):
        if any(d is not None for d in in_dims[:3]):
            raise NotImplementedError("batched interpolation tables are not supported")
        # The lookup is pointwise: a batch of points is more points.
        xb = x.movedim(in_dims[3], 1)
        d, batch, n = xb.shape
        out = _InterpLookup.apply(values, fgeom, igeom, xb.reshape(d, batch * n))
        return out.reshape(batch, n), 0


class _InterpTangent(torch.autograd.Function):
    """``d lookup(x)[dx]`` for one seed ``dx`` ``(d, N)``; under ``vmap`` the
    seeds go to the kernel as one ``(B, d, N)`` batch."""

    generate_vmap_rule = False

    @staticmethod
    def forward(values, fgeom, igeom, x, dx):
        return kernels.interp_tangent(values, fgeom, igeom, x.contiguous(), dx.contiguous()[None])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, values, fgeom, igeom, x, dx):
        if any(d is not None for d in in_dims[:3]):
            raise NotImplementedError("batched interpolation tables are not supported")
        x_dim, dx_dim = in_dims[3], in_dims[4]
        if x_dim is None:
            if dx_dim is None:
                return _InterpTangent.apply(values, fgeom, igeom, x, dx), None
            seeds = dx.movedim(dx_dim, 0).contiguous()
            return kernels.interp_tangent(values, fgeom, igeom, x.contiguous(), seeds), 0
        # A batch of points: fold it into the points, as the lookup does.
        xb = x.movedim(x_dim, 1)
        d, batch, n = xb.shape
        dxb = dx.movedim(dx_dim, 1) if dx_dim is not None else dx[:, None].expand(d, batch, n)
        out = _InterpTangent.apply(
            values, fgeom, igeom, xb.reshape(d, batch * n), dxb.reshape(d, batch * n)
        )
        return out.reshape(batch, n), 0


class InterpolatedFunction(Function):
    """Multilinear table lookup as an AD operator (reference
    ``operator_functions.py:248``): the function is pre-evaluated on a
    uniform Cartesian lattice; evaluation inside the compiled residual is a
    gather plus a weighted sum over the ``2^d`` cell corners (linear
    extrapolation outside the table), with piecewise-constant multilinear
    gradients. The lookup and its forward-mode tangents run in the K16
    kernel (``kernels/csrc/interp_lookup.cu``, ``d <= 3`` on the card), the
    plain version on the CPU: the function's dual rule in the assembly is one
    launch of the table's launcher for the value and every tangent; where
    ``torch.func`` differentiates the traced residual, an autograd Function
    launches the value or the tangent rows alone. The table follows the
    argument's device on first use.
    """

    def __init__(
        self,
        func: Callable,
        name: str,
        min_val,
        max_val,
        npt,
        order: int = 1,
        preval: bool = True,
    ) -> None:
        import numpy as np

        if order != 1:
            raise NotImplementedError(
                "Only linear interpolation order is supported"
            )
        from porepy_tpu_torch.utils.interpolation_tables import InterpolationTable

        min_val = np.atleast_1d(np.asarray(min_val, dtype=float))
        max_val = np.atleast_1d(np.asarray(max_val, dtype=float))
        npt = np.atleast_1d(np.asarray(npt, dtype=int))
        self.table = InterpolationTable(min_val, max_val, npt, func)

        self._host = {
            "values": torch.tensor(np.asarray(self.table._values[0]), dtype=torch.float64),
            "fgeom": torch.tensor(
                np.concatenate([min_val, np.asarray(self.table._h, dtype=float)]),
                dtype=torch.float64,
            ),
            "igeom": torch.tensor(
                np.concatenate([npt, np.asarray(self.table._strides).ravel()]),
                dtype=torch.int32,
            ),
        }
        self._on_device: dict = {}

        def lookup(*args):
            c = self.device_table(args[0].device)
            x = torch.stack([torch.atleast_1d(a) for a in args])
            return _InterpLookup.apply(c["values"], c["fgeom"], c["igeom"], x)

        def dual_rule(run, *duals):
            # One launch: the value in row 0, the tangents below it; a
            # constant argument's tangent is None, no rows are stacked.
            launcher = self.device_table(duals[0].val.device)["launcher"]
            xs = [torch.atleast_1d(d.val).contiguous() for d in duals]
            if all(d.tan is None for d in duals):
                return forward.Dual(launcher(xs)[0])
            # The kernel reads (B, N) tangents by unit-stride rows; a CSR
            # projection's tangent comes transposed and is copied.
            tans = [d.tan if d.tan is None or d.tan.stride(1) == 1 else d.tan.contiguous() for d in duals]
            buf = launcher(xs, tans)
            return forward.Dual(buf[0], buf[1:])

        super().__init__(lookup, name, dual_rule=dual_rule)

    def device_table(self, device) -> dict:
        """The K16 inputs on ``device``: flat ``values``, ``fgeom = [low, h]``
        (float64) and ``igeom = [npt, strides]`` (int32), copied once, and
        their :class:`~porepy_tpu_torch.kernels.InterpLauncher` (which builds
        the corner-block table, ``2^d`` times the flat one, at its first
        call)."""
        dev = torch.device(device)
        c = self._on_device.get(dev)
        if c is None:
            # Made outside any torch.func transform: a copy made inside one
            # is a wrapper without storage, which no launcher can point at.
            with torch._C._DisableFuncTorch():
                c = {k: v.to(dev) for k, v in self._host.items()}
                c["launcher"] = kernels.interp_launcher(c["values"], c["fgeom"], c["igeom"])
            self._on_device[dev] = c
        return c
