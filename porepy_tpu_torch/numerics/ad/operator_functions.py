"""User-defined operator functions (reference
``numerics/ad/operator_functions.py:43``).

:class:`Function` wraps a torch-traceable callable into a factory of
``evaluate`` DAG nodes; derivatives come from ``torch.func`` forward mode
rather than the reference's AdArray-aware callables.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from porepy_tpu_torch import kernels
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
    """

    def __init__(
        self, func: Callable, name: str = "Function", pattern_fn: Optional[Callable] = None
    ) -> None:
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
    as fixed scalings of each argument's contribution."""

    def __init__(self, func: Callable, name: str, multipliers) -> None:
        multipliers = list(multipliers) if isinstance(multipliers, (list, tuple)) else [multipliers]

        def scaled(*args):
            scaled_args = [m * a for m, a in zip(multipliers, args)]
            return func(*scaled_args)

        super().__init__(scaled, name)
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
    kernel (``kernels/csrc/interp_lookup.cu``, ``d <= 3`` on the card) through
    an autograd Function, the plain version on the CPU; the table follows
    the argument's device on first use.
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

        super().__init__(lookup, name)

    def device_table(self, device) -> dict:
        """The K16 inputs on ``device``: flat ``values``, ``fgeom = [low, h]``
        (float64) and ``igeom = [npt, strides]`` (int32), copied once."""
        dev = torch.device(device)
        c = self._on_device.get(dev)
        if c is None:
            c = self._on_device[dev] = {k: v.to(dev) for k, v in self._host.items()}
        return c
