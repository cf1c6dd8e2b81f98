"""User-defined operator functions (reference
``numerics/ad/operator_functions.py:43``).

:class:`Function` wraps a torch-traceable callable into a factory of
``evaluate`` DAG nodes; derivatives come from ``torch.func`` forward mode
rather than the reference's AdArray-aware callables.
"""

from __future__ import annotations

from typing import Callable, Optional

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


class InterpolatedFunction(Function):
    """Multilinear table lookup as an AD operator (reference
    ``operator_functions.py:248``): the function is pre-evaluated on a
    uniform Cartesian lattice; evaluation inside the compiled residual is a
    gather plus a weighted sum over the ``2^d`` cell corners,
    differentiable by forward-mode tracing (piecewise-constant multilinear
    gradients). Plain torch (K16 has no hand-written kernel yet); the table
    follows the argument's device on first use.
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
        import itertools

        import numpy as np
        import torch

        if order != 1:
            raise NotImplementedError(
                "Only linear interpolation order is supported"
            )
        from porepy_tpu_torch.utils.interpolation_tables import InterpolationTable

        min_val = np.atleast_1d(np.asarray(min_val, dtype=float))
        max_val = np.atleast_1d(np.asarray(max_val, dtype=float))
        npt = np.atleast_1d(np.asarray(npt, dtype=int))
        self.table = InterpolationTable(min_val, max_val, npt, func)

        param_dim = min_val.size
        host = {
            "values": torch.tensor(np.asarray(self.table._values[0]), dtype=torch.float64),
            "low": torch.tensor(min_val, dtype=torch.float64),
            "h": torch.tensor(np.asarray(self.table._h), dtype=torch.float64),
            "strides": torch.tensor(np.asarray(self.table._strides).ravel(), dtype=torch.int64),
            "npt": torch.tensor(npt, dtype=torch.int64),
        }
        corners = list(itertools.product(range(2), repeat=param_dim))
        on_device: dict = {}

        def lookup(*args):
            dev = args[0].device
            c = on_device.get(dev)
            if c is None:
                c = on_device[dev] = {k: v.to(dev) for k, v in host.items()}
            x = torch.stack([torch.atleast_1d(a) for a in args])
            rel = (x - c["low"][:, None]) / c["h"][:, None]
            base = torch.clamp(
                torch.floor(rel).detach().to(torch.int64),
                min=torch.zeros_like(c["npt"])[:, None],
                max=(c["npt"] - 2)[:, None],
            )
            frac = rel - base
            out = 0.0
            for incr in corners:
                incr_arr = torch.tensor(incr, dtype=torch.int64, device=dev)[:, None]
                weight = torch.prod(
                    frac * incr_arr + (1 - frac) * (1 - incr_arr), dim=0
                )
                flat = torch.sum((base + incr_arr) * c["strides"][:, None], dim=0)
                out = out + weight * c["values"][flat]
            return out

        super().__init__(lookup, name)
