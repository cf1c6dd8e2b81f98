"""Dimension-dispatching factory for fracture networks (reference
``fracs/fracture_network.py:20``)."""

from __future__ import annotations

from typing import Optional

from porepy_tpu_torch.fracs.fracture import LineFracture, PlaneFracture
from porepy_tpu_torch.fracs.fracture_network_2d import FractureNetwork2d
from porepy_tpu_torch.fracs.fracture_network_3d import FractureNetwork3d

__all__ = ["create_fracture_network"]


def create_fracture_network(
    fractures: Optional[list] = None,
    domain=None,
    tol: float = 1e-8,
    run_checks: bool = False,
):
    """Create a 2d or 3d fracture network from the fracture types (or, with
    no fractures, from the domain dimension)."""
    if fractures is None or len(fractures) == 0:
        fractures = []
    types = {type(f) for f in fractures}
    if len(types) > 1:
        raise TypeError("All fractures must be of the same type")
    if run_checks and not types <= {LineFracture, PlaneFracture}:
        raise TypeError("Unknown fracture type")
    if types == {LineFracture}:
        dim = 2
    elif types == {PlaneFracture}:
        dim = 3
    elif domain is not None:
        dim = getattr(domain, "dim", None)
        if dim is None:
            dim = 3 if "zmax" in domain.bounding_box else 2
    else:
        raise ValueError(
            "Cannot infer dimension: provide fractures or a domain"
        )
    if dim == 2:
        return FractureNetwork2d(fractures, domain, tol)
    return FractureNetwork3d(fractures, domain, tol, run_checks)
