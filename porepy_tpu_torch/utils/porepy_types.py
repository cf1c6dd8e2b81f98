"""Shared type aliases of the public API (reference
``utils/porepy_types.py``). Runtime values are ``typing`` objects; they
exist so user code annotated against the reference's aliases type-checks
unchanged."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Sequence, Union

__all__ = [
    "number",
    "GridLike",
    "GridLikeSequence",
    "SubdomainsOrBoundaries",
    "DomainFunctionType",
    "ExtendedDomainFunctionType",
    "discretization_type",
    "fracture_network",
]

number = Union[float, int]

if TYPE_CHECKING:
    import porepy_tpu_torch as pp

    GridLike = Union["pp.Grid", "pp.MortarGrid", "pp.BoundaryGrid"]
    SubdomainsOrBoundaries = Union[
        Sequence["pp.Grid"], Sequence["pp.BoundaryGrid"]
    ]
    GridLikeSequence = Union[SubdomainsOrBoundaries, Sequence["pp.MortarGrid"]]
    DomainFunctionType = Callable[[SubdomainsOrBoundaries], "pp.ad.Operator"]
    ExtendedDomainFunctionType = Callable[
        [GridLikeSequence], "pp.ad.Operator"
    ]
    discretization_type = "pp.ad.Discretization"
    fracture_network = Union[
        "pp.fracs.fracture_network_2d.FractureNetwork2d",
        "pp.fracs.fracture_network_3d.FractureNetwork3d",
    ]
else:  # pragma: no cover - runtime placeholders only
    GridLike = object
    SubdomainsOrBoundaries = object
    GridLikeSequence = object
    DomainFunctionType = Callable
    ExtendedDomainFunctionType = Callable
    discretization_type = object
    fracture_network = object
