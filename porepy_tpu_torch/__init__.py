"""porepy_tpu_torch: the PyTorch/CUDA port of porepy_tpu for one NVIDIA H100.

Same model framework and the same flat ``pp.`` names as ``porepy_tpu``, for
the part ported so far: single-phase flow in fractured 2d domains (MPFA,
mortar coupling), assembled and solved on a ``torch.device`` with the
hand-written kernels of :mod:`porepy_tpu_torch.kernels`::

    import porepy_tpu_torch as pp

Grid construction, meshing and discretization run on the host
(numpy/scipy); everything per Newton iteration runs on
``params["device"]`` (default ``"cuda"``). Importing the package imports no
jax, sets no global torch default and builds no kernel.
"""

from __future__ import annotations

__version__ = "0.1.0"

from porepy_tpu_torch.compositional.materials import (  # noqa: F401
    FluidComponent,
    SolidConstants,
)
from porepy_tpu_torch.fracs.fracture import LineFracture  # noqa: F401
from porepy_tpu_torch.geometry.domain import Domain  # noqa: F401
from porepy_tpu_torch.models.fluid_mass_balance import SinglePhaseFlow  # noqa: F401
from porepy_tpu_torch.models.run_models import run_time_dependent_model  # noqa: F401
from porepy_tpu_torch.numerics import ad  # noqa: F401
from porepy_tpu_torch.numerics.time_step_control import TimeManager  # noqa: F401
from porepy_tpu_torch.params.bc import BoundaryCondition  # noqa: F401

__all__ = [
    "SinglePhaseFlow",
    "LineFracture",
    "SolidConstants",
    "FluidComponent",
    "TimeManager",
    "Domain",
    "BoundaryCondition",
    "run_time_dependent_model",
    "ad",
]
