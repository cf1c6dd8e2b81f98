"""Core definitions for the compositional subpackage (reference
``compositional/_core.py``). The reference's numba compile flags have no
role here: compute kernels are jitted jax."""

from __future__ import annotations

from enum import Enum

__all__ = ["PhysicalState", "COMPOSITIONAL_VARIABLE_SYMBOLS"]


class PhysicalState(Enum):
    """Physical state of a phase."""

    liquid = 0
    gas = 1


COMPOSITIONAL_VARIABLE_SYMBOLS = {
    "overall_fraction": "z",
    "tracer_fraction": "z_tracer",
    "phase_fraction": "y",
    "phase_saturation": "s",
    "phase_composition": "x",
    "temperature": "T",
    "pressure": "p",
}
