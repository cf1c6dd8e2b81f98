"""Time-derivative helpers (reference ``numerics/ad/time_derivatives.py``).

Backward-Euler increments built from ``previous_timestep()`` re-tagging.
"""

from __future__ import annotations

from typing import Union

from porepy_tpu_torch.numerics.ad.operators import Operator, Scalar

__all__ = ["dt", "time_increment"]


def time_increment(op: Operator) -> Operator:
    out = op - op.previous_timestep()
    out.set_name(f"time_increment({op.name})")
    return out


def dt(op: Operator, time_step: Union[Operator, float]) -> Operator:
    if not isinstance(time_step, Operator):
        time_step = Scalar(float(time_step), name="dt")
    out = (op - op.previous_timestep()) / time_step
    out.set_name(f"dt({op.name})")
    return out
