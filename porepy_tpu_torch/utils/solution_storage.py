"""Solution-value storage in grid data dictionaries.

Parity counterpart of the reference's ``pp.set_solution_values`` /
``pp.get_solution_values`` helpers: values live in per-grid data dicts under
the ring-buffer keys ``pp.TIME_STEP_SOLUTIONS`` / ``pp.ITERATE_SOLUTIONS``,
indexed ``0`` (most recent) upward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.utils import common_constants as cc

__all__ = [
    "set_solution_values",
    "get_solution_values",
    "shift_solution_values",
    "state_version",
    "bump_state_version",
]

#: Monotone counter bumped on every stored-state mutation. Device-side caches
#: (the compiler's env arrays) key on this to avoid re-uploading unchanged
#: state every assembly.
_STATE_VERSION = [0]


def state_version() -> int:
    return _STATE_VERSION[0]


def bump_state_version() -> None:
    _STATE_VERSION[0] += 1


def shift_solution_values(
    name: str, data: dict, location: str, max_index: int = 1
) -> None:
    """Shift the ring buffer at ``data[location][name]`` backwards: values at
    index ``i`` are copied to ``i+1`` for ``i < max_index``."""
    ring = data.get(location, {}).get(name)
    if ring is None:
        return
    for i in range(max_index, 0, -1):
        if (i - 1) in ring:
            ring[i] = np.copy(ring[i - 1])
    bump_state_version()


def set_solution_values(
    name: str,
    values: np.ndarray,
    data: dict,
    time_step_index: Optional[int] = None,
    iterate_index: Optional[int] = None,
    additive: bool = False,
) -> None:
    if time_step_index is None and iterate_index is None:
        raise ValueError("Provide time_step_index and/or iterate_index")
    for key, index in (
        (cc.TIME_STEP_SOLUTIONS, time_step_index),
        (cc.ITERATE_SOLUTIONS, iterate_index),
    ):
        if index is None:
            continue
        ring = data.setdefault(key, {}).setdefault(name, {})
        if additive and index in ring:
            ring[index] = ring[index] + values
        else:
            ring[index] = np.array(values, dtype=float, copy=True)
    bump_state_version()


def get_solution_values(
    name: str,
    data: dict,
    time_step_index: Optional[int] = None,
    iterate_index: Optional[int] = None,
) -> np.ndarray:
    if (time_step_index is None) == (iterate_index is None):
        raise ValueError("Provide exactly one of time_step_index/iterate_index")
    if time_step_index is not None:
        return np.copy(data[cc.TIME_STEP_SOLUTIONS][name][time_step_index])
    return np.copy(data[cc.ITERATE_SOLUTIONS][name][iterate_index])
