"""Iteration-based adaptive time stepping.

Parity counterpart of reference ``numerics/time_step_control.py:105``:
schedule-constrained adaptation — the time step relaxes/restricts by the
iteration count relative to an optimal range, is clamped to [dt_min,
dt_max], is cut back for solution recomputation on nonconvergence (bounded
attempts), and always lands exactly on scheduled times.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np

__all__ = ["TimeManager"]

Number = Union[int, float]


class TimeManager:
    def __init__(
        self,
        schedule,
        dt_init: Number,
        constant_dt: bool = False,
        dt_min_max: Optional[tuple[Number, Number]] = None,
        iter_max: int = 15,
        iter_optimal_range: tuple[int, int] = (4, 7),
        iter_relax_factors: tuple[float, float] = (0.7, 1.3),
        recomp_factor: float = 0.5,
        recomp_max: int = 10,
        print_info: bool = False,
        rtol: float = 1e-10,
        atol: float = 1e-16,
    ) -> None:
        schedule = np.array(schedule, dtype=float)
        if schedule.size < 2:
            raise ValueError("Schedule needs at least two elements")
        if np.any(schedule < 0):
            raise ValueError("Schedule times must be non-negative")
        if np.any(np.diff(schedule) <= 0):
            raise ValueError("Schedule must be strictly increasing")
        if dt_init <= 0:
            raise ValueError("Initial time step must be positive")
        if dt_init > schedule[-1]:
            raise ValueError("Initial time step exceeds final time")

        if constant_dt:
            # Scheduled times must be multiples of dt.
            k = (schedule - schedule[0]) / dt_init
            if not np.allclose(k, np.round(k), rtol=rtol, atol=atol):
                raise ValueError(
                    "Constant time step must be compatible with the schedule"
                )

        if dt_min_max is None:
            final = schedule[-1]
            if constant_dt:
                dt_min_max = (dt_init, dt_init)
            else:
                dt_min_max = (min(0.001 * final, dt_init), 0.1 * final)
        if not constant_dt and not (dt_min_max[0] <= dt_init <= dt_min_max[1]):
            raise ValueError("dt_init outside [dt_min, dt_max]")
        if iter_relax_factors[0] >= 1 or iter_relax_factors[1] <= 1:
            raise ValueError("Need under-relaxation < 1 < over-relaxation")
        if not 0 < recomp_factor < 1:
            raise ValueError("Recomputation factor must be in (0, 1)")

        self.schedule = schedule
        self.time_init: float = float(schedule[0])
        self.time_final: float = float(schedule[-1])
        self.time: float = float(schedule[0])
        self.time_index: int = 0
        self.dt: float = float(dt_init)
        self.dt_init: float = float(dt_init)
        self.dt_min_max = (float(dt_min_max[0]), float(dt_min_max[1]))
        self.is_constant = constant_dt
        self.iter_max = iter_max
        self.iter_optimal_range = iter_optimal_range
        self.iter_relax_factors = iter_relax_factors
        self.recomp_factor = recomp_factor
        self.recomp_max = recomp_max
        self.rtol = rtol
        self.atol = atol
        self._print_info = print_info
        self._recomp_num = 0
        self._scheduled_idx = 1
        self._is_about_to_hit_schedule = False

    # -- queries -------------------------------------------------------------

    def final_time_reached(self) -> bool:
        return self.time > self.time_final or np.isclose(
            self.time, self.time_final, rtol=self.rtol, atol=self.atol
        )

    # -- stepping ------------------------------------------------------------

    def increase_time(self) -> None:
        self.time += self.dt

    def increase_time_index(self) -> None:
        self.time_index += 1

    def compute_time_step(
        self, iterations: Optional[int] = None, recompute_solution: bool = False
    ) -> Optional[float]:
        if not recompute_solution and self.final_time_reached():
            return None
        if self.is_constant:
            if recompute_solution:
                warnings.warn("recompute_solution has no effect for constant dt")
            return self.dt_init

        if not recompute_solution:
            self._adapt_on_iterations(iterations)
        else:
            self._adapt_on_recomputation()

        # Clamp and land on schedule.
        self.dt = max(self.dt, self.dt_min_max[0])
        self.dt = min(self.dt, self.dt_min_max[1])
        self._correct_for_schedule()
        return self.dt

    def _adapt_on_iterations(self, iterations: Optional[int]) -> None:
        if iterations is None:
            raise ValueError("Cannot adapt time step without iteration count")
        if iterations > self.iter_max:
            warnings.warn("Iteration count exceeds iter_max; adapting anyway")
        self._recomp_num = 0
        if iterations <= self.iter_optimal_range[0]:
            self.dt *= self.iter_relax_factors[1]
        elif iterations >= self.iter_optimal_range[1]:
            self.dt *= self.iter_relax_factors[0]

    def _adapt_on_recomputation(self) -> None:
        if self._recomp_num >= self.recomp_max:
            raise ValueError(
                f"Solution did not converge after {self.recomp_max} "
                "recomputation attempts"
            )
        if self.dt == self.dt_min_max[0]:
            raise ValueError(
                "Time step already at its minimum; recomputation is pointless"
            )
        self.time -= self.dt
        self.time_index -= 1
        self.dt *= self.recomp_factor
        self._recomp_num += 1
        if self._is_about_to_hit_schedule:
            self._scheduled_idx -= 1

    def _correct_for_schedule(self) -> None:
        self._is_about_to_hit_schedule = False
        if self._scheduled_idx >= self.schedule.size:
            return
        target = self.schedule[self._scheduled_idx]
        if self.time + self.dt > target or np.isclose(
            self.time + self.dt, target, rtol=self.rtol, atol=self.atol
        ):
            self.dt = target - self.time
            self._is_about_to_hit_schedule = True
            self._scheduled_idx += 1

    def __repr__(self) -> str:
        return (
            f"TimeManager(t={self.time}, dt={self.dt}, "
            f"final={self.time_final}, constant={self.is_constant})"
        )
