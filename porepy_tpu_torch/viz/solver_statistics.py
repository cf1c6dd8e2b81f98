"""Per-timestep nonlinear solver statistics (reference
``viz/solver_statistics.py:15``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

__all__ = ["SolverStatistics"]


class SolverStatistics:
    """Iteration counts and increment/residual norm histories, dumpable to
    JSON."""

    def __init__(self, path: Optional[Path] = None) -> None:
        self.num_iteration: int = 0
        self.nonlinear_increment_norms: list[float] = []
        self.residual_norms: list[float] = []
        self.path = path
        self.history: dict[str, dict] = {}

    def log_error(
        self, nonlinear_increment_norm: float, residual_norm: float
    ) -> None:
        self.nonlinear_increment_norms.append(float(nonlinear_increment_norm))
        self.residual_norms.append(float(residual_norm))

    def log_timestep(self, time_index: int, time: float) -> None:
        self.history[str(time_index)] = {
            "time": time,
            "num_iteration": self.num_iteration,
            "nonlinear_increment_norms": list(self.nonlinear_increment_norms),
            "residual_norms": list(self.residual_norms),
        }

    def reset(self) -> None:
        self.num_iteration = 0
        self.nonlinear_increment_norms = []
        self.residual_norms = []

    def save(self) -> None:
        if self.path is not None:
            Path(self.path).write_text(json.dumps(self.history, indent=2))

    def __repr__(self) -> str:
        return (
            f"SolverStatistics(iterations={self.num_iteration}, "
            f"increments={self.nonlinear_increment_norms})"
        )
