"""Single-solve wrapper for linear problems (reference
``numerics/linear_solvers.py:16``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["LinearSolver"]


class LinearSolver:
    def __init__(self, params: Optional[dict] = None) -> None:
        if params is None:
            params = {}
        self.params = params

    def solve(self, model) -> bool:
        model.before_nonlinear_loop()
        model.before_nonlinear_iteration()
        model.assemble_linear_system()
        solution = model.solve_linear_system()
        model.after_nonlinear_iteration(solution)
        is_converged, is_diverged = model.check_convergence(
            solution,
            None,
            np.zeros_like(solution),
            {
                "nl_convergence_tol": np.inf,
                "nl_convergence_tol_res": np.inf,
                "nl_divergence_tol": np.inf,
            },
        )
        if is_converged:
            model.after_nonlinear_convergence()
        else:
            model.after_nonlinear_failure()
        return is_converged
