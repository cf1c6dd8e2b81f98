"""Newton solver with model callbacks.

Parity counterpart of reference
``numerics/nonlinear/nonlinear_solvers.py:21``: the loop protocol
(before/after hooks, increment+residual convergence checks, divergence
guard) is identical; progress bars are omitted (logging instead).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

__all__ = ["NewtonSolver"]

logger = logging.getLogger(__name__)


class NewtonSolver:
    def __init__(self, params: Optional[dict] = None) -> None:
        if params is None:
            params = {}
        options = {
            "max_iterations": 10,
            "nl_convergence_tol": 1e-10,
            "nl_convergence_tol_res": np.inf,
            "nl_divergence_tol": np.inf,
        }
        options.update(params)
        self.params = options

    def solve(self, model) -> bool:
        model.before_nonlinear_loop()
        is_converged = False
        is_diverged = False

        # Device-resident fast path: the whole Newton loop in one dispatch.
        # ``None`` (ineligible model or non-converged attempt) falls through
        # to the host-orchestrated loop below on the untouched state.
        if type(self) is NewtonSolver:
            fused = getattr(model, "fused_newton_loop", None)
            if fused is not None and fused(self.params):
                model.after_nonlinear_convergence()
                return True

        reference_residual = model.equation_system.assemble(evaluate_jacobian=False)

        while (
            model.nonlinear_solver_statistics.num_iteration
            <= self.params["max_iterations"]
            and not is_converged
        ):
            model.before_nonlinear_iteration()
            nonlinear_increment = self.iteration(model)
            model.after_nonlinear_iteration(nonlinear_increment)

            if (
                self.params["nl_convergence_tol_res"] is not np.inf
                or self.params["nl_divergence_tol"] is not np.inf
            ):
                residual = model.equation_system.assemble(evaluate_jacobian=False)
            else:
                residual = None

            is_converged, is_diverged = model.check_convergence(
                nonlinear_increment, residual, reference_residual, self.params
            )
            if is_diverged:
                break
            if is_converged:
                model.after_nonlinear_convergence()
                break

        if not is_converged:
            model.after_nonlinear_failure()
        return is_converged

    def iteration(self, model) -> np.ndarray:
        model.assemble_linear_system()
        return model.solve_linear_system()
