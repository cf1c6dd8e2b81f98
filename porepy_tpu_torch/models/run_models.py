"""Simulation run loops (reference ``models/run_models.py:21,49``)."""

from __future__ import annotations

import logging
from typing import Optional

from porepy_tpu_torch.numerics.linear_solvers import LinearSolver
from porepy_tpu_torch.numerics.nonlinear.nonlinear_solvers import NewtonSolver

__all__ = ["run_stationary_model", "run_time_dependent_model"]

logger = logging.getLogger(__name__)


def _choose_solver(model, params: dict):
    if "nonlinear_solver" in params:
        return params["nonlinear_solver"](params)
    if model._is_nonlinear_problem():
        return NewtonSolver(params)
    return LinearSolver(params)


def run_stationary_model(model, params: Optional[dict] = None) -> None:
    params = params or model.params
    model.prepare_simulation()
    solver = _choose_solver(model, params)
    solver.solve(model)
    model.after_simulation()


def run_time_dependent_model(model, params: Optional[dict] = None) -> None:
    params = params or model.params
    if not getattr(model, "_prepared", False):
        model.prepare_simulation()
        model._prepared = True
    solver = _choose_solver(model, params)

    tm = model.time_manager
    # Fused multi-step time block (opt-in, ``fused_time_steps = N``): after
    # two observed per-step solves, chunks of constant-dt steps run as ONE
    # device dispatch (see SolutionStrategy.fused_time_block). A return of 0
    # (ineligible, rolled back, or failed) falls through to the per-step
    # path for the next step.
    fused_chunk = int(params.get("fused_time_steps", 0) or 0)
    steps_done = 0
    while not tm.final_time_reached():
        if (
            fused_chunk > 1
            and steps_done >= 2
            and tm.is_constant
            and type(solver) is NewtonSolver
            and hasattr(model, "fused_time_block")
        ):
            n_left = max(int(round((tm.time_final - tm.time) / tm.dt)), 0)
            if n_left >= 2:
                n_done = model.fused_time_block(
                    min(n_left, fused_chunk), solver.params
                )
                if n_done > 0:
                    steps_done += n_done
                    logger.info(
                        f"Fused time block committed {n_done} steps up to "
                        f"t={tm.time:.6e}"
                    )
                    continue
        tm.increase_time()
        tm.increase_time_index()
        logger.info(f"Time step {tm.time_index} at time {tm.time:.6e}, dt {tm.dt:.6e}")
        solver.solve(model)
        model.nonlinear_solver_statistics.log_timestep(tm.time_index, tm.time)
        steps_done += 1
    model.after_simulation()
