"""Step-length control for Newton's method, including the constraint-aware
search used for fracture contact problems.

Implements the algorithm family of arXiv:2407.01184 (the reference exposes
it in ``numerics/nonlinear/line_search.py``) over this framework's compiled
operator API, with a different numerical strategy: instead of recursive
interval sampling with per-cell spline minimization, constraint crossings
are located by *vectorized bisection* on the whole indicator field at once
(every trial weight is one compiled-kernel evaluation over all cells, so
batching the cells is the natural primitive here), followed by a monotone
interpolation polish of the bracketed root.

Three composable classes:

- :class:`LineSearchNewtonSolver` — Armijo backtracking on the residual
  norm along the Newton direction (``params["global_line_search"]``).
- :class:`SplineInterpolationLineSearch` — root localization strategy:
  bisection bracketing plus a PCHIP polish on the collected samples.
- :class:`ConstraintLineSearch` — caps the step so contact-state indicator
  fields (``opening_indicator``/``sliding_indicator``) do not jump across
  their complementarity boundaries in one update
  (``params["local_line_search"]``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.interpolate

from porepy_tpu_torch.numerics.nonlinear.nonlinear_solvers import NewtonSolver

__all__ = [
    "LineSearchNewtonSolver",
    "SplineInterpolationLineSearch",
    "ConstraintLineSearch",
]


class LineSearchNewtonSolver(NewtonSolver):
    """Newton iteration scaled by a residual line search."""

    @property
    def min_line_search_weight(self) -> float:
        """Smallest admissible step scaling."""
        return self.params.get("min_line_search_weight", 1e-10)

    def iteration(self, model) -> np.ndarray:
        dx = super().iteration(model)
        weight = self.nonlinear_line_search(model, dx)
        update = weight * dx
        model._current_update = update
        return update

    def nonlinear_line_search(self, model, dx: np.ndarray) -> np.ndarray:
        """Hook combining the enabled searches; subclasses extend."""
        return self.residual_line_search(model, dx)

    # -- residual (global) search --------------------------------------------

    def residual_line_search(self, model, dx: np.ndarray) -> np.ndarray:
        """Armijo-style backtracking on ||r(x + a dx)||.

        Accepts the first weight on a geometric ladder satisfying a
        sufficient-decrease test; falls back to the best sampled weight.
        """
        if not self.params.get("global_line_search", False):
            return np.ones_like(dx)

        r0 = self._residual_norm(model, dx, 0.0)
        # Converged already (e.g. linear problem solved exactly): full step.
        res_tol = self.params.get("nl_convergence_tol_res", 1e-10)
        r_full = self._residual_norm(model, dx, 1.0)
        if r_full <= res_tol * max(1.0, r0):
            return np.ones_like(dx)

        c_dec = self.params.get("line_search_sufficient_decrease", 1e-4)
        n_back = int(self.params.get("residual_line_search_num_steps", 5))
        best_a, best_r = 1.0, r_full
        a = 1.0
        for _ in range(n_back):
            if best_r <= (1.0 - c_dec * best_a) * r0:
                break
            a *= 0.5
            r_a = self._residual_norm(model, dx, a)
            if r_a < best_r:
                best_a, best_r = a, r_a
        alpha = max(best_a, self.min_line_search_weight)
        return alpha * np.ones_like(dx)

    def _residual_norm(self, model, dx: np.ndarray, weight: float) -> float:
        eq = model.equation_system
        x0 = eq.get_variable_values(iterate_index=0)
        eq.set_variable_values(x0 + weight * dx, iterate_index=0)
        try:
            residual = eq.assemble(evaluate_jacobian=False)
        finally:
            eq.set_variable_values(x0, iterate_index=0)
        return float(np.linalg.norm(residual))


class SplineInterpolationLineSearch:
    """Root localization for vector-valued constraint fields.

    :meth:`compute_constraint_weights` returns the largest step weight for
    which no component of the constraint field has crossed zero (relative
    to its starting sign), located by bisection on the "any component
    crossed" predicate and polished with a monotone (PCHIP) interpolant of
    the first-crossing component.
    """

    def compute_constraint_weights(
        self,
        model,
        solution_update: np.ndarray,
        constraint_function,
        crossing_inds: np.ndarray,
        f_0: np.ndarray,
        interval_target_size: float,
        max_weight: float = 1.0,
    ) -> float:
        if not np.any(crossing_inds):
            return float(max_weight)

        eq = model.equation_system
        x0 = eq.get_variable_values(iterate_index=0)
        f0 = np.atleast_1d(np.asarray(f_0)[crossing_inds])
        sign0 = np.sign(f0)

        def f(alpha: float) -> np.ndarray:
            vals = np.asarray(
                eq.evaluate(
                    constraint_function, state=x0 + alpha * solution_update
                )
            )
            return np.atleast_1d(vals)[crossing_inds]

        def any_crossed(vals: np.ndarray) -> bool:
            return bool(np.any(sign0 * vals < 0))

        # Bisection on [0, max_weight]: invariant lo = no crossing yet.
        lo, hi = 0.0, float(max_weight)
        samples: list[tuple[float, np.ndarray]] = [(0.0, f0)]
        f_hi = f(hi)
        samples.append((hi, f_hi))
        if not any_crossed(f_hi):
            return hi
        while hi - lo > interval_target_size:
            mid = 0.5 * (lo + hi)
            f_mid = f(mid)
            samples.append((mid, f_mid))
            if any_crossed(f_mid):
                hi = mid
            else:
                lo = mid
        # Polish: monotone interpolation of the earliest-crossing component
        # through the collected samples; its root refines the bracket.
        samples.sort(key=lambda t: t[0])
        alphas = np.array([a for a, _ in samples])
        values = np.vstack([v for _, v in samples])
        crossed_at_hi = sign0 * values[alphas.searchsorted(hi)] < 0
        root = hi
        for comp in np.flatnonzero(crossed_at_hi):
            try:
                interp = scipy.interpolate.PchipInterpolator(
                    alphas, values[:, comp]
                )
                roots = interp.roots()
                roots = roots[(roots >= lo) & (roots <= hi)]
                if roots.size:
                    root = min(root, float(roots.min()))
            except ValueError:
                pass
        return max(min(root, hi), lo)


class ConstraintLineSearch:
    """Scales the Newton update so contact-state transitions stay tame.

    Requires the model to provide ``opening_indicator`` / ``sliding_indicator``
    operators (the :class:`~porepy_tpu.models.solution_strategy.
    ContactIndicators` mixin) and a sibling mixin supplying
    :meth:`compute_constraint_weights`.
    """

    def nonlinear_line_search(self, model, dx: np.ndarray) -> np.ndarray:
        weights = self.residual_line_search(model, dx)
        if self.params.get("local_line_search", False):
            return self.constraint_line_search(model, dx, float(weights.min()))
        return weights

    def constraint_line_search(
        self, model, dx: np.ndarray, max_weight: float
    ) -> np.ndarray:
        """Minimum admissible weight over all fracture subdomains and both
        indicator families; the tangential search is capped by the normal
        one (a cell cannot slide while opening)."""
        global_weight = max_weight
        for sd in model.mdg.subdomains(dim=model.nd - 1):
            w_normal = self.constraint_weights(
                model, dx, model.opening_indicator([sd]), max_weight
            )
            w_tangential = self.constraint_weights(
                model,
                dx,
                model.sliding_indicator([sd]),
                float(np.minimum(max_weight, w_normal).min()),
            )
            cell_weights = np.minimum(w_normal, w_tangential)
            model.mdg.subdomain_data(sd)["constraint_weights"] = cell_weights
            global_weight = min(global_weight, float(cell_weights.min()))
        return global_weight * np.ones_like(dx)

    def constraint_weights(
        self,
        model,
        solution_update: np.ndarray,
        constraint_function,
        max_weight: float,
    ) -> np.ndarray:
        """Per-cell admissible weights for one indicator field.

        A cell constrains the step if its indicator changes sign across the
        update AND overshoots beyond ``constraint_violation_tolerance``.
        Small overshoots and transitions of a small fraction of cells
        (``relative_constraint_transition_tolerance``) are allowed —
        without this slack the search can stall active-set convergence
        (arXiv:2407.01184, Sec. 4).  The tolerance tightens geometrically
        while the step keeps producing large transitions.
        """
        from porepy_tpu_torch.numerics.ad.operators import wrap_as_dense_ad_array

        eq = model.equation_system
        x0 = eq.get_variable_values(iterate_index=0)
        violation_tol = self.params.get("constraint_violation_tolerance", 3e-1)
        relative_cell_tol = self.params.get(
            "relative_constraint_transition_tolerance", 2e-1
        )
        min_w = self.min_line_search_weight

        f_0 = np.atleast_1d(
            np.asarray(eq.evaluate(constraint_function, state=x0))
        )
        weights = np.full(f_0.shape, max_weight)
        weight = max_weight
        roundoff = 1e-8

        for _sweep in range(10):
            f_w = np.atleast_1d(
                np.asarray(
                    eq.evaluate(
                        constraint_function,
                        state=x0 + weight * solution_update,
                    )
                )
            )
            # Offending cells: sign change with overshoot beyond tolerance.
            offending = (np.abs(f_w) > violation_tol) & (f_0 * f_w < -roundoff)
            if not np.any(offending):
                break
            if _sweep > 0 and np.sum(offending) < max(
                1, relative_cell_tol * offending.size
            ):
                break
            # Shifted field: zero where the tolerated violation is reached.
            shifted = constraint_function - wrap_as_dense_ad_array(
                violation_tol * np.sign(f_w)
            )
            crossing_weight = self.compute_constraint_weights(
                model,
                solution_update,
                shifted,
                offending,
                f_0 - violation_tol * np.sign(f_w),
                interval_target_size=1e-3,
                max_weight=weight,
            )
            weight = float(np.clip(crossing_weight, min_w, max_weight))
            weights[offending] = weight
            violation_tol *= 0.5
        return weights
