"""Solution strategy: the model lifecycle engine.

Parity counterpart of reference ``models/solution_strategy.py:24``:
``prepare_simulation`` orchestration, Newton callbacks, assembly and linear
solve, convergence checks, rediscretization hooks. Linear solve backends:
``scipy_sparse`` (host direct, default), ``jax_bicgstab``/``jax_gmres``
(Jacobi-preconditioned Krylov on the model's device, K18; the names are
``porepy_tpu``'s) and ``device_gmres`` (the device-resident
block-preconditioned FGMRES on the assembled Jacobian).

The model computes on ``params["device"]`` (default ``"cuda"``); pass
``"cpu"`` to run on the host.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Any, Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.compositional.materials import (
    FluidComponent,
    NumericalConstants,
    ReferenceVariableValues,
    SolidConstants,
)
from porepy_tpu_torch.models.units import Units
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.time_step_control import TimeManager
from porepy_tpu_torch.utils import device_policy
from porepy_tpu_torch.viz.solver_statistics import SolverStatistics

__all__ = ["SolutionStrategy", "ContactIndicators"]

logger = logging.getLogger(__name__)


from porepy_tpu_torch.compositional.compositional_mixins import FluidMixin


class SolutionStrategy(FluidMixin):
    def __init__(self, params: Optional[dict] = None) -> None:
        if params is None:
            params = {}
        default_params = {
            "folder_name": "visualization",
            "file_name": "data",
            "linear_solver": "scipy_sparse",
            "device": "cuda",
        }
        default_params.update(params)
        self.params = default_params
        self.device = device_policy.resolve(self.params["device"])

        self.convergence_status = False
        self.units: Units = self.params.get("units", Units())
        reference_values: ReferenceVariableValues = self.params.get(
            "reference_variable_values", ReferenceVariableValues()
        )
        self.reference_variable_values = reference_values.to_units(self.units)

        if "time_manager" not in self.params:
            self.time_manager = TimeManager(
                schedule=[0, 1], dt_init=1, constant_dt=True
            )
        else:
            self.time_manager = self.params["time_manager"]

        self.restart_options = self.params.get("restart_options", {"restart": False})
        self.ad_time_step = ad.Scalar(self.time_manager.dt)
        self.results: list[Any] = []
        self.nonlinear_solver_statistics = SolverStatistics()
        self._nonlinear_discretizations: list = []

        self.linear_system: tuple[sps.csr_matrix, np.ndarray]

    # -- material setup ------------------------------------------------------

    def set_materials(self) -> None:
        constants = dict(self.params.get("material_constants", {}))
        solid = constants.get("solid", SolidConstants())
        fluid = constants.get("fluid", FluidComponent())
        numerical = constants.get("numerical", NumericalConstants())
        self.solid: SolidConstants = solid.to_units(self.units)
        self.numerical: NumericalConstants = numerical.to_units(self.units)
        self._fluid_component: FluidComponent = fluid.to_units(self.units)

    # -- lifecycle -----------------------------------------------------------

    def prepare_simulation(self) -> None:
        self.set_materials()
        self.set_geometry()
        self.initialize_data_saving()
        self.set_equation_system_manager()
        self.create_fluid()
        self.create_variables()
        self.assign_thermodynamic_properties_to_phases()
        self.initial_condition()
        self.initialize_previous_iterate_and_time_step_values()
        self.update_time_dependent_ad_arrays()
        self.reset_state_from_file()
        self.set_equations()
        self.update_discretization_parameters()
        self.discretize()
        self._initialize_linear_solver()
        self.set_nonlinear_discretizations()
        self.save_data_time_step()

    def set_equation_system_manager(self) -> None:
        if not hasattr(self, "equation_system"):
            self.equation_system = ad.EquationSystem(self.mdg, device=self.device)

    def initialize_previous_iterate_and_time_step_values(self) -> None:
        val = self.equation_system.get_variable_values(iterate_index=0)
        for iterate_index in self.iterate_indices:
            self.equation_system.set_variable_values(val, iterate_index=iterate_index)
        for time_step_index in self.time_step_indices:
            self.equation_system.set_variable_values(
                val, time_step_index=time_step_index
            )

    @property
    def time_step_indices(self) -> np.ndarray:
        return np.array([0])

    @property
    def iterate_indices(self) -> np.ndarray:
        return np.array([0])

    def reset_state_from_file(self) -> None:
        """Restart: overwrite the initial state from exported vtu/pvd files
        (reference ``solution_strategy.py:333-364``).

        ``params["restart_options"]``: ``{"restart": True, "pvd_file": path}``
        or ``{"restart": True, "vtu_files": [paths]}``; optional ``"time"``
        and ``"time_index"`` reposition the time manager at the restart
        point.
        """
        if not self.restart_options.get("restart", False):
            return
        if self.restart_options.get("pvd_file") is not None:
            self.load_data_from_pvd(self.restart_options["pvd_file"])
        else:
            vtu_files = self.restart_options.get("vtu_files") or []
            if isinstance(vtu_files, str):
                vtu_files = [vtu_files]
            if not vtu_files:
                raise ValueError(
                    "Restart requested but restart_options provides neither "
                    "'pvd_file' nor non-empty 'vtu_files'"
                )
            self.load_data_from_vtu(vtu_files)
        vals = self.equation_system.get_variable_values(time_step_index=0)
        self.equation_system.set_variable_values(
            vals, iterate_index=0, time_step_index=0
        )
        if "time" in self.restart_options:
            self.time_manager.time = float(self.restart_options["time"])
        if "time_index" in self.restart_options:
            self.time_manager.time_index = int(
                self.restart_options["time_index"]
            )
        self.update_time_dependent_ad_arrays()

    def update_time_dependent_ad_arrays(self) -> None:
        self.update_all_boundary_conditions()

    def update_derived_quantities(self) -> None:
        pass

    def set_nonlinear_discretizations(self) -> None:
        pass

    def add_nonlinear_discretization(
        self, keyword: str, max_dim: Optional[int] = None
    ) -> None:
        """Register a discretization keyword whose matrices depend on the
        solution and must be recomputed each nonlinear iteration.

        ``max_dim`` limits the rediscretized grids (default: subdimensional
        grids only, ``nd - 1`` — matching the reference's treatment of
        aperture-dependent fracture transmissibilities; pass ``self.nd`` for
        solution-dependent tensors on the matrix, e.g. fractional-flow total
        mobility). Reference: ``solution_strategy.py:960``.
        """
        self._nonlinear_discretizations.append((str(keyword), max_dim))

    def rediscretize(self) -> None:
        """Re-run registered nonlinear discretizations (explicit keyword +
        dimension scope; the in-kernel upwinding needs no rediscretization)."""
        if self._nonlinear_discretizations:
            self.update_discretization_parameters()
            for discr, sd, data in getattr(self, "_discretizations", []):
                for keyword, max_dim in self._nonlinear_discretizations:
                    lim = max_dim if max_dim is not None else self.nd - 1
                    if discr.keyword == keyword and sd.dim <= lim:
                        discr.discretize(sd, data)
                        break
            # Same grids, new matrix values: swap the compiled kernels'
            # constant arguments instead of retracing every equation.
            self.equation_system.refresh_compiled_constants()

    # -- discretization ------------------------------------------------------

    def _fv_discretizer(self, keyword: str, ad_wrapper):
        """Concrete FV discretizer matching an AD wrapper type (MpfaAd ->
        Mpfa, TpfaAd -> Tpfa)."""
        from porepy_tpu_torch.numerics.ad.discretizations import MpfaAd, TpfaAd
        from porepy_tpu_torch.numerics.fv.mpfa import Mpfa
        from porepy_tpu_torch.numerics.fv.tpfa import Tpfa

        if isinstance(ad_wrapper, MpfaAd):
            return Mpfa(keyword)
        if isinstance(ad_wrapper, TpfaAd):
            return Tpfa(keyword)
        raise ValueError(f"Unknown discretization wrapper {type(ad_wrapper)}")

    def update_discretization_parameters(self) -> None:
        pass

    def _register_discretization(self, discr, sd, data) -> None:
        """Register (or re-register) a discretizer for a grid. Re-running
        ``update_discretization_parameters`` (e.g. after fracture
        propagation rebuilds the model) replaces the previous entry of the
        same type/keyword/grid instead of duplicating it — a duplicate
        both doubles assembly work and breaks partial updates (the second
        pass would map already-updated matrices again)."""
        if not hasattr(self, "_discretizations"):
            self._discretizations = []
        kw = getattr(discr, "keyword", None)
        self._discretizations = [
            t
            for t in self._discretizations
            if not (
                t[1] is sd
                and type(t[0]) is type(discr)
                and getattr(t[0], "keyword", None) == kw
            )
        ]
        self._discretizations.append((discr, sd, data))

    def discretize(self) -> None:
        """(Re)compute every registered discretization. A grid whose data
        dictionary carries ``update_discretization`` info (set by e.g.
        fracture propagation) is routed through the discretizer's partial
        ``update_discretization`` when it has one — only the interaction
        regions whose contributions changed are re-assembled."""
        tic = _time.time()
        for discr, sd, data in getattr(self, "_discretizations", []):
            if "update_discretization" in data and hasattr(
                discr, "update_discretization"
            ):
                discr.update_discretization(sd, data)
            else:
                discr.discretize(sd, data)
        logger.info(f"Discretized in {_time.time() - tic:.2e} s")

    # -- Newton callbacks ----------------------------------------------------

    def before_nonlinear_loop(self) -> None:
        self.ad_time_step.set_value(self.time_manager.dt)
        self.nonlinear_solver_statistics.reset()
        self.update_time_dependent_ad_arrays()
        self.update_derived_quantities()
        # Reset the Eisenstat-Walker history at the start of each Newton loop.
        self._ew_prev_residual = None

    def before_nonlinear_iteration(self) -> None:
        self.rediscretize()

    def after_nonlinear_iteration(self, nonlinear_increment: np.ndarray) -> None:
        self.equation_system.shift_iterate_values(
            max_index=len(self.iterate_indices)
        )
        self.equation_system.set_variable_values(
            values=nonlinear_increment, additive=True, iterate_index=0
        )
        self.update_derived_quantities()
        self.nonlinear_solver_statistics.num_iteration += 1

    def after_nonlinear_convergence(self) -> None:
        solution = self.equation_system.get_variable_values(iterate_index=0)
        if not self.time_manager.is_constant:
            self.time_manager.compute_time_step(
                iterations=self.nonlinear_solver_statistics.num_iteration
            )
        self.update_solution(solution)
        self.convergence_status = True
        self.save_data_time_step()

    def variables_stored_all_time_steps(self) -> list:
        """Variables whose full time-step history must be retained (the
        ring depth grows each step). Used by history-integrating models
        (fracture damage); default none."""
        return []

    def update_solution(self, solution: np.ndarray) -> None:
        deep = [
            v if isinstance(v, str) else v.name
            for v in self.variables_stored_all_time_steps()
        ]
        self.equation_system.shift_time_step_values(
            max_index=len(self.time_step_indices), exclude=deep or None
        )
        if deep:
            self.equation_system.shift_time_step_values(
                max_index=None, variables=deep
            )
        self.equation_system.set_variable_values(
            values=solution, time_step_index=0, additive=False
        )

    def after_nonlinear_failure(self) -> None:
        self.save_data_time_step()
        if not self._is_nonlinear_problem():
            raise ValueError("Failed to solve the linear system")
        if self.time_manager.is_constant:
            raise ValueError("Nonlinear iterations did not converge")
        self.time_manager.compute_time_step(recompute_solution=True)
        prev = self.equation_system.get_variable_values(time_step_index=0)
        self.equation_system.set_variable_values(prev, iterate_index=0)

    def after_simulation(self) -> None:
        pass

    # -- convergence ---------------------------------------------------------

    def check_convergence(
        self,
        nonlinear_increment: np.ndarray,
        residual: Optional[np.ndarray],
        reference_residual: np.ndarray,
        nl_params: dict[str, Any],
    ) -> tuple[bool, bool]:
        if not self._is_nonlinear_problem():
            diverged = bool(np.any(np.isnan(nonlinear_increment)))
            self.nonlinear_solver_statistics.log_error(
                np.nan if diverged else 0.0, np.nan if diverged else 0.0
            )
            return not diverged, diverged

        if np.any(np.isnan(nonlinear_increment)):
            return False, True
        increment_norm = self.compute_nonlinear_increment_norm(nonlinear_increment)
        residual_norm = self.compute_residual_norm(residual, reference_residual)
        diverged = (
            nl_params["nl_divergence_tol"] is not np.inf
            and residual_norm > nl_params["nl_divergence_tol"]
        )
        converged_inc = (
            nl_params["nl_convergence_tol"] is np.inf
            or increment_norm < nl_params["nl_convergence_tol"]
        )
        converged_res = (
            nl_params["nl_convergence_tol_res"] is np.inf
            or residual_norm < nl_params["nl_convergence_tol_res"]
        )
        converged = converged_inc and converged_res
        self.nonlinear_solver_statistics.log_error(increment_norm, residual_norm)
        return converged, diverged

    def compute_residual_norm(
        self, residual: Optional[np.ndarray], reference_residual: np.ndarray
    ) -> float:
        if residual is None:
            return np.nan
        return float(np.linalg.norm(residual) / np.sqrt(residual.size))

    def compute_nonlinear_increment_norm(
        self, nonlinear_increment: np.ndarray
    ) -> float:
        return float(
            np.linalg.norm(nonlinear_increment) / np.sqrt(nonlinear_increment.size)
        )

    def _is_nonlinear_problem(self) -> bool:
        return True

    def _is_time_dependent(self) -> bool:
        return True

    # -- linear system -------------------------------------------------------

    def assemble_linear_system(self) -> None:
        tic = _time.time()
        if self.linear_solver.startswith("device"):
            data, b, cs = self.equation_system.assemble_device()
            self._device_assembly = (data, b, cs)
            # Host copy of the rhs only (convergence checks); the matrix
            # stays on the device.
            self.linear_system = (None, b.cpu().numpy())
        else:
            self.linear_system = self.equation_system.assemble()
        logger.info(f"Assembled linear system in {_time.time() - tic:.2e} s")

    def solve_linear_system(self) -> np.ndarray:
        A, b = self.linear_system
        if not np.any(b):
            return np.zeros_like(b)
        tic = _time.time()
        solver = self.linear_solver
        if solver == "scipy_sparse":
            x = sps.linalg.spsolve(A.tocsr(), b)
        elif solver in ("jax_bicgstab", "jax_gmres"):
            from porepy_tpu_torch.numerics.linalg.krylov import solve_sparse

            x = solve_sparse(A, b, method=solver.split("_")[1], device=self.device)
        elif solver.startswith("device"):
            data, b_dev, cs = self._device_assembly
            x = self._device_solver_for(cs).solve(
                data, b_dev, tol=self._inexact_newton_tol(b)
            )
        else:
            raise ValueError(f"Unknown linear solver {solver!r}")
        logger.info(f"Solved linear system in {_time.time() - tic:.2e} s")
        return np.atleast_1d(x)

    def _inexact_newton_tol(self, b: np.ndarray) -> Optional[float]:
        """Eisenstat-Walker forcing term for the device Krylov solve: the
        linear solve only needs to out-converge the current nonlinear
        residual contraction. ``eta_k = 0.9 (|F_k|/|F_{k-1}|)^2`` capped to
        [tight, 0.1]; the first iteration of each Newton loop uses ``eta0``.
        A direct-solver-grade tolerance at every Newton iteration (the
        reference's spsolve) wastes most Krylov iterations — the converged
        nonlinear solution is identical, controlled by the nonlinear
        tolerances. Disable with ``params['inexact_newton'] = False``."""
        if not self.params.get("inexact_newton", True):
            return None
        # A linear problem is accepted after a single solve with no
        # residual check — the one solve must be direct-solver-grade.
        if not self._is_nonlinear_problem():
            return None
        tight = self.params.get("linear_solver_tol", 1e-11)
        # First solve of each Newton loop: a LOOSE eta here trades Krylov
        # iterations for extra Newton iterations (extra assemblies). On the
        # bench Biot problem eta0=0.1 needs 28 Newton / 259 Krylov where
        # eta0=1e-5 needs 15 / 291 (reference's direct solves: 16 Newton);
        # 1e-4 is the robust middle for genuinely nonlinear models.
        eta0 = float(self.params.get("inexact_newton_eta0", 1e-4))
        b_norm = float(np.linalg.norm(b))
        prev = getattr(self, "_ew_prev_residual", None)
        if prev is not None and prev > 0.0 and np.isfinite(prev):
            eta = 0.9 * (b_norm / prev) ** 2
        else:
            eta = eta0
        self._ew_prev_residual = b_norm
        return float(np.clip(eta, tight, 0.1))

    # -- Newton loop on the device --------------------------------------------

    _FUSED_HOOKS = (
        "check_convergence",
        "compute_residual_norm",
        "compute_nonlinear_increment_norm",
        "update_derived_quantities",
        "before_nonlinear_iteration",
        "after_nonlinear_iteration",
    )

    def _fused_newton_eligible(self, nl_params: dict) -> bool:
        """The device Newton loop replays the host Newton protocol exactly
        only when the model keeps the default per-iteration hooks, nothing
        needs per-iteration host work (no nonlinear rediscretization, no
        previous-iterate states feeding the equations), and the solve runs
        on the device."""
        if not self.params.get("fused_newton", True):
            return False
        if not getattr(self, "linear_solver", "").startswith("device"):
            return False
        if not self._is_nonlinear_problem():
            return False
        if self._nonlinear_discretizations:
            return False
        cls = type(self)
        for name in self._FUSED_HOOKS:
            mine = getattr(cls, name, None)
            base = getattr(SolutionStrategy, name, None)
            if mine is not base:
                return False
        cs = self.equation_system.compiled_system()
        if cs.num_rows != cs.shape[1]:
            return False
        return not any(ce.env_spec.has_prev_iterate for ce in cs.ces)

    def fused_newton_loop(self, nl_params: dict):
        """Run the whole Newton loop of this time step on the device
        (assembly + preconditioned FGMRES + convergence test), with the
        iterate, the histories and the convergence flags as device tensors
        and the host reading one flag pair per iteration.

        Returns ``True`` (converged; state committed), or ``None`` if the
        model is ineligible or the Newton loop did not converge — the
        caller then runs the standard host-orchestrated loop on the
        untouched state. Errors propagate.
        """
        if not self._fused_newton_eligible(nl_params):
            return None
        eq_sys = self.equation_system
        cs = eq_sys.compiled_system()
        solver = self._device_solver_for(cs)
        envs = cs._envs(eq_sys)
        x0 = self._device_state_vector()
        if solver._m_state is None:
            self._refresh_preconditioner(cs, solver)

        newton = self._fused_newton_device_fn(cs, solver, nl_params)
        x, k, inc_hist, res_hist, kry_hist, converged, diverged = newton(
            x0, envs, solver._m_state
        )
        converged = converged and not diverged
        if converged:
            x = x.cpu().numpy()
            converged = bool(np.all(np.isfinite(x)))
        if not converged:
            # Stale preconditioner is the common cause: rebuild from the
            # failing state's Jacobian so the host fallback starts strong.
            logger.info(
                "Device Newton loop did not converge in %d iterations; "
                "falling back to the host loop",
                k,
            )
            solver.invalidate_preconditioner()
            return None
        stats = self.nonlinear_solver_statistics
        inc_hist = inc_hist.cpu().numpy()
        res_hist = res_hist.cpu().numpy()
        kry_hist = np.asarray(kry_hist)
        for i in range(k):
            stats.log_error(float(inc_hist[i]), float(res_hist[i]))
        stats.num_iteration += k
        # Surface the linear-solver work done inside the device loop: the
        # host-orchestrated path fills last_stats in solve().
        if k > 0:
            solver.last_stats = {
                "krylov_iters": int(kry_hist[k - 1]),
                "krylov_iters_per_newton": [int(j) for j in kry_hist[:k]],
                "residual": float(res_hist[k - 1]),
                "fused": True,
            }
        eq_sys.shift_iterate_values(max_index=len(self.iterate_indices))
        eq_sys.set_variable_values(x, iterate_index=0)
        return True

    def _device_state_vector(self):
        """The current iterate as a float64 tensor on the model's device."""
        import torch

        return torch.tensor(
            self.equation_system._global_vector(),
            dtype=torch.float64,
            device=self.equation_system.device,
        )

    def _refresh_preconditioner(self, cs, solver) -> None:
        """Build the frozen preconditioner from the Jacobian at the current
        iterate: assembled on the device, its nonzeros copied to the host
        once for the host-side builder."""
        data, _b = cs.assemble(self.equation_system)
        solver.refresh_preconditioner(data)

    def _fused_newton_device_fn(self, cs, solver, nl_params: dict):
        """The device Newton loop shared by the per-step path
        (:meth:`fused_newton_loop`) and the multi-step time block
        (:meth:`_build_fused_time_block`) (K9):
        ``newton(x0, envs, m_state) -> (x, k, inc_h, res_h, kry_h, done,
        div)``. ``x`` and the norm histories are device tensors, ``k``,
        ``kry_h`` and the flags host values: each iteration reads the
        convergence and divergence flags from the device once. Each
        iteration's assembly, solve and flag read are ``record_function``
        ranges (``newton.assemble``, ``newton.solve``, ``newton.flags``), which
        a ``torch.profiler`` trace shows and which cost nothing else."""
        import torch
        from torch.profiler import record_function

        max_it = int(nl_params["max_iterations"])
        tol_inc = nl_params["nl_convergence_tol"]
        tol_res = nl_params["nl_convergence_tol_res"]
        div_tol = nl_params["nl_divergence_tol"]
        need_res = tol_res is not np.inf or div_tol is not np.inf
        inexact = bool(self.params.get("inexact_newton", True))
        tight = float(self.params.get("linear_solver_tol", 1e-11))
        eta0 = float(self.params.get("inexact_newton_eta0", 1e-4))
        n = solver.n
        sqrt_n = float(np.sqrt(max(n, 1)))

        def loop(x0, envs, m_state):
            dev, dtype = x0.device, x0.dtype
            x = x0
            prev_b = torch.zeros((), dtype=dtype, device=dev)
            inc_h = torch.full((max_it + 1,), float("nan"), dtype=dtype, device=dev)
            res_h = torch.full((max_it + 1,), float("nan"), dtype=dtype, device=dev)
            kry_h = [0] * (max_it + 1)
            k = 0
            done = div = False
            while not done and not div and k < max_it + 1:
                with record_function("newton.assemble"):
                    data, b = cs._data_and_rhs(x, envs)
                bnorm = torch.linalg.vector_norm(b)
                if inexact:
                    eta = torch.where(
                        prev_b > 0.0,
                        0.9 * (bnorm / prev_b) ** 2,
                        torch.full_like(bnorm, eta0),
                    )
                    eta = torch.clamp(eta, tight, 0.1)
                else:
                    eta = torch.full_like(bnorm, tight)
                b_unit = b / torch.clamp(bnorm, min=1e-30)
                with record_function("newton.solve"):
                    dx_u, _res, it = solver._solve(
                        data, b_unit, torch.zeros(n, dtype=dtype, device=dev),
                        m_state, eta,
                    )
                dx = torch.where(bnorm > 0.0, dx_u * bnorm, torch.zeros_like(dx_u))
                x_new = x + dx
                inc_norm = torch.linalg.vector_norm(dx) / sqrt_n
                if need_res:
                    res_norm = (
                        torch.linalg.vector_norm(cs._rhs_only(x_new, envs)) / sqrt_n
                    )
                else:
                    res_norm = torch.full_like(inc_norm, float("nan"))
                bad = ~torch.isfinite(inc_norm)
                if div_tol is not np.inf:
                    bad = bad | (res_norm > div_tol)
                conv = torch.ones((), dtype=torch.bool, device=dev)
                if tol_inc is not np.inf:
                    conv = conv & (inc_norm < tol_inc)
                if tol_res is not np.inf:
                    conv = conv & (res_norm < tol_res)
                inc_h[k] = inc_norm
                res_h[k] = res_norm
                kry_h[k] = it
                with record_function("newton.flags"):
                    done, div = torch.stack([conv & ~bad, bad]).tolist()
                x = x_new
                prev_b = bnorm
                k += 1
            return x, k, inc_h, res_h, kry_h, done, div

        return loop

    # -- multi-step time block -------------------------------------------------
    #
    # A chunk of constant-dt time steps runs as one host loop over device
    # tensors, each step the device Newton loop above. The
    # previous-time-step variable values feeding the equations are sliced
    # from the carried state tensor instead of re-fetched from host storage,
    # so nothing crosses to the host between steps but the Newton flags.
    # Opt-in via ``params["fused_time_steps"] = N`` (chunk length).
    # Eligibility is *observed*, not assumed: the first two steps run
    # per-step, and the env cache records which equation inputs actually
    # changed across the step boundary (_EnvSpec.last_refreshed). The block
    # engages only if everything that changed is previous-time-step
    # variable state the loop carries itself; a final host-side
    # re-validation compares the env values at the block's last step
    # against the constants the block used, and rolls back (commits
    # nothing) on mismatch. Replaces the reference's per-step host
    # orchestration (`/root/reference/src/porepy/models/
    # solution_strategy.py:820-887`, per-iteration scipy assembly + solve).

    def _fused_block_substitution(self, cs):
        """Per-compiled-equation map ``{env slot -> (start, stop)}`` of
        global-dof slices replacing previous-time-step variable slots inside
        the block, or ``None`` if the system is ineligible (deeper history,
        or observed env changes the carry cannot reproduce)."""
        eq_sys = self.equation_system
        subst: list[dict[int, tuple[int, int]]] = []
        for ce in cs.ces:
            spec = ce.env_spec
            if spec.last_refreshed is None:
                return None  # no step-boundary observation yet
            idx_to_key = {v: k for k, v in spec._keys.items()}
            smap: dict[int, tuple[int, int]] = {}
            var_slots: set[int] = set()
            for idx in range(len(spec.fetchers)):
                if idx in spec.static_slots:
                    continue
                key = idx_to_key.get(idx)
                off = None
                if (
                    isinstance(key, tuple)
                    and len(key) == 4
                    and isinstance(key[0], str)
                    and key[2] == 0
                ):
                    off = eq_sys._dof_offsets.get((key[0], key[1]))
                if off is not None:
                    smap[idx] = (off[0], off[0] + off[1])
                    var_slots.add(idx)
                elif (
                    isinstance(key, tuple)
                    and len(key) == 4
                    and isinstance(key[0], str)
                    and isinstance(key[2], int)
                    and key[2] > 0
                ):
                    return None  # multi-step history: carry is one state deep
            # Anything observed changing across a step boundary must be a
            # substituted slot.
            if not set(spec.last_refreshed) <= var_slots:
                return None
            subst.append(smap)
        return subst

    def _fused_time_block_eligible(self, nl_params: dict) -> bool:
        if getattr(self, "_ftb_ineligible", False):
            return False
        if not self.time_manager.is_constant:
            return False
        if not self._fused_newton_eligible(nl_params):
            return False
        # The block skips the per-step host hooks; require the default
        # step-boundary hooks so the env producers are exactly
        # update_time_dependent_ad_arrays (+ the already-checked hooks).
        cls = type(self)
        for name in ("before_nonlinear_loop", "after_nonlinear_failure"):
            if getattr(cls, name, None) is not getattr(
                SolutionStrategy, name, None
            ):
                return False
        return True

    def fused_time_block(self, n_steps: int, nl_params: dict) -> int:
        """Attempt up to ``n_steps`` constant-dt time steps as one device
        block. Returns the number of time steps actually committed
        (``0`` = ineligible, not converged or rolled back; the caller
        proceeds per-step on the untouched state). Statistics, state-ring
        shifts, time-manager advancement and ``after_nonlinear_convergence``
        (hence data saving) are replayed per committed step, so observable
        behavior matches the per-step path for converged runs. Errors
        propagate."""
        if n_steps < 2 or not self._fused_time_block_eligible(nl_params):
            return 0
        eq_sys = self.equation_system
        cs = eq_sys.compiled_system()
        subst = self._fused_block_substitution(cs)
        if subst is None:
            return 0
        solver = self._device_solver_for(cs)
        envs = cs._envs(eq_sys)
        x0 = self._device_state_vector()
        if solver._m_state is None:
            self._refresh_preconditioner(cs, solver)

        chunk = int(self.params.get("fused_time_steps", n_steps))
        chunk = max(min(chunk, 512), 2)
        block = self._build_fused_time_block(cs, solver, nl_params, subst, chunk)
        n_active = min(int(n_steps), chunk)
        x_stack, k_arr, inc_st, res_st, kry_st, ok_arr = block(
            x0, envs, solver._m_state, n_active
        )
        n_ok = int(np.sum(ok_arr))
        if n_ok == 0:
            solver.invalidate_preconditioner()
            return 0
        # ``fused_commit_states: "tail"`` copies to the host only the states
        # the ring actually keeps (benchmarks with data saving suppressed).
        if str(self.params.get("fused_commit_states", "all")) == "tail":
            commit_lo = max(
                n_ok
                - max(
                    len(self.time_step_indices),
                    len(self.iterate_indices),
                    1,
                ),
                0,
            )
        else:
            commit_lo = 0
        x_host = x_stack[commit_lo:n_ok].cpu().numpy()
        if not np.all(np.isfinite(x_host)):
            solver.invalidate_preconditioner()
            return 0

        # Re-validate at the block's last step: with the state rings set to
        # just-before-the-last-step and the clock at its time, the freshly
        # produced env values must equal the constants the block used. A
        # mismatch means some non-carried input (BCs, sources, scalars) was
        # time-dependent after all — commit nothing, mark ineligible.
        tm = self.time_manager
        t_save, ti_save = tm.time, tm.time_index
        tm.time = t_save + n_ok * tm.dt
        tm.time_index = ti_save + n_ok
        self.update_time_dependent_ad_arrays()
        fresh_ok = True
        for ce, smap in zip(cs.ces, subst):
            spec = ce.env_spec
            for idx in range(len(spec.fetchers)):
                if idx in spec.static_slots or idx in smap:
                    continue
                h = spec.fetchers[idx](eq_sys)
                old = spec._cache_host[idx]
                if np.shape(old) != np.shape(h) or not np.array_equal(
                    np.asarray(old), np.asarray(h)
                ):
                    fresh_ok = False
                    break
            if not fresh_ok:
                break
        tm.time, tm.time_index = t_save, ti_save
        if not fresh_ok:
            logger.info(
                "Fused time block rolled back: env inputs are time-dependent"
            )
            self._ftb_ineligible = True
            return 0

        # Commit each step through the standard protocol.
        k_np = np.asarray(k_arr)
        inc_np = inc_st.cpu().numpy()
        res_np = res_st.cpu().numpy()
        kry_np = np.asarray(kry_st)
        stats = self.nonlinear_solver_statistics
        for j in range(n_ok):
            tm.increase_time()
            tm.increase_time_index()
            stats.reset()
            kj = int(k_np[j])
            for i in range(kj):
                stats.log_error(float(inc_np[j, i]), float(res_np[j, i]))
            stats.num_iteration = kj
            solver.last_stats = {
                "krylov_iters": int(kry_np[j, max(kj - 1, 0)]),
                "krylov_iters_per_newton": [int(q) for q in kry_np[j, :kj]],
                "residual": float(res_np[j, max(kj - 1, 0)]),
                "fused": True,
                "block": True,
            }
            eq_sys.shift_iterate_values(max_index=len(self.iterate_indices))
            if j >= commit_lo:
                eq_sys.set_variable_values(
                    x_host[j - commit_lo], iterate_index=0
                )
            self.after_nonlinear_convergence()
            stats.log_timestep(tm.time_index, tm.time)
        self._ftb_blocks_committed = (
            getattr(self, "_ftb_blocks_committed", 0) + 1
        )
        # Bench/diagnostics record: how much Newton work this block carried.
        self._ftb_last = {
            "steps": n_ok,
            "newton_iters": int(k_np[:n_ok].sum()),
            "krylov_iters": int(
                sum(kry_np[j, : max(int(k_np[j]), 1)].sum() for j in range(n_ok))
            ),
        }
        return n_ok

    def _build_fused_time_block(self, cs, solver, nl_params: dict, subst, chunk: int):
        """``block(x0, envs, m_state, n_active)``: up to ``n_active`` time
        steps (at most ``chunk``), each the device Newton loop with the
        previous-time-step env slots replaced by slices of the carried
        state. Stops at the first step that fails. Returns the stacked
        states, the per-step Newton counts, the norm and Krylov histories
        and the per-step ok flags, one entry per step run. A block is a
        ``record_function`` range, ``fused_time_block``."""
        import torch
        from torch.profiler import record_function

        newton = self._fused_newton_device_fn(cs, solver, nl_params)

        def substitute(envs, x_prev):
            return tuple(
                tuple(
                    x_prev[smap[i][0] : smap[i][1]] if i in smap else e
                    for i, e in enumerate(eq_env)
                )
                for eq_env, smap in zip(envs, subst)
            )

        @record_function("fused_time_block")
        def block(x0, envs, m_state, n_active):
            x_prev = x0
            xs, ks, incs, ress, krys, oks = [], [], [], [], [], []
            for _ in range(min(int(n_active), chunk)):
                x_new, k, inc_h, res_h, kry_h, done, div = newton(
                    x_prev, substitute(envs, x_prev), m_state
                )
                with record_function("newton.flags"):
                    step_ok = (
                        done and not div and bool(torch.all(torch.isfinite(x_new)))
                    )
                x_keep = x_new if step_ok else x_prev
                xs.append(x_keep)
                ks.append(k)
                incs.append(inc_h)
                ress.append(res_h)
                krys.append(kry_h)
                oks.append(step_ok)
                if not step_ok:
                    break
                x_prev = x_keep
            return (
                torch.stack(xs),
                np.asarray(ks),
                torch.stack(incs),
                torch.stack(ress),
                np.asarray(krys),
                np.asarray(oks),
            )

        return block

    def _initialize_linear_solver(self) -> None:
        solver = self.params["linear_solver"]
        known = (
            "scipy_sparse",
            "jax_bicgstab",
            "jax_gmres",
            "device_bicgstab",
            "device_gmres",
        )
        if solver not in known:
            raise ValueError(f"Unknown linear solver {solver!r}")
        self.linear_solver: str = solver
        self._device_solvers: dict = {}

    # -- device solver configuration ------------------------------------------

    # Known (equation, variable) pairings used by the automatic field split.
    # AMG pairs are elliptic cell-variable blocks; ELIM pairs are local
    # interface equations whose diagonal block is (exactly) diagonal — they
    # Schur-eliminate exactly inside the preconditioner (the builder demotes
    # any pair that turns out non-diagonal to a Jacobi-sweep block).
    _AMG_EQ_VAR_PAIRS = (
        ("mass_balance_equation", "pressure"),
        ("energy_balance_equation", "temperature"),
        ("momentum_balance_equation", "u"),
    )
    _ELIM_EQ_VAR_PAIRS = (
        ("interface_darcy_flux_equation", "interface_darcy_flux"),
        ("interface_fourier_flux_equation", "interface_fourier_flux"),
        ("interface_enthalpy_flux_equation", "interface_enthalpy_flux"),
        ("interface_force_balance_equation", "u_interface"),
    )

    def linear_solver_blocks(self) -> Optional[dict]:
        """Field-split declaration for the device block preconditioner:
        ``{"blocks": [(equation_names, variable_spec), ...], "methods":
        [...], "stabilization": {i: diag}, "near_nullspace": {i: (B, bs)}}``
        ordered for the lower Gauss-Seidel sweep.

        The default derives the split automatically from the model's
        equations: known elliptic cell-variable blocks get SA-AMG (the
        displacement block with rigid-body near-nullspace modes), interface
        flux equations are Schur-eliminated, anything left over lands in a
        trailing block of damped l1-Jacobi sweeps. Returns ``None`` (single
        whole-system AMG block) when no known pairing exists.
        """
        return self._auto_linear_solver_blocks()

    def _auto_linear_solver_blocks(self) -> Optional[dict]:
        eq_sys = self.equation_system
        eq_names = set(eq_sys.equations)
        var_names = {v.name for v in eq_sys.variables}
        blocks: list[tuple[list[str], list[str]]] = []
        methods: list[str] = []
        stab: dict = {}
        nns: dict = {}
        used_eqs: list[str] = []
        used_vars: list[str] = []
        for eq, var in self._AMG_EQ_VAR_PAIRS:
            if eq in eq_names and var in var_names:
                i = len(blocks)
                blocks.append(([eq], [var]))
                methods.append("amg")
                s = self._amg_block_stabilization(var)
                if s is not None:
                    stab[i] = s
                if var == self.__dict__.get("displacement_variable", "u"):
                    modes = self._displacement_near_nullspace()
                    if modes is not None:
                        nns[i] = modes
                used_eqs.append(eq)
                used_vars.append(var)
        if not blocks:
            return None
        for eq, var in self._ELIM_EQ_VAR_PAIRS:
            if eq in eq_names and var in var_names:
                blocks.append(([eq], [var]))
                methods.append("eliminate")
                used_eqs.append(eq)
                used_vars.append(var)
        rest_eqs = [n for n in eq_sys.equations if n not in used_eqs]
        rest_vars = [n for n in var_names if n not in used_vars]
        if rest_eqs or rest_vars:
            blocks.append((rest_eqs, rest_vars))
            methods.append("jacobi")
        return {
            "blocks": blocks,
            "methods": methods,
            "stabilization": stab,
            "near_nullspace": nns,
        }

    def _amg_block_stabilization(self, var_name: str) -> Optional[np.ndarray]:
        """Diagonal stabilization added to the named variable's AMG block
        inside the preconditioner (fixed-stress style). Overridden by
        coupled models; ``None`` -> no stabilization."""
        return None

    def _displacement_near_nullspace(self) -> Optional[tuple[np.ndarray, int]]:
        """Rigid-body modes of the displacement dofs (translations +
        rotations about the domain center), as ``(B, nd)`` for the AMG
        near-nullspace. Interleaved-dof layout matches the ``u`` variable
        (``cells: nd``)."""
        sds = [sd for sd in self.mdg.subdomains(dim=self.nd)]
        if not sds:
            return None
        centers = np.concatenate([sd.cell_centers for sd in sds], axis=1)
        nd = self.nd
        nc = centers.shape[1]
        c0 = centers - centers.mean(axis=1, keepdims=True)
        n_rot = 1 if nd == 2 else 3
        B = np.zeros((nc * nd, nd + n_rot))
        for d in range(nd):
            B[d::nd, d] = 1.0
        if nd == 2:
            B[0::nd, 2] = -c0[1]
            B[1::nd, 2] = c0[0]
        else:
            B[1::nd, 3] = -c0[2]
            B[2::nd, 3] = c0[1]
            B[0::nd, 4] = c0[2]
            B[2::nd, 4] = -c0[0]
            B[0::nd, 5] = -c0[1]
            B[1::nd, 5] = c0[0]
        return B, nd

    def _device_solver_for(self, cs):
        solver = self._device_solvers.get(id(cs))
        if solver is not None:
            return solver
        from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

        spec = self.linear_solver_blocks()
        blocks = None
        methods = None
        stab = None
        nns = None
        if spec is not None:
            blocks = []
            for eq_names, var_spec in spec["blocks"]:
                rows = []
                for eq in eq_names:
                    off = cs.row_offsets[eq]
                    nrows = self.equation_system._get_compiled(eq).pattern.shape[0]
                    rows.append(np.arange(off, off + nrows))
                blocks.append(
                    (
                        np.concatenate(rows) if rows else np.zeros(0, np.int64),
                        self.equation_system.dofs_of(var_spec),
                    )
                )
            methods = spec.get("methods")
            stab = spec.get("stabilization")
            nns = spec.get("near_nullspace")
            # Drop empty blocks (e.g. no interfaces in this mdg).
            keep = [i for i, (r, c) in enumerate(blocks) if r.size or c.size]
            blocks = [blocks[i] for i in keep]
            if methods is not None:
                methods = [methods[i] for i in keep]
            remap = {old: new for new, old in enumerate(keep)}
            if stab:
                stab = {remap[i]: v for i, v in stab.items() if i in remap}
            if nns:
                nns = {remap[i]: v for i, v in nns.items() if i in remap}
        solver = DeviceLinearSolver(
            cs,
            method=self.linear_solver.split("_")[1],
            blocks=blocks,
            methods=methods,
            stabilization=stab,
            near_nullspace=nns,
            tol=self.params.get("linear_solver_tol", 1e-11),
            maxiter=self.params.get("linear_solver_maxiter"),
            dense=self.params.get("dense_precond", False),
        )
        self._device_solvers = {id(cs): solver}
        return solver


class ContactIndicators:
    """Opening/sliding state indicator operators used by the
    constraint-aware line search (reference ``solution_strategy.py:1027``;
    algorithm of arXiv:2407.01184). Mix into contact-mechanics models and
    enable with ``params["local_line_search"]``."""

    def opening_indicator(self, subdomains) -> "ad.Operator":
        """Difference of the two arguments of the normal complementarity max:
        negative for open fractures, positive for closed."""
        from porepy_tpu_torch.numerics import ad

        nd_vec_to_normal = self.normal_component(subdomains)
        t_n = nd_vec_to_normal @ self.contact_traction(subdomains)
        u_n = nd_vec_to_normal @ self.displacement_jump(subdomains)
        c_num = self.contact_mechanics_numerical_constant(subdomains)
        max_arg_1 = ad.Scalar(-1.0) * t_n
        max_arg_2 = c_num * (u_n - self.fracture_gap(subdomains))
        ind = max_arg_1 - max_arg_2
        if self.params.get("adaptive_indicator_scaling", False):
            all_subdomains = self.mdg.subdomains(dim=self.nd - 1)
            scale_op = self.contact_traction_estimate(all_subdomains)
            scale = self.compute_traction_norm(
                np.asarray(self.equation_system.evaluate(scale_op))
            )
            ind = ind / ad.Scalar(scale)
        return ind

    def sliding_indicator(self, subdomains) -> "ad.Operator":
        """``||t_t + c u_t|| - b_p``: negative for sticking, positive for
        sliding; masked by the heaviside of the opening indicator."""
        from functools import partial

        from porepy_tpu_torch.numerics import ad

        num_cells = sum(sd.num_cells for sd in subdomains)
        nd_vec_to_tangential = self.tangential_component(subdomains)
        tangential_basis = self.basis(subdomains, dim=self.nd - 1)
        t_t = nd_vec_to_tangential @ self.contact_traction(subdomains)
        u_t = nd_vec_to_tangential @ self.displacement_jump(subdomains)
        u_t_increment = ad.time_increment(u_t)
        zeros_frac = ad.DenseArray(np.zeros(num_cells))
        c_num = self.contact_mechanics_numerical_constant(subdomains)
        basis_sum = ad.sum_projection_list(tangential_basis)
        tangential_sum = t_t + (basis_sum @ c_num) * u_t_increment
        max_arg_1 = ad.l2_norm(self.nd - 1, tangential_sum)
        max_arg_1.set_name("norm_tangential")
        max_arg_2 = ad.maximum(self.friction_bound(subdomains), zeros_frac)
        max_arg_2.set_name("b_p")
        h_oi = ad.heaviside(self.opening_indicator(subdomains), 0)
        ind = max_arg_1 - max_arg_2
        if self.params.get("adaptive_indicator_scaling", False):
            all_subdomains = self.mdg.subdomains(dim=self.nd - 1)
            scale_op = self.contact_traction_estimate(all_subdomains)
            scale = self.compute_traction_norm(
                np.asarray(self.equation_system.evaluate(scale_op))
            )
            ind = ind / ad.Scalar(scale)
        return ind * h_oi

    def contact_traction_estimate(self, subdomains) -> "ad.Operator":
        from porepy_tpu_torch.numerics import ad

        t = self.contact_traction(subdomains)
        e_n = self.e_i(subdomains, dim=self.nd, i=self.nd - 1)
        u = self.displacement_jump(subdomains) - e_n @ self.fracture_gap(
            subdomains
        )
        c_num = self.contact_mechanics_numerical_constant(subdomains)
        return ad.l2_norm(self.nd, t) + ad.l2_norm(self.nd, c_num * u)

    def compute_traction_norm(self, val: np.ndarray) -> float:
        val = np.asarray(val).clip(1e-8, 1e8)
        p = self.params.get("traction_estimate_p_mean", 5.0)
        return float(np.mean(val**p, axis=0) ** (1 / p))
