"""Convergence analysis harness (reference
``applications/convergence_analysis.py:21``): run a model over
successively refined meshes/time steps, collect errors and estimate
observed orders of convergence by log-log regression."""

from __future__ import annotations

import warnings
from copy import deepcopy
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.models.run_models import (
    run_stationary_model,
    run_time_dependent_model,
)
from porepy_tpu_torch.numerics.time_step_control import TimeManager
from porepy_tpu_torch.utils.txt_io import TxtData, export_data_to_txt

__all__ = ["ConvergenceAnalysis"]


class ConvergenceAnalysis:
    def __init__(
        self,
        model_class,
        model_params: dict,
        levels: int = 1,
        spatial_refinement_rate: int = 1,
        temporal_refinement_rate: int = 1,
    ) -> None:
        if spatial_refinement_rate < 1 or temporal_refinement_rate < 1:
            raise ValueError("Refinement rate cannot be less than 1.")
        if spatial_refinement_rate == 1 and temporal_refinement_rate == 1:
            warnings.warn("No refinement (in space or time) will be performed.")
        self.model_class = model_class
        self.levels = levels
        self.spatial_refinement_rate = spatial_refinement_rate
        self.temporal_refinement_rate = temporal_refinement_rate

        self._init_model = model_class(deepcopy(model_params))
        self._init_model.prepare_simulation()
        self._is_time_dependent = self._init_model._is_time_dependent()
        if not self._is_time_dependent and temporal_refinement_rate > 1:
            raise ValueError(
                "Stationary models cannot be refined in time."
            )

        mesh_args = self._get_list_of_meshing_arguments()
        time_managers = self._get_list_of_time_managers()
        self.model_params: list[dict] = []
        for lvl in range(levels):
            params = deepcopy(model_params)
            params["meshing_arguments"] = mesh_args[lvl]
            if time_managers is not None:
                params["time_manager"] = time_managers[lvl]
            self.model_params.append(params)

    def run_analysis(self) -> list:
        results = []
        for level in range(self.levels):
            model = self.model_class(deepcopy(self.model_params[level]))
            if not model._is_time_dependent():
                run_stationary_model(model, deepcopy(self.model_params[level]))
            else:
                run_time_dependent_model(
                    model, deepcopy(self.model_params[level])
                )
            result = model.results[-1]
            setattr(result, "cell_diameter", model.mdg.diameter())
            if model._is_time_dependent():
                setattr(result, "dt", model.time_manager.dt)
            results.append(result)
        return results

    def export_errors_to_txt(
        self,
        list_of_results: list,
        variables_to_export: Optional[list[str]] = None,
        file_name=Path("error_analysis.txt"),
    ) -> None:
        var_names = self._filter_variables_from_list_of_results(
            list_of_results, variables_to_export
        )
        data = [
            TxtData(
                header="cell_diameter",
                array=np.array(
                    [r.cell_diameter for r in list_of_results]
                ),
            )
        ]
        if self._is_time_dependent:
            data.append(
                TxtData(
                    header="time_step",
                    array=np.array([r.dt for r in list_of_results]),
                )
            )
        for name in var_names:
            data.append(
                TxtData(
                    header=name,
                    array=np.array(
                        [getattr(r, name) for r in list_of_results]
                    ),
                )
            )
        export_data_to_txt(data, file_name)

    def order_of_convergence(
        self,
        list_of_results: list,
        variables: Optional[list[str]] = None,
        x_axis: str = "cell_diameter",
        base_log_x_axis: int = 2,
        base_log_y_axis: int = 2,
        data_range: slice = slice(None, None, None),
    ) -> dict[str, float]:
        if x_axis == "time_step" and not self._is_time_dependent:
            raise ValueError(
                "Order of convergence cannot be estimated as a function of "
                "the time step for a stationary model."
            )
        if x_axis == "cell_diameter":
            x = np.array([r.cell_diameter for r in list_of_results])
        elif x_axis == "time_step":
            x = np.array([r.dt for r in list_of_results])
        else:
            raise ValueError(f"Unknown x_axis {x_axis!r}")
        names = self._filter_variables_from_list_of_results(
            list_of_results, variables
        )
        x_log = np.emath.logn(base_log_x_axis, x[data_range])
        out = {}
        for name in names:
            y = np.array([getattr(r, name) for r in list_of_results])
            y_log = np.emath.logn(base_log_y_axis, y[data_range])
            slope, _ = np.polyfit(x_log, y_log, 1)
            out["ooc_" + name.removeprefix("error_")] = float(slope)
        return out

    # -- error norms --------------------------------------------------------

    @staticmethod
    def lp_error(
        grid,
        true_array: np.ndarray,
        approx_array: np.ndarray,
        is_scalar: bool,
        is_cc: bool,
        p=2,
        relative: bool = False,
        parameter_weight: Optional[np.ndarray] = None,
    ):
        """Discrete Lp error; face quantities use the TPSA/TPFA-consistent
        half-distance measure."""
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        if isinstance(grid, MortarGrid) and not is_cc:
            raise NotImplementedError(
                "Interface variables can only be cell-centered."
            )
        if is_cc:
            num_entities = grid.num_cells
            meas = grid.cell_volumes.copy()
        else:
            num_entities = grid.num_faces
            fi, ci, _ = sps.find(grid.cell_faces)
            fc_cc = grid.face_centers[:, fi] - grid.cell_centers[:, ci]
            n = grid.face_normals[:, fi]
            dist = np.abs(np.sum(fc_cc * n, axis=0))
            meas = (
                np.bincount(fi, weights=dist, minlength=grid.num_faces)
                / grid.dim
            )
        if parameter_weight is not None:
            if parameter_weight.size != num_entities:
                raise ValueError("Invalid size of parameter weight.")
            meas = meas * parameter_weight
        if not is_scalar:
            meas = meas.repeat(grid.dim)
        numerator = ConvergenceAnalysis.lp_norm(
            true_array - approx_array, integration_weights=meas, p=p
        )
        denominator = (
            ConvergenceAnalysis.lp_norm(
                true_array, integration_weights=meas, p=p
            )
            if relative
            else 1.0
        )
        if np.isclose(denominator, 0):
            raise ZeroDivisionError("Attempted division by zero.")
        return numerator / denominator

    @staticmethod
    def l2_error(
        grid,
        true_array,
        approx_array,
        is_scalar: bool,
        is_cc: bool,
        relative: bool = False,
    ):
        return ConvergenceAnalysis.lp_error(
            grid, true_array, approx_array, is_scalar, is_cc, 2, relative
        )

    @staticmethod
    def lp_norm(vec: np.ndarray, integration_weights: np.ndarray, p=2):
        if np.isinf(p):
            return np.max(np.abs(vec))
        return np.sum(integration_weights * np.abs(vec) ** p) ** (1.0 / p)

    # -- internals ------------------------------------------------------------

    def _get_list_of_meshing_arguments(self) -> list[dict]:
        init = deepcopy(self._init_model.meshing_arguments())
        factors = 1 / (
            self.spatial_refinement_rate ** np.arange(self.levels)
        )
        return [
            {k: v * factors[lvl] for k, v in init.items()}
            for lvl in range(self.levels)
        ]

    def _get_list_of_time_managers(self):
        if not self._is_time_dependent:
            return None
        tm = self._init_model.time_manager
        if not tm.is_constant:
            raise NotImplementedError(
                "Analysis in time only supports constant time step."
            )
        factors = 1 / (
            self.temporal_refinement_rate ** np.arange(self.levels)
        )
        return [
            TimeManager(
                schedule=tm.schedule,
                dt_init=tm.dt_init * factors[lvl],
                constant_dt=True,
            )
            for lvl in range(self.levels)
        ]

    def _filter_variables_from_list_of_results(
        self, list_of_results: list, variables: Optional[list[str]]
    ) -> list[str]:
        if variables is None:
            return [
                attr
                for attr in vars(list_of_results[0])
                if attr.startswith("error_")
            ]
        return [
            attr
            for attr in vars(list_of_results[0])
            if attr.startswith("error_")
            and attr.removeprefix("error_") in variables
        ]
