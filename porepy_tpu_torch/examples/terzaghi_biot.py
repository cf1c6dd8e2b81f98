"""Terzaghi's consolidation problem: a classical Biot verification setup.

Parity counterpart of reference ``examples/terzaghi_biot.py``: a
pseudo-1d soil column loaded on top, with the analytical pressure profile
and degree of consolidation as verification targets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from porepy_tpu_torch.applications.convergence_analysis import ConvergenceAnalysis
from porepy_tpu_torch.geometry.domain import Domain
from porepy_tpu_torch.models.derived_models.biot import (
    BiotPoromechanics,
    SolutionStrategyBiot,
)
from porepy_tpu_torch.params.bc import BoundaryCondition, BoundaryConditionVectorial
from porepy_tpu_torch.utils.common_constants import GRAVITY_ACCELERATION
from porepy_tpu_torch.utils.examples_utils import VerificationUtils

__all__ = ["TerzaghiModel", "TerzaghiExactSolution", "terzaghi_solid_params"]

# Material values commonly used with this setup (incompressible fluid,
# unit Biot coefficient, zero storage — the classical Terzaghi regime).
terzaghi_solid_params = {
    "lame_lambda": 1.65e9,
    "shear_modulus": 1.475e9,
    "specific_storage": 0.0,
    "permeability": 9.86e-14,
    "biot_coefficient": 1.0,
    "porosity": 0.3,
}


@dataclass
class TerzaghiSaveData:
    approx_pressure: np.ndarray = None
    error_pressure: float = 0.0
    error_consolidation_degree: float = 0.0
    time: float = 0.0


class TerzaghiExactSolution:
    """Series solution of the 1d consolidation problem."""

    def __init__(self, model) -> None:
        self.model = model
        self.uls: int = self.model.params.get("upper_limit_summation", 1000)

    def pressure(self, y: np.ndarray, t) -> np.ndarray:
        F = self.model.applied_load()
        nondim_y = self.model.nondim_length(y)
        nondim_t = self.model.nondim_time(t)
        if t == 0:
            return F * np.ones_like(y)
        series = np.zeros_like(y)
        for i in range(1, self.uls + 1):
            series += (
                ((-1) ** (i - 1))
                / (2 * i - 1)
                * np.cos((2 * i - 1) * (np.pi / 2) * nondim_y)
                * np.exp(-((2 * i - 1) ** 2) * (np.pi**2 / 4) * nondim_t)
            )
        return (4 / np.pi) * F * series

    def consolidation_degree(self, t) -> float:
        t_nondim = self.model.nondim_time(t)
        if t == 0:
            return 0.0
        series = 0.0
        for i in range(1, self.uls + 1):
            series += (
                1
                / (2 * i - 1) ** 2
                * np.exp(-((2 * i - 1) ** 2) * (np.pi**2 / 4) * t_nondim)
            )
        return 1 - (8 / np.pi**2) * series


class TerzaghiUtils(VerificationUtils):
    def gravity_acceleration(self):
        ls = self.units.convert_units(1, "m")
        ts = self.units.convert_units(1, "s")
        return GRAVITY_ACCELERATION * ls / ts**2

    def confined_compressibility(self):
        return 1 / (2 * self.solid.shear_modulus + self.solid.lame_lambda)

    def consolidation_coefficient(self):
        k = self.solid.permeability
        mu_f = self.fluid.reference_component.viscosity
        rho = self.fluid.reference_component.density
        gamma_f = rho * self.gravity_acceleration()
        hydraulic_conductivity = k * gamma_f / mu_f
        storage = self.solid.specific_storage
        alpha = self.solid.biot_coefficient
        m_v = self.confined_compressibility()
        return hydraulic_conductivity / (
            gamma_f * (storage + alpha**2 * m_v)
        )

    def nondim_time(self, t):
        return t * self.consolidation_coefficient() / self.height() ** 2

    def nondim_length(self, length):
        return length / self.height()

    def nondim_pressure(self, pressure):
        return pressure / np.abs(self.applied_load())

    def numerical_consolidation_degree(self):
        sd = self.mdg.subdomains()[0]
        m_v = self.confined_compressibility()
        F = self.applied_load()
        t = self.time_manager.time
        if t == 0:
            return 0.0
        u_faces = self.face_displacement(sd)
        u_inf = m_v * self.height() * F
        return np.max(np.abs(u_faces[1::2])) / u_inf


class PseudoOneDimensionalColumn:
    def height(self):
        return self.params.get("height", 1.0) * self.units.convert_units(
            1, "m"
        )

    def set_domain(self) -> None:
        self._domain = Domain(
            {
                "xmin": 0.0,
                "xmax": self.height(),
                "ymin": 0.0,
                "ymax": self.height(),
            }
        )

    def meshing_arguments(self) -> dict:
        return {
            "cell_size_x": self.height(),
            "cell_size_y": self.height() / self.params.get("num_cells", 20),
        }

    def create_mdg(self):
        from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
        from porepy_tpu_torch.grids.structured import CartGrid

        args = self.meshing_arguments()
        ny = max(1, int(round(self.height() / args["cell_size_y"])))
        g = CartGrid([1, ny], physdims=[self.height(), self.height()])
        mdg = MixedDimensionalGrid()
        mdg.add_subdomains(g)
        mdg.compute_geometry()
        return mdg


class TerzaghiBoundaryConditionsMechanics:
    def applied_load(self):
        load = self.params.get("vertical_load", 6e8)
        return self.units.convert_units(load, "Pa")

    def bc_type_mechanics(self, sd) -> BoundaryConditionVectorial:
        boundary_faces = self.domain_boundary_sides(sd).all_bf
        bc = BoundaryConditionVectorial(sd, boundary_faces, "dir")
        bc.internal_to_dirichlet(sd)
        sides = self.domain_boundary_sides(sd)
        # Rollers on east/west (normal component fixed, tangential free),
        # Neumann (load) on the north, Dirichlet on the south.
        bc.is_neu[1, sides.east] = True
        bc.is_dir[1, sides.east] = False
        bc.is_neu[1, sides.west] = True
        bc.is_dir[1, sides.west] = False
        bc.is_neu[:, sides.north] = True
        bc.is_dir[:, sides.north] = False
        return bc

    def bc_values_stress(self, bg) -> np.ndarray:
        north = self.domain_boundary_sides(bg).north
        vals = np.zeros((2, bg.num_cells))
        vals[1, north] = -self.applied_load() * bg.cell_volumes[north]
        return vals.ravel("F")


class TerzaghiBoundaryConditionsFlow:
    def bc_type_darcy_flux(self, sd) -> BoundaryCondition:
        sides = self.domain_boundary_sides(sd)
        cond = np.asarray(sides.all_bf.size * ["neu"])
        cond[np.isin(sides.all_bf, np.where(sides.north)[0])] = "dir"
        return BoundaryCondition(sd, faces=sides.all_bf, cond=list(cond))


class TerzaghiInitialConditions:
    def ic_values_pressure(self, sd) -> np.ndarray:
        return self.applied_load() * np.ones(sd.num_cells)


class TerzaghiDataSaving:
    def collect_data(self) -> TerzaghiSaveData:
        sd = self.mdg.subdomains()[0]
        t = self.time_manager.time
        exact_p = self.exact_sol.pressure(sd.cell_centers[1], t)
        approx_p = np.asarray(
            self.equation_system.evaluate(self.pressure([sd]))
        )
        error_p = ConvergenceAnalysis.lp_error(
            sd, exact_p, approx_p, is_scalar=True, is_cc=True, relative=True
        )
        error_consol = np.abs(
            self.numerical_consolidation_degree()
            - self.exact_sol.consolidation_degree(t)
        )
        return TerzaghiSaveData(
            approx_pressure=approx_p,
            error_pressure=error_p,
            error_consolidation_degree=float(error_consol),
            time=t,
        )


class TerzaghiSolutionStrategy(SolutionStrategyBiot):
    def set_materials(self):
        super().set_materials()
        self.exact_sol = TerzaghiExactSolution(self)
        assert self.solid.specific_storage == 0
        assert self.solid.biot_coefficient == 1

    def _is_nonlinear_problem(self) -> bool:
        return False


class TerzaghiModel(
    PseudoOneDimensionalColumn,
    TerzaghiBoundaryConditionsFlow,
    TerzaghiBoundaryConditionsMechanics,
    TerzaghiInitialConditions,
    TerzaghiSolutionStrategy,
    TerzaghiUtils,
    TerzaghiDataSaving,
    BiotPoromechanics,
):
    """Terzaghi's consolidation problem on a pseudo-1d column."""
