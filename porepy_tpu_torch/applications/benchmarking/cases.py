"""Model + params builders for the benchmark configurations.

``build_case(name)`` returns ``(model, params)`` with data saving
suppressed, ready for ``pt.run_time_dependent_model``.

Configurations ported so far:
  - ``3d``: compressible single-phase flow on a 3d Cartesian 32^3 grid, no
    fractures, whole-boundary Dirichlet; pass ``dense_precond=True`` in
    the params for the dense frozen block inverse (K6) that ``porepy_tpu``
    used on the TPU at this size.
  - ``md``/``md256``: Mpfa single-phase md flow, 2d, 6 crossing
    fractures, mortar coupling, 0d intersections (1/128 and 1/256), run as
    fused 8-step time blocks with the device block-preconditioned FGMRES.
  - ``biot``: 2d poromechanics (MPSA/Biot displacement, MPFA pressure) on
    a 1/64 Cartesian grid, compressed from the north side, as fused 8-step
    time blocks with the device block-preconditioned FGMRES (SA-AMG with
    rigid-body modes on the displacement, fixed-stress stabilization).

The other ``porepy_tpu`` cases (``tracer``, ``thm``, ``berre3d``) follow
in later slices of the port.
"""

from __future__ import annotations

import numpy as np

FRACTURES_2D = [
    np.array([[0.125, 0.875], [0.25, 0.25]]),
    np.array([[0.125, 0.875], [0.5, 0.5]]),
    np.array([[0.125, 0.875], [0.75, 0.75]]),
    np.array([[0.25, 0.25], [0.125, 0.875]]),
    np.array([[0.5, 0.5], [0.125, 0.875]]),
    np.array([[0.75, 0.75], [0.125, 0.875]]),
]


def _mat_flow():
    import porepy_tpu_torch as pt

    return {
        "solid": pt.SolidConstants(
            permeability=1.0,
            porosity=0.1,
            residual_aperture=0.01,
            normal_permeability=1.0,
        ),
        "fluid": pt.FluidComponent(
            compressibility=1e-6, viscosity=1e-3, density=1000.0
        ),
    }


def _nosave(base):
    class NoSave(base):
        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    return NoSave


def build_md_flow(cell_size: float = 1.0 / 128, device: str = "cuda"):
    """The md flow case at ``cell_size`` on ``device``."""
    import porepy_tpu_torch as pt

    class Model(_nosave(pt.SinglePhaseFlow)):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(f) for f in FRACTURES_2D]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "material_constants": _mat_flow(),
        "time_manager": pt.TimeManager([0, 26.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "fused_time_steps": 8,
        "fused_commit_states": "tail",
        "device": device,
    }
    return Model, params


def build_3d_flow(cell_size: float = 1.0 / 32, device: str = "cuda"):
    """The 3d single-phase flow case at ``cell_size`` on ``device``."""
    import porepy_tpu_torch as pt

    class Model(_nosave(pt.SinglePhaseFlow)):
        def set_domain(self):
            self._domain = pt.Domain(
                {"xmin": 0.0, "xmax": 1.0, "ymin": 0.0, "ymax": 1.0,
                 "zmin": 0.0, "zmax": 1.0}
            )

        def set_fractures(self):
            self._fractures = []

        def bc_type_darcy_flux(self, sd):
            return pt.BoundaryCondition(
                sd, self.domain_boundary_sides(sd).all_bf, "dir"
            )

        def bc_values_pressure(self, bg):
            return 1.0e5 + 1.0e4 * (1.0 - bg.cell_centers[0])

        def ic_values_pressure(self, sd):
            return np.full(sd.num_cells, 2.0e5)

        def initial_condition(self):
            super().initial_condition()
            for sd in self.mdg.subdomains():
                self.equation_system.set_variable_values(
                    self.ic_values_pressure(sd),
                    ["pressure"],
                    time_step_index=0,
                    iterate_index=0,
                )

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "material_constants": {
            "solid": pt.SolidConstants(permeability=1.0, porosity=0.1),
            "fluid": pt.FluidComponent(
                compressibility=1e-6, viscosity=1e-3, density=1000.0
            ),
        },
        "time_manager": pt.TimeManager([0, 26.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "fused_time_steps": 8,
        "fused_commit_states": "tail",
        "device": device,
    }
    return Model, params


def build_biot(cell_size: float = 1.0 / 64, device: str = "cuda"):
    """The 2d poromechanics case at ``cell_size`` on ``device``."""
    import porepy_tpu_torch as pt

    class Model(_nosave(pt.Poromechanics)):
        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[1, north] = -0.001
            return vals.ravel("F")

        def bc_values_pressure(self, bg):
            return np.zeros(bg.num_cells)

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "material_constants": {
            "solid": pt.SolidConstants(
                shear_modulus=1.0,
                lame_lambda=1.0,
                permeability=1e-2,
                porosity=0.1,
                biot_coefficient=0.8,
                specific_storage=0.1,
            ),
            "fluid": pt.FluidComponent(
                viscosity=1.0, density=1.0, compressibility=1e-2
            ),
        },
        "time_manager": pt.TimeManager([0, 26.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "fused_time_steps": 8,
        "fused_commit_states": "tail",
        "device": device,
    }
    return Model, params


CASE_BUILDERS = {
    "3d": build_3d_flow,
    "biot": build_biot,
    "md": build_md_flow,
    "md256": lambda: build_md_flow(1.0 / 256),
}


def build_case(name: str):
    """Instantiate the case's model: ``(model, params)``."""
    cls, params = CASE_BUILDERS[name]()
    return cls(params), params
