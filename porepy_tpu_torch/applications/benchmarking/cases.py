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
  - ``tracer``: single-phase two-component transport on the unit square
    with two orthogonal fractures (1/64, 26 steps of 60 s); the advective
    fluxes are upwinded inside the residual by the K15 kernels
    (``kernels/csrc/upwind.cu``). ``device_gmres`` only: the Jacobi Krylov
    route of ``porepy_tpu`` diverges on this case.
  - ``thm``: thermoporomechanics with frictional contact in the unit cube
    at cell size 1/16 (25,120 dofs), three horizontal fractures and one
    vertical, 10 steps of 1.0. The fracture MPFA is rediscretized every
    Newton iteration, so the case runs the host Newton loop (each
    iteration assembled and solved on the card), with dense frozen block
    inverses (K6) in the field split.
  - ``berre3d``: Berre et al. (2021) 3d benchmark case 2, md single-phase
    flow on the native fracture-conforming tet mesh (a 16^3 lattice at
    refinement level 0: 31,578 dofs in 106 subdomains), 10 steps of 1.0 in
    fused 4-step blocks.
  - ``fb2d4``: Flemisch et al. (2018) 2d flow benchmark case 4, the
    published 63 fractures on 700 m x 600 m, simplex cells of 5 m from the
    native mesher (43,790 dofs in 149 subdomains and 233 interfaces), the
    example's fluid and time manager (one step of an incompressible fluid:
    one linear solve) on the device block-preconditioned FGMRES.
  - ``fb3d3``: Berre et al. (2021) 3d flow benchmark case 3, eight
    fractures in the box 1 x 2.25 x 1 on the native cut-tet mesh (a
    (9, 20, 9) lattice at refinement level 0: 47,900 dofs in 16 subdomains
    and 22 interfaces), a fracture/matrix permeability contrast of 1e4,
    the example's one step of an incompressible fluid on the device
    block-preconditioned FGMRES.
  - ``build_darcy_ad`` (not in :data:`CASE_BUILDERS`): ``DarcysLawAd`` with
    the cubic law and ``k(p)`` on one fracture at 1/128, the one path whose
    flux and pressure trace run the K14 kernels (``kernels/csrc/tpfa_ad.cu``).

These are all of ``porepy_tpu``'s bench cases, and ``fb2d4`` and ``fb3d3``.

Beside the builders, the inputs that ``chip_smoke.py``, the kernel checks
and the tests share: K10's region batches (:func:`region_batches`, the
chunks that :func:`capture_chunks` records from biot's discretizations),
the Biot problem of a grid (:func:`biot_problem`, :func:`biot_matrices`),
berre3d's small grid (:func:`berre3d_lattice_mdg`, run by :func:`berre3d_on`),
fb3d3's (:func:`fb3d3_lattice`),
the route of the region solves (:func:`local_solves`), and K16's table,
points and system (:func:`lookup_inputs`, :func:`table_system`).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np

FRACTURES_2D = [
    np.array([[0.125, 0.875], [0.25, 0.25]]),
    np.array([[0.125, 0.875], [0.5, 0.5]]),
    np.array([[0.125, 0.875], [0.75, 0.75]]),
    np.array([[0.25, 0.25], [0.125, 0.875]]),
    np.array([[0.5, 0.5], [0.125, 0.875]]),
    np.array([[0.75, 0.75], [0.125, 0.875]]),
]

#: K16's table, points and system (``chip_smoke.py`` phase 16): a 201 x 201
#: table of ``(p, T)``, 2048² points, a 1024² grid.
TABLE = ([1e5, 280.0], [5e7, 480.0], [201, 201])
N_POINTS = 2048 * 2048
NX_TABLE = 1024
BIOT_MECH_KEYS = ("stress", "bound_stress", "bound_displacement_cell", "bound_displacement_face")
BIOT_COUPLING_KEYS = (
    "scalar_gradient", "displacement_divergence", "boundary_displacement_divergence",
    "mpsa_consistency", "bound_displacement_pressure",
)


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


def build_tracer(cell_size: float = 1.0 / 64, device: str = "cuda"):
    """The tracer transport case at ``cell_size`` on ``device``."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.examples.tracer_flow import TracerFlowModel

    Model = _nosave(TracerFlowModel)
    params = {
        "material_constants": {
            "solid": pt.SolidConstants(
                porosity=0.1, permeability=1e-7, normal_permeability=1e-7,
                residual_aperture=1e-2,
            ),
        },
        "fracture_indices": [0, 1],
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "time_manager": pt.TimeManager([0, 26 * 60.0], 60.0, constant_dt=True),
        "max_iterations": 30,
        "nl_convergence_tol": 1e-8,
        "nl_convergence_tol_res": 1e-8,
        "linear_solver": "device_gmres",
        "fused_time_steps": 8,
        "fused_commit_states": "tail",
        "device": device,
    }
    return Model, params


def build_darcy_ad(cell_size: float = 1.0 / 128, device: str = "cuda"):
    """The differentiable-permeability flow model at ``cell_size`` on
    ``device``: ``DarcysLawAd`` with cubic-law fracture permeability and
    ``k(p) = k0 (1 + 0.3 p)`` in the matrix and the fracture, one fracture,
    TPFA, the md case's materials and solver parameters."""
    import porepy_tpu_torch as pt

    class PressureDependentPerm:
        def permeability(self, subdomains):
            size = sum(sd.num_cells for sd in subdomains)
            k0 = pt.ad.wrap_as_dense_ad_array(self.solid.permeability, size)
            k = k0 * (pt.ad.Scalar(1.0) + pt.ad.Scalar(0.3) * self.pressure(subdomains))
            return self.isotropic_second_order_tensor(subdomains, k)

    class Model(
        PressureDependentPerm,
        pt.DarcysLawAd,
        pt.constitutive_laws.CubicLawPermeability,
        _nosave(pt.SinglePhaseFlow),
    ):
        def set_fractures(self):
            self._fractures = [pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]]))]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[0]

        def darcy_flux_discretization(self, subdomains):
            return pt.ad.TpfaAd(self.darcy_keyword, subdomains, self.mdg)

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


def build_thm_contact_3d(cell_size: float = 1.0 / 16, device: str = "cuda"):
    """The 3d thermoporomechanics case with frictional contact at
    ``cell_size`` on ``device``: the unit cube with three horizontal
    fractures (z = 0.25, 0.5, 0.75) and one vertical (x = 0.5), the north
    side sheared and compressed, a pressure and a temperature gradient on
    the boundary."""
    import porepy_tpu_torch as pt

    class Model(_nosave(pt.Thermoporomechanics)):
        def set_domain(self):
            self._domain = pt.Domain(
                {"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1,
                 "zmin": 0, "zmax": 1}
            )

        def set_fractures(self):
            f = []
            for z in (0.25, 0.5, 0.75):
                f.append(np.array(
                    [[0.25, 0.75, 0.75, 0.25], [0.25, 0.25, 0.75, 0.75],
                     [z, z, z, z]]
                ))
            f.append(np.array(
                [[0.5, 0.5, 0.5, 0.5], [0.25, 0.25, 0.75, 0.75],
                 [0.25, 0.75, 0.75, 0.25]]
            ))
            self._fractures = f

        def bc_values_displacement(self, bg):
            vals = np.zeros((self.nd, bg.num_cells))
            north = self.domain_boundary_sides(bg).north
            vals[0, north] = 0.01
            vals[1, north] = -0.005
            return vals.ravel("F")

        def bc_values_pressure(self, bg):
            return 1e-3 * (1.0 - bg.cell_centers[1])

        def bc_values_temperature(self, bg):
            return 1.0 + 0.1 * bg.cell_centers[0]

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": cell_size},
        "material_constants": {
            "solid": pt.SolidConstants(
                residual_aperture=0.01,
                normal_permeability=1.0,
                permeability=1.0,
                porosity=0.1,
                thermal_expansion=1e-4,
                thermal_conductivity=1.0,
                specific_heat_capacity=1.0,
                biot_coefficient=0.8,
            ),
            "fluid": pt.FluidComponent(
                compressibility=1e-3,
                viscosity=1.0,
                density=1.0,
                thermal_conductivity=0.5,
                specific_heat_capacity=1.0,
                thermal_expansion=2e-4,
            ),
        },
        "time_manager": pt.TimeManager([0, 10.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        # The fracture MPFA is rediscretized every Newton iteration, so no
        # step runs in a fused block; the chunk is porepy_tpu's.
        "fused_time_steps": 2,
        "fused_commit_states": "tail",
        # Dense frozen block inverses (K6). The contact equations and the
        # tractions pair with no AMG or elimination slot of the field split,
        # so they fall into its trailing block, whose preconditioner without
        # dense inverses is damped l1-Jacobi sweeps
        # (device_solver._jacobi_sweeps), and the sweeps barely contract on
        # the semismooth contact block: porepy_tpu's record of this case at
        # 1/16 is 560 Krylov iterations stalled at |r| 4.2 from |b| 5.5 and
        # a host fallback solve, against 56 iterations to 1e-8 with the
        # block inverted densely; at 1/4 the port's last solve of the first
        # step takes 262 iterations with the sweeps and 73 with the dense
        # inverses.
        "dense_precond": True,
        "device": device,
    }
    return Model, params


def build_berre3d(refinement_level: int = 0, device: str = "cuda"):
    """Berre et al. (2021) 3d benchmark case 2 at ``refinement_level`` on
    ``device``: md single-phase flow on the native tet mesh
    (``mdg_library.benchmark_3d_case_2``), a pressure gradient along x on
    the boundary."""
    from porepy_tpu_torch.applications.md_grids.mdg_library import benchmark_3d_case_2

    mdg, _network = benchmark_3d_case_2(refinement_level=refinement_level)
    return berre3d_on(mdg, device)


def _fracture_csv(case: str) -> str:
    """The fracture network file of a case of ``mdg_library``'s file library."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "md_grids", "file_library", case, "fracture_network.csv")


def berre3d_lattice_mdg(lattice: int):
    """Berre et al. 3d case 2's fracture network on a ``lattice``^3 cube
    lattice of tets (``benchmark_3d_case_2`` meshes 16^3 at refinement 0):
    the small grid on which the tests and the card-against-host check run
    the case through :func:`berre3d_on`."""
    from porepy_tpu_torch.fracs.fracture_importer import network_3d_from_csv
    from porepy_tpu_torch.fracs.structured_simplex import tet_cart_grid

    network = network_3d_from_csv(_fracture_csv("benchmark_3d_case_2"))
    mdg = tet_cart_grid([f.pts for f in network.fractures], np.array([lattice] * 3), physdims=[1.0, 1.0, 1.0])
    mdg.compute_geometry()
    return mdg


def berre3d_on(mdg, device: str = "cuda"):
    """The berre3d case's model class and params on the grid ``mdg``."""
    import porepy_tpu_torch as pt

    class Model(_nosave(pt.SinglePhaseFlow)):
        def set_geometry(self):
            self.mdg = mdg
            self.nd = 3
            self._domain = pt.Domain(
                {"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1,
                 "zmin": 0, "zmax": 1}
            )
            self.set_well_network()

        def bc_values_pressure(self, bg):
            return 1.0e5 + 1.0e4 * (1.0 - bg.cell_centers[0])

    params = {
        "material_constants": {
            "solid": pt.SolidConstants(
                permeability=1.0,
                porosity=0.1,
                residual_aperture=1e-2,
                normal_permeability=1.0,
            ),
            "fluid": pt.FluidComponent(
                compressibility=1e-6, viscosity=1e-3, density=1000.0
            ),
        },
        "time_manager": pt.TimeManager([0, 10.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "fused_time_steps": 4,
        "fused_commit_states": "tail",
        "device": device,
    }
    return Model, params


def build_flow_benchmark_2d_case_4(cell_size: float = 5.0, device: str = "cuda"):
    """Flemisch et al. (2018) 2d flow benchmark case 4 at ``cell_size`` (m)
    on ``device``: :class:`FlowBenchmark2dCase4Model` with its published
    solid constants and boundary pressures (4e6 Pa west, 1e6 Pa east), its
    default fluid and time manager, solved by ``device_gmres``."""
    from porepy_tpu_torch.examples.flow_benchmark_2d_case_4 import (
        FlowBenchmark2dCase4Model,
        solid_constants,
    )

    params = {
        "cell_size": cell_size,
        "material_constants": {"solid": solid_constants},
        "linear_solver": "device_gmres",
        "device": device,
    }
    return _nosave(FlowBenchmark2dCase4Model), params


def build_flow_benchmark_3d_case_3(refinement_level: int = 0, device: str = "cuda", grid=None):
    """Berre et al. (2021) 3d flow benchmark case 3 at ``refinement_level``
    on ``device``: :class:`FlowBenchmark3dCase3Model` with its published
    solid constants, boundary bands and time manager, solved by
    ``device_gmres``. ``grid``, an ``(mdg, network)`` pair as
    :func:`fb3d3_lattice` gives it, replaces the refinement level's mesh.

    The flux is the two-point one, as porepy_tpu's
    ``tests/functional/test_benchmark_3d_case_3.py`` runs refinement 0 on
    ``device_gmres``; the example's default is MPFA. MPFA couples the
    mortar fluxes of each fracture side through its pressure traces, so
    eliminating the mortar block folds one dense inverse per fracture into
    the pressure block that SA-AMG is built on: 2,164 nonzeros a row on the
    (6, 14, 6) lattice against the two-point flux's 4.9
    (:mod:`.fold_width`)."""
    from porepy_tpu_torch.examples.flow_benchmark_3d_case_3 import (
        FlowBenchmark3dCase3Model,
        solid_constants,
    )

    Model = _nosave(FlowBenchmark3dCase3Model)
    if grid is not None:
        import porepy_tpu_torch as pt

        class OnGrid(Model):
            def set_geometry(self):
                self.mdg, self.fracture_network = grid
                self.nd = 3
                self._domain = self.fracture_network.domain
                self._fractures = self.fracture_network.fractures
                pt.set_local_coordinate_projections(self.mdg)
                self.set_well_network()

        Model = OnGrid
    params = {
        "refinement_level": refinement_level,
        "material_constants": {"solid": solid_constants},
        "flux_discretization": "tpfa",
        "linear_solver": "device_gmres",
        "device": device,
    }
    return Model, params


def fb3d3_lattice(nx):
    """Berre et al. 3d case 3's fracture network on the cut-tet lattice
    ``nx`` (``benchmark_3d_case_3`` meshes (9, 20, 9) at refinement 0):
    ``(mdg, network)``, the small grid on which the tests and the
    card-against-host check run the case. (6, 14, 6) gives 12,302 tets;
    (3, 7, 3) and (4, 9, 4) are too coarse for the fractures to match mesh
    faces."""
    from porepy_tpu_torch.fracs.cut_tet import cut_tet_grid
    from porepy_tpu_torch.fracs.fracture_importer import network_3d_from_csv

    network = network_3d_from_csv(_fracture_csv("benchmark_3d_case_3"))
    mdg = cut_tet_grid([f.pts for f in network.fractures], np.array(nx), physdims=[1.0, 2.25, 1.0],
                       exact_boundary=False)
    mdg.compute_geometry()
    return mdg, network


CASE_BUILDERS = {
    "3d": build_3d_flow,
    "biot": build_biot,
    "tracer": build_tracer,
    "md": build_md_flow,
    "md256": lambda: build_md_flow(1.0 / 256),
    "thm": build_thm_contact_3d,
    "berre3d": build_berre3d,
    "fb2d4": build_flow_benchmark_2d_case_4,
    "fb3d3": build_flow_benchmark_3d_case_3,
}


def build_case(name: str):
    """Instantiate the case's model: ``(model, params)``."""
    cls, params = CASE_BUILDERS[name]()
    return cls(params), params


# -- K10's region batches and K16's table -------------------------------------------


def capture_chunks(run) -> dict:
    """The dense ``(a, rhs, w)`` chunks that ``iter_solve_and_contract``
    builds while ``run()`` discretizes by the host route: the first chunk of
    each ``(n, m, q)`` bucket."""
    from porepy_tpu_torch.numerics.fv import local_solves as ls

    chunks = {}
    solve = ls._solve_chunk

    def record(a, rhs, w):
        chunks.setdefault((a.shape[1], rhs.shape[2], w.shape[1]), (a, rhs, w))
        return ls._solve_chunk_host(a, rhs, w)

    ls._solve_chunk = record
    try:
        run()
    finally:
        ls._solve_chunk = solve
    return chunks


def biot_problem(nx):
    """Grid and data of a ``Biot("mechanics")`` discretization on a unit
    Cartesian grid, with the inputs of the Biot matrix parity test: seeded
    moduli, alternating Dirichlet/Neumann boundary faces."""
    import porepy_tpu_torch as pt

    g = pt.CartGrid(list(nx), [1.0] * len(nx))
    g.compute_geometry()
    rng = np.random.default_rng(5 + len(nx))
    nc = g.num_cells
    bf = g.get_boundary_faces()
    d = pt.initialize_data(
        {},
        "mechanics",
        {
            "fourth_order_tensor": pt.FourthOrderTensor(rng.uniform(0.5, 2.0, nc), rng.uniform(0.5, 2.0, nc)),
            "bc": pt.BoundaryConditionVectorial(g, bf, ["dir" if i % 2 == 0 else "neu" for i in range(bf.size)]),
            "scalar_vector_mappings": {"flow": 0.8},
        },
    )
    return g, d


def biot_matrices(g, d) -> dict:
    """``Biot("mechanics").discretize(g, d)``'s matrices by name."""
    import porepy_tpu_torch as pt

    pt.Biot("mechanics").discretize(g, d)
    md = d[pt.DISCRETIZATION_MATRICES]["mechanics"]
    out = {k: md[k] for k in BIOT_MECH_KEYS}
    out.update({k: md[k]["flow"] for k in BIOT_COUPLING_KEYS})
    return out


def region_batches(dev) -> list:
    """``(source, (n, m, q), (a, rhs, w))`` numpy batches: the first chunk of
    each bucket of biot 1/64's discretization and of the Biot discretization
    of a 3d 16³ grid, a synthetic batch whose first region needs a row swap
    at the first step, and one that runs on the device workspace."""
    Model, params = build_biot(1.0 / 64, device=str(dev))
    batches = [("biot 1/64", k, v) for k, v in capture_chunks(lambda: Model(params).prepare_simulation()).items()]
    g3, d3 = biot_problem([16, 16, 16])
    batches += [("biot 3d 16^3", k, v) for k, v in capture_chunks(lambda: biot_matrices(g3, d3)).items()]
    gen = np.random.default_rng(11)
    for B, n, m, q, what in ((64, 20, 12, 20, "zero leading entry"), (3, 180, 20, 30, "device workspace")):
        a = gen.standard_normal((B, n, n)) + 0.5 * n * np.eye(n)
        a *= 10.0 ** gen.uniform(-3, 3, (B, n, 1))
        a[0, 0, 0] = 0.0
        batches.append(("synthetic, " + what, (n, m, q),
                        (a, gen.standard_normal((B, n, m)), gen.standard_normal((B, q, n)))))
    return batches


def table_fn(p, T):
    return np.log(p + 1e6) * np.exp(-T / 300.0) + 1e-8 * p * np.sin(T / 20.0)


def table_system(nx: int, device, rule=None):
    """``tab(p, T) = 0`` on an ``nx`` x ``nx`` grid, ``(es, op, fun)``: the
    201 x 201 table, states drawn a tenth of the span beyond each side of
    it; ``rule(fun)`` replaces the function's dual rule."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid

    g = pt.CartGrid([nx, nx], physdims=[1.0, 1.0])
    g.compute_geometry()
    mdg = MixedDimensionalGrid()
    mdg.add_subdomains(g)
    mdg.compute_geometry()
    es = pt.ad.EquationSystem(mdg, device=device)
    p = es.create_variables("pressure", dof_info={"cells": 1}, subdomains=[g])
    T = es.create_variables("temperature", dof_info={"cells": 1}, subdomains=[g])
    rng = np.random.default_rng(16)
    (lo_p, lo_T), (hi_p, hi_T), _ = TABLE
    es.set_variable_values(rng.uniform(lo_p - 0.1 * (hi_p - lo_p), hi_p + 0.1 * (hi_p - lo_p), g.num_cells),
                           ["pressure"], iterate_index=0)
    es.set_variable_values(rng.uniform(lo_T - 0.1 * (hi_T - lo_T), hi_T + 0.1 * (hi_T - lo_T), g.num_cells),
                           ["temperature"], iterate_index=0)
    fun = pt.ad.InterpolatedFunction(table_fn, "tab", *TABLE)
    if rule is not None:
        fun.func.dual_rule = rule(fun)
    op = fun(p, T)
    op.set_name("table_equation")
    es.set_equation(op, [g], {"cells": 1})
    return es, op, fun


def lookup_inputs(dev):
    """Phase 16's table on ``dev`` and its points: ``(table, x (2, N), dx
    (4, 2, N))``, a tenth of the span beyond each side of the table."""
    import torch

    import porepy_tpu_torch as pt

    fun = pt.ad.InterpolatedFunction(table_fn, "tab", *TABLE)
    tab = fun.device_table(dev)
    rng = np.random.default_rng(17)
    lo, hi = np.array(TABLE[0]), np.array(TABLE[1])
    span = hi - lo
    x = torch.tensor(rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (N_POINTS, 2)).T.copy(), device=dev)
    dx = torch.tensor(rng.standard_normal((4, 2, N_POINTS)) * span[None, :, None] * 1e-3, device=dev)
    return tab, x, dx


@contextmanager
def local_solves(route: str):
    """Region solves by ``route`` inside the block: ``"k10"`` sets
    ``PPT_LOCAL_SOLVE_DEVICE=1`` and restores it after, ``"host"`` clears
    it."""
    before = os.environ.pop("PPT_LOCAL_SOLVE_DEVICE", None)
    if route == "k10":
        os.environ["PPT_LOCAL_SOLVE_DEVICE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PPT_LOCAL_SOLVE_DEVICE", None)
        if before is not None:
            os.environ["PPT_LOCAL_SOLVE_DEVICE"] = before
