"""Case 3 of the Berre et al. (2021) 3d flow benchmark through
porepy_tpu_torch on the CPU (``examples/flow_benchmark_3d_case_3.py``,
copied from porepy_tpu), on the coarse cut-tet lattice (6, 14, 6) that
``cases.fb3d3_lattice`` meshes (12,302 tets, 8 fractures, 4 intersection
lines; 14,936 dofs) and that both packages' models are given in place of
the refinement level's mesh:

- the grid equals porepy_tpu's to the bit,
- the first Newton system equals porepy_tpu's row by row, and the solution
  agrees with porepy_tpu's system solved by scipy,
- the checks of ``tests/functional/test_benchmark_3d_case_3.py`` (Table 5's
  effective permeabilities, the boundary specification, a finite and
  driven pressure), with the two-point flux that test uses,
- the ``fb3d3`` bench case on the port's ``device_gmres`` route with the
  plain kernel versions.

Refinement level 0 (47,900 dofs) runs on the card (``chip_smoke.py`` phase
28). The system is well conditioned beside Flemisch et al. case 4: two
direct solves of the two packages' systems differ by 3.6e-14 of the largest
value, so the solutions are held at 1e-10 and the device route at
``FB3D3_ROUTE_TOL``.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.examples.flow_benchmark_3d_case_3 import FlowBenchmark3dCase3Model as Case3Jax
from porepy_tpu.examples.flow_benchmark_3d_case_3 import solid_constants as solid_jax
from porepy_tpu_torch.applications.benchmarking import cases
from porepy_tpu_torch.applications.test_utils.benchmarks import EffectivePermeability
from porepy_tpu_torch.examples import FlowBenchmark3dCase3Model
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

torch.set_num_threads(1)

LATTICE = (6, 14, 6)
#: The device route (FGMRES to its relative tolerance, AMG on the pressure
#: block, the mortar block eliminated) against the host's direct solve,
#: relative to each field's largest value: 7.5e-12 (pressure) and 2.5e-11
#: (mortar fluxes) measured at this lattice; 1e-9 is 40 times the larger.
FB3D3_ROUTE_TOL = 1e-9


def _jax_grid():
    """porepy_tpu's cut-tet mesh of the lattice and its network, as
    ``cases.fb3d3_lattice`` makes the port's."""
    import os

    from porepy_tpu.fracs.cut_tet import cut_tet_grid
    from porepy_tpu.fracs.fracture_importer import network_3d_from_csv

    lib = os.path.join(os.path.dirname(pt_jax.__file__), "applications", "md_grids", "file_library",
                       "benchmark_3d_case_3")
    network = network_3d_from_csv(os.path.join(lib, "fracture_network.csv"))
    mdg = cut_tet_grid([f.pts for f in network.fractures], np.array(LATTICE), physdims=[1.0, 2.25, 1.0],
                       exact_boundary=False)
    mdg.compute_geometry()
    return mdg, network


def _jax_model(flux: str):
    """porepy_tpu's case 3 model on its own mesh of the lattice, prepared."""
    mdg, network = _jax_grid()

    class Model(Case3Jax):
        def set_geometry(self):
            self.mdg, self.fracture_network = mdg, network
            self.nd = 3
            self._domain = network.domain
            self._fractures = network.fractures
            pt_jax.set_local_coordinate_projections(self.mdg)
            self.set_well_network()

    m = Model({"material_constants": {"solid": solid_jax}, "flux_discretization": flux, "suppress_export": True})
    m.prepare_simulation()
    return m


@pytest.fixture(scope="module")
def model():
    """The port's case 3 on the lattice by the two-point flux (as
    ``tests/functional/test_benchmark_3d_case_3.py`` runs it), solved on
    the host route, its first Newton system kept (the builder's flux)."""
    grid = cases.fb3d3_lattice(LATTICE)
    Base, params = cases.build_flow_benchmark_3d_case_3(device="cpu", grid=grid)
    assert issubclass(Base, FlowBenchmark3dCase3Model)
    assert params["flux_discretization"] == "tpfa"
    params.update(linear_solver="scipy_sparse", times_to_export=[])

    class Model(EffectivePermeability, Base):
        pass

    m = Model(params)
    m.prepare_simulation()
    m._prepared = True
    m.first_system = m.equation_system.assemble()
    m.first_state = m.equation_system.get_variable_values(iterate_index=0)
    pt.run_time_dependent_model(m, params)
    return m


def test_grid_equals_porepy_tpus(model):
    """The lattice's 16 grids of porepy_tpu's mesher and the port's: the
    same cells, faces, nodes and mortar maps to the bit."""
    from test_torch_meshers import _same_mdg

    mdg_jax, _ = _jax_grid()
    assert [len(model.mdg.subdomains(dim=d)) for d in (3, 2, 1, 0)] == [1, 8, 4, 0]
    assert model.mdg.subdomains(dim=3)[0].num_cells == 12302
    _same_mdg(model.mdg, mdg_jax)


def test_first_system_and_solution_against_porepy_tpu(model):
    """The first Newton system (14,936 dofs) equals porepy_tpu's row by row
    within 1e-13 of the row's largest entry (1.5e-18 measured), the
    right-hand side within 1e-13 of its largest entry (4.8e-19), and the
    port's solution (its host route) within 1e-10 of the largest value of
    porepy_tpu's system solved by scipy (3.6e-14)."""
    m_jax = _jax_model("tpfa")
    es, es_jax = model.equation_system, m_jax.equation_system
    assert es.num_dofs() == es_jax.num_dofs() == 14936
    x0 = np.asarray(es_jax.get_variable_values(iterate_index=0))
    np.testing.assert_array_equal(model.first_state, x0)
    A, b = model.first_system
    A_jax, b_jax = es_jax.assemble()
    A, A_jax = sps.csr_matrix(A), sps.csr_matrix(A_jax)
    b, b_jax = np.asarray(b), np.asarray(b_jax)
    row_max = np.asarray(abs(A_jax).max(axis=1).todense()).ravel()
    assert np.all(row_max > 0)
    diff = np.asarray(abs(A - A_jax).max(axis=1).todense()).ravel()
    assert np.all(diff <= 1e-13 * row_max), (diff / row_max).max()
    assert np.abs(b - b_jax).max() <= 1e-13 * np.abs(b_jax).max()
    x_jax = x0 + spla.spsolve(A_jax.tocsc(), b_jax)
    x = es.get_variable_values(time_step_index=0)
    assert np.abs(x - x_jax).max() <= 1e-10 * np.abs(x_jax).max()


# -- tests/functional/test_benchmark_3d_case_3.py through the port -------------


def test_effective_tangential_permeability_values(model):
    """Table 5: matrix 1.0, fractures 1e2, intersections 1.0."""
    for sd in model.mdg.subdomains():
        val = model.equation_system.evaluate(model.effective_tangential_permeability([sd]))
        np.testing.assert_array_almost_equal(val, 1e2 if sd.dim == 2 else 1.0)


def test_effective_normal_permeability_values(model):
    """Table 5: 2e6 on 2d interfaces, 2e4 on 1d."""
    for intf in model.mdg.interfaces():
        val = model.equation_system.evaluate(model.effective_normal_permeability([intf]))
        np.testing.assert_array_almost_equal(val, 2e6 if intf.dim == 2 else 2e4)


def test_boundary_specification(model):
    """Inlet: total influx -1/3 through the middle third of the south
    boundary; outlet: zero pressure on the Dirichlet north bands."""
    bg, data_bg = model.mdg.boundaries(return_data=True, dim=2)[0]
    south = model.domain_boundary_sides(bg).south
    assert np.isclose(np.sum(data_bg[pt.ITERATE_SOLUTIONS]["darcy_flux"][0][south]), -1 / 3, atol=1e-5)
    north = model.domain_boundary_sides(bg).north
    assert np.isclose(np.sum(data_bg[pt.ITERATE_SOLUTIONS]["pressure"][0][north]), 0, atol=1e-5)


def test_pressure_field_finite_and_driven(model):
    p = model.equation_system.get_variable_values([model.pressure_variable], iterate_index=0)
    assert np.all(np.isfinite(p))
    assert p.max() - p.min() > 1e-3


# -- the fb3d3 bench case on the device route ----------------------------------


def test_fb3d3_case_on_the_device_route(model):
    """``cases.build_flow_benchmark_3d_case_3`` (registered as ``fb3d3``) on
    the lattice by the two-point flux on the device route (``device_gmres``
    with the plain kernel versions): the example's one step, 0 host
    fallbacks, the field split of refinement 0 (the pressure block on AMG,
    the mortar block eliminated), pressure and mortar fluxes within
    ``FB3D3_ROUTE_TOL`` of each field's largest value of the host route's."""
    assert cases.CASE_BUILDERS["fb3d3"] is cases.build_flow_benchmark_3d_case_3
    Model, params = cases.build_flow_benchmark_3d_case_3(device="cpu", grid=cases.fb3d3_lattice(LATTICE))
    assert params["linear_solver"] == "device_gmres" and params["flux_discretization"] == "tpfa"
    fallbacks = FALLBACK_COUNTER["count"]
    m = Model(params)
    pt.run_time_dependent_model(m, params)
    assert FALLBACK_COUNTER["count"] == fallbacks
    (solver,) = m._device_solvers.values()
    assert solver._builder.methods == ["amg", "eliminate"]
    es = m.equation_system
    assert np.all(np.isfinite(es.get_variable_values(time_step_index=0)))
    for name in ("pressure", "interface_darcy_flux"):
        a = es.get_variable_values([name], time_step_index=0)
        b = model.equation_system.get_variable_values([name], time_step_index=0)
        assert np.abs(a - b).max() <= FB3D3_ROUTE_TOL * np.abs(b).max(), name


def test_fold_width_of_the_two_point_flux():
    """``fold_width.folded_block``: the pressure block that the field split
    hands to SA-AMG at the lattice by TPFA, the mortar block eliminated
    (13,171 rows: 12,302 tets and 869 fracture and line cells, 4.9
    nonzeros a row, the widest 7). MPFA's fold of the same case is 2,164 a
    row (``cases.build_flow_benchmark_3d_case_3``)."""
    from porepy_tpu_torch.applications.benchmarking.fold_width import folded_block

    assert folded_block("tpfa", LATTICE) == {"n": 13171, "nnz": 65087, "widest": 7}
