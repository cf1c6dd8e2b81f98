"""The Flemisch et al. (2018) 2d flow benchmark examples through
porepy_tpu_torch on the CPU (``examples/flow_benchmark_2d_case_{1,3,4}.py``
and ``applications/test_utils/benchmarks.py``, copied from porepy_tpu):
the checks of ``tests/examples/test_flow_benchmarks.py`` and
``tests/functional/test_benchmark_2d_case_3.py`` through the port, case 4's
first Newton system at 20 m against porepy_tpu's (both packages in one
process) and its solution, and the ``fb2d4`` bench case on the device
route (the plain kernel versions) at 40 m.

Case 4's system is ill conditioned (1-norm condition estimate ~1.3e26 at
20 m: matrix permeability 1e-14, fracture permeability 1e-8, aperture 1e-2),
so two direct solves of the same system agree only to ~8.1e-7 of the
largest pressure: the bit-level checks go on the assembled system, the
solutions are held to a tolerance above that spread."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

import porepy_tpu_torch as pt
from porepy_tpu.examples.flow_benchmark_2d_case_4 import FlowBenchmark2dCase4Model as Case4Jax
from porepy_tpu.examples.flow_benchmark_2d_case_4 import solid_constants as solid_jax
from porepy_tpu_torch.applications.benchmarking import cases
from porepy_tpu_torch.applications.test_utils.benchmarks import EffectivePermeability
from porepy_tpu_torch.examples import (
    FlowBenchmark2dCase1Model,
    FlowBenchmark2dCase3aModel,
    FlowBenchmark2dCase3bModel,
    FlowBenchmark2dCase4Model,
    solid_constants_conductive_fractures,
)
from porepy_tpu_torch.examples.flow_benchmark_2d_case_3 import solid_constants as solid_constants_3
from porepy_tpu_torch.examples.flow_benchmark_2d_case_4 import (
    benchmark_2d_case_4_fractures,
    solid_constants,
)
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER

torch.set_num_threads(1)

#: Case 4's solutions against each other, relative to each field's largest
#: value: direct solves (scipy) of porepy_tpu's and the port's systems,
#: equal to 2.2e-16, differ by 8.1e-7 (pressure) and 2.9e-6 (mortar fluxes)
#: at 20 m, by 7.8e-7 and 5.3e-6 at 40 m; the port's host and device routes
#: by 1.3e-7 and 2.2e-7 at 20 m, 8.2e-7 and 4.8e-6 at 40 m.
CASE4_SOLUTION_TOL = 1e-5


# -- tests/examples/test_flow_benchmarks.py through the port -------------------


def test_case1_conductive_runs_and_fracture_conducts():
    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 1 / 16},
        "material_constants": {"solid": solid_constants_conductive_fractures},
        "suppress_export": True,
        "flux_discretization": "tpfa",
        "device": "cpu",
    }
    m = FlowBenchmark2dCase1Model(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert np.all(np.isfinite(p))
    sd = m.mdg.subdomains(dim=2)[0]
    p_mat = p[: sd.num_cells]
    x = sd.cell_centers[0]
    assert p_mat[x < 0.25].mean() > p_mat[x > 0.75].mean() > 0.99


def test_case3a_runs_with_blocking_fractures():
    params = {
        "grid_type": "simplex",
        "meshing_arguments": {"cell_size": 0.15},
        "material_constants": {"solid": pt.SolidConstants(residual_aperture=1e-4)},
        "suppress_export": True,
        "device": "cpu",
    }
    m = FlowBenchmark2dCase3aModel(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert p.min() > 1.0 - 1e-6 and p.max() < 4.0 + 1e-6
    sd = m.mdg.subdomains(dim=2)[0]
    p_mat = p[: sd.num_cells]
    y = sd.cell_centers[1]
    assert p_mat[y > 0.75].mean() > p_mat[y < 0.25].mean()


def test_case4_geometry_loads():
    fracs = benchmark_2d_case_4_fractures()
    assert len(fracs) == 63
    pts = np.hstack([f.pts for f in fracs])
    assert pts[0].max() <= 700.0 and pts[1].max() <= 600.0
    assert solid_constants.fracture_permeability == 1e-8


# -- tests/functional/test_benchmark_2d_case_3.py through the port -------------

BLOCKING = [3, 4]


class Model3a(EffectivePermeability, FlowBenchmark2dCase3aModel):
    pass


class Model3b(EffectivePermeability, FlowBenchmark2dCase3bModel):
    pass


@pytest.fixture(scope="module", params=["tpfa", "mpfa"])
def flux_discretization(request):
    return request.param


@pytest.fixture(scope="module", params=["a", "b"])
def case(request):
    return request.param


@pytest.fixture(scope="module")
def model(flux_discretization, case):
    params = {
        "material_constants": {"solid": solid_constants_3},
        "grid_type": "simplex",
        "meshing_arguments": {"cell_size": 0.1},
        "flux_discretization": flux_discretization,
        "times_to_export": [],
        "device": "cpu",
    }
    cls = Model3a if case == "a" else Model3b
    m = cls(params)
    pt.run_time_dependent_model(m, params)
    return m


def test_effective_tangential_permeability(model):
    """2d: 1.0; conductive 1d fractures: 1.0; blocking (frac 3, 4): 1e-8."""
    for sd in model.mdg.subdomains():
        val = model.equation_system.evaluate(model.effective_tangential_permeability([sd]))
        if sd.dim == 2:
            np.testing.assert_array_almost_equal(val, 1.0)
        elif sd.dim == 1:
            np.testing.assert_array_almost_equal(val, 1e-8 if sd.frac_num in BLOCKING else 1.0)


def test_effective_normal_permeability(model):
    """Conductive 1d: 2e8; blocking 1d: 2; conductive 0d: 2e4; 0d touching
    a blocking fracture: 4e-4."""
    for intf in model.mdg.interfaces():
        val = model.equation_system.evaluate(model.effective_normal_permeability([intf]))
        _sd_high, sd_low = model.mdg.interface_to_subdomain_pair(intf)
        if intf.dim == 1:
            np.testing.assert_array_almost_equal(val, 2 if sd_low.frac_num in BLOCKING else 2e8)
        else:
            interfaces_lower = model.subdomains_to_interfaces([sd_low], [1])
            neighbors = model.interfaces_to_subdomains(interfaces_lower)
            blocking = [sd for sd in neighbors if sd.dim == 1 and sd.frac_num in BLOCKING]
            np.testing.assert_array_almost_equal(val, 4e-4 if blocking else 2e4)


def test_boundary_specification(model):
    """3a drives p=4 north / p=1 south; 3b p=4 west / p=1 east."""
    bg, data_bg = model.mdg.boundaries(return_data=True, dim=1)[0]
    sides = model.domain_boundary_sides(bg)
    p_bg = data_bg[pt.ITERATE_SOLUTIONS]["pressure"][0]
    if isinstance(model, Model3a):
        np.testing.assert_array_almost_equal(p_bg[sides.north], 4)
        np.testing.assert_array_almost_equal(p_bg[sides.south], 1)
    else:
        np.testing.assert_array_almost_equal(p_bg[sides.west], 4)
        np.testing.assert_array_almost_equal(p_bg[sides.east], 1)


def test_pressure_between_boundary_values(model):
    """The solved matrix pressure lies in the driven range [1, 4]."""
    p = model.equation_system.get_variable_values([model.pressure_variable], iterate_index=0)
    assert np.all(np.isfinite(p))
    assert p.min() > 1.0 - 1e-6 and p.max() < 4.0 + 1e-6


# -- case 4 against porepy_tpu --------------------------------------------------


def _case4(cls, **extra):
    params = {"cell_size": 20.0, "material_constants": {"solid": solid_constants}, "suppress_export": True}
    params.update(extra)
    m = cls(params)
    m.prepare_simulation()
    m._prepared = True
    return m


def test_case4_first_system_and_solution_against_porepy_tpu():
    """Case 4 at 20 m (4,594 dofs, 149 subdomains, 233 interfaces): the
    first Newton system assembled by the port (host route) equals
    porepy_tpu's row by row within 1e-13 of the row's largest entry, the
    right-hand side within 1e-13 of its largest entry (2.2e-16 and 3.0e-16
    measured), and the port's solution (its run on the host route)
    within ``CASE4_SOLUTION_TOL`` of the largest pressure of porepy_tpu's
    system solved by scipy."""
    m = _case4(FlowBenchmark2dCase4Model, device="cpu")
    m_jax = _case4(Case4Jax, material_constants={"solid": solid_jax})
    es, es_jax = m.equation_system, m_jax.equation_system
    assert es.num_dofs() == es_jax.num_dofs() == 4594
    assert (len(m.mdg.subdomains()), len(m.mdg.interfaces())) == (149, 233)
    x0 = es.get_variable_values(iterate_index=0)
    np.testing.assert_array_equal(x0, np.asarray(es_jax.get_variable_values(iterate_index=0)))
    A, b = es.assemble()
    A_jax, b_jax = es_jax.assemble()
    A, A_jax = sps.csr_matrix(A), sps.csr_matrix(A_jax)
    b, b_jax = np.asarray(b), np.asarray(b_jax)
    row_max = np.asarray(abs(A_jax).max(axis=1).todense()).ravel()
    assert np.all(row_max > 0)
    diff = np.asarray(abs(A - A_jax).max(axis=1).todense()).ravel()
    assert np.all(diff <= 1e-13 * row_max), (diff / row_max).max()
    assert np.abs(b - b_jax).max() <= 1e-13 * np.abs(b_jax).max()

    pt.run_time_dependent_model(m, m.params)
    p = es.get_variable_values(["pressure"], time_step_index=0)
    x_jax = x0 + spla.spsolve(A_jax.tocsc(), b_jax)
    p_dofs = es_jax.dofs_of([v for v in es_jax.variables if v.name == "pressure"])
    p_jax = x_jax[p_dofs]
    assert p.shape == p_jax.shape
    assert np.abs(p - p_jax).max() <= CASE4_SOLUTION_TOL * np.abs(p_jax).max()
    assert p.min() > 1e6 - 1.0 and p.max() < 4e6 + 1.0


def test_fb2d4_case_on_the_device_route():
    """The ``fb2d4`` bench case (``cases.build_flow_benchmark_2d_case_4``,
    registered in ``CASE_BUILDERS``) at 40 m on the device route
    (``device_gmres`` with the plain kernel versions): one step, 0 host
    fallbacks, a finite state, pressure and mortar fluxes within
    ``CASE4_SOLUTION_TOL`` of each field's largest value of the same case on
    the host route."""
    assert cases.CASE_BUILDERS["fb2d4"] is cases.build_flow_benchmark_2d_case_4
    runs = {}
    for solver in ("device_gmres", "scipy_sparse"):
        Model, params = cases.build_flow_benchmark_2d_case_4(40.0, device="cpu")
        assert params["linear_solver"] == "device_gmres"
        params["linear_solver"] = solver
        fallbacks = FALLBACK_COUNTER["count"]
        m = Model(params)
        pt.run_time_dependent_model(m, params)
        assert FALLBACK_COUNTER["count"] == fallbacks
        runs[solver] = m.equation_system
    es = runs["device_gmres"]
    assert np.all(np.isfinite(es.get_variable_values(time_step_index=0)))
    for name in ("pressure", "interface_darcy_flux"):
        a = es.get_variable_values([name], time_step_index=0)
        b = runs["scipy_sparse"].get_variable_values([name], time_step_index=0)
        assert np.abs(a - b).max() <= CASE4_SOLUTION_TOL * np.abs(b).max(), name
