"""The Berre et al. (2021) 3d case 2 slice end to end: porepy_tpu_torch
against porepy_tpu on the CPU (plain kernel versions), both packages in one
process. The tests of ``tests/functional/test_benchmark_3d_case_2.py``
through the port (the native fracture-conforming tet mesh, and md flow on
its 8^3 lattice against the reference golden and against porepy_tpu), and
the first step of the ``berre3d`` bench case on the 8^3 lattice: the Newton
loop on the device with the block-preconditioned FGMRES."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu.numerics.linalg.krylov import FALLBACK_COUNTER as FB_JAX
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.applications.md_grids.mdg_library import benchmark_3d_case_2
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as FB_TORCH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
sys.path.insert(0, os.path.join(REPO, "tests"))
from functional import test_benchmark_3d_case_2 as case2  # noqa: E402


def test_native_case2_mesh_structure():
    """``test_native_case2_mesh_structure`` through the port: nine
    fractures, the 6 x 16^3 tets of refinement level 0 filling the unit
    cube, every fracture coupled to the matrix by a mortar whose primary
    average rows sum to one; the same grids as porepy_tpu's."""
    mdg, network = benchmark_3d_case_2(refinement_level=0)
    assert len(network.fractures) == 9
    assert len(mdg.subdomains(dim=2)) == 9
    sd3 = mdg.subdomains(dim=3)[0]
    assert sd3.num_cells == 6 * 16**3
    assert np.isclose(sd3.cell_volumes.sum(), 1.0)
    intfs = mdg.interfaces(codim=1)
    assert len(intfs) >= 9 + len(mdg.subdomains(dim=1))
    for intf in intfs:
        P = intf.primary_to_mortar_avg()
        assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)
    ref, _ = pt_jax.mdg_library.benchmark_3d_case_2(refinement_level=0)
    for dim in (3, 2, 1, 0):
        mine, theirs = mdg.subdomains(dim=dim), ref.subdomains(dim=dim)
        assert [g.num_cells for g in mine] == [g.num_cells for g in theirs], dim
        for g, h in zip(mine, theirs):
            np.testing.assert_array_equal(g.nodes, h.nodes)
            np.testing.assert_array_equal(g.cell_centers, h.cell_centers)
    assert len(mdg.interfaces()) == len(ref.interfaces()) == 270
    assert len(mdg.subdomains()) == 106


def _case2_fractures():
    from porepy_tpu_torch.fracs import fracture_importer

    lib = os.path.join(
        os.path.dirname(pt_torch.__file__), "applications", "md_grids", "file_library", "benchmark_3d_case_2"
    )
    network = fracture_importer.network_3d_from_csv(os.path.join(lib, "fracture_network.csv"))
    return [f.pts for f in network.fractures]


def _on_cpu(base):
    class OnCpu(base):
        def __init__(self, params):
            params["device"] = "cpu"
            super().__init__(params)

    return OnCpu


def _pressures(model, mdg, dim):
    """Each subdomain of ``dim``'s pressure and cell centers."""
    es = model.equation_system
    p = es.get_variable_values(["pressure"], time_step_index=0)
    out = []
    for g in mdg.subdomains(dim=dim):
        dofs = es.dofs_of([v for v in es.variables if v.name == "pressure" and v.domain is g])
        out.append((p[dofs], g.cell_centers))
    return out


def test_case2_flow_parity_same_mesh():
    """``test_case2_flow_parity_same_mesh`` through the port: md flow on the
    8^3 lattice's tet mesh (one step, direct solve); every subdomain's
    pressure against the reference golden (cells matched by their centers,
    1e-8 of the largest value, as the original test) and against porepy_tpu
    on the same mesh (cell for cell, 1e-12 of the largest value)."""
    from porepy_tpu.fracs import meshing as meshing_jax
    from porepy_tpu.fracs.structured_simplex import tet_subdomain_lists as lists_jax
    from porepy_tpu_torch.fracs import meshing
    from porepy_tpu_torch.fracs.structured_simplex import tet_subdomain_lists

    fracs = _case2_fractures()
    mdg = meshing.subdomains_to_mdg(tet_subdomain_lists(fracs, np.array([8] * 3), physdims=[1, 1, 1]))
    mdg.compute_geometry()
    m = case2._run_flow(pt_torch, mdg, _on_cpu(pt_torch.SinglePhaseFlow))
    mdg_jax = meshing_jax.subdomains_to_mdg(lists_jax(fracs, np.array([8] * 3), physdims=[1, 1, 1]))
    mdg_jax.compute_geometry()
    m_jax = case2._run_flow(pt_jax, mdg_jax, pt_jax.SinglePhaseFlow)
    golden = np.load(os.path.join(GOLDENS, "test_case2_flow_parity_same_mesh.npz"))
    compared = 0
    for dim in (3, 2, 1, 0):
        mine, theirs = _pressures(m, mdg, dim), _pressures(m_jax, mdg_jax, dim)
        assert len(mine) == len(theirs)
        for i, ((p, cc), (p_j, cc_j)) in enumerate(zip(mine, theirs)):
            np.testing.assert_array_equal(cc, cc_j)
            assert np.abs(p - p_j).max() <= 1e-12 * np.abs(p_j).max(), (dim, i)
            p_ref, cc_ref = golden[f"p_{dim}_{i}"], golden[f"cc_{dim}_{i}"]
            key_m, key_r = np.round(cc, 10), np.round(cc_ref, 10)
            order_m, order_r = np.lexsort(key_m), np.lexsort(key_r)
            assert np.allclose(key_m[:, order_m], key_r[:, order_r], atol=1e-9), (dim, i)
            err = np.abs(p[order_m] - p_ref[order_r]).max()
            assert err / max(np.abs(p_ref).max(), 1e-300) < 1e-8, (dim, i)
            compared += 1
    assert compared == 1 + 9 + 69 + 27


# -- the bench case ---------------------------------------------------------------


@pytest.fixture(scope="module")
def berre_runs():
    """The berre3d case on the 8^3 lattice, its first step: the Newton loop
    on the device (the fused 4-step blocks start at the third step; on the
    CPU one step of the plain kernel versions takes about 20 s)."""
    before = (FB_JAX["count"], FB_TORCH["count"])
    import porepy_tpu.applications.md_grids.mdg_library as library_jax
    from porepy_tpu.fracs.fracture_importer import network_3d_from_csv
    from porepy_tpu.fracs.structured_simplex import tet_cart_grid

    lib = os.path.join(os.path.dirname(library_jax.__file__), "file_library", "benchmark_3d_case_2")
    network = network_3d_from_csv(os.path.join(lib, "fracture_network.csv"))
    mdg_jax = tet_cart_grid([f.pts for f in network.fractures], np.array([8] * 3), physdims=[1.0, 1.0, 1.0])
    mdg_jax.compute_geometry()
    original = library_jax.benchmark_3d_case_2
    library_jax.benchmark_3d_case_2 = lambda refinement_level=0: (mdg_jax, network)
    try:
        Model, params = cases_jax.build_berre3d()
    finally:
        library_jax.benchmark_3d_case_2 = original
    runs = []
    case_torch = cases_torch.berre3d_on(cases_torch.berre3d_lattice_mdg(8), device="cpu")
    for pt, (Model, params) in ((pt_jax, (Model, params)), (pt_torch, case_torch)):
        params["time_manager"] = pt.TimeManager([0, 1.0], 1.0, constant_dt=True)
        m = Model(params)
        pt.run_time_dependent_model(m, params)
        runs.append(m)
    assert (FB_JAX["count"], FB_TORCH["count"]) == before, "a solve fell back to host"
    return tuple(runs)


def test_berre3d_case_loop_and_counts_match_jax(berre_runs):
    """5,136 dofs in 106 subdomains on both; the step's Newton loop ran on
    the device with the same Newton and Krylov counts, on the same field
    split (AMG on the pressure, the mortar fluxes eliminated)."""
    m_jax, m_torch = berre_runs
    assert m_torch.equation_system.num_dofs() == m_jax.equation_system.num_dofs() == 5136
    assert len(m_torch.mdg.subdomains()) == 106
    assert m_torch._fused_newton_eligible({})
    s_jax = next(iter(m_jax._device_solvers.values()))
    s_torch = next(iter(m_torch._device_solvers.values()))
    assert s_torch.last_stats["fused"] and s_jax.last_stats["fused"]
    assert s_torch._builder.methods == s_jax._builder.methods == ["amg", "eliminate"]
    assert not s_torch._dense and not s_jax._dense
    stats_j, stats_t = m_jax.nonlinear_solver_statistics, m_torch.nonlinear_solver_statistics
    assert stats_t.num_iteration == stats_j.num_iteration >= 1
    # A Newton iteration whose increment is at the rounding floor (the last
    # one, ~1e-11 on pressures of 1e5) solves for rounding noise, and its
    # Krylov count may differ by one between the two packages' f32 inner
    # solves; every other count is the same.
    floor = 1e-14 * np.abs(m_jax.equation_system.get_variable_values(["pressure"], time_step_index=0)).max()
    k_t = s_torch.last_stats["krylov_iters_per_newton"]
    k_j = s_jax.last_stats["krylov_iters_per_newton"]
    incs = stats_j.nonlinear_increment_norms
    assert len(k_t) == len(k_j) == len(incs)
    for kt, kj, inc in zip(k_t, k_j, incs):
        assert kt == kj if inc > floor else abs(kt - kj) <= 1, (k_t, k_j, incs)
    assert sum(inc > floor for inc in incs) >= 3


@pytest.mark.parametrize("var", ["pressure", "interface_darcy_flux"])
def test_berre3d_case_state_matches_jax(berre_runs, var):
    """The final pressure and mortar fluxes to 1e-12 of the field's largest
    value."""
    m_jax, m_torch = berre_runs
    v_j = m_jax.equation_system.get_variable_values([var], time_step_index=0)
    v_t = m_torch.equation_system.get_variable_values([var], time_step_index=0)
    assert v_t.shape == v_j.shape
    assert np.all(np.isfinite(v_t))
    assert np.abs(v_t - v_j).max() <= 1e-12 * np.abs(v_j).max()


def test_port_builds_berre3d_without_jax():
    """With jax blocked, the port exports ``mdg_library`` and has the
    berre3d case, which defaults to the card (and so refuses a machine
    without one)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import porepy_tpu_torch as pt\n"
        "from porepy_tpu_torch.applications.benchmarking import cases\n"
        "import inspect\n"
        "assert cases.CASE_BUILDERS['berre3d'] is cases.build_berre3d\n"
        "assert list(inspect.signature(cases.build_berre3d).parameters) == ['refinement_level', 'device']\n"
        "assert inspect.signature(cases.build_berre3d).parameters['device'].default == 'cuda'\n"
        "assert pt.mdg_library.benchmark_3d_case_2.__module__.startswith('porepy_tpu_torch.')\n"
        "Model, params = cases.berre3d_on(cases.berre3d_lattice_mdg(8))\n"
        "assert params['device'] == 'cuda' and params['fused_time_steps'] == 4\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        Model(params).prepare_simulation()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('the case ran without a card')\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'porepy_tpu.')) or k == 'porepy_tpu'\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PPT_LOCAL_SOLVE_DEVICE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
