"""The thermoporomechanics slice end to end: porepy_tpu_torch against
porepy_tpu on the CPU (plain kernel versions), both packages in one process.
The tests of ``tests/models/test_thermoporomechanics.py`` and
``tests/models/test_mass_and_energy.py`` through the port (each parity case
also against the checked-in reference goldens), and the ``thm`` bench case
(3d, four fractures, frictional contact, heat and flow) at cell size 1/4 for
one step with the device block-preconditioned FGMRES and dense frozen block
inverses."""

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
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as FB_TORCH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
sys.path.insert(0, os.path.join(REPO, "tests"))
from models import test_mass_and_energy as me  # noqa: E402
from models import test_thermoporomechanics as thm  # noqa: E402


def _on_cpu(base):
    class OnCpu(base):
        def __init__(self, params):
            params["device"] = "cpu"
            super().__init__(params)

    return OnCpu


def _values(model, names, **index):
    return {v: model.equation_system.get_variable_values([v], **index) for v in names}


def test_fractured_thermoporomechanics_parity():
    """``test_fractured_thermoporomechanics_parity`` through the port: every
    field against porepy_tpu and against the reference golden, to 1e-12."""
    m_jax, p_jax = thm._make(pt_jax, pt_jax.Thermoporomechanics, lambda a: a)
    pt_jax.run_time_dependent_model(m_jax, p_jax)
    m_torch, p_torch = thm._make(pt_torch, _on_cpu(pt_torch.Thermoporomechanics), lambda a: a)
    pt_torch.run_time_dependent_model(m_torch, p_torch)
    golden = np.load(os.path.join(GOLDENS, "test_fractured_thermoporomechanics_parity.npz"))
    got = _values(m_torch, thm.THM_FIELDS, iterate_index=0)
    want = _values(m_jax, thm.THM_FIELDS, iterate_index=0)
    for var in thm.THM_FIELDS:
        assert got[var].shape == want[var].shape == golden[var].shape, var
        assert np.abs(got[var] - want[var]).max() < 1e-12, var
        assert np.abs(got[var] - golden[var]).max() < 1e-12, var


def test_thermal_stress_drives_deformation():
    """``test_thermal_stress_drives_deformation`` through the port: heating
    with fixed boundaries moves the unfractured domain, as in porepy_tpu."""
    runs = {}
    for pt, base in ((pt_jax, pt_jax.Thermoporomechanics), (pt_torch, _on_cpu(pt_torch.Thermoporomechanics))):
        m, params = thm._make(pt, base, lambda a: a)

        class Unfractured(type(m)):
            def set_fractures(self):
                self._fractures = []

            def bc_values_displacement(self, bg):
                return np.zeros((self.nd, bg.num_cells)).ravel("F")

            def bc_values_temperature(self, bg):
                return 10.0 * np.ones(bg.num_cells)

        m = Unfractured(params)
        pt.run_time_dependent_model(m, params)
        runs[pt] = m.equation_system.get_variable_values(["u"], iterate_index=0)
    u_torch, u_jax = runs[pt_torch], runs[pt_jax]
    assert np.linalg.norm(u_torch) > 1e-8
    assert np.abs(u_torch - u_jax).max() <= 1e-12 * np.abs(u_jax).max()


def test_mass_and_energy_parity():
    """``test_mass_and_energy_parity`` through the port: pressure,
    temperature and every interface flux against porepy_tpu (1e-12) and
    against the reference golden (1e-10, as the original test holds
    porepy_tpu)."""
    m_jax, p_jax = me._make(pt_jax, pt_jax.MassAndEnergyBalance, lambda a: a)
    pt_jax.run_time_dependent_model(m_jax, p_jax)
    m_torch, p_torch = me._make(pt_torch, _on_cpu(pt_torch.MassAndEnergyBalance), lambda a: a)
    pt_torch.run_time_dependent_model(m_torch, p_torch)
    golden = np.load(os.path.join(GOLDENS, "test_mass_and_energy_parity.npz"))
    got = _values(m_torch, me._ME_VARS, time_step_index=0)
    want = _values(m_jax, me._ME_VARS, time_step_index=0)
    for var in me._ME_VARS:
        assert got[var].shape == want[var].shape == golden[var].shape, var
        assert np.abs(got[var] - want[var]).max() < 1e-12, var
        assert np.abs(got[var] - golden[var]).max() < 1e-10, var


def test_mass_and_energy_monodim_conduction():
    """``test_mass_and_energy_monodim_conduction`` through the port: pure
    conduction relaxes to the linear boundary profile. The port has no VTU
    exporter, so the run suppresses the export."""

    class M(_on_cpu(pt_torch.MassAndEnergyBalance)):
        def bc_values_temperature(self, bg):
            return 1.0 + bg.cell_centers[0]

    params = {
        "meshing_arguments": {"cell_size": 0.25},
        "time_manager": pt_torch.TimeManager([0, 50.0], 10.0, constant_dt=True),
        "suppress_export": True,
        "material_constants": {
            "solid": pt_torch.SolidConstants(
                permeability=1.0, porosity=0.1, thermal_conductivity=1.0,
                specific_heat_capacity=1.0, density=1.0,
            ),
            "fluid": pt_torch.FluidComponent(
                viscosity=1.0, density=1.0, thermal_conductivity=1.0,
                specific_heat_capacity=1.0,
            ),
        },
    }
    m = M(params)
    pt_torch.run_time_dependent_model(m, params)
    sd = m.mdg.subdomains()[0]
    T = m.equation_system.get_variable_values(["temperature"], time_step_index=0)
    assert np.abs(T - (1.0 + sd.cell_centers[0])).max() < 1e-6


# -- the bench case ---------------------------------------------------------------


def _shorten(pt, params):
    # The case's width at 1/4 (3d, 664 dofs), its first step only.
    params["meshing_arguments"] = {"cell_size": 1.0 / 4}
    params["time_manager"] = pt.TimeManager([0, 1.0], 1.0, constant_dt=True)
    return params


@pytest.fixture(scope="module")
def thm_runs():
    before = (FB_JAX["count"], FB_TORCH["count"])
    Model, params = cases_jax.build_thm_contact_3d()
    m_jax = Model(_shorten(pt_jax, params))
    pt_jax.run_time_dependent_model(m_jax, params)
    Model, params = cases_torch.build_thm_contact_3d(1.0 / 4, device="cpu")
    m_torch = Model(_shorten(pt_torch, params))
    pt_torch.run_time_dependent_model(m_torch, params)
    assert (FB_JAX["count"], FB_TORCH["count"]) == before, "a solve fell back to host"
    return m_jax, m_torch


def test_thm_case_runs_the_host_newton_loop_with_dense_inverses(thm_runs):
    """The fracture MPFA is rediscretized every Newton iteration, so the
    case takes the host Newton loop (no fused block) on both; both build
    the same field split with the same blocks inverted densely (the contact
    block, the trailing one, among them), and take the same number of
    Newton iterations."""
    m_jax, m_torch = thm_runs
    assert m_torch.equation_system.num_dofs() == m_jax.equation_system.num_dofs() == 664
    assert getattr(m_torch, "_ftb_blocks_committed", 0) == getattr(m_jax, "_ftb_blocks_committed", 0) == 0
    assert m_torch._nonlinear_discretizations == m_jax._nonlinear_discretizations
    assert not m_torch._fused_newton_eligible({})
    s_jax = next(iter(m_jax._device_solvers.values()))
    s_torch = next(iter(m_torch._device_solvers.values()))
    assert s_jax._dense and s_torch._dense
    # porepy_tpu names the trailing slot "cheb"; what it runs there is the
    # damped l1-Jacobi sweeps the port calls "jacobi".
    assert s_torch._builder.methods == [("jacobi" if m == "cheb" else m) for m in s_jax._builder.methods]
    assert s_torch._builder._block_dense == s_jax._builder._block_dense
    assert s_torch._builder._block_dense[len(s_torch._builder.methods) - 1]
    stats_j, stats_t = m_jax.nonlinear_solver_statistics, m_torch.nonlinear_solver_statistics
    assert stats_t.num_iteration == stats_j.num_iteration > 1


@pytest.mark.parametrize("var", thm.THM_FIELDS)
def test_thm_case_state_matches_jax(thm_runs, var):
    """Each of the eight fields after the first step, to 1e-12 of the
    field's largest value."""
    m_jax, m_torch = thm_runs
    v_j = m_jax.equation_system.get_variable_values([var], time_step_index=0)
    v_t = m_torch.equation_system.get_variable_values([var], time_step_index=0)
    assert v_t.shape == v_j.shape
    assert np.all(np.isfinite(v_t))
    assert np.abs(v_t - v_j).max() <= 1e-12 * np.abs(v_j).max()


def test_port_builds_thm_without_jax():
    """With jax blocked, the port exports the thermoporomechanics names and
    has the thm case, which defaults to the card (and so refuses a machine
    without one) and prepares at 1/4 on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import porepy_tpu_torch as pt\n"
        "from porepy_tpu_torch.applications.benchmarking import cases\n"
        "assert cases.CASE_BUILDERS['thm'] is cases.build_thm_contact_3d\n"
        "assert all(hasattr(pt, k) for k in ('Thermoporomechanics', 'MassAndEnergyBalance'))\n"
        "Model, params = cases.build_thm_contact_3d()\n"
        "assert params['device'] == 'cuda' and params['meshing_arguments']['cell_size'] == 1 / 16\n"
        "assert params['dense_precond'] is True and params['linear_solver'] == 'device_gmres'\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        Model(params).prepare_simulation()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('the case ran without a card')\n"
        "Model, params = cases.build_thm_contact_3d(1 / 4, device='cpu')\n"
        "m = Model(params); m.prepare_simulation()\n"
        "assert m.equation_system.num_dofs() == 664\n"
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
