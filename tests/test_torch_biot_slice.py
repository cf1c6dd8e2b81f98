"""The poromechanics slice end to end: porepy_tpu_torch against porepy_tpu
on the CPU (plain kernel versions). The biot bench case at cell size 1/16
(768 dofs) through fused time blocks with the device block-preconditioned
FGMRES, the coupled poromechanics parity cases of
``tests/models/test_poromechanics.py`` (with and without a frictional
fracture), and the contact-state characteristic function (K15)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu.models.contact_mechanics import _characteristic_jax
from porepy_tpu.numerics.linalg.krylov import FALLBACK_COUNTER as FB_JAX
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.models.contact_mechanics import _characteristic
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as FB_TORCH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from models.test_poromechanics import _FRAC_PORO_VARS, _make, _make_fractured  # noqa: E402


def _shorten(pt, params):
    # Ten steps: two per-step solves and one fused 8-step block. By t = 26
    # the pressure has decayed to ~7e-12, below the Newton tolerance, where
    # a relative comparison would measure rounding and not the solve.
    params["meshing_arguments"] = {"cell_size": 1.0 / 16}
    params["time_manager"] = pt.TimeManager([0, 10.0], 1.0, constant_dt=True)
    params["dense_precond"] = False
    return params


def _recording(Model):
    class Recording(Model):
        """Keeps each time step's Krylov count per Newton iteration."""

        def after_nonlinear_convergence(self, *args, **kwargs):
            solver = next(iter(self._device_solvers.values()))
            self.krylov_log.append(list(solver.last_stats["krylov_iters_per_newton"]))
            return super().after_nonlinear_convergence(*args, **kwargs)

    return Recording


def _run(pt, Model, params):
    model = _recording(Model)(params)
    model.krylov_log = []
    pt.run_time_dependent_model(model, params)
    return model


@pytest.fixture(scope="module")
def biot_runs():
    before = (FB_JAX["count"], FB_TORCH["count"])
    Model, params = cases_jax.build_biot()
    m_jax = _run(pt_jax, Model, _shorten(pt_jax, params))
    Model, params = cases_torch.build_biot(1.0 / 16, device="cpu")
    m_torch = _run(pt_torch, Model, _shorten(pt_torch, params))
    assert (FB_JAX["count"], FB_TORCH["count"]) == before, "a solve fell back to host"
    return m_jax, m_torch


def test_biot_blocks_and_counts_match_jax(biot_runs):
    """One committed 8-step block, the same Newton count in every step, on
    the AMG + fixed-stress field split (no dense inverse) on both; the same
    Krylov count in every Newton iteration above the rounding floor. A
    Newton iteration whose increment is at the floor (~1e-15; step 3 ends
    with one) solves for rounding noise, and its Krylov count may differ
    by one between the two packages' f32 inner solves."""
    m_jax, m_torch = biot_runs
    assert m_jax._ftb_blocks_committed == m_torch._ftb_blocks_committed == 1
    assert m_torch._ftb_last["steps"] == m_jax._ftb_last["steps"] == 8
    assert m_torch._ftb_last["newton_iters"] == m_jax._ftb_last["newton_iters"]
    s_jax = next(iter(m_jax._device_solvers.values()))
    s_torch = next(iter(m_torch._device_solvers.values()))
    assert not s_jax._dense and not s_torch._dense
    history = m_jax.nonlinear_solver_statistics.history
    assert len(m_torch.krylov_log) == len(m_jax.krylov_log) == len(history) == 10
    compared = 0
    for step, (k_t, k_j) in enumerate(zip(m_torch.krylov_log, m_jax.krylov_log), 1):
        incs = history[str(step)]["nonlinear_increment_norms"]
        assert len(k_t) == len(k_j) == len(incs), step
        for kt, kj, inc in zip(k_t, k_j, incs):
            if inc > 1e-13:
                assert kt == kj, (step, k_t, k_j)
                compared += 1
            else:
                assert abs(kt - kj) <= 1, (step, k_t, k_j)
    assert compared >= 20


@pytest.mark.parametrize("var", ["u", "pressure"])
def test_biot_final_state_matches_jax(biot_runs, var):
    """Final displacement and pressure to 1e-10 of each field's max."""
    m_jax, m_torch = biot_runs
    v_j = m_jax.equation_system.get_variable_values([var], time_step_index=0)
    v_t = m_torch.equation_system.get_variable_values([var], time_step_index=0)
    assert v_t.shape == v_j.shape == ((512,) if var == "u" else (256,))
    assert np.all(np.isfinite(v_t))
    assert np.abs(v_t - v_j).max() <= 1e-10 * np.abs(v_j).max()


class _OnCpu(pt_torch.Poromechanics):
    def __init__(self, params):
        params["device"] = "cpu"
        super().__init__(params)


def test_poromechanics_parity():
    """``test_poromechanics_parity`` through the port against porepy_tpu."""
    m_jax, p_jax = _make(pt_jax, pt_jax.Poromechanics)
    pt_jax.run_time_dependent_model(m_jax, p_jax)
    m_torch, p_torch = _make(pt_torch, _OnCpu)
    pt_torch.run_time_dependent_model(m_torch, p_torch)
    for var in ("pressure", "u"):
        v_j = m_jax.equation_system.get_variable_values([var], time_step_index=0)
        v_t = m_torch.equation_system.get_variable_values([var], time_step_index=0)
        assert np.abs(v_t - v_j).max() < 1e-12, var


@pytest.mark.parametrize("bc", [(0.01, -0.005), (0.0, 0.004)], ids=["contact", "opening"])
def test_fractured_poromechanics_parity(bc):
    """``test_fractured_poromechanics_parity`` (flow, mechanics, frictional
    contact on a fractured domain) through the port against porepy_tpu:
    every field and the jump-based aperture to 1e-12."""
    m_jax, p_jax = _make_fractured(pt_jax, pt_jax.Poromechanics, lambda a: a, *bc)
    pt_jax.run_time_dependent_model(m_jax, p_jax)
    m_torch, p_torch = _make_fractured(pt_torch, _OnCpu, lambda a: a, *bc)
    pt_torch.run_time_dependent_model(m_torch, p_torch)
    for var in _FRAC_PORO_VARS:
        v_j = m_jax.equation_system.get_variable_values([var], iterate_index=0)
        v_t = m_torch.equation_system.get_variable_values([var], iterate_index=0)
        assert np.abs(v_t - v_j).max() < 1e-12, var
    fracs_j, fracs_t = m_jax.mdg.subdomains(dim=1), m_torch.mdg.subdomains(dim=1)
    ap_j = np.asarray(m_jax.equation_system.evaluate(m_jax.aperture(fracs_j)))
    ap_t = np.asarray(m_torch.equation_system.evaluate(m_torch.aperture(fracs_t)))
    assert np.abs(ap_t - ap_j).max() < 1e-12


def test_characteristic_tie_and_zero_derivative():
    """K15: 1 where |x| <= tol, the tie |x| == tol included, as in
    porepy_tpu; the selection carries no derivative."""
    tol = 1e-5
    x = np.array([-2 * tol, -tol, -0.5 * tol, 0.0, 0.5 * tol, tol, np.nextafter(tol, 1), 3.0])
    want = np.asarray(_characteristic_jax(tol, x))
    got = _characteristic(tol, torch.tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [0, 1, 1, 1, 1, 1, 0, 0])
    _, tangent = torch.func.jvp(
        lambda v: _characteristic(tol, v), (torch.tensor(x),), (torch.ones(x.size, dtype=torch.float64),)
    )
    assert bool(torch.all(tangent == 0))


def test_port_builds_biot_without_jax():
    """With jax blocked, the port exports the poromechanics names, has the
    biot case, and discretizes its 1/16 grid by the host route."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import porepy_tpu_torch as pt\n"
        "from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS, build_biot\n"
        "assert 'biot' in CASE_BUILDERS\n"
        "assert all(hasattr(pt, k) for k in ('Poromechanics', 'MomentumBalance', 'Biot', 'Mpsa', 'ContactMechanics'))\n"
        "Model, params = build_biot(1 / 16, device='cpu')\n"
        "m = Model(params); m.prepare_simulation()\n"
        "assert m.equation_system.num_dofs() == 768\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
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
