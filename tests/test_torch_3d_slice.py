"""The 3d single-phase flow slice end to end: porepy_tpu_torch against
porepy_tpu with dense frozen block inverses, on the CPU (plain kernel
versions), at cell size 1/16 (4,096 dofs): two per-step solves and one
fused 8-step block."""

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


def _shorten(pt, params):
    params["meshing_arguments"] = {"cell_size": 1.0 / 16}
    params["time_manager"] = pt.TimeManager([0, 10.0], 1.0, constant_dt=True)
    params["dense_precond"] = True
    return params


@pytest.fixture(scope="module")
def runs():
    before = (FB_JAX["count"], FB_TORCH["count"])
    Model, params = cases_jax.build_3d_flow()
    params = _shorten(pt_jax, params)
    m_jax = Model(params)
    pt_jax.run_time_dependent_model(m_jax, params)
    Model, params = cases_torch.build_3d_flow(1.0 / 16, device="cpu")
    params = _shorten(pt_torch, params)
    m_torch = Model(params)
    pt_torch.run_time_dependent_model(m_torch, params)
    assert (FB_JAX["count"], FB_TORCH["count"]) == before, "a solve fell back to host"
    return m_jax, m_torch


def test_3d_dense_counts_match_jax(runs):
    """One committed 8-step block with the same Newton and Krylov counts
    (8 and 24), dense active and not demoted on both sides."""
    m_jax, m_torch = runs
    assert m_jax._ftb_blocks_committed == m_torch._ftb_blocks_committed == 1
    assert m_torch._ftb_last == m_jax._ftb_last
    assert m_torch._ftb_last == {"steps": 8, "newton_iters": 8, "krylov_iters": 24}
    s_jax = next(iter(m_jax._device_solvers.values()))
    s_torch = next(iter(m_torch._device_solvers.values()))
    assert s_jax._dense and s_torch._dense
    assert s_torch._builder._block_dense == {0: True}


def test_3d_dense_final_state_matches_jax(runs):
    """Final pressures to 1e-8 relative, within the boundary data and the
    initial value."""
    m_jax, m_torch = runs
    p_j = m_jax.equation_system.get_variable_values(["pressure"], time_step_index=0)
    p_t = m_torch.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert p_t.shape == p_j.shape == (4096,)
    assert np.abs(p_t - p_j).max() <= 1e-8 * np.abs(p_j).max()
    assert 1e5 <= p_t.min() and p_t.max() <= 2e5


def test_port_runs_flow_steps_without_jax():
    """With jax blocked, the port's 3d case builder and flow-step modules
    import, and one structured and one unstructured Newton step run on the
    CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from porepy_tpu_torch.applications.benchmarking.cases import build_case, CASE_BUILDERS\n"
        "from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel\n"
        "from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel, newton_step\n"
        "assert '3d' in CASE_BUILDERS\n"
        "k, p0 = build_structured_flow_kernel((4, 4, 4), (1, 1, 1), p_ref=1e5, device='cpu')\n"
        "p, r = k.newton_step(p0 + 1e3, p0)\n"
        "assert bool(torch.isfinite(p).all()) and float(r) > 0\n"
        "u, q0 = build_cart_flow_kernel([4, 4, 4], [1, 1, 1], p_ref=1e5, device='cpu')\n"
        "q, r = newton_step(u, torch.tensor(q0) + 1e3, torch.tensor(q0))\n"
        "assert bool(torch.isfinite(q).all()) and float(r) > 0\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
