"""The md flow slice end to end: porepy_tpu_torch against porepy_tpu and
against the reference goldens, all on the CPU (plain kernel versions)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")


def _final_fields(model):
    es = model.equation_system
    return (
        es.get_variable_values([model.pressure_variable], time_step_index=0),
        es.get_variable_values([model.interface_darcy_flux_variable], time_step_index=0),
    )


@pytest.fixture(scope="module")
def md_runs():
    Model, params = cases_jax.build_md_flow(1.0 / 16)
    params["dense_precond"] = False
    m_jax = Model(params)
    pt_jax.run_time_dependent_model(m_jax, params)
    Model, params = cases_torch.build_md_flow(1.0 / 16, device="cpu")
    params["dense_precond"] = False
    m_torch = Model(params)
    pt_torch.run_time_dependent_model(m_torch, params)
    return m_jax, m_torch


def test_md_26_steps_match_jax(md_runs):
    """26 steps of md 1/16 (2 per-step, 3 fused 8-step blocks): final
    pressure and interface flux match porepy_tpu to 1e-8 max abs."""
    m_jax, m_torch = md_runs
    assert m_jax._ftb_blocks_committed == m_torch._ftb_blocks_committed == 3
    assert m_torch.time_manager.time == m_jax.time_manager.time == 26.0
    for got, want in zip(_final_fields(m_torch), _final_fields(m_jax)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-8


def test_md_block_statistics_match_jax(md_runs):
    """Newton counts agree; Krylov counts per block within 2 per solve."""
    m_jax, m_torch = md_runs
    a, b = m_jax._ftb_last, m_torch._ftb_last
    assert a["steps"] == b["steps"] == 8
    assert a["newton_iters"] == b["newton_iters"]
    assert abs(a["krylov_iters"] - b["krylov_iters"]) <= 2 * a["newton_iters"]


CASES = [
    ("single horizontal", [[[0.25, 0.75], [0.5, 0.5]]]),
    ("through-going", [[[0.0, 1.0], [0.5, 0.5]]]),
    ("X intersection", [[[0.25, 0.75], [0.5, 0.5]], [[0.5, 0.5], [0.25, 0.75]]]),
]


@pytest.mark.parametrize("name,fracs", CASES, ids=[c[0] for c in CASES])
def test_md_flow_parity_goldens(name, fracs):
    """The configurations of tests/models/test_md_flow.py::test_md_flow_parity
    through the port with the device solver, against the same reference
    goldens, to 1e-8."""

    class MD(pt_torch.SinglePhaseFlow):
        def set_fractures(self):
            self._fractures = [pt_torch.LineFracture(np.array(f)) for f in fracs]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.125},
        "material_constants": {
            "solid": pt_torch.SolidConstants(
                permeability=1.0, porosity=0.1, residual_aperture=0.01,
                normal_permeability=1.0,
            ),
            "fluid": pt_torch.FluidComponent(
                compressibility=0.0, viscosity=1.0, density=1.0
            ),
        },
        "time_manager": pt_torch.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "device_gmres",
        "device": "cpu",
    }
    m = MD(params)
    pt_torch.run_time_dependent_model(m, params)
    golden = np.load(os.path.join(GOLDENS, f"test_md_flow_parity({name}).npz"))
    p, lam = _final_fields(m)
    assert np.abs(p - golden["pressure"]).max() <= 1e-8
    assert np.abs(lam - golden["interface_flux"]).max() <= 1e-8


def test_port_runs_md_without_jax():
    """With jax blocked, the port imports and runs md 1/16 on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import porepy_tpu_torch as pt\n"
        "from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow\n"
        "Model, params = build_md_flow(1 / 16, device='cpu')\n"
        "m = Model(params)\n"
        "pt.run_time_dependent_model(m, params)\n"
        "assert m._ftb_blocks_committed == 3\n"
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


def test_port_source_has_no_jax():
    """No module of the port imports jax or uses jnp."""
    pattern = re.compile(r"import jax|from jax|jnp\.")
    root = os.path.join(REPO, "porepy_tpu_torch")
    hits = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    hits += [
                        f"{path}:{i}" for i, line in enumerate(fh, 1) if pattern.search(line)
                    ]
    assert not hits, hits


def test_md256_case_yields_cell_size_without_meshing():
    """``CASE_BUILDERS["md256"]`` is md at cell size 1/256 on the card by
    default, with md's solver parameters; building the parameters meshes
    nothing."""
    Model, params = cases_torch.CASE_BUILDERS["md256"]()
    assert params["meshing_arguments"] == {"cell_size": 1.0 / 256}
    assert params["device"] == "cuda"
    Model_md, params_md = cases_torch.build_md_flow(1.0 / 128, device="cuda")
    for key in ("linear_solver", "fused_time_steps", "fused_commit_states", "grid_type"):
        assert params[key] == params_md[key]
    assert Model.__mro__[2:] == Model_md.__mro__[2:]
    assert not hasattr(Model, "mdg")


def test_md256_model_at_a_coarse_size_assembles_by_the_dual_route():
    """The md256 model (``build_md_flow``'s class and parameters) at cell size
    1/8: the same equations as md, assembled by the forward-mode pass with no
    node left to ``torch.func``, equal to porepy_tpu's assembly."""
    Model, params = cases_torch.build_md_flow(1.0 / 8, device="cpu")
    _cls, params256 = cases_torch.CASE_BUILDERS["md256"]()
    assert {k for k in params256} == {k for k in params}
    m = Model(params)
    m.prepare_simulation()
    cs = m.equation_system.compiled_system()
    assert cs.names == ("mass_balance_equation", "interface_darcy_flux_equation")
    assert all(ce.fn.dual.ruleless == [] for ce in cs.ces)
    Model_j, params_j = cases_jax.build_md_flow(1.0 / 8)
    m_jax = Model_j(params_j)
    m_jax.prepare_simulation()
    data, b = cs.assemble(m.equation_system)
    J_j, b_j = m_jax.equation_system.assemble()
    J_t = cs.bcoo(data).to_dense().numpy()
    assert np.abs(J_t - J_j.toarray()).max() <= 1e-12 * np.abs(J_j.toarray()).max()
    assert np.abs(b.numpy() - np.asarray(b_j)).max() <= 1e-12 * max(np.abs(b_j).max(), 1.0)
