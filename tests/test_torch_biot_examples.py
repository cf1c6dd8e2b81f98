"""The Terzaghi and Mandel poroelastic verification examples through
porepy_tpu_torch on the CPU (``examples/{terzaghi_biot,mandel_biot}.py``,
``applications/convergence_analysis.py`` and ``utils/examples_utils.py``,
copied from porepy_tpu): the analytical bounds of
``tests/examples/test_biot_examples.py``, and the collected errors, the
final displacement and the final pressure against porepy_tpu's models on
the same inputs (both packages in one process)."""

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.examples.mandel_biot import MandelModel as MandelJax
from porepy_tpu.examples.terzaghi_biot import TerzaghiModel as TerzaghiJax
from porepy_tpu_torch.examples import MandelModel, TerzaghiModel
from porepy_tpu_torch.examples.mandel_biot import mandel_solid_params
from porepy_tpu_torch.examples.terzaghi_biot import terzaghi_solid_params

torch.set_num_threads(1)

#: The port's errors, displacement and pressure against porepy_tpu's, both
#: solved by a direct solve: Terzaghi's within 6.8e-16, Mandel's errors
#: within 1.0e-12 and its final pressure within 7.7e-12 of its largest
#: value, measured.
PARITY_TOL = 1e-10


def terzaghi_params(mod, **extra):
    """``tests/examples/test_biot_examples.py``'s Terzaghi inputs for the
    package ``mod``: 20 cells, 6 steps of 0.05 s."""
    params = {
        "material_constants": {
            "solid": mod.SolidConstants(**terzaghi_solid_params),
            "fluid": mod.FluidComponent(viscosity=1e-3, density=1e3, compressibility=0.0),
        },
        "time_manager": mod.TimeManager([0, 0.05, 0.1, 0.3], 0.05, constant_dt=True),
        "num_cells": 20,
        "vertical_load": 6e8,
        "suppress_export": True,
    }
    params.update(extra)
    return params


def mandel_params(mod, **extra):
    """The test's Mandel inputs for ``mod``: cells of 2.5 m on 100 m x 10 m,
    5 steps of 10 s."""
    params = {
        "material_constants": {
            "solid": mod.SolidConstants(**mandel_solid_params),
            "fluid": mod.FluidComponent(viscosity=1e-3, density=1e3, compressibility=0.0),
        },
        "time_manager": mod.TimeManager([0, 10, 50], 10, constant_dt=True),
        "meshing_arguments": {"cell_size": 2.5},
        "suppress_export": True,
    }
    params.update(extra)
    return params


def _run(cls, params):
    m = cls(params)
    (pt_jax if cls in (TerzaghiJax, MandelJax) else pt).run_time_dependent_model(m, params)
    return m


@pytest.fixture(scope="module")
def terzaghi():
    return _run(TerzaghiModel, terzaghi_params(pt, device="cpu")), _run(TerzaghiJax, terzaghi_params(pt_jax))


@pytest.fixture(scope="module")
def mandel():
    return _run(MandelModel, mandel_params(pt, device="cpu")), _run(MandelJax, mandel_params(pt_jax))


def test_terzaghi_matches_analytical(terzaghi):
    m, _ = terzaghi
    errors_p = [r.error_pressure for r in m.results if r.time > 0]
    assert len(errors_p) == 6
    assert all(e < 0.07 for e in errors_p)
    assert errors_p[-1] < errors_p[0]
    assert all(r.error_consolidation_degree < 0.03 for r in m.results if r.time > 0)


def test_mandel_matches_analytical(mandel):
    m, _ = mandel
    errors_p = [r.error_pressure for r in m.results if r.time > 0]
    errors_u = [r.error_displacement for r in m.results if r.time > 0]
    assert len(errors_p) == 5
    assert all(e < 0.05 for e in errors_p)
    assert all(e < 2e-3 for e in errors_u)
    assert errors_p[-1] < errors_p[0]


@pytest.mark.parametrize(
    "case, fields",
    [
        ("terzaghi", ("error_pressure", "error_consolidation_degree")),
        ("mandel", ("error_pressure", "error_displacement", "error_flux")),
    ],
)
def test_errors_and_state_equal_porepy_tpus(case, fields, request):
    """Every saved time's errors within ``PARITY_TOL`` of porepy_tpu's, and
    the final displacement and pressure within ``PARITY_TOL`` of the
    largest value of porepy_tpu's."""
    m, m_jax = request.getfixturevalue(case)
    assert [r.time for r in m.results] == [r.time for r in m_jax.results]
    for field in fields:
        mine = np.array([getattr(r, field) for r in m.results])
        theirs = np.array([getattr(r, field) for r in m_jax.results])
        assert np.abs(mine - theirs).max() <= PARITY_TOL, field
    for var in ("u", "pressure"):
        a = m.equation_system.get_variable_values([var], time_step_index=0)
        b = np.asarray(m_jax.equation_system.get_variable_values([var], time_step_index=0))
        assert a.shape == b.shape and np.abs(a - b).max() <= PARITY_TOL * np.abs(b).max(), var


def test_terzaghi_on_the_device_route(terzaghi):
    """Terzaghi on the port's ``device_gmres`` route (the plain kernel
    versions on the CPU): every saved time's errors within 1e-8 of the host
    route's (3e-12 measured), as ``chip_smoke.py`` phase 29 holds the card
    to the host."""
    m_host, _ = terzaghi
    m = _run(TerzaghiModel, terzaghi_params(pt, device="cpu", linear_solver="device_gmres"))
    for field in ("error_pressure", "error_consolidation_degree"):
        mine = np.array([getattr(r, field) for r in m.results])
        host = np.array([getattr(r, field) for r in m_host.results])
        assert np.abs(mine - host).max() <= 1e-8, field
