"""Device assembly of porepy_tpu_torch against porepy_tpu on the md case.

Both packages set up md at cell size 1/16; the port then evaluates its
compiled equations on the jax package's own inputs (state vector and env
tuples, handed over through ``porepy_tpu_torch.interop``), so any
difference comes from the traced residual and the colored-JVP assembly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.interop import tensors_from_numpy

torch.set_num_threads(1)

EQUATIONS = ["mass_balance_equation", "interface_darcy_flux_equation"]


@pytest.fixture(scope="module")
def md_pair():
    Model, params = cases_jax.build_md_flow(1.0 / 16)
    params["dense_precond"] = False
    m_jax = Model(params)
    m_jax.prepare_simulation()
    Model, params = cases_torch.build_md_flow(1.0 / 16, device="cpu")
    m_torch = Model(params)
    m_torch.prepare_simulation()
    cs_jax = m_jax.equation_system.compiled_system()
    cs_torch = m_torch.equation_system.compiled_system()
    # A state away from the initial one: both pressure and mortar fluxes
    # nonzero, so every term of both equations is exercised.
    x0 = m_jax.equation_system._global_vector()
    x = x0 + np.random.default_rng(0).uniform(0.0, 1.0, x0.size)
    envs = cs_jax._envs_host(m_jax.equation_system)
    return {
        "cs_jax": cs_jax,
        "cs_torch": cs_torch,
        "eq_sys_torch": m_torch.equation_system,
        "x": x,
        "envs": envs,
        "x_t": torch.tensor(x),
        "envs_t": tensors_from_numpy(envs, "cpu"),
    }


def test_same_structure(md_pair):
    cs_j, cs_t = md_pair["cs_jax"], md_pair["cs_torch"]
    assert cs_t.names == cs_j.names == tuple(EQUATIONS)
    assert cs_t.shape == cs_j.shape
    np.testing.assert_array_equal(cs_t.indices_np, cs_j.indices_np)
    for ce_t, ce_j in zip(cs_t.ces, cs_j.ces):
        assert ce_t.n_colors == ce_j.n_colors
        assert len(ce_t.env_spec.fetchers) == len(ce_j.env_spec.fetchers)


@pytest.mark.parametrize("name", EQUATIONS)
def test_equation_residual_matches_rhs_only(md_pair, name):
    """Each equation's residual equals porepy_tpu's ``_rhs_only`` part to
    1e-13 relative (max norm)."""
    cs_j, cs_t = md_pair["cs_jax"], md_pair["cs_torch"]
    i = cs_j.names.index(name)
    want = -np.asarray(
        cs_j._rhs_only(jnp.asarray(md_pair["x"]), md_pair["envs"])
    )
    lo = cs_j.row_offsets[name]
    want = want[lo : lo + cs_j.ces[i].pattern.shape[0]]
    got = cs_t.ces[i].fn(md_pair["x_t"], *md_pair["envs_t"][i]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_jacobian_and_rhs_match_data_and_rhs_host(md_pair):
    """The Jacobian nonzeros (colored JVPs gathered into nonzero order) and
    the rhs equal porepy_tpu's ``_data_and_rhs_host`` to 1e-12 relative."""
    cs_j, cs_t = md_pair["cs_jax"], md_pair["cs_torch"]
    data_j, b_j = cs_j._data_and_rhs_host(md_pair["x"], md_pair["envs"])
    data_t, b_t = cs_t._data_and_rhs(md_pair["x_t"], md_pair["envs_t"])
    assert data_t.shape == data_j.shape and b_t.shape == b_j.shape
    assert np.abs(data_t.numpy() - data_j).max() <= 1e-12 * np.abs(data_j).max()
    assert np.abs(b_t.numpy() - b_j).max() <= 1e-12 * np.abs(b_j).max()


def test_own_env_fetch_matches(md_pair):
    """The port's own env fetch (device cache included) delivers the same
    inputs as the jax package's host fetch."""
    envs_t = md_pair["cs_torch"]._envs(md_pair["eq_sys_torch"])
    for env_t, env_j in zip(envs_t, md_pair["envs"]):
        assert len(env_t) == len(env_j)
        for a, b in zip(env_t, env_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
