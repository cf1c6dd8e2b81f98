"""The device solver of porepy_tpu_torch against porepy_tpu's.

Both packages set up md at cell size 1/32 (a two-level AMG hierarchy on
the pressure block) and build their block preconditioners from the same
Jacobian, both with ``dense=False``. The preconditioner tests hand the
jax package's frozen state (``_m_state``) to the port through
``porepy_tpu_torch.interop``, so both apply the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.interop import tensors_from_numpy

torch.set_num_threads(1)

# Preconditioner applies run in float32 on both sides.
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def solvers():
    Model, params = cases_jax.build_md_flow(1.0 / 32)
    params["dense_precond"] = False
    m_jax = Model(params)
    m_jax.prepare_simulation()
    Model, params = cases_torch.build_md_flow(1.0 / 32, device="cpu")
    m_torch = Model(params)
    m_torch.prepare_simulation()

    cs_jax = m_jax.equation_system.compiled_system()
    x = m_jax.equation_system._global_vector()
    data, b = cs_jax._data_and_rhs_host(x, cs_jax._envs_host(m_jax.equation_system))
    s_jax = m_jax._device_solver_for(cs_jax)
    s_jax.refresh_preconditioner(data)
    cs_torch = m_torch.equation_system.compiled_system()
    s_torch = m_torch._device_solver_for(cs_torch)
    s_torch.refresh_preconditioner(torch.tensor(data))
    m_state = jax.tree_util.tree_map(np.asarray, s_jax._m_state)
    A = sps.csr_matrix(
        (data, (cs_jax.indices_np[:, 0], cs_jax.indices_np[:, 1])), shape=cs_jax.shape
    )
    return {
        "jax": s_jax,
        "torch": s_torch,
        "m_state": m_state,
        "m_state_t": tensors_from_numpy(m_state, "cpu"),
        "data": data,
        "b": b,
        "A": A,
    }


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_field_split_and_hierarchy_match(solvers):
    s_j, s_t = solvers["jax"], solvers["torch"]
    assert s_t._builder.methods == s_j._builder.methods == ["amg", "eliminate"]
    (i,) = s_t._hierarchies
    assert s_t._hierarchies[i].level_sizes == s_j._hierarchies[i].level_sizes
    assert len(s_t._hierarchies[i].level_sizes) >= 2


def test_amg_apply_matches(solvers):
    """One SA-AMG V-cycle (K3, one ``amg_vcycle`` launch), float32."""
    s_j, s_t = solvers["jax"], solvers["torch"]
    (i,) = s_t._hierarchies
    n = s_t._hierarchies[i].level_sizes[0]
    r = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    want = np.asarray(s_j._hierarchies[i].apply(solvers["m_state"]["amg"][i], jnp.asarray(r)))
    got = s_t._hierarchies[i].apply(solvers["m_state_t"]["amg"][i], torch.tensor(r))
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= F32_TOL


def test_block_preconditioner_apply_matches(solvers):
    """The block Gauss-Seidel apply with mortar elimination (K7), float32,
    from the same frozen state."""
    s_j, s_t = solvers["jax"], solvers["torch"]
    r = np.random.default_rng(2).standard_normal(s_j.n).astype(np.float32)
    want = np.asarray(s_j._m_apply(solvers["m_state"], jnp.asarray(r)))
    got = s_t._m_apply(solvers["m_state_t"], torch.tensor(r))
    assert _rel_err(got.numpy(), want) <= F32_TOL


def test_own_preconditioner_state_matches(solvers):
    """The port's own host build gives the same frozen state (index
    tensors used only for gathers are int64 in the port)."""
    flat_j = jax.tree_util.tree_leaves(solvers["m_state"])
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), solvers["torch"]._m_state)
    )
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("tol", [1e-4, 1e-8])
def test_solves_meet_tolerance_with_close_krylov_counts(solvers, tol):
    """Both FGMRES-IR solves meet tol * |b| against the scipy matrix
    without the host fallback, and their Krylov counts differ by at most
    2."""
    from porepy_tpu.numerics.linalg.krylov import FALLBACK_COUNTER as fb_jax
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as fb_torch

    s_j, s_t = solvers["jax"], solvers["torch"]
    before = (fb_jax["count"], fb_torch["count"])
    A, b = solvers["A"], solvers["b"]
    x_j = s_j.solve(solvers["data"], b, tol=tol)
    x_t = s_t.solve(torch.tensor(solvers["data"]), torch.tensor(b), tol=tol)
    b_norm = np.linalg.norm(b)
    for x in (x_j, x_t):
        assert np.linalg.norm(A @ x - b) <= tol * b_norm
    assert (fb_jax["count"], fb_torch["count"]) == before
    assert abs(s_t.last_stats["krylov_iters"] - s_j.last_stats["krylov_iters"]) <= 2


def test_dense_preconditioner_builds_and_reports(solvers):
    """``dense=True`` on the md field split (pressure block dense after the
    mortar elimination): the solve meets its tolerance without host
    fallback and ``last_stats["dense"]`` reports the dense block."""
    from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver
    from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as fb_torch

    s_t = solvers["torch"]
    solver = DeviceLinearSolver(
        s_t.system, blocks=s_t._builder.blocks, methods=["amg", "eliminate"], dense=True
    )
    assert solver._dense
    before = fb_torch["count"]
    A, b = solvers["A"], solvers["b"]
    x = solver.solve(torch.tensor(solvers["data"]), torch.tensor(b), tol=1e-8)
    assert fb_torch["count"] == before
    assert np.linalg.norm(A @ x - b) <= 1e-8 * np.linalg.norm(b)
    assert solver.last_stats["dense"] is True
    assert solver._builder._block_dense == {0: True}


def _two_operation_launchers(monkeypatch):
    """Route every K1 launcher through the product and a separate torch
    subtraction or addition: the composition the epilogue replaced."""
    from porepy_tpu_torch.kernels import ops, reference

    def two_ops(self, x, c=None, sign=1):
        ax = reference.ell_spmv(self.val, self.col, x)
        if c is None:
            return ax if sign > 0 else -ax
        return c - ax if sign < 0 else c + ax

    monkeypatch.setattr(ops.EllOperator, "__call__", two_ops)


@pytest.mark.parametrize("state", ["own", "jax"])
def test_amg_apply_through_launchers_equals_two_operation_form(solvers, monkeypatch, state):
    """The V-cycle composed from launchers (K1 with ``r - A y`` and ``y + P
    z`` in its epilogue, the yardstick of ``vcycle_check.py`` that the one
    ``amg_vcycle`` launch replaced) equals, to the bit, the same cycle with
    the product and the torch operation apart; from the port's own state
    and from the jax package's state handed in (md at 1/32, the smallest md
    case with a coarse level)."""
    from porepy_tpu_torch.applications.benchmarking.vcycle_check import Composition

    s_t = solvers["torch"]
    (i,) = s_t._hierarchies
    hier = s_t._hierarchies[i]
    st = hier.state if state == "own" else solvers["m_state_t"]["amg"][i]
    r = torch.tensor(np.random.default_rng(3).standard_normal(hier.level_sizes[0]).astype(np.float32))
    fused = Composition(st, hier.nu)(r)
    _two_operation_launchers(monkeypatch)
    assert torch.equal(fused, Composition(st, hier.nu)(r))


@pytest.mark.parametrize("state", ["own", "jax"])
def test_block_preconditioner_through_launchers_equals_two_operation_form(
    solvers, monkeypatch, state
):
    """The block Gauss-Seidel apply (K7) with every ``r_i - C y_j`` in K1's
    epilogue equals, to the bit, the product and the torch subtraction
    apart."""
    s_t = solvers["torch"]
    st = s_t._m_state if state == "own" else solvers["m_state_t"]
    r = torch.tensor(np.random.default_rng(4).standard_normal(s_t.n).astype(np.float32))
    fused = s_t._m_apply(st, r)
    _two_operation_launchers(monkeypatch)
    assert torch.equal(fused, s_t._m_apply(st, r))
