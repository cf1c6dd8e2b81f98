"""The Jacobi-Krylov solve route (K18) of porepy_tpu_torch against
porepy_tpu on the CPU (the plain versions of the K18 kernels).

``porepy_tpu``'s ``solve_sparse`` hands its jitted ``_krylov`` the matrix
in the compiler's ELL layout, which is not a pytree, so it raises; its
``_krylov`` is fed here what its docstring names, a BCOO matrix. The biot
runs compare with ``porepy_tpu``'s ``scipy_sparse`` route instead."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg  # noqa: F401
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.applications.benchmarking import cases as cases_jax
from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.numerics.linalg import krylov
from porepy_tpu_torch.utils import device_policy

torch.set_num_threads(1)

METHODS = ("bicgstab", "gmres")


def _jax_krylov(A, b, method, tol=1e-12):
    """``porepy_tpu``'s jitted K18 iteration on a BCOO matrix."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from porepy_tpu.numerics.linalg.krylov import _krylov

    A = sps.csr_matrix(A)
    dinv = krylov._inverse_diagonal(A)
    x = _krylov(
        jsparse.BCOO.from_scipy_sparse(A), jnp.asarray(b), jnp.asarray(dinv),
        method, tol, max(200, 4 * A.shape[0]),
    )
    return np.asarray(x)


def _biot_params(pt, cases, solver, **kwargs):
    """biot at 1/16 for ten steps, the per-step host Newton loop (no fused
    time blocks: those are for the ``device*`` solvers) with ``solver``."""
    Model, params = cases.build_biot(**kwargs)
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["meshing_arguments"] = {"cell_size": 1.0 / 16}
    params["time_manager"] = pt.TimeManager([0, 10.0], 1.0, constant_dt=True)
    params["linear_solver"] = solver
    return Model, params


@pytest.fixture(scope="module")
def biot_system():
    """The first Newton system of biot 1/16 (768 dofs), host-assembled."""
    Model, params = _biot_params(pt_torch, cases_torch, "scipy_sparse", device="cpu")
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    model.assemble_linear_system()
    A, b = model.linear_system
    return sps.csr_matrix(A), np.asarray(b)


def _random_system(n=400, seed=3):
    """Seeded, diagonally dominant and nonsymmetric."""
    rng = np.random.default_rng(seed)
    A = sps.random(n, n, density=0.02, random_state=seed, format="csr")
    A = A - A.T * 0.5
    diag = np.abs(A).sum(axis=1).A1 + rng.uniform(0.5, 2.0, n)
    return sps.csr_matrix(A + sps.diags(diag)), rng.standard_normal(n)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("system", ["biot_1_16", "random"])
def test_solve_sparse_matches_jax_krylov(biot_system, method, system):
    """The port's route (the K18 kernels' plain versions, ``device="cpu"``)
    against ``porepy_tpu``'s ``_krylov``: x within 1e-9 of max |x|."""
    A, b = biot_system if system == "biot_1_16" else _random_system()
    before = krylov.FALLBACK_COUNTER["count"]
    got = krylov.solve_sparse(A, b, method=method, device="cpu")
    assert krylov.FALLBACK_COUNTER["count"] == before
    assert krylov.LAST_SOLVE["iterations"] > 0
    want = _jax_krylov(A, b, method)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    assert np.linalg.norm(b - A @ got) <= 1e-10 * np.linalg.norm(b)


def _per_iteration_passes(A, b, atol2, maxiter):
    """The BiCGStab route as it ran before its iterations became one kernel:
    the plain K18a passes around two matvecs an iteration (rounded as the
    kernels round them, ``reference.ell_spmv_ordered``), three partial rows,
    the continue flag read every iteration. Returns ``(vectors, st,
    iterations)`` with ``vectors`` ``[x, r, rhat, p, q, phat, s, shat, t]``."""
    n = A.shape[0]
    val, col = reference.csr_ell(*krylov.csr_arrays(A, "cpu"), n)
    dinv, bt = torch.tensor(krylov._inverse_diagonal(A)), torch.tensor(b)
    x = torch.zeros(n, dtype=torch.float64)
    r = bt - reference.ell_spmv_ordered(val, col, x)
    rhat, p, q = r.clone(), r.clone(), r.clone()
    phat, s, shat, t = (torch.zeros(n, dtype=torch.float64) for _ in range(4))
    partials = torch.zeros(3, -(-n // reference.KRYLOV_BLOCK), dtype=torch.float64)
    st = krylov.bicgstab_state(n, atol2, "cpu")[-2]
    cont = torch.zeros(1, dtype=torch.int32)
    reference.krylov_dots(r, r, r, r, partials, 1)
    reference.bicgstab_scalars(partials, st, cont, reference.STAGE_INIT)
    k = 0
    while k < maxiter and bool(cont):
        reference.bicgstab_p(r, q, dinv, st, p, phat)
        q = reference.ell_spmv_ordered(val, col, phat)
        reference.krylov_dots(rhat, q, rhat, q, partials, 1)
        reference.bicgstab_scalars(partials, st, cont, reference.STAGE_ALPHA)
        reference.bicgstab_s(r, q, dinv, st, s, shat, partials)
        t = reference.ell_spmv_ordered(val, col, shat)
        reference.krylov_dots(t, s, t, t, partials[1:], 2)
        reference.bicgstab_scalars(partials, st, cont, reference.STAGE_OMEGA)
        reference.bicgstab_xr(x, r, phat, shat, s, t, rhat, st, partials)
        reference.bicgstab_scalars(partials, st, cont, reference.STAGE_NEXT)
        k += 1
    return [x, r, rhat, p, q, phat, s, shat, t], st, k


def _bicgstab_chunked(A, b, atol2, maxiter, chunk=None):
    """A solve through ``kernels.bicgstab_cycle`` (its plain version here):
    the start, then launches of ``chunk`` iterations (default: the whole
    remaining budget). Returns the state and the number of launches after
    the start."""
    n = A.shape[0]
    csr = krylov.csr_arrays(A, "cpu")
    dinv, bt = torch.tensor(krylov._inverse_diagonal(A)), torch.tensor(b)
    state = krylov.bicgstab_state(n, atol2, "cpu")
    kernels.bicgstab_cycle(*csr, dinv, bt, *state, 0)
    launches = 0
    while state[-1][1] < maxiter and bool(state[-1][0]):
        left = maxiter - int(state[-1][1])
        kernels.bicgstab_cycle(*csr, dinv, bt, *state, left if chunk is None else min(chunk, left))
        launches += 1
    return state, launches


def _same_bits(a, b):
    """Equal, NaN where the other is NaN (a breakdown's 0/0)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _breakdown_system():
    """A unit-diagonal 3 x 3 system on which the first BiCGStab iteration
    breaks down exactly: <t, s> = 0 with s, t nonzero, so omega = 0."""
    A = sps.csr_matrix(np.array([[1.0, 0.0, 0.0], [1.0, 1.0, -2.0], [1.0, 0.0, 1.0]]))
    return A, np.array([1.0, 0.0, 0.0])


@pytest.mark.parametrize("chunk", [1, 7, None], ids=["chunks-of-1", "chunks-of-7", "whole"])
@pytest.mark.parametrize("system", ["biot_1_16", "random"])
def test_bicgstab_cycle_equals_the_per_iteration_passes(biot_system, system, chunk):
    """K18a's plain version, ``reference.bicgstab_cycle``, run as the solve
    runs it (a start, then launches of 1, 7 or all remaining iterations)
    gives the same bits as the per-iteration passes it composes: every
    vector, every scalar of the state, the iteration count and the stop."""
    A, b = biot_system if system == "biot_1_16" else _random_system()
    atol2 = 1e-24 * float(b @ b)
    maxiter = max(200, 4 * A.shape[0])
    want, want_st, want_k = _per_iteration_passes(A, b, atol2, maxiter)
    state, launches = _bicgstab_chunked(A, b, atol2, maxiter, chunk)
    assert 0 < want_k < maxiter
    assert state[-1].tolist() == [0, want_k]
    assert launches == (1 if chunk is None else -(-want_k // chunk))
    assert all(torch.equal(g, w) for g, w in zip(state[:9], want))
    assert torch.equal(state[-2], want_st)
    assert np.linalg.norm(b - A @ state[0].numpy()) <= 1e-10 * np.linalg.norm(b)


def test_bicgstab_cycle_stops_at_maxiter():
    """A budget of 5 iterations stops the solve after 5, the continue flag
    still set, with the bits of 5 per-iteration passes."""
    A, b = _random_system()
    atol2 = 1e-24 * float(b @ b)
    want, want_st, want_k = _per_iteration_passes(A, b, atol2, 5)
    state, launches = _bicgstab_chunked(A, b, atol2, 5, chunk=3)
    assert want_k == 5 and launches == 2 and state[-1].tolist() == [1, 5]
    assert all(torch.equal(g, w) for g, w in zip(state[:9], want))
    assert torch.equal(state[-2], want_st)
    x, k = krylov._bicgstab_fused(krylov.csr_arrays(A, "cpu"), torch.tensor(b),
                                  torch.tensor(krylov._inverse_diagonal(A)), atol2, 5)
    assert k == 5 and torch.equal(x, want[0])


def test_bicgstab_cycle_stops_on_breakdown():
    """omega = 0 in the first iteration: the solve stops there on the
    device, its update kept (x = e_0), as the per-iteration passes stop."""
    A, b = _breakdown_system()
    want, want_st, want_k = _per_iteration_passes(A, b, 0.0, 10)
    state, launches = _bicgstab_chunked(A, b, 0.0, 10)
    assert want_k == 1 and launches == 1 and state[-1].tolist() == [0, 1]
    assert float(state[-2][reference.BICG_OMEGA]) == 0.0
    assert state[-2][reference.BICG_RR] > 0
    assert state[0].tolist() == [1.0, 0.0, 0.0]
    assert all(torch.equal(g, w) for g, w in zip(state[:9], want))
    assert _same_bits(state[-2], want_st)


@pytest.mark.parametrize("method", METHODS)
def test_plain_iterations_match_jax(biot_system, method):
    """The plain versions that ``chip_smoke.py`` holds the K18 kernels
    against, ``krylov.bicgstab`` and ``krylov.gmres``, against jax's."""
    A, b = biot_system
    At = torch.sparse_csr_tensor(
        torch.tensor(A.indptr, dtype=torch.int64), torch.tensor(A.indices, dtype=torch.int64),
        torch.tensor(A.data), size=A.shape,
    )
    dinv = torch.tensor(krylov._inverse_diagonal(A))
    solve = krylov.gmres if method == "gmres" else krylov.bicgstab
    kwargs = {"restart": 30} if method == "gmres" else {}
    x, _ = solve(
        lambda v: torch.mv(At, v), torch.tensor(b), tol=1e-12,
        maxiter=max(200, 4 * A.shape[0]), M=lambda v: dinv * v, **kwargs,
    )
    want = _jax_krylov(A, b, method)
    assert np.abs(x.numpy() - want).max() <= 1e-9 * np.abs(want).max()


def test_solve_sparse_falls_back_and_counts():
    """One iteration cannot reach the tolerance; the host check catches it,
    counts one fallback and returns spsolve's answer."""
    A, b = _random_system()
    before = krylov.FALLBACK_COUNTER["count"]
    x = krylov.solve_sparse(A, b, method="bicgstab", maxiter=1, device="cpu")
    assert krylov.FALLBACK_COUNTER["count"] == before + 1
    assert np.allclose(x, sps.linalg.spsolve(A, b), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def biot_reference():
    """``porepy_tpu``'s biot 1/16, ten steps, host direct solves."""
    Model, params = _biot_params(pt_jax, cases_jax, "scipy_sparse")
    model = Model(params)
    pt_jax.run_time_dependent_model(model, params)
    return model


@pytest.mark.parametrize("solver", ["jax_bicgstab", "jax_gmres"])
def test_biot_with_krylov_route_matches_jax(biot_reference, solver):
    """biot 1/16 through the port's K18 route against ``porepy_tpu``'s
    ``scipy_sparse`` run (its K18 route raises): 1e-8 of each field's max,
    no fallback."""
    Model, params = _biot_params(pt_torch, cases_torch, solver, device="cpu")
    model = Model(params)
    before = krylov.FALLBACK_COUNTER["count"]
    pt_torch.run_time_dependent_model(model, params)
    assert krylov.FALLBACK_COUNTER["count"] == before
    assert krylov.LAST_SOLVE["method"] == solver.split("_")[1]
    for var in ("u", "pressure"):
        got = model.equation_system.get_variable_values([var], time_step_index=0)
        want = biot_reference.equation_system.get_variable_values([var], time_step_index=0)
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max(), var


def test_jacobi_preconditioner_defaults_to_the_device_policy(biot_system, monkeypatch):
    """Without ``device`` the preconditioner asks the device policy (the
    card); ``device="cpu"`` keeps it on the host."""
    A, _ = biot_system
    asked = []
    resolve = device_policy.resolve

    def spy(device):
        asked.append(device)
        return resolve("cpu")

    monkeypatch.setattr(device_policy, "resolve", spy)
    M = krylov.jacobi_preconditioner(A)
    assert asked == [None]
    monkeypatch.setattr(device_policy, "resolve", resolve)
    x = torch.ones(A.shape[0], dtype=torch.float64)
    assert np.allclose(M(x).numpy(), krylov._inverse_diagonal(A))
    assert krylov.jacobi_preconditioner(A, device="cpu")(x).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            krylov.jacobi_preconditioner(A)
