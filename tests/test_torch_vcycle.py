"""The V-cycle (K3, one ``amg_vcycle`` launch) and the Jacobi block's sweeps
(K2, one ``jacobi_sweeps`` launch) of porepy_tpu_torch.

On the CPU, with the plain versions (:func:`reference.amg_vcycle`,
:func:`reference.jacobi_sweeps`):

- ``Hierarchy.apply`` against porepy_tpu's ``Hierarchy.apply`` at md 1/32
  (the set-up of ``tests/test_torch_solver.py``), from the port's own state
  and from the jax package's state handed in, in f32 (1e-5 of max |y|) and
  in f64 (1e-12);
- the plain V-cycle against the composition it replaced
  (``vcycle_check.Composition``: K1 launchers, one-sweep K2 launches,
  ``torch.matmul``);
- the plain sweeps against porepy_tpu's ``_jacobi_sweeps``;
- what ``VCycleOperator`` refuses.

The tests marked ``cuda`` hold the kernels against their plain versions to
the bit at md 1/32 and 1/128 and skip without a card; only the CPU tests
import jax and porepy_tpu, inside their fixtures:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vcycle.py -m cuda
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking import cases as cases_torch
from porepy_tpu_torch.applications.benchmarking.vcycle_check import COMPOSITION_TOL, Composition, state_as
from porepy_tpu_torch.interop import tensors_from_numpy
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.numerics.linalg import amg, device_solver

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _md_solver(cell_size: float, device: str):
    """The port's device solver of md at ``cell_size``, its preconditioner
    built from the first Jacobian."""
    Model, params = cases_torch.build_md_flow(cell_size, device=device)
    params["dense_precond"] = False
    model = Model(params)
    model.prepare_simulation()
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    solver = model._device_solver_for(cs)
    solver.refresh_preconditioner(cs.assemble(eq_sys)[0])
    return solver


@pytest.fixture(scope="module")
def md():
    """md 1/32 in both packages, the jax package's frozen state handed to
    the port (as in ``tests/test_torch_solver.py``), and a float64
    hierarchy of each package from the port's host levels."""
    import jax
    import jax.numpy as jnp

    from porepy_tpu.applications.benchmarking import cases as cases_jax
    from porepy_tpu.numerics.linalg import amg as amg_jax

    Model, params = cases_jax.build_md_flow(1.0 / 32)
    params["dense_precond"] = False
    m_jax = Model(params)
    m_jax.prepare_simulation()
    cs_jax = m_jax.equation_system.compiled_system()
    x = m_jax.equation_system._global_vector()
    data, _b = cs_jax._data_and_rhs_host(x, cs_jax._envs_host(m_jax.equation_system))
    s_jax = m_jax._device_solver_for(cs_jax)
    s_jax.refresh_preconditioner(data)
    Model, params = cases_torch.build_md_flow(1.0 / 32, device="cpu")
    m_torch = Model(params)
    m_torch.prepare_simulation()
    s_torch = m_torch._device_solver_for(m_torch.equation_system.compiled_system())
    s_torch.refresh_preconditioner(torch.tensor(data))
    (i,) = s_torch._hierarchies
    h_t, h_j = s_torch._hierarchies[i], s_jax._hierarchies[i]
    jax_state = jax.tree_util.tree_map(np.asarray, s_jax._m_state["amg"][i])
    # float64 hierarchies of both packages from the port's host levels.
    levels = h_t._levels_host
    A, P = levels[-1]["A"], levels[-1]["P"]
    coarse_inv = amg._safe_inv((P.T @ A @ P).toarray())
    return {
        "jax": h_j,
        "torch": h_t,
        "jax_state": jax_state,
        "jax_state_t": tensors_from_numpy(jax_state, "cpu"),
        "torch64": amg.Hierarchy(levels, coarse_inv, dtype=torch.float64, device="cpu"),
        "jax64": amg_jax.Hierarchy(levels, coarse_inv, dtype=jnp.float64),
        "jnp": jnp,
        "amg_jax": amg_jax,
    }


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("state", ["own", "jax"])
def test_hierarchy_apply_matches_jax(md, state, dtype):
    """One V-cycle of the port (on the CPU the plain ``amg_vcycle``)
    against porepy_tpu's ``Hierarchy.apply`` at md 1/32 (a smoothing level
    and the coarse one), the
    port from its own state or from the jax package's handed in."""
    jnp = md["jnp"]
    n = md["torch"].level_sizes[0]
    r = np.random.default_rng(5).standard_normal(n)
    if dtype == "f32":
        h_t, h_j = md["torch"], md["jax"]
        st_j = md["jax_state"]
        st_t = h_t.state if state == "own" else md["jax_state_t"]
        r = r.astype(np.float32)
    else:
        h_t, h_j = md["torch64"], md["jax64"]
        if state == "own":
            st_t, st_j = h_t.state, h_j.state
        else:
            st_j = {
                "levels": [{k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in lv.items()}
                           for lv in md["jax_state"]["levels"]],
                "coarse_inv": md["jax_state"]["coarse_inv"].astype(np.float64),
            }
            st_t = tensors_from_numpy(st_j, "cpu")
    assert len(h_t.level_sizes) >= 2
    want = np.asarray(h_j.apply(st_j, jnp.asarray(r)))
    got = h_t.apply(st_t, torch.tensor(r))
    assert got.dtype == DTYPES[dtype]
    assert _rel_err(got.numpy(), want) <= TOL[DTYPES[dtype]]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plain_vcycle_matches_composition(md, dtype):
    """The plain ``amg_vcycle`` (rows in slot order, the coarse product row
    by row) against the composition it replaced, which sums in other
    orders: within ``COMPOSITION_TOL`` of max |y|."""
    dt = DTYPES[dtype]
    hier = md["torch"]
    st = state_as(hier.state, dt)
    r = torch.tensor(np.random.default_rng(6).standard_normal(hier.level_sizes[0]), dtype=dt)
    got = reference.amg_vcycle(st["levels"], st["coarse_inv"], r, hier.nu)
    want = Composition(st, hier.nu)(r)
    assert float((got - want).abs().max()) <= COMPOSITION_TOL[dt] * float(want.abs().max())
    # The launcher on the CPU is the plain version.
    op = kernels.VCycleOperator(st["levels"], st["coarse_inv"], hier.nu)
    assert torch.equal(op(r), got)


def _jacobi_block(n: int, K: int, dtype, seed: int):
    """A diagonally dominant ELL matrix with padding and its damped l1
    smoother (as ``amg._l1_smoother`` makes it)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), K - 1)
    cols = rng.integers(0, n, rows.size)
    A = sps.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n))
    A = A + sps.diags(np.abs(A).sum(axis=1).A.ravel() + 1.0 + rng.random(n))
    val, col = amg._ell_arrays(A, dtype)
    return val, col, amg._l1_smoother(A).astype(dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("sweeps", [1, 2, 8, 40])
def test_plain_jacobi_sweeps_matches_jax(sweeps, dtype):
    """``device_solver._jacobi_sweeps`` through the block's ``JacobiSweeps``
    launcher (on the CPU the plain ``jacobi_sweeps``) against porepy_tpu's
    ``_jacobi_sweeps`` (device_solver.py:256)."""
    import jax.numpy as jnp

    from porepy_tpu.numerics.linalg import amg as amg_jax
    from porepy_tpu.numerics.linalg import device_solver as ds_jax

    dt = DTYPES[dtype]
    np_dt = np.float32 if dtype == "f32" else np.float64
    val, col, sinv = _jacobi_block(211, 7, np_dt, 8)
    r = np.random.default_rng(9).standard_normal(211).astype(np_dt)
    mv = lambda v: amg_jax.ell_matvec(jnp.asarray(val), jnp.asarray(col), v)  # noqa: E731
    want = np.asarray(ds_jax._jacobi_sweeps(mv, jnp.asarray(sinv), jnp.asarray(r), sweeps))
    op = kernels.JacobiSweeps(*(torch.tensor(a) for a in (val, col, sinv)))
    got = device_solver._jacobi_sweeps(op, torch.tensor(r), sweeps)
    assert got.dtype == dt
    assert _rel_err(got.numpy(), want) <= TOL[dt]
    assert torch.equal(got, reference.jacobi_sweeps(op.val, op.col, op.sinv, torch.tensor(r), None, sweeps - 1))


@pytest.mark.parametrize("s", [0, -1])
def test_jacobi_sweeps_refuses_fewer_than_one(s):
    """A launch runs at least one sweep: ``_jacobi_sweeps`` makes ``sinv r``
    (one sweep frozen) without it."""
    val, col, sinv = _jacobi_block(17, 3, np.float32, 5)
    op = kernels.JacobiSweeps(*(torch.tensor(a) for a in (val, col, sinv)))
    with pytest.raises(ValueError):
        op(torch.ones(17), s)


def _small_state(levels: int, dtype=torch.float32, col_dtype=torch.int32):
    """A state of ``levels`` levels of 4 rows each (the coarse one too)."""
    n, K = 4, 2
    lv = {
        "A_val": torch.ones(n, K, dtype=dtype), "A_col": torch.zeros(n, K, dtype=col_dtype),
        "P_val": torch.ones(n, K, dtype=dtype), "P_col": torch.zeros(n, K, dtype=col_dtype),
        "R_val": torch.ones(n, K, dtype=dtype), "R_col": torch.zeros(n, K, dtype=col_dtype),
        "sinv": torch.ones(n, dtype=dtype),
    }
    return [dict(lv) for _ in range(levels)], torch.eye(n, dtype=dtype)


@pytest.mark.parametrize("fault", ["seven levels", "int64 columns", "mixed dtypes"])
def test_vcycle_operator_refusals(fault):
    levels, coarse = _small_state(7 if fault == "seven levels" else 2,
                                  col_dtype=torch.int64 if fault == "int64 columns" else torch.int32)
    if fault == "mixed dtypes":
        levels[1]["P_val"] = levels[1]["P_val"].double()
    with pytest.raises(ValueError if fault == "seven levels" else TypeError):
        kernels.VCycleOperator(levels, coarse, 2)
    if fault == "seven levels":
        # Six levels are taken.
        kernels.VCycleOperator(levels[:6], coarse, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("cell_size", [1 / 32, 1 / 128], ids=["md32", "md128"])
def test_cuda_vcycle_equals_plain(cuda, cell_size, dtype):
    """``amg_vcycle`` equals its plain version on the card to the bit, one
    launch an apply, at md's hierarchy (the state cast for f64) with the
    case's ``nu`` = 2 and with 1 and 3; and the block's ``jacobi_sweeps``
    launches equal theirs at the finest level."""
    dt = DTYPES[dtype]
    hier = next(iter(_md_solver(cell_size, str(cuda))._hierarchies.values()))
    st = state_as(hier.state, dt)
    r = torch.tensor(np.random.default_rng(7).standard_normal(hier.level_sizes[0]), dtype=dt, device=cuda)
    for nu in (hier.nu, 1, 3):
        op = kernels.VCycleOperator(st["levels"], st["coarse_inv"], nu)
        kernels.reset_launches()
        y = op(r)
        assert kernels.LAUNCHES["amg_vcycle"] == 1
        assert torch.equal(y, reference.amg_vcycle(st["levels"], st["coarse_inv"], r, nu))
    lv = st["levels"][0]
    sweeps = kernels.JacobiSweeps(lv["A_val"], lv["A_col"], lv["sinv"])
    for s in (1, 2, 7):
        want = reference.jacobi_sweeps(lv["A_val"], lv["A_col"], lv["sinv"], r, None, s)
        assert torch.equal(sweeps(r, s), want)
    assert torch.equal(sweeps(r, 1, want), reference.ell_jacobi_sweep(lv["A_val"], lv["A_col"], lv["sinv"], r, want))
