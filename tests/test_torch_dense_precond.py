"""The dense frozen block inverse (K6) of porepy_tpu_torch against
porepy_tpu's.

Inputs are made with numpy from a seed and handed to both packages; both
run on the CPU, the port with the plain versions of its kernels. Every
solver is built with ``dense`` given explicitly, since ``porepy_tpu`` turns
dense inverses on by itself only on a TPU.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt_torch
from porepy_tpu.numerics.linalg import device_solver as ds_jax
from porepy_tpu.numerics.linalg.krylov import FALLBACK_COUNTER as FB_JAX
from porepy_tpu_torch import kernels
from porepy_tpu_torch.numerics.linalg import device_solver as ds_torch
from porepy_tpu_torch.numerics.linalg.krylov import FALLBACK_COUNTER as FB_TORCH

torch.set_num_threads(1)

SOLID = dict(
    permeability=1.0, porosity=0.1, residual_aperture=0.01, normal_permeability=1.0
)


def _well_conditioned(n, seed):
    """Diagonally dominant f32 matrix, condition number about 3: block
    Gauss-Jordan without pivoting between blocks is stable on it."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) / np.sqrt(n) + 4.0 * np.eye(n)).astype(np.float32)


# |A X - I| and |X_port - X_jax| of an f32 inverse of a matrix with
# condition number kappa are about kappa * n * eps_f32 at worst; here
# kappa ~ 3 and n <= 2048 give ~4e-4, and the observed values are ~1e-6.
INV_RESIDUAL_TOL = 1e-4
INV_DISTANCE_TOL = 1e-5


@pytest.mark.parametrize("n", [512, 2048])
def test_blocked_inverse_matches_jax(n):
    """At n = 512 porepy_tpu inverts directly (n <= its 1024-row pivot),
    at 2048 by its Gauss-Jordan loop; the port by 128-row pivot steps."""
    import jax.numpy as jnp

    A = _well_conditioned(n, n)
    X_j = np.asarray(ds_jax._dense_block_inv(jnp.asarray(A)))
    X_t = ds_torch._dense_block_inv(torch.tensor(A)).numpy()
    eye = np.eye(n)
    A64 = A.astype(np.float64)
    for X in (X_j, X_t):
        assert np.abs(A64 @ X - eye).max() <= INV_RESIDUAL_TOL
    assert np.abs(X_t - X_j).max() <= INV_DISTANCE_TOL * np.abs(X_j).max()


def test_blocked_inverse_runs_in_place():
    A = torch.tensor(_well_conditioned(256, 1))
    X = ds_torch._dense_block_inv(A)
    assert X.data_ptr() == A.data_ptr()


def test_pivot_inverse_pivots_inside_the_block():
    """A pivot block with a zero leading entry inverts (row pivoting, as
    jnp.linalg.inv's LU does); a singular one sets its flag."""
    rng = np.random.default_rng(4)
    good = _well_conditioned(128, 5).astype(np.float64)
    good[[0, 1]] = good[[1, 0]]
    good[0, 0] = 0.0
    singular = np.outer(np.arange(1.0, 129.0), np.arange(1.0, 129.0))
    batch = torch.tensor(np.stack([good, singular, rng.standard_normal((128, 128))]))
    flag = torch.zeros(3, dtype=torch.int32)
    inv = kernels.gj_pivot_inverse(batch, flag)
    assert flag.tolist() == [0, 1, 0]
    for m in (0, 2):
        err = np.abs(batch[m].numpy() @ inv[m].numpy() - np.eye(128)).max()
        assert err <= 1e-10


def test_scatter_and_apply_match_jax_expressions():
    """The plain scatter (coalesced COO + identity pad) and apply (pad,
    f32 GEMV, slice, cast back) against the expressions of
    porepy_tpu's _dense_inv_fn and build.apply."""
    import jax.numpy as jnp

    ni, n_pad = 200, 256
    rng = np.random.default_rng(6)
    S = sps.random(ni, ni, density=0.05, random_state=6, format="coo")
    S.sum_duplicates()
    vals = S.data.astype(np.float32)
    rows, cols = S.row.astype(np.int32), S.col.astype(np.int32)
    Ad = jnp.zeros((n_pad, n_pad), jnp.float32).at[rows, cols].add(vals)
    pad = jnp.arange(ni, n_pad, dtype=jnp.int32)
    Ad = np.asarray(Ad.at[pad, pad].set(1.0))
    D = kernels.dense_block_scatter(
        torch.tensor(vals), torch.tensor(rows), torch.tensor(cols), ni, n_pad
    )
    np.testing.assert_array_equal(D.numpy(), Ad)

    r = rng.standard_normal(ni)
    rp = jnp.pad(jnp.asarray(r).astype(jnp.float32), (0, n_pad - ni))
    want = np.asarray((jnp.asarray(Ad) @ rp)[:ni].astype(jnp.float64))
    got = kernels.dense_block_apply(D, torch.tensor(r))
    assert got.dtype == torch.float64
    # f32 GEMV: a few ulps of each row's sum of |terms|.
    bound = 1e-5 * (np.abs(Ad[:ni, :ni]) @ np.abs(r))
    assert np.all(np.abs(got.numpy() - want) <= bound)


def _md_flow(pt, solver, dense, **extra):
    class MD(pt.SinglePhaseFlow):
        def set_fractures(self):
            self._fractures = [
                pt.LineFracture(np.array([[0.25, 0.75], [0.5, 0.5]])),
                pt.LineFracture(np.array([[0.5, 0.5], [0.25, 0.75]])),
            ]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 1 / 16},
        "material_constants": {
            "solid": pt.SolidConstants(**SOLID),
            "fluid": pt.FluidComponent(compressibility=1e-6, viscosity=1.0, density=1.0),
        },
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": solver,
        "dense_precond": dense,
        **extra,
    }
    m = MD(params)
    pt.run_time_dependent_model(m, params)
    return m


def test_dense_preconditioner_md_flow():
    """Mirror of tests/numerics/test_device_solver.py:153: md 1/16 with
    dense frozen inverses reproduces the host direct solution to 1e-10
    relative, without host fallback and without demotion; porepy_tpu's
    dense run gives the same state."""
    ref = _md_flow(pt_torch, "scipy_sparse", False, device="cpu")
    ref = ref.equation_system.get_variable_values(time_step_index=0)
    before = (FB_JAX["count"], FB_TORCH["count"])
    m = _md_flow(pt_torch, "device_gmres", True, device="cpu")
    m_jax = _md_flow(pt_jax, "device_gmres", True)
    assert (FB_JAX["count"], FB_TORCH["count"]) == before, "a solve fell back to host"
    solver = next(iter(m._device_solvers.values()))
    assert solver._dense, "dense preconditioner was demoted"
    assert next(iter(m_jax._device_solvers.values()))._dense
    dev = m.equation_system.get_variable_values(time_step_index=0)
    assert np.linalg.norm(dev - ref) / np.linalg.norm(ref) < 1e-10
    dev_jax = m_jax.equation_system.get_variable_values(time_step_index=0)
    assert np.linalg.norm(dev - dev_jax) / np.linalg.norm(ref) < 1e-10


def _ten_order_block(n=120, seed=3):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    core = Q @ Q.T + n * np.eye(n)
    s = 10.0 ** rng.uniform(-5, 5, n)
    return sps.csr_matrix(np.diag(s) @ core @ np.diag(s))


def test_dense_block_inverse_validates_on_ten_order_scaling():
    """Mirror of test_device_solver.py:221: a well-posed block whose rows
    and columns span ~10 orders of magnitude passes the equilibrated-space
    condition gate and yields an accurate frozen inverse (5% contract on
    fresh probes); it agrees with porepy_tpu's inverse to f32 level."""
    A = _ten_order_block()
    n = A.shape[0]
    b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
    b.dense_limit = 1024
    minv = b._build_dense_block(A).numpy()[:n, :n]
    dr, dc = ds_torch._ruiz_scaling(A)
    S_eq = np.diag(dr) @ A.toarray() @ np.diag(dc)
    inv_eq = np.diag(1.0 / dc) @ minv @ np.diag(1.0 / dr)
    for seed in (11, 12, 13):
        e = np.random.default_rng(seed).standard_normal(n)
        e /= np.linalg.norm(e)
        assert np.linalg.norm(S_eq @ (inv_eq @ e) - e) < 0.05

    bj = ds_jax._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None)
    bj.dense_limit = 1024
    inv_eq_j = np.diag(1.0 / dc) @ np.asarray(bj._build_dense_block(A))[:n, :n] @ np.diag(1.0 / dr)
    # Equilibrated inverses, cond(S_eq) <= 1e5 by the gate: f32 agreement
    # to 1e-3 of the largest entry.
    assert np.abs(inv_eq - inv_eq_j).max() <= 1e-3 * np.abs(inv_eq_j).max()


def test_dense_block_inverse_demotes_deterministically_on_singular_block():
    """Mirror of test_device_solver.py:257: a numerically singular block
    fails the condition gate (estimate = inf) and the full build demotes it
    to its sparse method, on every rebuild."""
    n = 64
    A = sps.csr_matrix(np.outer(np.arange(1, n + 1.0), np.arange(1, n + 1.0)))
    for _ in range(3):
        b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
        b.dense_limit = 1024
        with pytest.raises(FloatingPointError, match="gated off"):
            b._build_dense_block(A)
        _state, _apply, _h = b.build(A)
        assert b._block_dense.get(0) is False, "block was not demoted"
        assert not _state["dense"]


def test_zero_leading_pivot_inverts_through_pivoting():
    """Well conditioned, but its leading entry stays 0 under Ruiz scaling:
    the port inverts it (row pivoting inside the pivot block), as
    porepy_tpu does with jnp.linalg.inv."""
    n = 100
    A = _well_conditioned(n, 7).astype(np.float64)
    A[[0, 1]] = A[[1, 0]]
    A[0, 0] = 0.0
    A = sps.csr_matrix(A)
    b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
    b.dense_limit = 1024
    minv = b._build_dense_block(A).numpy()[:n, :n]
    assert np.abs(A @ minv - np.eye(n)).max() <= 1e-5
    bj = ds_jax._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None)
    bj.dense_limit = 1024
    minv_j = np.asarray(bj._build_dense_block(A))[:n, :n]
    assert np.abs(minv - minv_j).max() <= 1e-5 * np.abs(minv_j).max()


def _swapped_halves(n=256):
    """A permutation matrix (condition number 1, so the gate passes) whose
    leading 128 x 128 pivot block is zero."""
    P = np.zeros((n, n))
    P[np.arange(128), np.arange(128, 256)] = 1.0
    P[np.arange(128, 256), np.arange(128)] = 1.0
    return sps.csr_matrix(P)


def test_singular_pivot_block_demotes_through_the_pivot_flag(monkeypatch):
    """A block whose leading pivot block is singular in its own order and
    in the row order the second build takes (here made the same order):
    the unpivoted block elimination cannot invert it, the pivot flag turns
    that into FloatingPointError, and the build demotes the block."""
    A = _swapped_halves()
    n = A.shape[0]
    monkeypatch.setattr(ds_torch, "_pivot_row_order", lambda S: np.arange(S.shape[0]))
    b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
    b.dense_limit = 1024
    with pytest.raises(FloatingPointError, match="pivot"):
        b._build_dense_block(A)
    b.build(A)
    assert b._block_dense.get(0) is False


def test_singular_leading_pivot_block_inverts_in_the_lu_row_order():
    """The same block in the default route: the pivot flag of the first
    build sends it to a second one with its rows in its sparse LU's order,
    where every leading pivot block is nonsingular, and the inverse comes
    back in the block's order: exact here, as porepy_tpu's (which pivots
    over 1024-row blocks, so over this block whole), and the block stays
    dense, marked as reordered."""
    A = _swapped_halves()
    n = A.shape[0]
    perm = ds_torch._pivot_row_order(A)
    assert sorted(perm) == list(range(n))
    lead = A.toarray()[np.argsort(perm)][:128, :128]
    assert np.linalg.matrix_rank(lead) == 128
    b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
    b.dense_limit = 1024
    minv = b._build_dense_block(A).numpy()[:n, :n]
    np.testing.assert_array_equal(minv, A.toarray().T)
    bj = ds_jax._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None)
    bj.dense_limit = 1024
    np.testing.assert_array_equal(minv, np.asarray(bj._build_dense_block(A))[:n, :n])
    b.build(A)
    assert b._block_dense.get(0) is True and b._block_reordered.get(0) is True
    assert b._pivot_reorders == 2


def test_lu_row_order_inverts_rows_without_leading_entries():
    """A well-conditioned, unsymmetric block ``[[0, E], [F, G]]`` (64 + 128
    rows) whose first 64 rows read the last 64 columns only, as thm's
    contact block's tangential rows read no tangential column: its leading
    128-row pivot block is singular. The reordered build inverts it to f32
    level, and agrees with porepy_tpu's inverse."""
    rng = np.random.default_rng(21)
    n = 192
    A = np.zeros((n, n))
    A[:64, 128:] = _well_conditioned(64, 22)
    A[64:, :128] = _well_conditioned(128, 23)
    A[64:, 128:] = 0.1 * rng.standard_normal((128, 64))
    assert np.linalg.cond(A) < 10.0
    assert np.linalg.matrix_rank(A[:128, :128]) == 64
    A = sps.csr_matrix(A)
    b = ds_torch._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None, "cpu")
    b.dense_limit = 1024
    minv = b._build_dense_block(A).numpy()[:n, :n].astype(np.float64)
    assert b._pivot_reorders == 1
    assert np.abs(A @ minv - np.eye(n)).max() <= INV_RESIDUAL_TOL
    bj = ds_jax._BlockPrecondBuilder([(np.arange(n), np.arange(n))], ["jacobi"], None, None)
    bj.dense_limit = 1024
    minv_j = np.asarray(bj._build_dense_block(A))[:n, :n]
    assert np.abs(minv - minv_j).max() <= INV_RESIDUAL_TOL * np.abs(minv_j).max()
