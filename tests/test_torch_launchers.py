"""K1's launchers and fused epilogue, and K18b's one-launch GMRES restart.

On the CPU a launcher (``kernels.EllOperator``) and ``kernels.gmres_cycle``
run their plain versions; these tests hold the epilogue ``c + sign (A x)``
against ``porepy_tpu``'s ``ell_matvec`` followed by the same arithmetic in
jax, the launcher's bookkeeping, and the GMRES restart's plain version
against the seven plain passes it composes. The tests marked ``cuda`` hold
both kernels against their plain versions on the card and skip without one;
they need no jax, so on a machine with a card they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_launchers.py -m cuda
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.numerics.linalg import krylov

torch.set_num_threads(1)

# |port - jax| <= TOL * (|c| + row sum of |terms|): float64 agrees to
# rounding, float32 to a few ulps of the row's magnitude (sums run in
# another order).
TOL = {np.float64: 1e-13, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
# (c given, sign): A x; c - A x (a residual); c + A x (a correction).
FORMS = {"Ax": (False, 1), "c-Ax": (True, -1), "c+Ax": (True, 1)}


def _ell(n_rows, n_cols, K, dtype, seed):
    """Random padded-row operator: ~10% padding slots (col == n_cols) and
    every seventh row all padding."""
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((n_rows, K)).astype(dtype)
    col = rng.integers(0, n_cols, (n_rows, K)).astype(np.int32)
    pad = rng.random((n_rows, K)) < 0.1
    pad[::7] = True
    val[pad] = 0
    col[pad] = n_cols
    return val, col


def _rowsum(val, col, x):
    x_p = np.concatenate([np.abs(x), np.zeros(x.shape[:-1] + (1,))], axis=-1)
    return (np.abs(val) * x_p[..., col]).sum(-1)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("batch", [1, 17], ids=["B1", "B17"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_ell_epilogue_matches_amg_ell_matvec(dtype, batch, form):
    """The launcher's ``c + sign (A x)`` (plain version) against
    ``porepy_tpu``'s ``ell_matvec`` (vmapped over the batch rows) and the
    same subtraction or addition in jax; and to the bit the two torch
    operations it fuses."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from porepy_tpu.numerics.linalg import amg as amg_jax

    with_c, sign = FORMS[form]
    n_rows, n_cols, K = 257, 301, 9
    val, col = _ell(n_rows, n_cols, K, dtype, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, n_cols)).astype(dtype)
    c = rng.standard_normal((batch, n_rows)).astype(dtype) if with_c else None
    if batch == 1:
        x, c = x[0], None if c is None else c[0]
    mv = lambda xx: amg_jax.ell_matvec(jnp.asarray(val), jnp.asarray(col), xx)  # noqa: E731
    ax = mv(jnp.asarray(x)) if batch == 1 else jax.vmap(mv)(jnp.asarray(x))
    want = ax if c is None else (jnp.asarray(c) - ax if sign < 0 else jnp.asarray(c) + ax)
    want = np.asarray(want)

    val_t, col_t, x_t = torch.tensor(val), torch.tensor(col), torch.tensor(x)
    c_t = None if c is None else torch.tensor(c)
    got = kernels.EllOperator(val_t, col_t)(x_t, c=c_t, sign=sign)
    assert got.dtype == TORCH[dtype] and got.shape == want.shape
    scale = _rowsum(val, col, x) + (0 if c is None else np.abs(c))
    assert np.all(np.abs(got.numpy() - want) <= TOL[dtype] * scale)
    ax_t = reference.ell_spmv(val_t, col_t, x_t)
    two_ops = ax_t if c_t is None else (c_t - ax_t if sign < 0 else c_t + ax_t)
    assert torch.equal(got, two_ops)


def test_ell_operators_make_one_launcher_per_matrix():
    """``EllOperators`` gives the same launcher for the same tensors and a
    new one for new tensors; a launcher refuses what K1 does not take."""
    val, col = (torch.tensor(a) for a in _ell(20, 20, 3, np.float64, 2))
    ops = kernels.EllOperators()
    op = ops(val, col)
    assert ops(val, col) is op
    val2 = val.clone()
    assert ops(val2, col) is not op and ops(val2, col).val is val2
    with pytest.raises(TypeError):
        kernels.EllOperator(val, col.long())
    with pytest.raises(ValueError):
        kernels.EllOperator(val, col[:, :2])
    before = dict(kernels.LAUNCHES)
    op(torch.ones(20, dtype=torch.float64))
    assert kernels.LAUNCHES == before


def test_block_partials_and_finish_follow_the_kernels_order():
    """The plain K18 reductions add in the kernels' order: each 128-entry
    tile by the halving tree, and a row of tile partials by 128 running sums
    (``t, t + 128, ...``) and the same tree; checked against that order
    written out in Python floats."""
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.standard_normal(300) * 10.0 ** rng.uniform(-8, 8, 300))

    def tree(vals):
        vals = list(vals) + [0.0] * (128 - len(vals))
        s = 64
        while s:
            vals = [vals[t] + vals[t + s] for t in range(s)]
            s //= 2
        return vals[0]

    want = [tree(v[t : t + 128].tolist()) for t in range(0, 300, 128)]
    assert reference.block_partials(v).tolist() == want
    parts = torch.tensor(rng.standard_normal((2, 300)))
    sums = []
    for row in parts.tolist():
        acc = [0.0] * 128
        for b, p in enumerate(row):
            acc[b % 128] = acc[b % 128] + p
        sums.append(tree(acc))
    assert reference.finish(parts).tolist() == sums


def _system(kind, n, seed=5):
    """``(A, b)``: a seeded nonsymmetric, diagonally dominant CSR matrix
    and a random ``b`` (``random``); or a diagonal of powers of two and a
    ``b`` with one nonzero (``breakdown``: the preconditioned operator is
    the identity, exactly, so the first Arnoldi step breaks down with a
    zero vector and the restart solves the system)."""
    rng = np.random.default_rng(seed)
    if kind == "breakdown":
        b = np.zeros(n)
        b[7] = 3.0
        return sps.diags(np.tile([1.0, 2.0, 4.0], n // 3 + 1)[:n]).tocsr(), b
    A = sps.random(n, n, density=10.0 / n, random_state=seed, format="csr")
    A = A - 0.5 * A.T
    A = sps.csr_matrix(A + sps.diags(np.abs(A).sum(axis=1).A1 + rng.uniform(0.5, 2.0, n)))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("kind", ["random", "breakdown"])
def test_gmres_cycle_plain_equals_the_seven_passes(kind):
    """Every restart of ``gmres_cycle``'s plain version equals, to the bit,
    the seven plain passes (``cgs_project``, ``cgs_update``,
    ``cgs_normalize``, ``gmres_lstsq``, ``gmres_correct``,
    ``gmres_residual``, ``gmres_restart``) composed around the ordered CSR
    matvec, as the solve ran them before they became one kernel."""
    n, restart = 400, 30
    A, b = _system(kind, n)
    csr = krylov.csr_arrays(A, "cpu")
    dinv = torch.tensor(krylov._inverse_diagonal(A))
    bt = torch.tensor(b)
    atol = 1e-12 * np.linalg.norm(b)
    val, col = reference.csr_ell(*csr, n)

    def mv(v):
        return reference.ell_spmv_ordered(val, col, v)

    got, want = (krylov.gmres_state(n, restart, atol, "cpu") for _ in range(2))
    x, V, H, y, w, partials, flags, st, cont = want
    kernels.gmres_cycle(*csr, dinv, bt, *got, 0)
    reference.gmres_residual(bt, mv(x), dinv, w, partials)
    reference.gmres_restart(w, V, H, partials, flags, st, cont)
    restarts = 0
    while bool(want[-1]) and restarts < 20:
        assert all(torch.equal(g, h) for g, h in zip(got, want))
        kernels.gmres_cycle(*csr, dinv, bt, *got, 1)
        for k in range(restart):
            reference.cgs_project(mv(V[k]), dinv, V, w, partials, flags, k)
            reference.cgs_update(V, w, partials, flags, k)
            reference.cgs_normalize(w, V, H, partials, flags, k)
        reference.gmres_lstsq(H, st, y)
        reference.gmres_correct(V, y, x)
        reference.gmres_residual(bt, mv(x), dinv, w, partials)
        reference.gmres_restart(w, V, H, partials, flags, st, cont)
        restarts += 1
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert 0 < restarts < 20 and not bool(cont)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-10 * np.linalg.norm(b)
    if kind == "breakdown":
        # Step 0 broke down: V[1:] are the zero vectors the iteration holds.
        assert restarts == 1 and bool(torch.all(V[1:] == 0))
        assert flags.tolist() == [0] * (restart + 1)


def test_gmres_solve_runs_one_operator_per_restart():
    """``solve_sparse(method="gmres")`` calls one K18b operator to start and
    one per restart, and counts 30 Arnoldi steps per restart."""
    A, b = _system("random", 300)
    calls = []

    def run(name, *args):
        calls.append((name, args[-1]))
        getattr(kernels, name)(*args)

    csr = krylov.csr_arrays(A, "cpu")
    dinv = torch.tensor(krylov._inverse_diagonal(A))
    x, steps = krylov._gmres_fused(csr, torch.tensor(b), dinv, 1e-12 * np.linalg.norm(b),
                                   1200, 30, run=run)
    restarts = steps // 30
    assert restarts >= 1 and steps == 30 * restarts
    assert calls == [("gmres_cycle", 0)] + [("gmres_cycle", 1)] * restarts
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-10 * np.linalg.norm(b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [9, 700], ids=["K9-staged", "K700-direct"])
@pytest.mark.parametrize("batch", [1, 17], ids=["B1", "B17"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_ell_operator_matches_plain(cuda, dtype, batch, K):
    """K1 on the card against its plain version (1e-13 / 1e-5 of the row's
    sum of |terms|); its epilogue equal to the kernel's product followed by
    the torch subtraction or addition, to the bit; one launch a call. K =
    700 rows do not fit the shared-memory span and read device memory."""
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    n = 16969 if K == 9 else 2000
    val, col = _ell(n, n, K, np.float64, 10)
    val = torch.tensor(val, dtype=dtype, device=cuda)
    col = torch.tensor(col, device=cuda)
    gen = np.random.default_rng(11)
    x = torch.tensor(gen.standard_normal((batch, n)), dtype=dtype, device=cuda)
    c = torch.tensor(gen.standard_normal((batch, n)), dtype=dtype, device=cuda)
    if batch == 1:
        x, c = x[0], c[0]
    op = kernels.EllOperator(val, col)
    before = kernels.LAUNCHES["ell_spmv"]
    ax = op(x)
    scale = reference.ell_spmv(val.abs(), col, x.abs())
    assert bool(torch.all((ax - reference.ell_spmv(val, col, x)).abs() <= tol * scale))
    assert torch.equal(op(x, c=c, sign=-1), c - ax)
    assert torch.equal(op(x, c=c), c + ax)
    assert torch.equal(kernels.ell_spmv(val, col, x), ax)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ell_spmv"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("random", 1000), ("random", 12288), ("breakdown", 999)])
def test_cuda_gmres_cycle_matches_plain_to_the_bit(cuda, kind, n):
    """K18b: every restart on the card from the same state as its plain
    version gives the same bits (the plain passes round as the kernel does);
    one launch per restart, and no K1 launch."""
    A, b = _system(kind, n, seed=16)
    csr = krylov.csr_arrays(A, cuda)
    dinv = torch.tensor(krylov._inverse_diagonal(A), device=cuda)
    bt = torch.tensor(b, device=cuda)
    state = krylov.gmres_state(n, 30, 1e-12 * np.linalg.norm(b), cuda)
    before = dict(kernels.LAUNCHES)
    restarts = 0
    for arnoldi in [0] + [1] * 20:
        if arnoldi and not bool(state[-1]):
            break
        plain = [t.clone() for t in state]
        kernels.gmres_cycle(*csr, dinv, bt, *state, arnoldi)
        reference.gmres_cycle(*csr, dinv, bt, *plain, arnoldi)
        assert all(torch.equal(k, p) for k, p in zip(state, plain))
        restarts += arnoldi
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gmres_cycle"] == before["gmres_cycle"] + restarts + 1
    assert kernels.LAUNCHES["ell_spmv"] == before["ell_spmv"]
    x = state[0].cpu().numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-10 * np.linalg.norm(b)
