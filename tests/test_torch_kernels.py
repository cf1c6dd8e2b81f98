"""The hand-written kernels of porepy_tpu_torch against porepy_tpu.

On the CPU each kernel operator runs its plain PyTorch version; these
tests hold that version against the jax code it replaces, on the same
inputs made with numpy from a seed. The tests marked ``cuda`` hold each
CUDA kernel against its plain version on the card and skip without one;
they need no jax, so on a machine with a card and without jax they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking.dual_pivot_check import pivot_blocks
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad.compiler import _EllMatvec
from porepy_tpu_torch.numerics.linalg import device_solver as ds_torch

torch.set_num_threads(1)

# |port - jax| <= TOL * (row sum of |terms|): float64 agrees to rounding,
# float32 to a few ulps of the row's magnitude (sums run in another order).
TOL = {np.float64: 1e-13, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture
def jx():
    """The jax reference: ``(jax, jnp, amg, device_solver)`` of porepy_tpu."""
    jax = pytest.importorskip("jax")
    from porepy_tpu.numerics.linalg import amg, device_solver

    return jax, jax.numpy, amg, device_solver


def _ell(n_rows, n_cols, K, dtype, seed):
    """Random padded-row operator with ~10% padding slots (col == n_cols)."""
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((n_rows, K)).astype(dtype)
    col = rng.integers(0, n_cols, (n_rows, K)).astype(np.int32)
    pad = rng.random((n_rows, K)) < 0.1
    val[pad] = 0
    col[pad] = n_cols
    return val, col


def _rowsum(val, col, x):
    x_p = np.concatenate([np.abs(x), np.zeros(x.shape[:-1] + (1,))], axis=-1)
    return (np.abs(val) * x_p[..., col]).sum(-1)


@pytest.mark.parametrize("batch", [None, 11], ids=["vector", "batched"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_ell_spmv_matches_amg_ell_matvec(jx, dtype, batch):
    jax, jnp, amg_jax, _ = jx
    n_rows, n_cols, K = 257, 301, 9
    val, col = _ell(n_rows, n_cols, K, dtype, 0)
    shape = (n_cols,) if batch is None else (batch, n_cols)
    x = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    mv = lambda xx: amg_jax.ell_matvec(jnp.asarray(val), jnp.asarray(col), xx)
    want = np.asarray(mv(jnp.asarray(x)) if batch is None else jax.vmap(mv)(jnp.asarray(x)))
    got = kernels.ell_spmv(torch.tensor(val), torch.tensor(col), torch.tensor(x))
    assert got.dtype == TORCH[dtype] and got.shape == want.shape
    err = np.abs(got.numpy() - want)
    assert np.all(err <= TOL[dtype] * _rowsum(val, col, x))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_ell_jacobi_sweep_matches_cycle_smoother(jx, dtype):
    _, jnp, amg_jax, _ = jx
    n, K = 263, 9
    val, col = _ell(n, n, K, dtype, 2)
    rng = np.random.default_rng(3)
    sinv, r, y = (rng.standard_normal(n).astype(dtype) for _ in range(3))
    # The smoother line of porepy_tpu Hierarchy._cycle (amg.py:336/340).
    A = lambda v: amg_jax.ell_matvec(jnp.asarray(val), jnp.asarray(col), v)
    want = np.asarray(
        jnp.asarray(y) + jnp.asarray(sinv) * (jnp.asarray(r) - A(jnp.asarray(y)))
    )
    got = kernels.ell_jacobi_sweep(*(torch.tensor(a) for a in (val, col, sinv, r, y)))
    scale = np.abs(y) + np.abs(sinv) * (np.abs(r) + _rowsum(val, col, y))
    assert np.all(np.abs(got.numpy() - want) <= TOL[dtype] * scale)


@pytest.mark.parametrize("j", [0, 1, 6])
def test_fgmres_givens_plain_matches_recurrence(j):
    """The Givens part of the FGMRES Arnoldi step's plain version (K4,
    ``reference._givens``) against device_solver.py:198-210 written in
    numpy."""
    restart = 8
    rng = np.random.default_rng(4 + j)
    h = np.zeros(restart + 1)
    h[: j + 2] = rng.standard_normal(j + 2)
    theta = rng.random(restart) * 2 * np.pi
    cs, sn = np.cos(theta), np.sin(theta)
    g = np.zeros(restart + 1)
    g[: j + 1] = rng.standard_normal(j + 1)
    hv, gv, csv, snv = h.copy(), g.copy(), cs.copy(), sn.copy()
    for i in range(j):
        t = csv[i] * hv[i] + snv[i] * hv[i + 1]
        hv[i + 1] = -snv[i] * hv[i] + csv[i] * hv[i + 1]
        hv[i] = t
    denom = np.sqrt(hv[j] ** 2 + hv[j + 1] ** 2)
    c, s = hv[j] / max(denom, 1e-30), hv[j + 1] / max(denom, 1e-30)
    csv[j], snv[j] = c, s
    hv[j], hv[j + 1] = denom, 0.0
    gv[j + 1], gv[j] = -s * gv[j], c * gv[j]

    args = [torch.tensor(a) for a in (h, cs, sn, g)]
    flag = torch.zeros((), dtype=torch.int32)
    atol = torch.tensor(1e-3, dtype=torch.float64)
    reference._givens(*args, j, atol, flag)
    for got, want in zip(args, (hv, csv, snv, gv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)
    assert int(flag) == int(j + 1 < restart and abs(gv[j + 1]) > 1e-3)


def test_fgmres_givens_past_last_column_only_clears_flag():
    """An Arnoldi step (K4's launcher, the plain version on the CPU) at
    ``j = restart`` clears the flag and changes nothing else."""
    restart, n = 4, 6
    val, col = _ell(n, n, 3, np.float64, 9)
    V, g = torch.ones(restart + 1, n, dtype=torch.float64), torch.ones(restart + 1, dtype=torch.float64)
    Z, Ht = torch.ones(restart, n, dtype=torch.float64), torch.ones(restart, restart + 1, dtype=torch.float64)
    cs, sn = torch.ones(restart, dtype=torch.float64), torch.zeros(restart, dtype=torch.float64)
    j = torch.tensor(restart, dtype=torch.int32)
    flag = torch.ones((), dtype=torch.int32)
    atol = torch.tensor(0.0, dtype=torch.float64)
    state = (V, Z, Ht, cs, sn, g)
    before = [t.clone() for t in state]
    op = kernels.EllOperator(torch.tensor(val), torch.tensor(col))
    kernels.FgmresArnoldi(V, Z, Ht, cs, sn, g, j, atol, flag, op)(torch.ones(n, dtype=torch.float64))
    assert int(flag) == 0 and int(j) == restart
    assert all(torch.equal(a, b) for a, b in zip(state, before))


def _test_system(n=60, seed=5):
    """Nonsymmetric, diagonally dominant sparse matrix in ELL form."""
    from porepy_tpu_torch.numerics.linalg.amg import _ell_arrays

    rng = np.random.default_rng(seed)
    A = sps.random(n, n, density=0.08, random_state=seed, format="csr")
    A = (A - A.T * 0.5 + sps.diags(4.0 + rng.random(n))).tocsr()
    val, col = _ell_arrays(A, np.float64)
    b = rng.standard_normal(n)
    return A, val, col, b


@pytest.mark.parametrize("restart,max_cycles", [(40, 1), (6, 8)], ids=["one-cycle", "restarted"])
def test_fgmres_matches_jax(jx, restart, max_cycles):
    """The whole _fgmres (each Arnoldi step through the K4 launcher, early exit,
    back-substitution) on a fixed matrix, float64, against porepy_tpu."""
    _, jnp, amg_jax, ds_jax = jx
    A, val, col, b = _test_system()
    dinv = 1.0 / A.diagonal()
    atol = 1e-10 * np.linalg.norm(b)

    mv_j = lambda x: amg_jax.ell_matvec(jnp.asarray(val), jnp.asarray(col), x)
    x_j, res_j, it_j = ds_jax._fgmres(
        mv_j, lambda r: jnp.asarray(dinv) * r, jnp.asarray(b),
        jnp.zeros_like(jnp.asarray(b)), atol, restart, max_cycles,
    )
    val_t, col_t = torch.tensor(val), torch.tensor(col)
    dinv_t = torch.tensor(dinv)
    x_t, res_t, it_t = ds_torch._fgmres(
        lambda x: kernels.ell_spmv(val_t, col_t, x), lambda r: dinv_t * r,
        torch.tensor(b), torch.zeros(b.size, dtype=torch.float64), atol,
        restart, max_cycles,
    )
    x_j = np.asarray(x_j)
    assert it_t == int(it_j)
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-12 * np.abs(x_j).max()
    assert abs(float(res_t) - float(res_j)) <= 1e-12 * np.linalg.norm(b)


def test_vmap_jvp_through_ell_function_matches_plain_torch():
    """Colored JVPs of a nonlinear residual through the K1 autograd
    Function equal those of the same residual written in plain torch."""
    n, K = 40, 5
    val, col = _ell(n, n, K, np.float64, 6)
    val_t, col_t = torch.tensor(val), torch.tensor(col)
    x = torch.tensor(np.random.default_rng(7).standard_normal(n))
    seeds = torch.tensor(np.random.default_rng(8).standard_normal((11, n)))

    def f(xx):
        return torch.exp(0.1 * _EllMatvec.apply(val_t, col_t, xx)) * xx

    def f_plain(xx):
        return torch.exp(0.1 * reference.ell_spmv(val_t, col_t, xx)) * xx

    def colored(fn):
        return torch.func.vmap(lambda s: torch.func.jvp(fn, (x,), (s,)))(seeds)

    (v1, j1), (v2, j2) = colored(f), colored(f_plain)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    torch.testing.assert_close(j1, j2, rtol=1e-15, atol=1e-15)


def test_csr_constant_matrix_path_matches_dense():
    """A constant matrix with a near-dense row takes the sparse-CSR layout
    instead of ELL; its matvec is linear and batchable like K1's."""
    from porepy_tpu_torch.numerics.ad.compiler import _device_const_matrix, _CsrMat

    rng = np.random.default_rng(12)
    A = sps.random(200, 200, density=0.01, random_state=12, format="lil")
    A[3, :] = rng.standard_normal(200)
    A = A.tocsr()
    mat = _device_const_matrix(A, torch.device("cpu"))
    assert isinstance(mat, _CsrMat)
    x = torch.tensor(rng.standard_normal(200))
    seeds = torch.tensor(rng.standard_normal((4, 200)))
    val, tangents = torch.func.vmap(
        lambda s: torch.func.jvp(lambda xx: mat.matvec(xx) ** 2, (x,), (s,))
    )(seeds)
    Ad = A.toarray()
    y = Ad @ x.numpy()
    np.testing.assert_allclose(val[0].numpy(), y**2, rtol=1e-13)
    np.testing.assert_allclose(
        tangents.numpy(), 2 * y * (seeds.numpy() @ Ad.T), rtol=1e-12, atol=1e-12
    )


def test_cuda_wrappers_refuse_cpu_tensors_without_falling_back():
    """The CUDA path raises on a non-CUDA tensor (it never silently runs the
    plain version) and the CPU path launches no kernel."""
    val, col = _ell(5, 5, 3, np.float64, 9)
    x = torch.zeros(5, dtype=torch.float64)
    before = dict(kernels.LAUNCHES)
    kernels.ell_spmv(torch.tensor(val), torch.tensor(col), x)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="expected cuda"):
        ops._ell_spmv_cuda(torch.tensor(val), torch.tensor(col), x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_kernels_match_plain(cuda, dtype):
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    val, col = _ell(18157, 18157, 9, np.float64, 10)
    val = torch.tensor(val, dtype=dtype, device=cuda)
    col = torch.tensor(col, device=cuda)
    gen = np.random.default_rng(11)
    x = torch.tensor(gen.standard_normal((11, 18157)), dtype=dtype, device=cuda)
    scale = reference.ell_spmv(val.abs(), col, x.abs())
    err = (kernels.ell_spmv(val, col, x) - reference.ell_spmv(val, col, x)).abs()
    assert bool(torch.all(err <= tol * scale))
    sinv, r, y = x[0], x[1], x[2]
    out = kernels.ell_jacobi_sweep(val, col, sinv, r, y)
    want = reference.ell_jacobi_sweep(val, col, sinv, r, y)
    bound = tol * (y.abs() + sinv.abs() * (r.abs() + reference.ell_spmv(val.abs(), col, y.abs())))
    assert bool(torch.all((out - want).abs() <= bound))
    # K4: an FGMRES Arnoldi step at column 35 of restart 70 on this matrix,
    # the kernel's bits those of its plain version.
    restart, j0 = 70, 35
    V = torch.linalg.qr(torch.tensor(gen.standard_normal((18157, restart + 1)), device=cuda))[0].T
    V = V.contiguous().to(dtype)
    V[j0 + 1 :] = 0
    state = [V, torch.zeros(restart, 18157, dtype=dtype, device=cuda),
             torch.zeros(restart, restart + 1, dtype=dtype, device=cuda),
             torch.ones(restart, dtype=dtype, device=cuda) * 0.6,
             torch.ones(restart, dtype=dtype, device=cuda) * 0.8,
             torch.tensor(gen.standard_normal(restart + 1), dtype=dtype, device=cuda)]
    runs = []
    for _ in range(2):
        st = [t.clone() for t in state] + [torch.tensor(j0, dtype=torch.int32, device=cuda),
                                           torch.tensor(1e-6, dtype=dtype, device=cuda),
                                           torch.ones((), dtype=torch.int32, device=cuda)]
        runs.append(st)
    kernels.FgmresArnoldi(*runs[0], kernels.EllOperator(val, col))(x[3].contiguous())
    reference.fgmres_arnoldi(val, col, x[3].contiguous(), *runs[1])
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_dense_block_kernels_match_plain(cuda, dtype):
    """K6: scatter, pivot inverse (with a zero leading entry and a singular
    matrix in the batch) and apply against their plain versions."""
    ni, n_pad, b = 300, 384, 128
    gen = np.random.default_rng(13)
    S = sps.random(ni, ni, density=0.05, random_state=13, format="coo")
    S.sum_duplicates()
    vals = torch.tensor(S.data, dtype=dtype, device=cuda)
    rows = torch.tensor(S.row.astype(np.int32), device=cuda)
    cols = torch.tensor(S.col.astype(np.int32), device=cuda)
    D = kernels.dense_block_scatter(vals, rows, cols, ni, n_pad)
    assert bool(torch.equal(D, reference.dense_block_scatter(vals, rows, cols, ni, n_pad)))

    a = gen.standard_normal((3, b, b)) / np.sqrt(b) + 4 * np.eye(b)
    a[0, [0, 1]] = a[0, [1, 0]]
    a[0, 0, 0] = 0.0
    a[2] = np.outer(np.arange(1.0, b + 1), np.arange(1.0, b + 1))
    a = torch.tensor(a, dtype=dtype, device=cuda)
    flag = torch.zeros(3, dtype=torch.int32, device=cuda)
    inv = kernels.gj_pivot_inverse(a, flag)
    torch.cuda.synchronize()
    assert flag.tolist() == [0, 0, 1]
    want = reference.gj_pivot_inverse(a[:2], torch.zeros(2, dtype=torch.int32, device=cuda))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert float((inv[:2] - want).abs().max()) <= tol * float(want.abs().max())

    D32 = D.to(torch.float32)
    r = torch.tensor(gen.standard_normal(ni), dtype=dtype, device=cuda)
    y = kernels.dense_block_apply(D32, r)
    y_ref = reference.dense_block_apply(D32, r)
    bound = 1e-5 * (D32[:ni, :ni].abs() @ r.abs().to(torch.float32)).to(dtype)
    assert y.dtype == dtype and bool(torch.all((y - y_ref).abs() <= bound))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("b", [1, 7, 64, 128])
def test_cuda_gj_pivot_inverse_ties_sizes_and_flags(cuda, dtype, b):
    """K6's pivot inverse against ``torch.linalg.inv_ex`` (its plain
    version) for every size class: ties, a zero leading entry, a singular
    block; flags equal to the plain version's and never cleared."""
    a_np = pivot_blocks(b, 40 + b)
    a = torch.tensor(a_np, dtype=dtype, device=cuda)
    flag = torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=cuda)
    inv = kernels.gj_pivot_inverse(a, flag)
    again = kernels.gj_pivot_inverse(a, torch.zeros(4, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    want_flag = torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=cuda)
    want = reference.gj_pivot_inverse(a, want_flag)
    assert flag.tolist() == want_flag.tolist()
    assert flag.tolist()[2:] == [1, 1]
    eps = float(torch.finfo(dtype).eps)
    for m in range(4):
        if want_flag[m] and m != 3:
            continue
        X = inv[m].double()
        assert torch.equal(inv[m], again[m])
        bound = 4 * eps * b * float(np.linalg.cond(a_np[m])) * float(want[m].abs().max())
        assert float((X - want[m].double()).abs().max()) <= bound, m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_flow_kernels_match_plain(cuda, dtype):
    """K12 and K13: residual and tangent against their plain versions on a
    (9, 7, 5) box, to 1e-13 (f64) / 1e-5 (f32) of the largest entry."""
    from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel
    from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel

    shape = (9, 7, 5)
    fluid = dict(compressibility=1e-6, viscosity=1e-3, rho_ref=1000.0, p_ref=1e5)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    gen = np.random.default_rng(14)
    ks, _ = build_structured_flow_kernel(
        shape, (1, 1, 1), bc_pressure=lambda x, y, z: 1e5 + 1e4 * x, device=cuda, **fluid
    )
    ks = ks._as_dtype(dtype)
    ku, _ = build_cart_flow_kernel(
        list(shape), [1, 1, 1], bc_pressure=lambda fc: 1e5 + 1e4 * fc[0], device=cuda, **fluid
    )
    u_args = list(ku._arrays()) + [ku._coef()]
    for i in (2, 4, 5):  # t, bc_val, pv
        u_args[i] = u_args[i].to(dtype)
    u_args[-1] = u_args[-1].to(dtype)
    s_args = (*ks._arrays(), ks._coef())
    for n_shape, args, ops_pair in (
        (shape, s_args, ("structured_residual", "structured_jvp")),
        ((ku.num_cells,), tuple(u_args), ("tpfa_residual", "tpfa_jvp")),
    ):
        p, q, v = (
            torch.tensor(2e5 + 1e4 * gen.standard_normal(n_shape), dtype=dtype, device=cuda)
            for _ in range(3)
        )
        for name, second in zip(ops_pair, (q, v)):
            got = getattr(kernels, name)(p, second, *args)
            want = getattr(reference, name)(p, second, *args)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= tol * float(want.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(4, 8, 7, 9), (64, 20, 12, 20), (16, 81, 32, 80), (3, 180, 20, 30)],
    ids=["n8", "n20", "n81", "n180-workspace"],
)
def test_cuda_region_solve_matches_plain(cuda, shape):
    """K10: the batched region solve and contraction against its plain
    version, 1e-12 of the largest output entry; region 0 has a zero leading
    entry (a row swap), and n = 180 exceeds shared memory, so that batch
    runs on the device workspace."""
    B, n, m, q = shape
    gen = np.random.default_rng(15)
    a = gen.standard_normal((B, n, n)) + 0.5 * n * np.eye(n)
    a *= 10.0 ** gen.uniform(-3, 3, (B, n, 1))
    a[0, 0, 0] = 0.0
    a, rhs, w = (
        torch.tensor(x, device=cuda)
        for x in (a, gen.standard_normal((B, n, m)), gen.standard_normal((B, q, n)))
    )
    before = kernels.LAUNCHES["region_solve"]
    got = kernels.region_solve(a, rhs, w)
    want = reference.region_solve_contract(a, rhs, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["region_solve"] == before + 1
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _diag_dominant(n, seed):
    """A seeded nonsymmetric, diagonally dominant CSR matrix, 5-15 entries
    per row."""
    rng = np.random.default_rng(seed)
    A = sps.random(n, n, density=10.0 / n, random_state=seed, format="csr")
    A = A - 0.5 * A.T
    return sps.csr_matrix(A + sps.diags(np.abs(A).sum(axis=1).A1 + rng.uniform(0.5, 2.0, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 12288])
def test_cuda_krylov_kernels_match_plain(cuda, n):
    """K18a and K18b: whole Jacobi-preconditioned solves through the
    kernels (``solve_sparse`` on the card) against the plain iterations
    (``krylov.bicgstab``/``krylov.gmres`` with the same K1 matvec), x within
    1e-9 of max |x|; every K18 kernel launched."""
    from porepy_tpu_torch.numerics.ad.compiler import _EllMat
    from porepy_tpu_torch.numerics.linalg import krylov

    A = _diag_dominant(n, 16)
    b = np.random.default_rng(17).standard_normal(n)
    ell = _EllMat.from_scipy(A, cuda)
    dinv = torch.tensor(krylov._inverse_diagonal(A), device=cuda)
    for method, names, plain in (
        ("bicgstab", kernels.K18A, krylov.bicgstab),
        ("gmres", kernels.K18B, krylov.gmres),
    ):
        before = {k: kernels.LAUNCHES[k] for k in names}
        got = krylov.solve_sparse(A, b, method=method, device=cuda)
        torch.cuda.synchronize()
        assert all(kernels.LAUNCHES[k] > before[k] for k in names), method
        kwargs = {"restart": 30} if method == "gmres" else {}
        want, _ = plain(
            lambda v: kernels.ell_spmv(ell.val, ell.col, v), torch.tensor(b, device=cuda),
            tol=1e-12, maxiter=max(200, 4 * n), M=lambda v: dinv * v, **kwargs,
        )
        want = want.cpu().numpy()
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max(), method


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [2, 3])
def test_cuda_flash_matches_plain(cuda, nc):
    """K17: V, x and y within 1e-12 of the plain version (fractions in
    [0, 1]); the same converged flags and iteration counts; two launches
    (the first capped at ``flash.cu``'s ``kTailCap`` iterations, the second
    over the points still running)."""
    K = torch.tensor([2.5, 0.3] if nc == 2 else [3.0, 0.8, 0.2], dtype=torch.float64, device=cuda)
    raw = np.random.default_rng(18 + nc).random((nc, 20000)) + 0.02
    zs = torch.tensor(raw / raw.sum(axis=0), device=cuda)
    before = kernels.LAUNCHES["rachford_rice"]
    got = kernels.rachford_rice(zs, K, 150, 1e-8)
    want = reference.rachford_rice(zs, K, 150, 1e-8)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rachford_rice"] == before + 2
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 1e-12
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_interp_lookup_matches_plain(cuda, d):
    """K16: the value and four tangents at points in and around the table
    against the plain version, 1e-13 of the largest magnitude."""
    from porepy_tpu_torch.numerics.ad.operator_functions import InterpolatedFunction

    lo, hi, npt = [1.0, 280.0, 0.0][:d], [5.0, 400.0, 1.0][:d], [41, 61, 9][:d]
    fun = InterpolatedFunction(lambda *a: np.sin(a[0]) * np.cos(a[1]) + sum(a), "t", lo, hi, npt)
    tab = fun.device_table(cuda)
    rng = np.random.default_rng(19 + d)
    span = np.array(hi) - np.array(lo)
    x = torch.tensor(rng.uniform(np.array(lo) - 0.2 * span, np.array(hi) + 0.2 * span, (5000, d)).T.copy(), device=cuda)
    dx = torch.tensor(rng.standard_normal((4, d, 5000)), device=cuda)
    args = (tab["values"], tab["fgeom"], tab["igeom"], x)
    for got, want in (
        (kernels.interp_lookup(*args), reference.interp_lookup(*args)),
        (kernels.interp_tangent(*args, dx), reference.interp_tangent(*args, dx)),
    ):
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
