"""K4, the FGMRES Arnoldi step (``kernels.FgmresArnoldi``, one cooperative
``fgmres_arnoldi`` launch a step on the card), on the CPU through its
plain version ``reference.fgmres_arnoldi``:

- the port's whole ``_fgmres`` against ``porepy_tpu``'s on md 1/16's first
  Jacobian (Ruiz-equilibrated, as the solve runs it) with a Jacobi
  preconditioner;
- one step against the composition it replaced (K1's matvec, the GEMVs of
  CGS2 in ``torch.matmul``, the norm, the copies and the Givens step in
  torch), kept here as the yardstick;
- the edge cases (breakdown, the last column, a column out of range, the
  tolerance's boundary), the launcher's CPU route and one launcher call a
  step of ``_fgmres``.

The test marked ``cuda`` holds the kernel against the plain version on the
card, to the bit; it needs no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fgmres_arnoldi.py -m cuda
"""

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.numerics.linalg import device_solver as ds_torch

torch.set_num_threads(1)

TORCH = {"f64": torch.float64, "f32": torch.float32}
# One step against the composition it replaced: the dots are summed in
# another order (tile partials and a tree against torch.matmul), so the
# outputs agree to a few ulps of their scale.
STEP_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}


@pytest.fixture(scope="module")
def md16():
    """md 1/16's first Jacobian in the port solver's ELL layout, Ruiz
    equilibrated as ``DeviceLinearSolver._solve`` runs it, and its rhs:
    ``(val, col, b)`` as float64 numpy arrays."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow

    Model, params = build_md_flow(1.0 / 16, device="cpu")
    m = Model(params)
    m.prepare_simulation()
    data, b, cs = m.equation_system.assemble_device()
    solver = ds_torch.DeviceLinearSolver(cs)
    A = solver._host_matrix(data)
    dr, dc = ds_torch._ruiz_scaling(A)
    val = torch.cat([data, data.new_zeros(1)])[solver._ell_sel].numpy()
    col = solver._ell_col.numpy()
    n = A.shape[0]
    dc_p = np.concatenate([dc, [0.0]])
    val_eq = dr[:, None] * val * dc_p[np.minimum(col, n)]
    return val_eq, col, dr * b.numpy()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fgmres_matches_jax_on_md16(md16, dtype):
    """The whole ``_fgmres`` (one launcher step an Arnoldi step, its plain
    version here; restart 30, up to 8 cycles, the early exit inside one)
    against ``porepy_tpu``'s ``_fgmres`` on md 1/16's equilibrated first
    Jacobian with the l1-Jacobi preconditioner ``M r = r / sum_k |a_ik|``
    (the plain diagonal is ~1e-12 on 9 interface rows: cond(D^-1 A) ~7e13,
    where both the parent's composition and this step leave porepy_tpu's
    iterates by 1e-4 after 20 steps). f64: the same iteration count and
    ``x`` within 1e-10 of max |x|; f32: within one iteration and 1e-4 (each
    side sums in its own order at f32's rounding)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from porepy_tpu.numerics.linalg import amg as amg_jax
    from porepy_tpu.numerics.linalg import device_solver as ds_jax

    val, col, b = md16
    n = b.size
    dinv = 1.0 / np.abs(val).sum(1)
    np_t = np.float64 if dtype == "f64" else np.float32
    val_t, b_t, dinv_t = val.astype(np_t), (b / np.linalg.norm(b)).astype(np_t), dinv.astype(np_t)
    atol = 1e-4 if dtype == "f64" else 1e-3
    restart, cycles = 30, 8

    def mv_j(x):
        return amg_jax.ell_matvec(jnp.asarray(val_t), jnp.asarray(col), x)

    x_j, _res_j, it_j = ds_jax._fgmres(
        mv_j, lambda r: jnp.asarray(dinv_t) * r, jnp.asarray(b_t), jnp.zeros(n, np_t), atol, restart, cycles
    )
    op = kernels.EllOperator(torch.tensor(val_t), torch.tensor(col))
    dinv_tt = torch.tensor(dinv_t)
    x_t, res_t, it_t = ds_torch._fgmres(
        op, lambda r: dinv_tt * r, torch.tensor(b_t), torch.zeros(n, dtype=TORCH[dtype]), atol, restart, cycles
    )
    x_j = np.asarray(x_j, dtype=np.float64)
    scale = np.abs(x_j).max()
    # Restarted, and stopped by the tolerance inside a cycle.
    assert restart < it_t < restart * cycles and it_t % restart
    assert float(res_t) <= atol
    if dtype == "f64":
        assert it_t == int(it_j)
        assert np.abs(x_t.numpy() - x_j).max() <= 1e-10 * scale
    else:
        assert abs(it_t - int(it_j)) <= 1
        assert np.abs(x_t.numpy().astype(np.float64) - x_j).max() <= 1e-4 * scale


def _system(n: int, K: int, dtype, seed: int):
    """A diagonally dominant nonsymmetric ELL matrix with ~10% padding
    slots (column n) and a diagonal in slot 0."""
    rng = np.random.default_rng(seed)
    val = rng.standard_normal((n, K)) * 0.3
    col = rng.integers(0, n, (n, K)).astype(np.int32)
    col[:, 0] = np.arange(n)
    val[:, 0] = 4.0 + rng.random(n)
    pad = rng.random((n, K)) < 0.1
    pad[:, 0] = False
    val[pad], col[pad] = 0.0, n
    return torch.tensor(val, dtype=dtype), torch.tensor(col)


def _state(n: int, restart: int, dtype, atol: float = 1e-9, beta: float = 1.0, seed: int = 0):
    """A cycle's fresh state: ``V[0]`` a random unit vector, ``g[0] =
    beta``, everything else zero, ``j = 0``, ``flag = 1``."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    V = torch.zeros(restart + 1, n, dtype=dtype)
    V[0] = torch.tensor(v0 / np.linalg.norm(v0), dtype=dtype)
    g = torch.zeros(restart + 1, dtype=dtype)
    g[0] = beta
    return [V, torch.zeros(restart, n, dtype=dtype), torch.zeros(restart, restart + 1, dtype=dtype),
            torch.zeros(restart, dtype=dtype), torch.zeros(restart, dtype=dtype), g,
            torch.zeros((), dtype=torch.int32), torch.tensor(atol, dtype=dtype), torch.ones((), dtype=torch.int32)]


def _copy(state):
    return [t.clone() for t in state]


def parent_step(val, col, z, V, Z, Ht, cs, sn, g, j_dev, atol, flag) -> None:
    """The composition the step replaced (``_fgmres`` before the K4 kernel):
    K1's product, CGS2 by ``torch.matmul``, ``vector_norm``, the copies,
    then the Givens step of the retired K4g kernel's plain version."""
    j = int(j_dev)
    restart = Ht.shape[0]
    if j < 0 or j >= restart:
        flag.fill_(0)
        return
    w = reference.ell_spmv(val, col, z)
    Vj = V[: j + 1]
    h = Vj @ w
    w = w - Vj.T @ h
    h2 = Vj @ w
    w = w - Vj.T @ h2
    hj1 = torch.linalg.vector_norm(w)
    V[j + 1] = w / torch.clamp(hj1, min=1e-30)
    Z[j] = z
    hc = Ht[j]
    hc[: j + 1] = h + h2
    hc[j + 1] = hj1
    for i in range(j):
        hi, hn = hc[i].clone(), hc[i + 1].clone()
        hc[i] = cs[i] * hi + sn[i] * hn
        hc[i + 1] = -sn[i] * hi + cs[i] * hn
    denom = torch.sqrt(hc[j] * hc[j] + hc[j + 1] * hc[j + 1])
    safe = torch.clamp(denom, min=1e-30)
    c, s = hc[j] / safe, hc[j + 1] / safe
    cs[j], sn[j] = c, s
    hc[j], hc[j + 1] = denom, 0.0
    gj = g[j].clone()
    g[j + 1] = -s * gj
    g[j] = c * gj
    flag.fill_(int(j + 1 < restart and bool(torch.abs(g[j + 1]) > atol)))
    j_dev.fill_(j + 1)


def _zs(n: int, count: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(n), dtype=dtype) for _ in range(count)]


@pytest.mark.parametrize("j", [0, 1, 8, 35, 69])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_plain_step_matches_parent_composition(dtype, j):
    """One plain step at column ``j`` of restart 70 (n = 300: three tiles,
    the last ragged) from the state the parent's composition built, against
    the parent's step from the same state: every output within
    ``STEP_TOL`` of its largest entry, ``j`` and the flag equal."""
    dt = TORCH[dtype]
    n, restart = 300, 70
    val, col = _system(n, 9, dt, 1)
    state = _state(n, restart, dt, atol=1e-12)
    zs = _zs(n, j + 1, dt, 2)
    for z in zs[:j]:
        parent_step(val, col, z, *state)
    assert int(state[6]) == j and int(state[8]) == 1
    got, want = _copy(state), _copy(state)
    reference.fgmres_arnoldi(val, col, zs[j], *got)
    parent_step(val, col, zs[j], *want)
    for name, a, b in zip(("V", "Z", "Ht", "cs", "sn", "g"), got, want):
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= STEP_TOL[dt] * scale, (name, err, scale)
    assert int(got[6]) == int(want[6]) == j + 1
    assert int(got[8]) == int(want[8])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_breakdown_gives_finite_basis(dtype):
    """``w`` in the span of ``V[:j+1]`` (``A = I``, ``z = V[0]``; and ``z =
    0``): ``V[j + 1]``, the column and the rotation stay finite."""
    dt = TORCH[dtype]
    n, restart = 200, 6
    val = torch.zeros(n, 3, dtype=dt)
    val[:, 0] = 1.0
    col = torch.full((n, 3), n, dtype=torch.int32)
    col[:, 0] = torch.arange(n, dtype=torch.int32)
    for z_of in (lambda st: st[0][0].clone(), lambda st: torch.zeros(n, dtype=dt)):
        st = _state(n, restart, dt)
        reference.fgmres_arnoldi(val, col, z_of(st), *st)
        V, _Z, Ht, cs, sn, g = st[:6]
        assert int(st[6]) == 1
        assert all(bool(torch.all(torch.isfinite(t))) for t in (V[1], Ht[0], cs, sn, g))
        assert float(torch.linalg.vector_norm(V[1])) <= 1.0 + 1e-3


def test_last_column_clears_flag():
    """At ``j = restart - 1`` the flag clears although ``|g[j + 1]| >
    atol``; the column is finished and ``j`` advances to ``restart``."""
    n, restart = 120, 3
    val, col = _system(n, 5, torch.float64, 3)
    st = _state(n, restart, torch.float64, atol=1e-14)
    for i, z in enumerate(_zs(n, restart, torch.float64, 4)):
        reference.fgmres_arnoldi(val, col, z, *st)
        assert int(st[8]) == int(i + 1 < restart)
    assert int(st[6]) == restart
    assert float(st[5][restart].abs()) > 1e-14
    assert bool(torch.all(st[1][restart - 1] != 0))


@pytest.mark.parametrize("j0", [-1, 4])
def test_column_out_of_range_only_clears_flag(j0):
    n, restart = 50, 4
    val, col = _system(n, 4, torch.float64, 5)
    st = _state(n, restart, torch.float64)
    st[6].fill_(j0)
    before = _copy(st)
    op = kernels.EllOperator(val, col)
    step = kernels.FgmresArnoldi(*st, op)
    step(_zs(n, 1, torch.float64, 6)[0])
    assert int(st[8]) == 0 and int(st[6]) == j0
    assert all(torch.equal(a, b) for a, b in zip(st[:6], before[:6]))
    st[8].fill_(1)
    step.split(_zs(n, 1, torch.float64, 6)[0], torch.ones(n, dtype=torch.float64), lambda t: t)
    assert int(st[8]) == 0 and int(st[6]) == j0


def test_flag_at_the_tolerance_boundary():
    """``flag = |g[j + 1]| > atol``, strictly: atol equal to ``|g[j + 1]|``
    clears it, the next float below sets it."""
    n, restart = 80, 5
    val, col = _system(n, 4, torch.float64, 7)
    z = _zs(n, 1, torch.float64, 8)[0]
    st = _state(n, restart, torch.float64, atol=0.0)
    reference.fgmres_arnoldi(val, col, z, *st)
    g1 = float(st[5][1].abs())
    assert int(st[8]) == 1 and g1 > 0
    for atol, want in ((g1, 0), (np.nextafter(g1, 0.0), 1)):
        st = _state(n, restart, torch.float64, atol=float(atol))
        reference.fgmres_arnoldi(val, col, z, *st)
        assert int(st[8]) == want


def test_split_step_with_identity_sums_is_the_step():
    """The sharded solve's form (``w = A z`` given, the finished sums
    through ``all_sum``) with no ranks to sum over equals the step to the
    bit; ``all_sum`` sees the three sums, in order."""
    n, restart = 260, 10
    val, col = _system(n, 7, torch.float32, 9)
    a, b = _state(n, restart, torch.float32), _state(n, restart, torch.float32)
    seen = []

    def all_sum(t):
        seen.append(t.numel())
        return t

    for i, z in enumerate(_zs(n, 4, torch.float32, 10)):
        reference.fgmres_arnoldi(val, col, z, *a)
        reference.fgmres_arnoldi_split(z, reference.ell_spmv_ordered(val, col, z), *b, all_sum)
        assert seen[-3:] == [i + 1, i + 1, 1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launcher_runs_plain_version_on_cpu():
    """On the CPU the launcher runs ``reference.fgmres_arnoldi`` (the same
    bits) and launches nothing."""
    n, restart = 140, 8
    val, col = _system(n, 6, torch.float32, 11)
    a, b = _state(n, restart, torch.float32), _state(n, restart, torch.float32)
    op = kernels.EllOperator(val, col)
    step = kernels.FgmresArnoldi(*a, op)
    before = dict(kernels.LAUNCHES)
    for z in _zs(n, 3, torch.float32, 12):
        step(z)
        reference.fgmres_arnoldi(val, col, z, *b)
    assert kernels.LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="contiguous"):
        step(torch.zeros(2 * n, dtype=torch.float32)[::2])
    with pytest.raises(TypeError, match="one float32/float64 dtype"):
        kernels.FgmresArnoldi(*(_state(n, restart, torch.float32)[:5]), torch.zeros(restart + 1, dtype=torch.float64),
                              *a[6:], op)


def test_fgmres_makes_one_launcher_call_a_step(monkeypatch):
    """``_fgmres`` with an ``EllOperator`` matvec: one launcher call (the
    matvec inside) and one preconditioner apply a step, no other matvec
    than the cycle's residual."""
    n = 180
    val, col = _system(n, 6, torch.float64, 13)
    op = kernels.EllOperator(val, col)
    calls = {"step": 0, "split": 0, "M": 0, "matvec": 0}
    step_call, split_call = kernels.FgmresArnoldi.__call__, kernels.FgmresArnoldi.split

    def counted_step(self, z):
        calls["step"] += 1
        return step_call(self, z)

    def counted_split(self, z, w, all_sum):
        calls["split"] += 1
        return split_call(self, z, w, all_sum)

    monkeypatch.setattr(kernels.FgmresArnoldi, "__call__", counted_step)
    monkeypatch.setattr(kernels.FgmresArnoldi, "split", counted_split)

    class Counted(kernels.EllOperator):
        __slots__ = ()

        def __call__(self, x, c=None, sign=1):
            calls["matvec"] += 1
            return super().__call__(x, c, sign)

    def M(r):
        calls["M"] += 1
        return r / 4.5

    b = torch.tensor(np.random.default_rng(14).standard_normal(n))
    x, _res, it = ds_torch._fgmres(Counted(op.val, op.col), M, b, torch.zeros(n, dtype=torch.float64),
                                   1e-10, 12, 3)
    assert it > 12
    assert calls["step"] == calls["M"] == it and calls["split"] == 0
    # The residual of each cycle and the closing one.
    assert calls["matvec"] == -(-it // 12) + 1
    assert float(torch.linalg.vector_norm(b - reference.ell_spmv(val, col, x))) <= 1e-9
    # A matvec that is no EllOperator takes the split route, one call a step.
    calls.update(step=0, split=0, M=0)
    _x, _res, it = ds_torch._fgmres(lambda v: op(v), M, b, torch.zeros(n, dtype=torch.float64), 1e-10, 12, 3)
    assert calls["split"] == calls["M"] == it and calls["step"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cuda_kernel_matches_plain(cuda, dtype):
    """The kernel (fused, and the split form with identity sums) equals its
    plain version to the bit at n = 18,157 (142 tiles), restart 70, along
    a cycle's columns 0..69 from random ``z``, and at n = 300 (3 tiles)."""
    dt = TORCH[dtype]
    for n, K, steps in ((18157, 9, 70), (300, 5, 70)):
        val, col = _system(n, K, dt, 15)
        val, col = val.to(cuda), col.to(cuda)
        op = kernels.EllOperator(val, col)
        runs = [[t.to(cuda) for t in _state(n, 70, dt, atol=1e-30)] for _ in range(3)]
        fused, split = kernels.FgmresArnoldi(*runs[0], op), kernels.FgmresArnoldi(*runs[1])
        before = kernels.LAUNCHES["fgmres_arnoldi"]
        for z in _zs(n, steps, dt, 16):
            z = z.to(cuda)
            fused(z)
            split.split(z, op(z), lambda t: t)
            reference.fgmres_arnoldi(val, col, z, *runs[2])
            for a, b, c in zip(*runs):
                assert torch.equal(a, c) and torch.equal(b, c)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fgmres_arnoldi"] - before == 5 * steps
