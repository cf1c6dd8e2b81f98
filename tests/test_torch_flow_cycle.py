"""The flow steps' BiCGStab (K12, K13) as the cooperative kernel runs it:
the linearizations that write the Jacobian's coefficients, the
coefficient matvecs, :class:`porepy_tpu_torch.kernels.FlowCycle` (its
plain version on the CPU) and the Newton steps through it, against the
plain jvps and ``porepy_tpu``'s ``jax.linearize`` and ``bicgstab``.

Inputs are made from numpy seeds at 6 x 5 x 4 cells and its ``CartGrid``
twin. ``jax`` is imported inside the tests that compare with it, so the
tests marked ``cuda`` (the kernels against their plain versions, to the
bit) run on a card without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flow_cycle.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.parallel.flow_step import _jacobian_pattern
from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel as cart_torch
from porepy_tpu_torch.parallel.structured_flow import (
    build_structured_flow_kernel as struct_torch,
)

torch.set_num_threads(1)

FLUID = dict(compressibility=1e-6, viscosity=1e-3, rho_ref=1000.0, p_ref=1e5)
SHAPE = (6, 5, 4)
TORCH = {"f64": torch.float64, "f32": torch.float32}
# The coefficient matvec against a jvp, relative to the largest entry: f64
# to rounding (the same terms summed in another order), f32 to a few ulps.
JVP_TOL = {"f64": 1e-12, "f32": 1e-5}


def _bc_xyz(x, y, z):
    return 1e5 + 1e4 * (1 - np.asarray(x))


def _bc_faces(fc):
    return 1e5 + 1e4 * (1 - fc[0])


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _states(shape, seed):
    rng = np.random.default_rng(seed)
    return (
        2e5 + 1e4 * rng.standard_normal(shape),
        2e5 + 1e4 * rng.standard_normal(shape),
        rng.standard_normal(shape),
    )


@pytest.fixture(scope="module")
def flow():
    """The port's structured kernel and its CartGrid twin, on the CPU."""
    ks, _ = struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device="cpu", **FLUID)
    ku, _ = cart_torch(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu", **FLUID)
    return {"stencil": ks, "tpfa": ku}


def _args(kind, kernel, dtype):
    if kind == "stencil":
        k = kernel._as_dtype(dtype)
        return (*k._arrays(), k._coef())
    return (*(a.to(dtype) if a.is_floating_point() else a for a in kernel._arrays()), kernel._coef().to(dtype))


def _pattern(ku, device="cpu"):
    arrays = (ku.lo, ku.hi, ku.cell_ptr, ku.cell_faces)
    return [torch.tensor(a, device=device) for a in _jacobian_pattern(*(a.cpu().numpy() for a in arrays), ku.num_cells)]


def _operator(kind, kernel, p, dtype):
    """``(op, matvec)``: the kind's linearization at ``p`` through
    ``kernels`` (its plain version on the CPU) and its coefficient matvec."""
    args = _args(kind, kernel, dtype)
    if kind == "stencil":
        coef = torch.empty((7,) + tuple(p.shape), dtype=dtype, device=p.device)
        kernels.structured_linearize(p.to(dtype), *args, coef)
        return (coef,), lambda v: reference.stencil_matvec(coef, v.reshape(-1))
    row_ptr, cols, slot, diag_slot = _pattern(kernel, p.device)
    vals = torch.zeros(cols.shape[0], dtype=dtype, device=p.device)
    kernels.tpfa_linearize(p.to(dtype), *args, slot, diag_slot, vals)
    val, col = reference.csr_ell(row_ptr, cols, vals, p.shape[0])
    return (row_ptr, cols, vals), lambda v: reference.ell_spmv_ordered(val, col, v.reshape(-1))


def _shape(kind, kernel):
    return SHAPE if kind == "stencil" else (kernel.num_cells,)


# -- the linearizations and coefficient matvecs ----------------------------------


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_coefficient_matvec_matches_plain_jvp(flow, kind, dtype):
    """The linearization's matvec against the plain jvp at the same p:
    f64 within 1e-12 of the largest entry, f32 within 1e-5."""
    kernel, dt = flow[kind], TORCH[dtype]
    p, _, v = (torch.tensor(a, dtype=dt) for a in _states(_shape(kind, kernel), 1))
    _op, matvec = _operator(kind, kernel, p, dt)
    jvp = reference.structured_jvp if kind == "stencil" else reference.tpfa_jvp
    want = jvp(p, v, *_args(kind, kernel, dt))
    got = matvec(v).reshape(want.shape)
    assert got.dtype == dt
    assert _rel_err(got.numpy(), want.numpy()) <= JVP_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_coefficient_matvec_matches_jax_linearize(kind, dtype):
    """The coefficient matvec of a kernel built from ``porepy_tpu``'s
    arrays against ``porepy_tpu``'s ``jax.linearize`` jvp at the same p:
    f64 within 1e-12 of the largest entry, f32 within 1e-5."""
    import jax
    import jax.numpy as jnp

    from porepy_tpu.parallel.flow_step import build_cart_flow_kernel as cart_jax
    from porepy_tpu.parallel.structured_flow import build_structured_flow_kernel as struct_jax
    from porepy_tpu_torch.interop import structured_flow_kernel_from, tpfa_flow_kernel_from

    np_dt, dt = {"f64": np.float64, "f32": np.float32}[dtype], TORCH[dtype]
    if kind == "stencil":
        kj, _ = struct_jax(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, **FLUID)
        kj = kj._as_dtype(jnp.dtype(np_dt))
        kt = structured_flow_kernel_from(kj, "cpu")
        shape = SHAPE
    else:
        kj, _ = cart_jax(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, **FLUID)
        floats = ("t", "bc_val", "pv", "rho_ref", "comp", "visc", "p_ref", "dt")
        kj = dataclasses.replace(kj, **{f: jnp.asarray(getattr(kj, f), np_dt) for f in floats})
        kt = tpfa_flow_kernel_from(kj, "cpu")
        shape = (kj.num_cells,)
    p, p_prev, v = (a.astype(np_dt) for a in _states(shape, 2))
    _r, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    _op, matvec = _operator(kind, kt, torch.tensor(p), dt)
    got = matvec(torch.tensor(v)).reshape(shape)
    assert _rel_err(got.numpy(), lin(jnp.asarray(v))) <= JVP_TOL[dtype]


def test_tpfa_pattern_is_the_cell_cell_graph(flow):
    """The Jacobian's pattern: each row the cell and its face neighbours,
    columns increasing; the diagonal slot on the diagonal; every
    neighbour slot in its cell's row."""
    ku = flow["tpfa"]
    row_ptr, cols, slot, diag_slot = (a.numpy() for a in _pattern(ku))
    nc = ku.num_cells
    lo, hi = ku.lo.numpy(), ku.hi.numpy()
    inner = (lo >= 0) & (hi >= 0)
    assert cols.size == nc + 2 * int(inner.sum())
    for c in range(nc):
        row = cols[row_ptr[c]:row_ptr[c + 1]]
        assert np.all(np.diff(row) > 0)
        want = {c} | set(hi[lo == c][hi[lo == c] >= 0]) | set(lo[hi == c][lo[hi == c] >= 0])
        assert set(row) == want
        assert cols[diag_slot[c]] == c and row_ptr[c] <= diag_slot[c] < row_ptr[c + 1]
    cell = np.repeat(np.arange(nc), np.diff(ku.cell_ptr.numpy()))
    has = slot >= 0
    assert np.all((row_ptr[cell[has]] <= slot[has]) & (slot[has] < row_ptr[cell[has] + 1]))


# -- FlowCycle: the solve the kernel runs ------------------------------------------


def _system(flow, kind, dtype, seed=4):
    """A linearization at a seeded state, its Jacobi diagonal and the
    normalized negative residual."""
    kernel, dt = flow[kind], TORCH[dtype]
    p, p_prev, _ = (torch.tensor(a) for a in _states(_shape(kind, kernel), seed))
    op, matvec = _operator(kind, kernel, p, dt)
    diag = kernel._jacobi_diagonal(p).to(dt).reshape(-1).contiguous()
    res = (kernel.residual(p, p_prev)).reshape(-1)
    b = (-res / torch.linalg.vector_norm(res)).to(dt)
    return op, matvec, diag, b


def _run(cycle, b, maxiter, tol, chunk=None):
    """The start, then launches of ``chunk`` iterations (default: the whole
    budget) while the solve goes on; returns the launches after the start."""
    cycle.launch(b, 0, tol)
    launches = 0
    while bool(cycle.state[-1][0]) and int(cycle.state[-1][1]) < maxiter:
        left = maxiter - int(cycle.state[-1][1])
        cycle.launch(b, left if chunk is None else min(chunk, left), tol)
        launches += 1
    return launches


@pytest.mark.parametrize("chunk", [1, 7], ids=["chunks-of-1", "chunks-of-7"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cycle_in_chunks_equals_one_run(flow, kind, dtype, chunk):
    """A solve run as launches of 1 or 7 iterations gives the same bits
    as one launch of the whole budget: every vector, the partial sums, the
    scalars, the flag and the count."""
    op, _mv, diag, b = _system(flow, kind, dtype)
    tol = 1e-6 if dtype == "f32" else 1e-10
    whole, chunked = kernels.FlowCycle(kind, op, diag), kernels.FlowCycle(kind, op, diag)
    assert _run(whole, b, 200, tol) == 1
    k = int(whole.state[-1][1])
    assert 0 < k < 200 and not bool(whole.state[-1][0])
    assert _run(chunked, b, 200, tol, chunk) == -(-k // chunk)
    for got, want in zip(chunked.state, whole.state):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_solve_restarts_from_zero(flow, kind):
    """``solve`` starts from x = 0 whatever the state holds: a second solve
    of the same system gives the same bits and count as the first."""
    op, matvec, diag, b = _system(flow, kind, "f64")
    cycle = kernels.FlowCycle(kind, op, diag)
    x1, k1 = cycle.solve(b, tol=1e-10, maxiter=200)
    x1 = x1.clone()
    cycle.solve(2 * b, tol=1e-10, maxiter=3)
    x2, k2 = cycle.solve(b, tol=1e-10, maxiter=200)
    assert k1 == k2 > 0 and torch.equal(x1, x2)
    assert float(torch.linalg.vector_norm(matvec(x1) - b)) <= 1e-10 * float(torch.linalg.vector_norm(b)) * 10


@pytest.mark.parametrize("maxiter", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cycle_iterates_match_jax_bicgstab(kind, maxiter):
    """The iterates after 1, 2, 3, 5 iterations (the stop at ``maxiter``,
    the flag still set) against ``jax.scipy.sparse.linalg.bicgstab`` with
    ``M = v / diag`` on ``porepy_tpu``'s ``jax.linearize`` jvp at the same
    p (f64, within 1e-12 of the largest entry)."""
    import jax
    import jax.numpy as jnp

    from porepy_tpu.parallel.flow_step import build_cart_flow_kernel as cart_jax
    from porepy_tpu.parallel.structured_flow import build_structured_flow_kernel as struct_jax
    from porepy_tpu_torch.interop import structured_flow_kernel_from, tpfa_flow_kernel_from

    if kind == "stencil":
        kj, _ = struct_jax(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, **FLUID)
        kt, shape = structured_flow_kernel_from(kj, "cpu"), SHAPE
        diag_j = lambda p: kj._jacobi_diagonal(p)  # noqa: E731
    else:
        kj, _ = cart_jax(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, **FLUID)
        kt, shape = tpfa_flow_kernel_from(kj, "cpu"), (kj.num_cells,)
        diag_j = lambda p: kj._jacobi_diagonal(p, p)  # noqa: E731
    p, p_prev, b = _states(shape, 5)
    r, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    d = diag_j(jnp.asarray(p))
    x_j, _ = jax.scipy.sparse.linalg.bicgstab(lin, jnp.asarray(b), M=lambda v: v / d, tol=1e-10,
                                              atol=0.0, maxiter=maxiter)
    op, _mv = _operator(kind, kt, torch.tensor(p), torch.float64)
    diag = kt._jacobi_diagonal(torch.tensor(p)).reshape(-1).contiguous()
    np.testing.assert_allclose(diag.numpy(), np.asarray(d).reshape(-1), rtol=1e-14)
    cycle = kernels.FlowCycle(kind, op, diag)
    x, k = cycle.solve(torch.tensor(b).reshape(-1), tol=1e-10, maxiter=maxiter)
    assert k == maxiter and cycle.state[-1].tolist() == [1, maxiter]
    assert _rel_err(x.numpy(), np.asarray(x_j).reshape(-1)) <= 1e-12


def _diagonal_csr(d: np.ndarray):
    n = d.size
    return (torch.arange(n + 1, dtype=torch.int32), torch.arange(n, dtype=torch.int32), torch.tensor(d))


def _stencil_of(centre: np.ndarray):
    coef = torch.zeros((7,) + centre.shape, dtype=torch.float64)
    coef[0] = torch.tensor(centre)
    return (coef,)


@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cycle_exit_early(kind):
    """``J = 2 I`` with ``diag = 2``: the half step solves exactly, |s|^2 <
    atol^2 takes the early exit (x += alpha phat) and the solve stops
    after one iteration with x = b / 2, as jax's does."""
    import jax
    import jax.numpy as jnp

    b = np.random.default_rng(6).standard_normal(SHAPE)
    op = _stencil_of(np.full(SHAPE, 2.0)) if kind == "stencil" else _diagonal_csr(np.full(b.size, 2.0))
    cycle = kernels.FlowCycle(kind, op, torch.full((b.size,), 2.0, dtype=torch.float64))
    x, k = cycle.solve(torch.tensor(b).reshape(-1), tol=0.0, atol=1e-12, maxiter=10)
    x_j, _ = jax.scipy.sparse.linalg.bicgstab(lambda v: 2.0 * v, jnp.asarray(b), M=lambda v: v / 2.0,
                                              tol=0.0, atol=1e-12, maxiter=10)
    assert k == 1 and cycle.state[-1].tolist() == [0, 1]
    assert float(cycle.state[-2][reference.BICG_EXIT]) == 1.0
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j).reshape(-1), rtol=1e-15)
    np.testing.assert_allclose(x.numpy(), b.reshape(-1) / 2, rtol=1e-15)


def test_cycle_stops_on_breakdown():
    """The unit-diagonal 3 x 3 system on which the first iteration breaks
    down exactly (<t, s> = 0, so omega = 0): the solve stops there, its
    update kept (x = e_0), the flag cleared after one iteration."""
    A = np.array([[1.0, 0.0, 0.0], [1.0, 1.0, -2.0], [1.0, 0.0, 1.0]])
    rows, cols = np.nonzero(A)
    op = (torch.tensor(np.r_[0, np.cumsum(np.bincount(rows, minlength=3))], dtype=torch.int32),
          torch.tensor(cols, dtype=torch.int32), torch.tensor(A[rows, cols]))
    cycle = kernels.FlowCycle("tpfa", op, torch.ones(3, dtype=torch.float64))
    x, k = cycle.solve(torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64), tol=0.0, maxiter=10)
    assert k == 1 and cycle.state[-1].tolist() == [0, 1]
    assert float(cycle.state[-2][reference.BICG_OMEGA]) == 0.0
    assert x.tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cycle_zero_rhs_takes_no_iteration(flow, kind):
    """b = 0: the start finds |r|^2 = 0 <= atol2 = 0, the run launch runs no
    iteration, x = 0."""
    op, _mv, diag, b = _system(flow, kind, "f64")
    cycle = kernels.FlowCycle(kind, op, diag)
    cycle.solve(b, tol=1e-10, maxiter=200)
    x, k = cycle.solve(torch.zeros_like(b), tol=1e-10, maxiter=200)
    assert k == 0 and cycle.state[-1].tolist() == [0, 0]
    assert bool(torch.all(x == 0))


def test_start_sets_the_tolerance_from_b():
    """The start's tolerance: atol2 = max(tol^2 <b, b>, atol^2) in b's
    dtype, the f32 product rounded in f32; a NaN in b is kept (as
    jnp.maximum keeps it) and stops the solve."""
    b = torch.tensor(np.random.default_rng(7).standard_normal(300), dtype=torch.float32)
    op = _diagonal_csr(np.full(300, 3.0, dtype=np.float32))
    cycle = kernels.FlowCycle("tpfa", op, torch.full((300,), 3.0))
    cycle.launch(b, 0, 1e-3, 1e-9)
    bb = reference.finish(reference.block_partials(b * b)[None])[0]
    assert cycle.state[-2][reference.BICG_ATOL2] == torch.tensor(1e-6, dtype=torch.float32) * bb
    cycle.launch(b, 0, 0.0, 2.0)
    assert float(cycle.state[-2][reference.BICG_ATOL2]) == 4.0
    b[3] = float("nan")
    x, k = cycle.solve(b, tol=1e-3, maxiter=10)
    assert torch.isnan(cycle.state[-2][reference.BICG_ATOL2]) and k == 0


def test_flow_cycle_checks_its_inputs(flow):
    op, _mv, diag, b = _system(flow, "stencil", "f64")
    with pytest.raises(ValueError, match="kind"):
        kernels.FlowCycle("csr", op, diag)
    with pytest.raises(ValueError, match="coef"):
        kernels.FlowCycle("stencil", (op[0][:6],), diag)
    with pytest.raises(ValueError, match="b must be"):
        kernels.FlowCycle("stencil", op, diag).launch(b.float(), 0, 1e-6)
    with pytest.raises(TypeError, match="int32"):
        kernels.FlowCycle("tpfa", (torch.arange(4), torch.arange(3), torch.ones(3)), torch.ones(3))


# -- the Newton steps through the cycle -------------------------------------------


@pytest.fixture(scope="module")
def jax_flow():
    from porepy_tpu.parallel.flow_step import build_cart_flow_kernel as cart_jax
    from porepy_tpu.parallel.structured_flow import build_structured_flow_kernel as struct_jax

    kj, _ = struct_jax(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, **FLUID)
    uj, _ = cart_jax(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, **FLUID)
    return {"stencil": kj, "tpfa": uj}


@pytest.mark.parametrize("step", ["newton_step", "newton_step_f64"])
def test_structured_newton_step_matches_jax(flow, jax_flow, step):
    """One Newton step from p = 2e5 through the plain cycle (f32 inner
    solves and f64 refinement; or one f64 solve) against ``porepy_tpu``'s:
    the same residual norm (1e-13 relative) and new state (1e-9 relative)."""
    import jax
    import jax.numpy as jnp

    kj, kt = jax_flow["stencil"], flow["stencil"]
    p0 = np.full(SHAPE, 2e5)
    pj, rj = jax.jit(lambda a, b: getattr(kj, step)(a, b))(jnp.asarray(p0), jnp.asarray(p0))
    pt, rt = getattr(kt, step)(torch.tensor(p0), torch.tensor(p0))
    assert abs(float(rt) - float(rj)) <= 1e-13 * float(rj)
    assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-9


def test_tpfa_newton_steps_match_jax(flow, jax_flow):
    """Three Newton steps of the twin from p = 2e5 through the plain cycle
    against ``porepy_tpu``'s ``jitted_newton_step``: residual norms to
    1e-13 relative of the first, states to 1e-9 relative."""
    import jax.numpy as jnp

    from porepy_tpu.parallel.flow_step import jitted_newton_step

    kj, kt = jax_flow["tpfa"], flow["tpfa"]
    p0 = np.full(kj.num_cells, 2e5)
    pj, pt = jnp.asarray(p0), torch.tensor(p0)
    first = None
    for _ in range(3):
        pj, rj = jitted_newton_step(kj, pj, jnp.asarray(p0))
        pt, rt = kt.newton_step(pt, torch.tensor(p0))
        first = first or float(rj)
        assert abs(float(rt) - float(rj)) <= 1e-13 * first
        assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-9


def test_newton_step_keeps_one_solver_a_dtype():
    """The linearization buffers and the FlowCycle are made once a kernel
    and dtype and rewritten in place by every step."""
    ks, _ = struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device="cpu", **FLUID)
    ku, _ = cart_torch(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu", **FLUID)
    p0 = torch.full(SHAPE, 2e5, dtype=torch.float64)
    ks.newton_step(p0, p0)
    cycle = ks._solvers[torch.float32][-1]
    ks.newton_step(p0 + 1.0, p0)
    assert ks._solvers[torch.float32][-1] is cycle and set(ks._solvers) == {torch.float32}
    q0 = torch.full((ku.num_cells,), 2e5, dtype=torch.float64)
    ku.newton_step(q0, q0)
    ku.newton_step(q0, q0)
    assert set(ku._solvers) == {torch.float64}


def test_newton_step_reports_each_solves_iterations():
    """``iterations=`` gets one count a solve (4 a structured step, 1 an
    unstructured one), the last the count its FlowCycle holds, each within
    the solve's budget; the step itself is the same with or without it."""
    ks, _ = struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device="cpu", **FLUID)
    ku, _ = cart_torch(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu", **FLUID)
    for kernel, shape, counts in ((ks, SHAPE, 4), (ku, (ku.num_cells,), 1)):
        p, p_prev = (torch.tensor(a) for a in _states(shape, 21)[:2])
        iters = []
        got, rn = kernel.newton_step(p, p_prev, iterations=iters)
        dtype = torch.float32 if kernel is ks else torch.float64
        assert len(iters) == counts and all(0 < k <= 200 for k in iters)
        assert iters[-1] == int(kernel._solvers[dtype][-1].state[-1][1])
        want, rn_want = kernel.newton_step(p, p_prev)
        assert torch.equal(got, want) and torch.equal(rn, rn_want)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cycle_check_runs_on_the_newton_steps_solver(kind, dtype):
    """``flow_cycle_check.check`` (``chip_smoke.py`` phase 10b) on the
    CPU, where both of its sides are the plain version, at 6^3: it holds
    the kernel's own FlowCycle and linearization buffers (the objects the
    Newton step solves with), the linearization equals its plain version,
    the coefficient matvec is within 1e-12 (f64) or 1e-5 (f32) of the
    jvp, and the solve ends within its tolerance's reach (|J x - b| / |b|
    below 1e-8 in f64, 1e-4 in f32)."""
    from porepy_tpu_torch.applications.benchmarking import flow_cycle_check as fcc

    n, dt = 6, TORCH[dtype]
    kernel = fcc.structured_kernel(n, "cpu") if kind == "stencil" else fcc.tpfa_kernel(n, "cpu")
    shape = (n,) * 3 if kind == "stencil" else (kernel.num_cells,)
    p, p_prev, _ = (torch.tensor(a) for a in _states(shape, 22))
    r = fcc.check(kind, kernel, p, p_prev, dt, timing=False)
    cycle = kernel._solvers[dt][-1]
    assert kernel._linearized(p, dt) is cycle
    assert r["equal"] and r["lin_ok"] and r["lin_err"] == 0.0
    assert r["held"] >= 2 and r["flag"] == 0 and 0 < r["iterations"] < fcc.SOLVES[(kind, dt)][1]
    assert r["jvp_rel"] <= JVP_TOL[dtype]
    assert r["res"] <= {"f64": 1e-8, "f32": 1e-4}[dtype]


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cooperative kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["stencil", "tpfa"])
def test_cuda_cycle_matches_plain_to_the_bit(cuda, flow, kind, dtype):
    """Every launch of one solve on the card (the start, 1 and 7
    iterations, the rest) against the plain version from the same state:
    the same bits; one launch each counted; the linearization within 1e-13
    (f64) or 1e-5 (f32) of its plain version's largest coefficient."""
    kernel = flow[kind]
    dt = TORCH[dtype]
    dev_kernel = (struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device=cuda, **FLUID)[0]
                  if kind == "stencil" else
                  cart_torch(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device=cuda,
                             **FLUID)[0])
    p = torch.tensor(_states(_shape(kind, kernel), 8)[0], device=cuda)
    op, _mv = _operator(kind, dev_kernel, p, dt)
    want = (reference.structured_linearize(p.to(dt), *_args(kind, dev_kernel, dt)) if kind == "stencil"
            else None)
    if want is not None:
        assert float((op[0] - want).abs().max()) <= {"f64": 1e-13, "f32": 1e-5}[dtype] * float(want.abs().max())
    diag = dev_kernel._jacobi_diagonal(p).to(dt).reshape(-1).contiguous()
    b = torch.randn(diag.shape[0], generator=torch.Generator(device=cuda).manual_seed(9), dtype=dt, device=cuda)
    cycle = kernels.FlowCycle(kind, op, diag)
    plain = reference.bicgstab_stencil if kind == "stencil" else reference.bicgstab_tpfa
    name = "bicgstab_" + kind
    for budget in (0, 1, 7, 200):
        before = kernels.LAUNCHES[name]
        copy = [t.clone() for t in cycle.state]
        cycle.launch(b, budget, 1e-6)
        plain(*op, diag, b, *copy, budget, 1e-12, 0.0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        for got, exp in zip(cycle.state, copy):
            nan = torch.isnan(exp)
            assert torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], exp[~nan])
