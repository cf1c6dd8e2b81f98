"""K12's Newton-step launches on the CPU: the residual that also writes the
cell densities and the refinement round ``c - J(p) dx`` from them
(``kernels.StructuredLauncher``; plain versions
``reference.structured_residual_rho``, ``reference.structured_refine``), and
``reference.fma``, with which the plain versions form the faces as the
kernel does.

(a) ``fma`` against exact rational arithmetic (the correctly rounded ``a b +
    c``) in f64 and f32, on random operands, near-cancelling ones, small
    addends and near ties: equal;
(b) the two new plain versions compose to the bits of
    ``-reference.structured_residual - reference.structured_jvp``, f64 and
    f32, and the launcher on the CPU is its plain versions;
(c) ``newton_step`` (the new launches) against the parent's step (a
    ``structured_jvp`` and two torch operations a round) to the bit, and
    against porepy_tpu's ``StructuredFlowKernel.newton_step`` at 8^3 over
    chained steps within 1e-10 relative (f32 inner solves on both sides,
    iterations in another order).

``jax`` is imported inside the test that compares with it, so the test
marked ``cuda`` (the launches against their plain versions and the
parent's tangent, to the bit) runs on a card without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_structured_refine.py -m cuda
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking.structured_refine_check import parent_newton_step
from porepy_tpu_torch.kernels import reference
from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel as struct_torch

torch.set_num_threads(1)

FLUID = dict(compressibility=1e-6, viscosity=1e-3, rho_ref=1000.0, p_ref=1e5)
SHAPE = (8, 8, 8)
#: The port's chained Newton states against porepy_tpu's, relative to the
#: largest pressure.
TOL_JAX = 1e-10
STEPS = 4


def _bc_xyz(x, y, z):
    return 1e5 + 1e4 * (1 - np.asarray(x))


@pytest.fixture(scope="module")
def structured():
    kt, _ = struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device="cpu", **FLUID)
    return kt


# -- (a) the fused multiply-add ------------------------------------------------------


def _operands(mode, rng, n, dtype):
    if mode == "random":
        a, b, c = rng.standard_normal(n), rng.standard_normal(n), rng.standard_normal(n)
    elif mode == "cancelling":
        a, b = rng.standard_normal(n), rng.standard_normal(n)
        c = -(a * b).astype(dtype) * (1.0 + 1e-7 * rng.standard_normal(n))
    elif mode == "small_addend":
        a, b, c = 1e5 * rng.standard_normal(n), 1e-3 * rng.standard_normal(n), 1e-30 * rng.standard_normal(n)
    else:  # integers whose products sit on or near ties of the type
        a = rng.integers(1, 2**20, n).astype(float)
        b = rng.integers(1, 2**20, n).astype(float)
        c = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 10, n)
    return a.astype(dtype), b.astype(dtype), c.astype(dtype)


def _round(r: Fraction, dtype):
    """``r`` rounded to nearest, ties to even, in ``dtype``."""
    near = dtype(float(r))
    cands = [near, np.nextafter(near, dtype(np.inf)), np.nextafter(near, dtype(-np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - r), int(np.asarray(y).view(
        np.int64 if dtype == np.float64 else np.int32)) & 1))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["random", "cancelling", "small_addend", "ties"])
def test_fma_is_rounded_once(dtype, mode):
    rng = np.random.default_rng(5)
    a, b, c = _operands(mode, rng, 2000, dtype)
    got = reference.fma(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    want = np.array([
        _round(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)), dtype) for x, y, z in zip(a, b, c)
    ], dtype=dtype)
    np.testing.assert_array_equal(got, want)


def test_fma_special_values_and_tangent():
    t = lambda *v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    got = reference.fma(t(0.0, 2.0, float("inf"), 3.0), t(5.0, 0.0, 1.0, 4.0), t(-0.0, 7.0, 1.0, float("nan")))
    assert got[0] == 0.0 and got[1] == 7.0 and got[2] == float("inf") and bool(torch.isnan(got[3]))
    rng = np.random.default_rng(6)
    a, b, c, da, db, dc = (torch.tensor(rng.standard_normal(50)) for _ in range(6))
    val, tan = torch.func.jvp(reference.fma, (a, b, c), (da, db, dc))
    assert torch.equal(val, reference.fma(a, b, c))
    torch.testing.assert_close(tan, da * b + a * db + dc, rtol=1e-15, atol=1e-15)


# -- (b) the plain versions --------------------------------------------------------------


def _states(seed, dtype):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.tensor(a, dtype=dtype)
        for a in (2e5 + 1e4 * rng.standard_normal(SHAPE), 2e5 + 1e4 * rng.standard_normal(SHAPE),
                  rng.standard_normal(SHAPE))
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_versions_compose_to_the_parent_pair(structured, dtype):
    kt = structured._as_dtype(dtype)
    args = (*kt._arrays(), kt._coef())
    p, p_prev, dx = _states(8, dtype)
    r, rho = reference.structured_residual_rho(p, p_prev, *args)
    assert torch.equal(r, reference.structured_residual(p, p_prev, *args))
    assert torch.equal(rho, reference._density(p, args[-1]))
    c = -r
    got = reference.structured_refine(p, dx, c, rho, *args)
    assert torch.equal(got, -reference.structured_residual(p, p_prev, *args) - reference.structured_jvp(p, dx, *args))
    launcher = kernels.StructuredLauncher(*args)
    r2, rho2 = launcher.residual(p, p_prev)
    assert torch.equal(r2, r) and torch.equal(rho2, rho)
    assert torch.equal(launcher.refine(p, dx, c, rho), got)


def test_plain_tangent_against_forward_mode(structured):
    """The written-out tangent with its FMAs against ``torch.func.jvp`` of
    the plain residual (f64, to rounding)."""
    kt = structured
    args = (*kt._arrays(), kt._coef())
    p, p_prev, v = _states(9, torch.float64)
    want = torch.func.jvp(lambda x: reference.structured_residual(x, p_prev, *args), (p,), (v,))[1]
    got = reference.structured_jvp(p, v, *args)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-13


# -- (c) the Newton step ---------------------------------------------------------------------


def test_newton_step_equals_the_parent_route(structured):
    kt = structured
    p0 = torch.full(SHAPE, 2e5, dtype=torch.float64)
    p_new = p_old = p0
    it_new, it_old = [], []
    for _ in range(STEPS):
        p_new, r_new = kt.newton_step(p_new, p0, iterations=it_new)
        p_old, r_old = parent_newton_step(kt, p_old, p0, iterations=it_old)
        assert torch.equal(p_new, p_old) and torch.equal(r_new, r_old)
    assert it_new == it_old


def test_newton_step_matches_jax(structured):
    import jax
    import jax.numpy as jnp

    from porepy_tpu.parallel.structured_flow import build_structured_flow_kernel as struct_jax

    kj, _ = struct_jax(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, **FLUID)
    kt = structured
    p0 = np.full(SHAPE, 2e5)
    step_j = jax.jit(lambda a, b: kj.newton_step(a, b))
    pj, pt = jnp.asarray(p0), torch.tensor(p0)
    for _ in range(STEPS):
        pj, rj = step_j(pj, jnp.asarray(p0))
        pt, rt = kt.newton_step(pt, torch.tensor(p0))
        scale = np.abs(np.asarray(pj)).max()
        assert np.abs(pt.numpy() - np.asarray(pj)).max() <= TOL_JAX * scale
        assert abs(float(rt) - float(rj)) <= 1e-6 * max(float(rj), 1e-3)


# -- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cuda_launches_match_plain(structured, cuda, dtype):
    kt = structured._as_dtype(dtype)
    args = (*kt._arrays(), kt._coef())
    card = tuple(a.to(cuda) for a in args)
    p, p_prev, dx = _states(10, dtype)
    launcher = kernels.StructuredLauncher(*card)
    r, rho = launcher.residual(p.to(cuda), p_prev.to(cuda))
    want_r, want_rho = reference.structured_residual_rho(p.to(cuda), p_prev.to(cuda), *card)
    assert torch.equal(r, want_r) and torch.equal(rho, want_rho)
    got = launcher.refine(p.to(cuda), dx.to(cuda), -r, rho)
    assert torch.equal(got, reference.structured_refine(p.to(cuda), dx.to(cuda), -r, rho, *card))
    assert torch.equal(got, -r - kernels.structured_jvp(p.to(cuda), dx.to(cuda), *card))
