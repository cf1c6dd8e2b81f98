"""The structured (K12) and unstructured (K13) flow steps and the BiCGStab
of porepy_tpu_torch against porepy_tpu's, on the CPU (plain kernel
versions).

Both packages build their kernels from the same numpy data; the port's
copies of porepy_tpu's arrays come through ``porepy_tpu_torch.interop``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from porepy_tpu.parallel.flow_step import build_cart_flow_kernel as cart_jax
from porepy_tpu.parallel.flow_step import jitted_newton_step
from porepy_tpu.parallel.structured_flow import build_structured_flow_kernel as struct_jax
from porepy_tpu_torch import kernels
from porepy_tpu_torch.interop import structured_flow_kernel_from, tpfa_flow_kernel_from
from porepy_tpu_torch.numerics.linalg.krylov import bicgstab
from porepy_tpu_torch.parallel import flow_step
from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel as cart_torch
from porepy_tpu_torch.parallel.structured_flow import (
    build_structured_flow_kernel as struct_torch,
)

torch.set_num_threads(1)

FLUID = dict(compressibility=1e-6, viscosity=1e-3, rho_ref=1000.0, p_ref=1e5)
SHAPE = (8, 8, 4)
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
# Residual and tangent, relative to the largest entry: f64 agrees to
# rounding (sums and exp evaluated in another order), f32 to a few ulps.
REL_TOL = {np.float64: 1e-13, np.float32: 1e-5}
# The Newton residual reaches its rounding floor (|r| ~ 1e-4 against 7e11
# at the start) after 4 iterations at this size; the 5th starts from there.
NEWTON_ITERS = 5


def _bc_xyz(x, y, z):
    return 1e5 + 1e4 * (1 - np.asarray(x))


def _bc_faces(fc):
    return 1e5 + 1e4 * (1 - fc[0])


@pytest.fixture(scope="module")
def structured():
    kj, _ = struct_jax(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, **FLUID)
    kt, _ = struct_torch(SHAPE, (1.0, 1.0, 1.0), dt=1.0, bc_pressure=_bc_xyz, device="cpu", **FLUID)
    return kj, kt


@pytest.fixture(scope="module")
def unstructured():
    kj, _ = cart_jax(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, **FLUID)
    kt, _ = cart_torch(list(SHAPE), physdims=[1, 1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu", **FLUID)
    return kj, kt


def test_structured_builder_matches(structured):
    kj, kt = structured
    assert kt.shape == kj.shape
    for f in ("tx", "ty", "tz", "pbc_x", "pbc_y", "pbc_z", "pv", "rho_ref", "comp", "visc", "p_ref", "dt"):
        assert getattr(kt, f).shape == np.shape(getattr(kj, f)), f
        assert getattr(kt, f).is_contiguous(), f
        np.testing.assert_array_equal(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)), err_msg=f)


def test_cart_builder_matches(unstructured):
    """Same topology and data; transmissibilities to rounding (the port's
    TPFA sums half-face reciprocals in another order)."""
    kj, kt = unstructured
    assert (kt.num_cells, kt.num_faces) == (kj.num_cells, kj.num_faces)
    for f in ("lo", "hi", "is_neu"):
        np.testing.assert_array_equal(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)), err_msg=f)
    for f in ("t", "bc_val", "pv"):
        np.testing.assert_allclose(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)), rtol=1e-14)
    for f in ("rho_ref", "comp", "visc", "p_ref", "dt"):
        assert getattr(kt, f).shape == (), f
    # The cell-to-face CSR lists every face once per adjacent cell.
    ptr, cf = kt.cell_ptr.numpy(), kt.cell_faces.numpy()
    assert ptr[-1] == cf.size == int((np.asarray(kj.lo) >= 0).sum() + (np.asarray(kj.hi) >= 0).sum())


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return (
        2e5 + 1e4 * rng.standard_normal(n),
        2e5 + 1e4 * rng.standard_normal(n),
        rng.standard_normal(n),
    )


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_structured_residual_and_jvp_match_linearize(structured, dtype):
    kj, _ = structured
    kj = kj._as_dtype(jnp.dtype(dtype))
    kt = structured_flow_kernel_from(kj, "cpu")
    p, p_prev, v = (a.astype(dtype) for a in _states(SHAPE, 1))
    r_j, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    r_t = kt.residual(torch.tensor(p), torch.tensor(p_prev))
    jv_t = kt.jvp(torch.tensor(p), torch.tensor(v))
    assert r_t.dtype == jv_t.dtype == TORCH[dtype]
    assert _rel_err(r_t.numpy(), np.asarray(r_j)) <= REL_TOL[dtype]
    assert _rel_err(jv_t.numpy(), np.asarray(lin(jnp.asarray(v)))) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_tpfa_residual_and_jvp_match_linearize(unstructured, dtype):
    """The unstructured step runs in f64; the f32 case holds the kernels'
    f32 variant against porepy_tpu's residual on f32 arrays."""
    floats = ("t", "bc_val", "pv", "rho_ref", "comp", "visc", "p_ref", "dt")
    kj = dataclasses.replace(
        unstructured[0], **{f: jnp.asarray(getattr(unstructured[0], f), dtype) for f in floats}
    )
    kt = tpfa_flow_kernel_from(kj, "cpu")
    args = [
        x.to(TORCH[dtype]) if x.is_floating_point() else x
        for x in (*kt._arrays(), kt._coef())
    ]
    p, p_prev, v = (a.astype(dtype) for a in _states(kj.num_cells, 2))
    r_j, lin = jax.linearize(lambda q: kj.residual(q, jnp.asarray(p_prev)), jnp.asarray(p))
    r_t = kernels.tpfa_residual(torch.tensor(p), torch.tensor(p_prev), *args)
    jv_t = kernels.tpfa_jvp(torch.tensor(p), torch.tensor(v), *args)
    assert r_t.dtype == jv_t.dtype == TORCH[dtype]
    assert _rel_err(r_t.numpy(), np.asarray(r_j)) <= REL_TOL[dtype]
    assert _rel_err(jv_t.numpy(), np.asarray(lin(jnp.asarray(v)))) <= REL_TOL[dtype]


def test_structured_newton_step_matches(structured):
    """One mixed-precision Newton step from p = 2e5: the same residual norm
    and the same new state (f32 inner BiCGStab on both sides, so to 1e-9
    relative)."""
    kj, kt = structured
    p0 = np.full(SHAPE, 2e5)
    pj, rj = jax.jit(lambda a, b: kj.newton_step(a, b))(jnp.asarray(p0), jnp.asarray(p0))
    pt, rt = kt.newton_step(torch.tensor(p0), torch.tensor(p0))
    assert abs(float(rt) - float(rj)) <= 1e-13 * float(rj)
    assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-9


def test_tpfa_newton_step_matches(unstructured):
    kj, kt = unstructured
    p0 = np.full(kj.num_cells, 2e5)
    pj, rj = jitted_newton_step(kj, jnp.asarray(p0), jnp.asarray(p0))
    pt, rt = flow_step.newton_step(kt, torch.tensor(p0), torch.tensor(p0))
    assert abs(float(rt) - float(rj)) <= 1e-13 * float(rj)
    assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-9


def _newton(step, p0):
    p = p0
    for _ in range(NEWTON_ITERS):
        p, rn = step(p, p0)
    return p, float(rn)


@pytest.fixture(scope="module")
def converged(structured, unstructured):
    (sj, st), (uj, ut) = structured, unstructured
    ps0 = np.full(SHAPE, 2e5)
    pu0 = np.full(uj.num_cells, 2e5)
    return {
        "s_jax": _newton(jax.jit(lambda a, b: sj.newton_step(a, b)), jnp.asarray(ps0)),
        "s_torch": _newton(st.newton_step, torch.tensor(ps0)),
        "u_jax": _newton(lambda a, b: jitted_newton_step(uj, a, b), jnp.asarray(pu0)),
        "u_torch": _newton(ut.newton_step, torch.tensor(pu0)),
    }


@pytest.mark.parametrize("kind", ["s", "u"], ids=["structured", "unstructured"])
def test_newton_to_convergence_matches_jax(converged, kind):
    """Newton to the rounding floor of the residual: both packages reach
    the same state to 1e-6 abs (pressures ~1e5)."""
    (p_j, r_j), (p_t, r_t) = converged[kind + "_jax"], converged[kind + "_torch"]
    assert r_t < 1e-3 and r_j < 1e-3
    assert np.abs(p_t.numpy() - np.asarray(p_j)).max() <= 1e-6


def test_structured_matches_unstructured(converged):
    """Mirror of tests/parallel/test_flow_kernels.py:60: the stencil and
    the face-gather steps converge to the same pressures (1e-4 abs); the
    Cartesian grid numbers cells x fastest."""
    p_s = converged["s_torch"][0].numpy()
    p_u = converged["u_torch"][0].numpy().reshape(SHAPE[::-1]).T
    assert np.abs(p_s - p_u).max() < 1e-4


# -- BiCGStab ---------------------------------------------------------------------


def _operator(shape=(6, 5, 4), seed=3):
    """A nonsymmetric, diagonally dominant operator on (nx, ny, nz)
    tensors: a dense matrix on the flattened vector."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    A = rng.standard_normal((n, n)) / n + np.diag(2.0 + rng.random(n))
    A[0, 1] += 0.5
    b = rng.standard_normal(shape)
    return A, b, 1.0 / np.diag(A).reshape(shape)


@pytest.mark.parametrize("maxiter", [1, 2, 3, 5, 40])
def test_bicgstab_iterates_match_jax(maxiter):
    """The first iterates, and the converged solution (tol 1e-10), equal
    jax.scipy.sparse.linalg.bicgstab's to 1e-12 relative (f64)."""
    A, b, dinv = _operator()
    shape = b.shape
    mv_j = lambda x: (jnp.asarray(A) @ x.reshape(-1)).reshape(shape)  # noqa: E731
    x_j, _ = jax.scipy.sparse.linalg.bicgstab(
        mv_j, jnp.asarray(b), M=lambda v: v * jnp.asarray(dinv), tol=1e-10, atol=0.0, maxiter=maxiter
    )
    A_t, dinv_t = torch.tensor(A), torch.tensor(dinv)
    x_t, info = bicgstab(
        lambda x: (A_t @ x.reshape(-1)).reshape(shape),
        torch.tensor(b),
        M=lambda v: v * dinv_t,
        tol=1e-10,
        atol=0.0,
        maxiter=maxiter,
    )
    assert info is None and x_t.shape == shape
    assert _rel_err(x_t.numpy(), np.asarray(x_j)) <= 1e-12


def test_bicgstab_exit_early_and_atol():
    """``A = 2 I``: the half step solves exactly, |s|^2 < atol^2 takes the
    exit_early branch (x += alpha phat) and the loop stops after one
    iteration, as in jax."""
    b = np.random.default_rng(5).standard_normal((4, 3))
    x_j, _ = jax.scipy.sparse.linalg.bicgstab(lambda x: 2.0 * x, jnp.asarray(b), tol=0.0, atol=1e-12, maxiter=10)
    x_t, _ = bicgstab(lambda x: 2.0 * x, torch.tensor(b), tol=0.0, atol=1e-12, maxiter=10)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-15)
    np.testing.assert_allclose(x_t.numpy(), b / 2, rtol=1e-15)


def test_bicgstab_zero_rhs_takes_no_iteration():
    calls = []

    def A(x):
        calls.append(1)
        return x

    x, _ = bicgstab(A, torch.zeros(5, dtype=torch.float64), tol=1e-8, maxiter=10)
    assert bool(torch.all(x == 0)) and len(calls) == 1  # only r0 = b - A x0


@pytest.mark.parametrize("kind", ["structured", "tpfa"])
def test_plain_tangents_equal_forward_ad(structured, unstructured, kind):
    """The plain tangents, written out by hand, against torch.func.jvp of
    the plain residuals (f64, to rounding)."""
    reference = kernels.reference

    if kind == "structured":
        kt = structured[1]
        res, tan, shape = reference.structured_residual, reference.structured_jvp, SHAPE
    else:
        kt = unstructured[1]
        res, tan, shape = reference.tpfa_residual, reference.tpfa_jvp, (kt.num_cells,)
    args = (*kt._arrays(), kt._coef())
    p, p_prev, v = (torch.tensor(a) for a in _states(shape, 3))
    want = torch.func.jvp(lambda x: res(x, p_prev, *args), (p,), (v,))[1]
    assert _rel_err(tan(p, v, *args).numpy(), want.numpy()) <= 1e-13


def test_unstructured_kernel_matches_model():
    """Mirror of tests/parallel/test_flow_kernels.py:26 through the port:
    the K13 step (2d, 8 x 8) converges to the pressures of the port's
    SinglePhaseFlow model layer (1e-4 abs)."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.compositional.materials import ReferenceVariableValues

    kernel, _ = cart_torch(
        [8, 8], physdims=[1, 1], dt=1.0, bc_pressure=_bc_faces, device="cpu", **FLUID
    )
    p_prev = torch.full((kernel.num_cells,), 2e5, dtype=torch.float64)
    p = p_prev
    for _ in range(NEWTON_ITERS):
        p, _rn = kernel.newton_step(p, p_prev)

    class M(pt.SinglePhaseFlow):
        def bc_values_pressure(self, bg):
            return 1e5 + 1e4 * (1 - bg.cell_centers[0])

        def ic_values_pressure(self, sd):
            return np.full(sd.num_cells, 2e5)

        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {
        "meshing_arguments": {"cell_size": 1 / 8},
        "material_constants": {
            "fluid": pt.FluidComponent(compressibility=1e-6, viscosity=1e-3, density=1000.0),
            "solid": pt.SolidConstants(permeability=1.0, porosity=0.1),
        },
        "reference_variable_values": ReferenceVariableValues(pressure=1e5),
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "device": "cpu",
    }
    m = M(params)
    pt.run_time_dependent_model(m, params)
    p_model = m.equation_system.get_variable_values(time_step_index=0)
    assert np.abs(p.numpy() - p_model).max() < 1e-4
