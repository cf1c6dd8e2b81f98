"""The constant-K flash (K17) of porepy_tpu_torch on the CPU (the plain
version of the kernel): the mirrors of ``tests/compositional/test_flash.py``
and of the ConstantKFlash part of ``tests/compositional/test_peng_robinson.py``,
and the port against ``porepy_tpu``'s ``ConstantKFlash`` on seeded
feeds."""

import numpy as np
import pytest
import scipy.optimize
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.compositional import base as base_jax
from porepy_tpu.compositional._core import PhysicalState as PhysicalStateJax
from porepy_tpu_torch.compositional._core import PhysicalState
from porepy_tpu_torch.compositional.base import Fluid, Phase
from porepy_tpu_torch.kernels import reference

torch.set_num_threads(1)

CH4 = dict(
    name="ch4", critical_temperature=190.564, critical_pressure=4.5992e6,
    acentric_factor=0.01142, molar_mass=0.016043,
)
C3H8 = dict(
    name="c3h8", critical_temperature=369.89, critical_pressure=4.2512e6,
    acentric_factor=0.1521, molar_mass=0.0441,
)


def _fluid(nc=2, specs=None, pkg=pt, base=None, state=PhysicalState):
    base = base or {"Fluid": Fluid, "Phase": Phase}
    specs = specs or [dict(name=f"c{i}") for i in range(nc)]
    comps = [pkg.FluidComponent(**s) for s in specs]
    phases = [base["Phase"](state.liquid, "liquid"), base["Phase"](state.gas, "gas")]
    for ph in phases:
        ph.components = comps
    return base["Fluid"](comps, phases)


def _flash(K, nc=None):
    return pt.ConstantKFlash(_fluid(nc or len(K)), K, device="cpu")


def test_flash_matches_scalar_root():
    K = np.array([2.5, 0.3])
    flash = _flash(K)
    rng = np.random.default_rng(4)
    z0 = rng.uniform(0.2, 0.8, 50)
    z = [z0, 1.0 - z0]
    state, success, _ = flash.compute_flash(z)
    assert np.all(success == 0)
    V = state.y[1]
    for j in range(0, 50, 7):
        def rr(v):
            return sum(zi[j] * (k - 1) / (1 + v * (k - 1)) for zi, k in zip(z, K))

        if rr(0) <= 0:
            v_ref = 0.0
        elif rr(1) >= 0:
            v_ref = 1.0
        else:
            v_ref = scipy.optimize.brentq(rr, 0.0, 1.0, xtol=1e-12)
        assert abs(V[j] - v_ref) < 1e-8
        x = state.phases[0].x[:, j]
        y = state.phases[1].x[:, j]
        assert np.isclose(x.sum(), 1.0) and np.isclose(y.sum(), 1.0)
        if 0 < v_ref < 1:
            assert np.allclose(y / x, K, rtol=1e-6)


def test_flash_single_phase_corners():
    flash = _flash(np.array([2.0, 0.5]))
    state, success, _ = flash.compute_flash([np.array([0.05]), np.array([0.95])])
    assert state.y[1][0] == 0.0
    state, _, _ = flash.compute_flash([np.array([0.98]), np.array([0.02])])
    assert state.y[1][0] == 1.0


def test_flash_mass_balance():
    flash = _flash(np.array([3.0, 0.8, 0.2]))
    rng = np.random.default_rng(1)
    raw = rng.random((3, 30)) + 0.05
    zs = raw / raw.sum(axis=0)
    state, success, _ = flash.compute_flash(list(zs))
    V = state.y[1]
    x = state.phases[0].x
    y = state.phases[1].x
    two_phase = (V > 0) & (V < 1)
    recon = (1 - V) * x + V * y
    assert np.allclose(recon[:, two_phase], zs[:, two_phase], atol=1e-8)


def test_flash_matches_constant_k_at_converged_k():
    """With K frozen at the Peng-Robinson flash's converged values, the
    port's ConstantKFlash gives the same vapor fraction."""
    fluid = _fluid(specs=[CH4, C3H8])
    flash = pt.PengRobinsonFlash(fluid)
    z = [np.array([0.4]), np.array([0.6])]
    p, T = np.array([2.0e6]), np.array([280.0])
    state, success, _ = flash.compute_flash(z, p=p, T=T)
    assert success[0] == 0
    liq, gas = state.phases
    K = (gas.x / liq.x)[:, 0]
    state_ck, _, _ = pt.ConstantKFlash(fluid, K, device="cpu").compute_flash(z, p=p, T=T)
    assert np.isclose(state_ck.y[1][0], state.y[1][0], atol=1e-6)


@pytest.mark.parametrize(
    "K", [[2.5, 0.3], [3.0, 0.8, 0.2], [4.0, 1.6, 0.9, 0.35, 0.05]], ids=["nc2", "nc3", "nc5"]
)
def test_constant_k_flash_matches_jax(K):
    """The port against ``porepy_tpu``'s ConstantKFlash on 2,000 seeded
    feeds (both corners and the two-phase region): V, x and y within 1e-13,
    the same converged flags."""
    nc = len(K)
    rng = np.random.default_rng(7 + nc)
    raw = rng.random((nc, 2000)) ** 3 + 1e-3
    zs = raw / raw.sum(axis=0)
    fluid_jax = _fluid(
        nc, pkg=pt_jax, base={"Fluid": base_jax.Fluid, "Phase": base_jax.Phase},
        state=PhysicalStateJax,
    )
    got, ok, its = _flash(np.array(K)).compute_flash(list(zs))
    want, ok_jax, its_jax = pt_jax.ConstantKFlash(fluid_jax, K).compute_flash(list(zs))
    assert np.array_equal(ok, ok_jax) and np.array_equal(its, its_jax)
    V = got.y[1]
    assert 0 < np.count_nonzero((V > 0) & (V < 1)) < V.size
    assert np.abs(got.y - want.y).max() <= 1e-13
    for ph, ph_jax in zip(got.phases, want.phases):
        assert np.abs(ph.x - ph_jax.x).max() <= 1e-13


PHASE15_K = {2: [2.5, 0.3], 3: [3.0, 0.8, 0.2], 5: [4.0, 1.6, 0.9, 0.35, 0.05]}


@pytest.mark.parametrize("max_iter", [7, 149, 150, 151])
@pytest.mark.parametrize("nc", [2, 3, 5])
def test_flash_cycle_exit_equals_the_full_loop(nc, max_iter):
    """The plain version, whose points stop once an iterate repeats one of
    the last ``FLASH_RING``, equals a loop of all ``max_iter`` steps to the
    bit in V, x, y and the flags, on 2^14 points of ``chip_smoke.py`` phase
    15's generator; ``max_iter`` 7, 149, 150 and 151 put the end of the loop
    at every phase of a 2-cycle and of most longer ones."""
    K = torch.tensor(PHASE15_K[nc], dtype=torch.float64)
    raw = np.random.default_rng(15 + nc).random((nc, 1 << 14)) + 0.02
    zs = torch.tensor(raw / raw.sum(axis=0))
    got = reference.rachford_rice(zs, K, max_iter, 1e-8)
    want = reference.rachford_rice_full(zs, K, max_iter, 1e-8)
    for g, w in zip(got[:4], want):
        assert reference.same_bits(g, w)
    iters = got[4]
    two_phase = (got[0] > 0) & (got[0] < 1)
    assert int(two_phase.sum()) > 1000
    # Points stop early: fewer iterations than max_iter on most of them.
    if max_iter >= 149:
        assert float(iters[two_phase].float().mean()) < 10


def test_flash_plain_version_counts_the_iterations_it_needs():
    """The plain version records, per point, the iterations it ran: 0 for a
    single-phase point, else the first ``it`` whose iterate repeats one of
    the ``FLASH_RING`` before it in the full loop's orbit (``max_iter``
    where none does), and it ends with the full loop's V to the bit."""
    K = torch.tensor([3.0, 0.8, 0.2], dtype=torch.float64)
    rng = np.random.default_rng(2)
    raw = rng.random((3, 500)) + 0.05
    zs = torch.tensor(raw / raw.sum(axis=0))
    V, x, y, conv, iters = reference.rachford_rice(zs, K, 150, 1e-8)
    V_full = reference.rachford_rice_full(zs, K, 150, 1e-8)[0]
    orbit = torch.stack(list(reference.rachford_rice_iterates(zs, K, 150)))
    assert reference.same_bits(V, V_full)
    single = (V == 0) | (V == 1)
    assert torch.equal(iters == 0, single)
    # repeat[it, i]: V_it equals one of V_{it - 1} .. V_{it - FLASH_RING}.
    window = reference.FLASH_RING
    repeat = torch.zeros_like(orbit, dtype=torch.bool)
    for m in range(1, window + 1):
        repeat[m:] |= orbit[m:] == orbit[:-m]
    first = torch.where(repeat[1:].any(0), repeat[1:].to(torch.int8).argmax(0) + 1, 150)
    assert torch.equal(iters[~single].long(), first[~single])
    stopped = iters < 150
    assert int((stopped & ~single).sum()) > 300 and int(iters.max()) <= 150


def test_flash_iteration_stats_and_work():
    """The K17 helpers that phase 15 and the check script print: the mean
    iterations a point, the mean over warps of the slowest lane (the last
    warp padded with zeros), the points at ``max_iter``, and the bytes and
    f64 operations of the bound."""
    iters = torch.tensor([0] * 31 + [150] + [3] * 32 + [5] * 4, dtype=torch.int32)
    stats = reference.flash_iteration_stats(iters, 150)
    assert stats == {"mean": 266 / 68, "warp_slowest": (150 + 3 + 5) / 3, "at_max": 1}
    assert reference.flash_work(iters, 3) == (8.0 * 10 * 68 + 5.0 * 68, 266.0 * 32 + 68 * 45)
