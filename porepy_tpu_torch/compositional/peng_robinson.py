"""Peng-Robinson (1976) equation of state and a two-phase p-T flash.

The EoS depth the reference's abstraction anticipates
(``/root/reference/src/porepy/compositional/base.py:340`` defines the
interface; the reference ships concrete cubic EoS machinery in its
`porepy-composite` extension): mixture parameters with van der Waals
mixing rules, a vectorized trigonometric/Cardano cubic solve, fugacity
coefficients, mass density and departure enthalpy.

TPU-native shape: every routine is written as closed-form array math over
ALL cells at once (no point loops — the reference extension compiles
per-point numba kernels); the flash is successive substitution with a
vectorized bounded-Newton Rachford-Rice inner solve, so each iteration is
a handful of fused elementwise passes over the batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from porepy_tpu_torch.compositional.base import EquationOfState
from porepy_tpu_torch.compositional.flash import Flash
from porepy_tpu_torch.compositional.states import FluidState, PhaseState

__all__ = ["PengRobinsonEoS", "PengRobinsonFlash", "R_IDEAL"]

R_IDEAL = 8.31446261815324  # J / (mol K)

# Critical-point coefficients of the PR cubic to full precision (the
# usual 5-digit 0.45724/0.07780 split the critical triple root enough to
# shift Z_c by 5%): exact values from (dP/dV) = (d2P/dV2) = 0.
OMEGA_A = 0.4572355289213822
OMEGA_B = 0.07779607390388846

_SQRT2 = np.sqrt(2.0)


def _solve_cubic_z(A: np.ndarray, B: np.ndarray, gas_like: bool) -> np.ndarray:
    """Real roots of ``Z^3 + c2 Z^2 + c1 Z + c0 = 0`` (PR form), selecting
    the largest root for gas-like and the smallest root ``> B`` for
    liquid-like phases. Fully vectorized Cardano/trigonometric solve."""
    c2 = -(1.0 - B)
    c1 = A - 3.0 * B**2 - 2.0 * B
    c0 = -(A * B - B**2 - B**3)

    p = c1 - c2**2 / 3.0
    q = 2.0 * c2**3 / 27.0 - c2 * c1 / 3.0 + c0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # Three-real-root (disc <= 0) branch: trigonometric form.
    p_safe = np.where(p < 0.0, p, -1e-30)
    m = 2.0 * np.sqrt(-p_safe / 3.0)
    arg = np.clip(3.0 * q / (p_safe * m), -1.0, 1.0)
    theta = np.arccos(arg) / 3.0
    k = np.arange(3.0)[:, None]
    roots3 = m * np.cos(theta - 2.0 * np.pi * k / 3.0) - c2 / 3.0

    # One-real-root (disc > 0) branch: Cardano.
    sq = np.sqrt(np.maximum(disc, 0.0))
    u = np.cbrt(-q / 2.0 + sq)
    v = np.cbrt(-q / 2.0 - sq)
    root1 = u + v - c2 / 3.0

    if gas_like:
        z3 = roots3.max(axis=0)
    else:
        # Smallest root above B (a physically meaningful volume).
        valid = roots3 > B[None, :] + 1e-14
        z3 = np.where(valid, roots3, np.inf).min(axis=0)
        z3 = np.where(np.isfinite(z3), z3, roots3.max(axis=0))
    Z = np.where(disc > 0.0, root1, z3)
    # Newton polish: near-degenerate (triple-root) regions lose several
    # digits to cancellation in either closed form; a few guarded steps
    # restore them. Vectorized, so the cost is negligible.
    for _ in range(3):
        f = ((Z + c2) * Z + c1) * Z + c0
        df = (3.0 * Z + 2.0 * c2) * Z + c1
        step = f / np.where(np.abs(df) < 1e-30, 1e-30, df)
        Z = Z - np.clip(step, -0.1, 0.1)
    return Z


class PengRobinsonEoS(EquationOfState):
    """Peng-Robinson EoS over a component set with critical data.

    Components must provide ``critical_temperature`` [K],
    ``critical_pressure`` [Pa], ``acentric_factor`` [-] and ``molar_mass``
    [kg/mol] (:class:`~porepy_tpu.compositional.materials.FluidComponent`
    does). ``binary_interaction`` is an optional symmetric
    ``(nc, nc)`` k_ij matrix (defaults to zeros).
    """

    def __init__(
        self,
        components: Sequence,
        binary_interaction: Optional[np.ndarray] = None,
    ) -> None:
        super().__init__(components)
        self.Tc = np.array([c.critical_temperature for c in components])
        self.pc = np.array([c.critical_pressure for c in components])
        self.omega = np.array([c.acentric_factor for c in components])
        self.M = np.array([c.molar_mass for c in components])
        nc = len(components)
        if binary_interaction is None:
            binary_interaction = np.zeros((nc, nc))
        self.kij = np.asarray(binary_interaction, dtype=float)
        self.kappa = (
            0.37464 + 1.54226 * self.omega - 0.26992 * self.omega**2
        )
        self.b_i = OMEGA_B * R_IDEAL * self.Tc / self.pc
        self.a_crit_i = OMEGA_A * R_IDEAL**2 * self.Tc**2 / self.pc

    # -- mixture parameters ----------------------------------------------------

    def _ai(self, T: np.ndarray) -> np.ndarray:
        """Per-component a_i(T), shape (nc, N)."""
        Tr = T[None, :] / self.Tc[:, None]
        alpha = (1.0 + self.kappa[:, None] * (1.0 - np.sqrt(Tr))) ** 2
        return self.a_crit_i[:, None] * alpha

    def _dai_dT(self, T: np.ndarray) -> np.ndarray:
        Tr = T[None, :] / self.Tc[:, None]
        sqrt_alpha = 1.0 + self.kappa[:, None] * (1.0 - np.sqrt(Tr))
        # d sqrt(alpha)/dT = -kappa / (2 sqrt(T Tc))
        dsqrt_alpha = -self.kappa[:, None] / (
            2.0 * np.sqrt(T[None, :] * self.Tc[:, None])
        )
        return self.a_crit_i[:, None] * 2.0 * sqrt_alpha * dsqrt_alpha

    def _mixture(self, x: np.ndarray, T: np.ndarray):
        """Mixture a, b and the per-component sum S_i = sum_j x_j a_ij
        for composition x of shape (nc, N)."""
        ai = self._ai(T)  # (nc, N)
        sqrt_ai = np.sqrt(ai)
        # a_ij = sqrt(a_i a_j) (1 - k_ij)
        # S_i = sum_j x_j a_ij = sqrt(a_i) sum_j x_j sqrt(a_j) (1 - k_ij)
        xsj = x * sqrt_ai  # (nc, N)
        S = sqrt_ai * (
            np.einsum("jn,ij->in", xsj, 1.0 - self.kij)
        )
        a = np.sum(x * S, axis=0)
        b = np.sum(x * self.b_i[:, None], axis=0)
        return a, b, S, ai

    # -- phase evaluation ------------------------------------------------------

    def compressibility(self, p, T, x, gas_like: bool) -> np.ndarray:
        p = np.atleast_1d(np.asarray(p, dtype=float))
        T = np.atleast_1d(np.asarray(T, dtype=float))
        a, b, _S, _ai = self._mixture(np.atleast_2d(x), T)
        A = a * p / (R_IDEAL**2 * T**2)
        B = b * p / (R_IDEAL * T)
        return _solve_cubic_z(A, B, gas_like)

    def fugacity_coefficients(self, p, T, x, gas_like: bool) -> np.ndarray:
        """ln phi_i, shape (nc, N)."""
        p = np.atleast_1d(np.asarray(p, dtype=float))
        T = np.atleast_1d(np.asarray(T, dtype=float))
        x = np.atleast_2d(x)
        a, b, S, _ai = self._mixture(x, T)
        A = a * p / (R_IDEAL**2 * T**2)
        B = b * p / (R_IDEAL * T)
        Z = _solve_cubic_z(A, B, gas_like)
        bb = self.b_i[:, None] / b[None, :]
        safe_log1 = np.log(np.maximum(Z - B, 1e-300))
        log_term = np.log(
            np.maximum(
                (Z + (1.0 + _SQRT2) * B) / (Z + (1.0 - _SQRT2) * B), 1e-300
            )
        )
        a_safe = np.maximum(a, 1e-300)
        ln_phi = (
            bb * (Z - 1.0)[None, :]
            - safe_log1[None, :]
            - (A / (2.0 * _SQRT2 * B))[None, :]
            * (2.0 * S / a_safe[None, :] - bb)
            * log_term[None, :]
        )
        return ln_phi

    def compute_phase_properties(self, phase_state, *thermo_input, params=None):
        """(p, T, x_1..x_nc) -> PhaseState with mass density, departure-
        corrected enthalpy, fugacity coefficients. ``phase_state`` decides
        the cubic root branch (gas: largest; liquid: smallest)."""
        from porepy_tpu_torch.compositional._core import PhysicalState

        p = np.atleast_1d(np.asarray(thermo_input[0], dtype=float))
        T = np.atleast_1d(np.asarray(thermo_input[1], dtype=float))
        if len(thermo_input) > 2:
            x = np.vstack([np.atleast_1d(xi) for xi in thermo_input[2:]])
        else:
            x = np.ones((1, p.size))
        x = x / np.maximum(x.sum(axis=0, keepdims=True), 1e-300)
        gas_like = phase_state == PhysicalState.gas

        a, b, S, _ai = self._mixture(x, T)
        A = a * p / (R_IDEAL**2 * T**2)
        B = b * p / (R_IDEAL * T)
        Z = _solve_cubic_z(A, B, gas_like)

        M_mix = np.sum(x * self.M[:, None], axis=0)
        rho = p * M_mix / (np.maximum(Z, 1e-12) * R_IDEAL * T)

        # Departure enthalpy (molar), converted to specific [J/kg].
        daT = np.sum(
            x
            * np.sqrt(self._ai(T))
            * (
                np.einsum(
                    "jn,ij->in",
                    x * self._dai_dT(T) / np.maximum(np.sqrt(self._ai(T)), 1e-300),
                    1.0 - self.kij,
                )
            ),
            axis=0,
        )
        log_term = np.log(
            np.maximum(
                (Z + (1.0 + _SQRT2) * B) / (Z + (1.0 - _SQRT2) * B), 1e-300
            )
        )
        h_dep_molar = R_IDEAL * T * (Z - 1.0) + (
            T * daT - a
        ) / (2.0 * _SQRT2 * b) * log_term
        h = h_dep_molar / np.maximum(M_mix, 1e-300)

        n = p.size
        return PhaseState(
            rho=rho,
            h=h,
            mu=np.full(n, 1e-5 if gas_like else 1e-3),
            kappa=np.full(n, 0.03 if gas_like else 0.5),
            x=x,
            phis=np.exp(self.fugacity_coefficients(p, T, x, gas_like)),
            drho=np.zeros((len(thermo_input), n)),
            dh=np.zeros((len(thermo_input), n)),
            dmu=np.zeros((len(thermo_input), n)),
            dkappa=np.zeros((len(thermo_input), n)),
        )


def _rachford_rice(z: np.ndarray, K: np.ndarray, iters: int = 60) -> np.ndarray:
    """Vapor fraction V in [0, 1] solving sum_i z_i (K_i - 1) /
    (1 + V (K_i - 1)) = 0 per point; vectorized bounded Newton with
    bisection fallback. ``z``/``K`` of shape (nc, N)."""
    Km1 = K - 1.0
    # Feasible window (poles of the RR function).
    Kmax = K.max(axis=0)
    Kmin = K.min(axis=0)
    lo = np.where(Kmax > 1.0, 1.0 / (1.0 - Kmax), -1e10) + 1e-12
    hi = np.where(Kmin < 1.0, 1.0 / (1.0 - Kmin), 1e10) - 1e-12
    V = np.clip(0.5, lo, hi)

    def g_and_dg(V):
        den = 1.0 + V[None, :] * Km1
        den = np.where(np.abs(den) < 1e-14, 1e-14, den)
        g = np.sum(z * Km1 / den, axis=0)
        dg = -np.sum(z * Km1**2 / den**2, axis=0)
        return g, dg

    glo, _ = g_and_dg(lo)
    for _ in range(iters):
        g, dg = g_and_dg(V)
        Vn = V - g / np.where(np.abs(dg) < 1e-300, -1e-300, dg)
        bad = (Vn <= lo) | (Vn >= hi) | ~np.isfinite(Vn)
        # Bisection fallback keeps the bracket.
        same_side = np.sign(g) == np.sign(glo)
        lo = np.where(same_side, V, lo)
        hi = np.where(same_side, hi, V)
        V = np.where(bad, 0.5 * (lo + hi), Vn)
    return V


class PengRobinsonFlash(Flash):
    """Two-phase p-T flash by successive substitution on the PR EoS:
    Wilson initialization, vectorized Rachford-Rice inner solve, fugacity-
    coefficient K-update; single-phase points detected by the RR window.

    Whole-batch iteration: every step is closed-form array math over all
    points (the reference extension iterates pointwise in numba)."""

    def __init__(self, fluid, binary_interaction=None) -> None:
        super().__init__(fluid)
        self.eos = PengRobinsonEoS(
            list(fluid.components), binary_interaction
        )

    def wilson_k(self, p: np.ndarray, T: np.ndarray) -> np.ndarray:
        e = self.eos
        return (e.pc[:, None] / p[None, :]) * np.exp(
            5.373
            * (1.0 + e.omega[:, None])
            * (1.0 - e.Tc[:, None] / T[None, :])
        )

    def compute_flash(
        self,
        z,
        p=None,
        T=None,
        h=None,
        v=None,
        initial_state=None,
        parameters=None,
    ):
        if p is None or T is None:
            raise NotImplementedError(
                "PengRobinsonFlash implements the p-T specification"
            )
        p = np.atleast_1d(np.asarray(p, dtype=float))
        T = np.atleast_1d(np.asarray(T, dtype=float))
        z = np.vstack([np.atleast_1d(np.asarray(zi, float)) for zi in z])
        z = z / np.maximum(z.sum(axis=0, keepdims=True), 1e-300)
        N = p.size
        eos = self.eos

        K = self.wilson_k(p, T)
        n_iter = np.zeros(N, dtype=int)
        for it in range(self.max_iter):
            V = _rachford_rice(z, K)
            Vc = np.clip(V, 0.0, 1.0)
            x = z / (1.0 + Vc[None, :] * (K - 1.0))
            y = K * x
            x = x / np.maximum(x.sum(axis=0, keepdims=True), 1e-300)
            y = y / np.maximum(y.sum(axis=0, keepdims=True), 1e-300)
            ln_phi_l = eos.fugacity_coefficients(p, T, x, gas_like=False)
            ln_phi_v = eos.fugacity_coefficients(p, T, y, gas_like=True)
            dlnK = ln_phi_l - ln_phi_v
            K_new = np.exp(np.log(K) + 0.8 * (dlnK - np.log(K)))
            err = np.abs(np.log(K_new) - np.log(K)).max(axis=0)
            live = err > self.tolerance
            n_iter += live
            K = K_new
            if not live.any():
                break

        V = np.clip(_rachford_rice(z, K), 0.0, 1.0)
        x = z / (1.0 + V[None, :] * (K - 1.0))
        y = K * x
        x = x / np.maximum(x.sum(axis=0, keepdims=True), 1e-300)
        y = y / np.maximum(y.sum(axis=0, keepdims=True), 1e-300)

        from porepy_tpu_torch.compositional._core import PhysicalState

        liq = eos.compute_phase_properties(
            PhysicalState.liquid, p, T, *list(x)
        )
        gas = eos.compute_phase_properties(PhysicalState.gas, p, T, *list(y))
        state = FluidState(
            p=p,
            T=T,
            z=z,
            y=np.vstack([1.0 - V, V]),
            phases=[liq, gas],
        )
        state.evaluate_saturations()
        success = np.where(err <= self.tolerance, 0, 1)
        return state, success, n_iter

    def saturation_pressure(
        self, T: float, tol: float = 1e-9, max_iter: int = 200
    ) -> float:
        """Pure-component vapor pressure at T via equal-fugacity bisection
        (single component only)."""
        eos = self.eos
        if eos.Tc.size != 1:
            raise ValueError("saturation_pressure is single-component only")
        Tc, pc, om = eos.Tc[0], eos.pc[0], eos.omega[0]
        if T >= Tc:
            raise ValueError("T above critical")
        # Successive substitution from the Wilson estimate: p <- p
        # phi_L/phi_V converges monotonically to equal fugacity in the
        # two-root region (the Wilson guess starts inside it below Tc).
        p = pc * np.exp(5.373 * (1.0 + om) * (1.0 - Tc / T))
        Ta = np.array([T])
        x1 = np.ones((1, 1))
        for _ in range(max_iter):
            pa = np.array([p])
            lv = eos.fugacity_coefficients(pa, Ta, x1, gas_like=True)[0, 0]
            ll = eos.fugacity_coefficients(pa, Ta, x1, gas_like=False)[0, 0]
            d = ll - lv
            p_new = min(p * float(np.exp(d)), pc * 0.999999)
            if abs(d) < tol:
                return float(p_new)
            p = p_new
        return float(p)
