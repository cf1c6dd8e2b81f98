"""Compositional conversion kernels.

Parity counterpart of reference ``compositional/utils.py``: fraction
normalization, saturation-from-fraction inversion and chain rules for
normalized fractions. The reference's numba kernels are plain
numpy/vectorized here (host-side pre/post-processing); jax variants can
jit them directly since all shapes are static.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = [
    "safe_sum",
    "normalize_rows",
    "chainrule_fractional_derivatives",
    "compute_saturations",
    "CompositionalModellingError",
]


class CompositionalModellingError(Exception):
    """Raised for inconsistent compositional model configurations."""


def safe_sum(x: Sequence):
    """Sum that respects operator overloading of the first element (works
    for AD operators and arrays alike)."""
    if len(x) >= 1:
        total = x[0]
        for item in x[1:]:
            total = total + item
        return total
    return 0


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Divide each row by its row sum."""
    return (x.T / x.sum(axis=1)).T


def chainrule_fractional_derivatives(
    df_dxn: np.ndarray, x: np.ndarray
) -> np.ndarray:
    """Chain rule for derivatives w.r.t. normalized fractions: converts
    ``df/dxn`` (last ``num_comp`` rows) to ``df/dx`` for
    ``xn_i = x_i / sum_k x_k``, columnwise over N points."""
    if df_dxn.ndim != 2 or x.ndim != 2:
        raise ValueError("Expecting 2D arrays (vectorized per point)")
    ncomp, npt = x.shape
    out = df_dxn.copy()
    x_sum = x.sum(axis=0)
    # dxn_i/dx_j = delta_ij / S - x_i / S^2, per point.
    eye = np.eye(ncomp)[:, :, None]
    dxn = eye / x_sum[None, None, :] - (
        x[:, None, :] / (x_sum**2)[None, None, :]
    )
    dfn = df_dxn[-ncomp:]
    # out_j = sum_i dfn_i * dxn_{ij}, per point.
    out[-ncomp:] = np.einsum("ijp,ip->jp", dxn, dfn)
    return out


def compute_saturations(
    y: np.ndarray, rho: np.ndarray, eps: float = 1e-10
) -> np.ndarray:
    """Saturations from molar phase fractions and phase densities, solving
    ``(sum_k s_k rho_k) y_j - rho_j s_j = 0`` with ``sum_k s_k = 1``,
    columnwise over N points."""
    y = np.atleast_2d(y)
    rho = np.atleast_2d(rho)
    if y.shape != rho.shape:
        raise ValueError("Arguments 1 and 2 must be of same shape.")
    nphase, npt = y.shape
    s = np.zeros_like(y)
    if nphase == 1:
        return np.ones_like(y)
    saturated = y >= 1.0 - eps
    if np.any(saturated.sum(axis=0) > 1):
        raise ValueError("More than one phase saturated.")
    if nphase == 2:
        sat_any = saturated.any(axis=0)
        # Analytic two-phase inversion where no phase is saturated.
        free = ~sat_any
        denom = 1.0 + y[1, free] / (1 - y[1, free]) * rho[0, free] / rho[
            1, free
        ]
        s[0, free] = 1.0 / denom
        s[1, free] = 1.0 - s[0, free]
        s[saturated] = 1.0
        return s
    for p in range(npt):
        yp, rp = y[:, p], rho[:, p]
        sat = saturated[:, p]
        if np.any(sat):
            s[sat, p] = 1.0
            continue
        present = yp > eps
        y_, r_ = yp[present], rp[present]
        n = y_.size
        rhs = r_ * (y_ - 1.0)
        mat = np.empty((n, n))
        for j in range(n):
            mat[j] = r_[j] * (y_[j] - 1) - r_ * y_[j]
        np.fill_diagonal(mat, 0.0)
        s[present, p] = np.linalg.solve(mat, rhs)
    total = s.sum(axis=0)
    if not np.allclose(total, 1.0):
        raise AssertionError("Saturations violate the unity constraint")
    return s
