"""Krylov solvers on assembled sparse matrices, and the host-fallback count.

:data:`FALLBACK_COUNTER` counts every device Krylov solve that missed its
tolerance and fell back to the host direct solver (observable from
SolverStatistics, the tests and ``chip_smoke.py``).

:func:`bicgstab` is the matrix-free BiCGStab of ``jax.scipy.sparse.linalg``
(jax 0.9), which the structured and unstructured flow steps
(:mod:`porepy_tpu_torch.parallel`) solve with.

``porepy_tpu``'s ``solve_sparse`` (K18: a Jacobi-preconditioned
``jax.scipy`` GMRES/BiCGStab behind the ``jax_gmres``/``jax_bicgstab``
linear-solver options) is not ported: it raises ``NotImplementedError``.
The md path uses :mod:`porepy_tpu_torch.numerics.linalg.device_solver`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse as sps
import torch

__all__ = ["bicgstab", "solve_sparse", "jacobi_preconditioner", "FALLBACK_COUNTER"]

#: Number of times a device Krylov solve missed tolerance and fell back to
#: the host direct solver (observable from SolverStatistics and tests).
FALLBACK_COUNTER = {"count": 0}


def jacobi_preconditioner(A: sps.spmatrix, device="cpu"):
    """``x -> D^{-1} x`` with ``D`` the (guarded) diagonal of ``A``."""
    d = np.asarray(A.diagonal())
    d = np.where(np.abs(d) > 1e-300, d, 1.0)
    inv = torch.tensor(1.0 / d, dtype=torch.float64, device=device)

    def M(x):
        return inv * x

    return M


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))


def bicgstab(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-5,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[torch.Tensor, None]:
    """Preconditioned BiCGStab for ``A x = b``, the iteration of
    ``jax.scipy.sparse.linalg.bicgstab`` (jax 0.9 ``_bicgstab_solve``):
    stop when ``|r|^2 <= max(tol^2 |b|^2, atol^2)``, after ``maxiter``
    iterations (default ``10 * b.numel()``), or on breakdown
    (``rho == 0``, ``omega == 0`` or ``alpha == 0``; the breaking
    iteration's update is kept, as in jax). When ``|s|^2 < atol^2`` after
    the half step, the half step is taken alone. ``b`` may have any shape;
    dot products run over all its elements. Returns ``(x, None)``.

    The loop runs on the host and reads one continue flag from the device
    per iteration."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if maxiter is None:
        maxiter = 10 * b.numel()
    x = torch.zeros_like(b) if x0 is None else x0
    bs = _vdot(b, b)
    atol2 = torch.clamp(tol**2 * bs, min=atol**2)
    r = b - A(x)
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    p = q = r
    k = 0
    cont = _vdot(r, r) > atol2
    while k < maxiter and bool(cont):
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / _vdot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = _vdot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega_ = _vdot(t, s) / _vdot(t, t)
        x = torch.where(exit_early, x + alpha_ * phat, x + (alpha_ * phat + omega_ * shat))
        r = torch.where(exit_early, s, s - omega_ * t)
        breakdown = (omega_ == 0) | (alpha_ == 0) | (rho_ == 0)
        alpha, omega, rho, p, q = alpha_, omega_, rho_, p_, q_
        k += 1
        cont = (_vdot(r, r) > atol2) & ~breakdown
    return x, None


def solve_sparse(
    A: sps.spmatrix,
    b: np.ndarray,
    method: str = "bicgstab",
    tol: float = 1e-12,
    maxiter: Optional[int] = None,
) -> np.ndarray:
    """Jacobi-preconditioned GMRES/BiCGStab (K18): not ported."""
    raise NotImplementedError(
        f"solve_sparse ({method}, K18) is not ported; use linear_solver="
        "'device_gmres' or 'scipy_sparse'"
    )
