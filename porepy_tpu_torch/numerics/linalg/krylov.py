"""Krylov solvers on assembled sparse matrices, and the host-fallback count.

:data:`FALLBACK_COUNTER` counts every device Krylov solve that missed its
tolerance and fell back to the host direct solver (observable from
SolverStatistics, the tests and ``chip_smoke.py``).

:func:`bicgstab` and :func:`gmres` are the matrix-free BiCGStab and GMRES
(``solve_method="batched"``) of ``jax.scipy.sparse.linalg`` (jax 0.9) in
plain PyTorch, host loops that read a flag every iteration: the
matrix-free plain versions the tests compare with. The structured and
unstructured flow steps (:mod:`porepy_tpu_torch.parallel`) solve with
:class:`porepy_tpu_torch.kernels.FlowCycle`, the same BiCGStab in one
cooperative kernel.

:func:`solve_sparse` (K18, behind the ``jax_bicgstab``/``jax_gmres``
linear-solver options) solves an assembled scipy matrix with the same two
iterations and a Jacobi preconditioner on the device: the matrix goes over
once per solve, in CSR form. A BiCGStab solve is one cooperative K18a
kernel that runs its iterations, matvecs and scalar recurrence included,
until the solve stops (after one that starts it); each GMRES(30) restart is
one cooperative K18b kernel, matvecs included (``kernels/csrc/krylov.cu``;
their plain versions on the CPU). A solve that misses its tolerance on the
host check falls back to ``spsolve`` and counts in :data:`FALLBACK_COUNTER`.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg  # noqa: F401  (sps.linalg.spsolve)
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import reference as _ref
from porepy_tpu_torch.utils import device_policy

__all__ = [
    "bicgstab", "gmres", "solve_sparse", "jacobi_preconditioner", "FALLBACK_COUNTER",
    "LAST_SOLVE", "csr_arrays", "gmres_state", "bicgstab_state",
]

logger = logging.getLogger(__name__)

#: Number of times a device Krylov solve missed tolerance and fell back to
#: the host direct solver (observable from SolverStatistics and tests).
FALLBACK_COUNTER = {"count": 0}

#: The last :func:`solve_sparse` call: its method and Krylov iterations
#: (BiCGStab iterations; GMRES Arnoldi steps, ``restart`` per restart).
LAST_SOLVE = {"method": None, "iterations": 0}


def _inverse_diagonal(A: sps.spmatrix) -> np.ndarray:
    """``1 / diag(A)``, with the diagonal's zeros (|d| <= 1e-300) taken as 1."""
    d = np.asarray(A.diagonal())
    return 1.0 / np.where(np.abs(d) > 1e-300, d, 1.0)


def jacobi_preconditioner(A: sps.spmatrix, device=None):
    """``x -> D^{-1} x`` with ``D`` the (guarded) diagonal of ``A``, on
    ``device`` (default: the card, :func:`device_policy.resolve`)."""
    inv = torch.tensor(
        _inverse_diagonal(A), dtype=torch.float64, device=device_policy.resolve(device)
    )

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


def _safe_normalize(x: torch.Tensor, thresh=None):
    """jax's ``_safe_normalize``: ``(x / |x|, |x|)``, or ``(0, 0)`` where
    ``|x|`` is at or below ``thresh`` (default eps)."""
    norm = torch.sqrt(_vdot(x, x))
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return torch.where(use, x / norm, torch.zeros_like(x)), torch.where(use, norm, torch.zeros_like(norm))


def gmres(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-5,
    atol: float = 0.0,
    restart: int = 20,
    maxiter: Optional[int] = None,
    M: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[torch.Tensor, None]:
    """Restarted GMRES for ``A x = b`` with ``b`` of shape ``(n,)``, the
    iteration of ``jax.scipy.sparse.linalg.gmres(solve_method="batched")``
    (jax 0.9 ``_gmres_solve``/``_gmres_batched``): restart while
    ``|M (b - A x)| > max(tol |b|, atol)``, at most ``maxiter`` restarts
    (default ``10 n``). Each restart builds ``restart`` Arnoldi vectors of
    ``M A`` by one classical Gram-Schmidt pass (what jax's
    ``_iterative_classical_gram_schmidt`` with ``max_iterations=2`` runs),
    stops early on a breakdown, and solves the least squares by the normal
    equations and a Cholesky factorization (jax's ``_lstsq``). Returns
    ``(x, None)``."""
    if M is None:
        M = lambda v: v  # noqa: E731
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    restart = min(restart, n)
    x = torch.zeros_like(b) if x0 is None else x0
    eps = torch.finfo(b.dtype).eps
    atol = torch.clamp(tol * torch.sqrt(_vdot(b, b)), min=atol)
    unit, rnorm = _safe_normalize(M(b - A(x)))
    k = 0
    while k < maxiter and bool(rnorm > atol):
        V = torch.zeros(restart + 1, n, dtype=b.dtype, device=b.device)
        V[0] = unit
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        for j in range(restart):
            v = M(A(V[j]))
            _, norm0 = _safe_normalize(v)
            h = V @ v
            v = v - V.T @ h
            unit_v, norm1 = _safe_normalize(v, thresh=eps * norm0)
            V[j + 1] = unit_v
            h[j + 1] = norm1
            H[j] = h
            if bool(norm1 == 0):
                break
        beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
        beta[0] = rnorm
        L = torch.linalg.cholesky(H @ H.T)
        y = torch.cholesky_solve((H @ beta)[:, None], L)[:, 0]
        x = x + V[:-1].T @ y
        unit, rnorm = _safe_normalize(M(b - A(x)))
        k += 1
    return x, None


def _op(name: str, *args) -> None:
    """Call the K18 operator ``name`` (kernel on the card, plain on the CPU)."""
    getattr(kernels, name)(*args)


def bicgstab_state(n: int, atol2: float, device) -> list:
    """The arrays a BiCGStab solve of ``n`` unknowns carries from one
    ``bicgstab_cycle`` launch to the next, after the matrix, ``dinv`` and
    ``b``: ``[x, r, rhat, p, q, phat, s, shat, t, partials, st, cont]``, ``x
    = 0``, the tolerance ``atol2`` (squared) in ``st``, ``rho = alpha = omega
    = 1``, ``cont`` int32 ``(2,)`` (the continue flag, the iterations run)."""
    f64 = dict(dtype=torch.float64, device=device)
    nb = -(-n // _ref.KRYLOV_BLOCK)
    st = torch.zeros(_ref.BICG_SLOTS, **f64)
    st[[_ref.BICG_RHO, _ref.BICG_ALPHA, _ref.BICG_OMEGA]] = 1.0
    st[_ref.BICG_ATOL2] = atol2
    return (
        [torch.zeros(n, **f64) for _ in range(9)]
        + [torch.zeros(_ref.BICG_ROWS, nb, **f64), st,
           torch.zeros(2, dtype=torch.int32, device=device)]
    )


def _bicgstab_fused(csr, b: torch.Tensor, dinv: torch.Tensor, atol2: float, maxiter: int,
                    run=_op):
    """:func:`bicgstab` with ``M = dinv *`` on the CSR matrix ``csr = (row_ptr,
    cols, vals)``: one K18a operator (``bicgstab_cycle``) starts the solve,
    and one more runs its iterations, the matvecs and the scalar recurrence
    inside it, until it stops on the device or spends the ``maxiter``
    budget; the host reads the continue flag and the count after it, once.
    ``run(name, *args)`` calls each K18 operator (a check may wrap it).
    Returns ``(x, iterations)``."""
    state = bicgstab_state(b.shape[0], atol2, b.device)
    run("bicgstab_cycle", *csr, dinv, b, *state, 0)
    # The solve's launch follows the start unread: it runs no iteration
    # where the start found the residual within the tolerance.
    flag, k = 1, 0
    while k < maxiter and flag:
        run("bicgstab_cycle", *csr, dinv, b, *state, maxiter - k)
        flag, k = state[-1].tolist()
    return state[0], k


def gmres_state(n: int, restart: int, atol: float, device) -> list:
    """The arrays a GMRES(``restart``) solve of ``n`` unknowns carries from
    one ``gmres_cycle`` to the next, after the matrix, ``dinv`` and ``b``:
    ``[x, V, H, y, w, partials, flags, st, cont]``, ``x = 0`` and the
    tolerance ``atol`` in ``st``."""
    f64 = dict(dtype=torch.float64, device=device)
    nb = -(-n // _ref.KRYLOV_BLOCK)
    st = torch.zeros(_ref.GMRES_SLOTS, **f64)
    st[_ref.GMRES_ATOL] = atol
    return [
        torch.zeros(n, **f64), torch.zeros(restart + 1, n, **f64),
        torch.zeros(restart, restart + 1, **f64), torch.zeros(restart, **f64),
        torch.zeros(n, **f64), torch.zeros(restart + 3, nb, **f64),
        torch.zeros(restart + 1, dtype=torch.int32, device=device), st,
        torch.zeros(1, dtype=torch.int32, device=device),
    ]


def _gmres_fused(csr, b: torch.Tensor, dinv: torch.Tensor, atol: float, maxiter: int,
                 restart: int, run=_op):
    """:func:`gmres` with ``M = dinv *`` on the CSR matrix ``csr = (row_ptr,
    cols, vals)`` (int32, int32, float64), each restart one K18b operator
    (``gmres_cycle``, its matvecs inside it); a breakdown is handled on the
    device, and the host reads the continue flag once per restart. ``run``
    as for :func:`_bicgstab_fused`. Returns ``(x, arnoldi_steps)``."""
    n = b.shape[0]
    restart = min(restart, n)
    state = gmres_state(n, restart, atol, b.device)
    run("gmres_cycle", *csr, dinv, b, *state, 0)
    k = 0
    while k < maxiter and bool(state[-1]):
        run("gmres_cycle", *csr, dinv, b, *state, 1)
        k += 1
    return state[0], k * restart


def csr_arrays(A: sps.spmatrix, device) -> tuple:
    """``(row_ptr, cols, vals)`` of ``A`` on ``device``: int32, int32,
    float64, each row's columns in increasing order."""
    A = sps.csr_matrix(A, copy=True)
    A.sort_indices()
    return (
        torch.tensor(A.indptr.astype(np.int32), device=device),
        torch.tensor(A.indices.astype(np.int32), device=device),
        torch.tensor(A.data.astype(np.float64), device=device),
    )


def solve_sparse(
    A: sps.spmatrix,
    b: np.ndarray,
    method: str = "bicgstab",
    tol: float = 1e-12,
    maxiter: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Solve ``A x = b`` with Jacobi-preconditioned GMRES(30) (``method
    "gmres"``: each restart one K18b launch) or BiCGStab (any other method:
    one K18a launch for the whole solve, after the one that starts it) on
    the matrix in CSR form on ``device`` (default: the card); falls back to host ``spsolve``, and counts it in
    :data:`FALLBACK_COUNTER`, when ``|b - A x| > max(tol max(|b|, 1) 1e3,
    1e-8)`` on the host. ``maxiter`` (default ``max(200, 4 n)``) counts
    BiCGStab iterations or GMRES restarts, as in jax."""
    A = A.tocsr()
    n = A.shape[0]
    if maxiter is None:
        maxiter = max(200, 4 * n)
    dev = device_policy.resolve(device)
    dinv = torch.tensor(_inverse_diagonal(A), dtype=torch.float64, device=dev)
    b = np.asarray(b, dtype=np.float64)
    b_dev = torch.tensor(b, dtype=torch.float64, device=dev)
    b_dot = float(b @ b)
    csr = csr_arrays(A, dev)
    if method == "gmres":
        x, iters = _gmres_fused(csr, b_dev, dinv, tol * np.sqrt(b_dot), maxiter, 30)
    else:
        x, iters = _bicgstab_fused(csr, b_dev, dinv, tol**2 * b_dot, maxiter)
    LAST_SOLVE.update(method=method, iterations=iters)
    x_np = x.cpu().numpy()
    res = np.linalg.norm(b - A @ x_np)
    b_norm = np.linalg.norm(b)
    if not np.isfinite(res) or res > max(tol * max(b_norm, 1.0) * 1e3, 1e-8):
        FALLBACK_COUNTER["count"] += 1
        logger.warning(
            "Device %s missed tolerance (|r|=%.2e, |b|=%.2e); falling back "
            "to host spsolve (fallback #%d). Consider a stronger "
            "preconditioner or the block-preconditioned solver.",
            method,
            res,
            b_norm,
            FALLBACK_COUNTER["count"],
        )
        x_np = sps.linalg.spsolve(A, b)
    return x_np
