"""Krylov solvers on assembled sparse matrices, and the host-fallback count.

:data:`FALLBACK_COUNTER` counts every device Krylov solve that missed its
tolerance and fell back to the host direct solver (observable from
SolverStatistics, the tests and ``chip_smoke.py``).

``porepy_tpu``'s ``solve_sparse`` (K18: a Jacobi-preconditioned
``jax.scipy`` GMRES/BiCGStab behind the ``jax_gmres``/``jax_bicgstab``
linear-solver options) is not ported: it raises ``NotImplementedError``.
The md path uses :mod:`porepy_tpu_torch.numerics.linalg.device_solver`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

__all__ = ["solve_sparse", "jacobi_preconditioner", "FALLBACK_COUNTER"]

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
