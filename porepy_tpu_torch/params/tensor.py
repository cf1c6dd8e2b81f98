"""Cell-wise material tensors.

Parity counterpart of reference ``params/tensor.py:68,251``:

- :class:`SecondOrderTensor`: permeability/conductivity, stored as a dense
  ``(3, 3, num_cells)`` array regardless of grid dimension (unit values pad
  unused directions).
- :class:`FourthOrderTensor`: elastic stiffness C built from cell-wise Lame
  parameters, stored as ``(3*3, 3*3, num_cells)``.

These are host-side containers; discretizations pull out the per-cell dense
blocks as device arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["SecondOrderTensor", "FourthOrderTensor"]


class SecondOrderTensor:
    """Symmetric positive-definite cell-wise 3x3 tensor."""

    def __init__(
        self,
        kxx: np.ndarray,
        kyy: Optional[np.ndarray] = None,
        kzz: Optional[np.ndarray] = None,
        kxy: Optional[np.ndarray] = None,
        kxz: Optional[np.ndarray] = None,
        kyz: Optional[np.ndarray] = None,
    ) -> None:
        kxx = np.asarray(kxx, dtype=float)
        nc = kxx.size
        kyy = kxx if kyy is None else np.asarray(kyy, dtype=float)
        kzz = kxx if kzz is None else np.asarray(kzz, dtype=float)
        zero = np.zeros(nc)
        kxy = zero if kxy is None else np.asarray(kxy, dtype=float)
        kxz = zero if kxz is None else np.asarray(kxz, dtype=float)
        kyz = zero if kyz is None else np.asarray(kyz, dtype=float)

        if np.any(kxx < 0):
            raise ValueError("Tensor not positive definite (x)")
        if np.any(kxx * kyy - kxy**2 < 0):
            raise ValueError("Tensor not positive definite (y)")
        det = (
            kxx * (kyy * kzz - kyz**2)
            - kxy * (kxy * kzz - kyz * kxz)
            + kxz * (kxy * kyz - kyy * kxz)
        )
        if np.any(det < 0):
            raise ValueError("Tensor not positive definite (z)")

        values = np.zeros((3, 3, nc))
        values[0, 0] = kxx
        values[1, 1] = kyy
        values[2, 2] = kzz
        values[0, 1] = values[1, 0] = kxy
        values[0, 2] = values[2, 0] = kxz
        values[1, 2] = values[2, 1] = kyz
        self.values: np.ndarray = values

    def copy(self) -> "SecondOrderTensor":
        t = SecondOrderTensor.__new__(SecondOrderTensor)
        t.values = self.values.copy()
        return t

    def restrict_to_cells(self, cells: np.ndarray) -> "SecondOrderTensor":
        t = SecondOrderTensor.__new__(SecondOrderTensor)
        t.values = self.values[:, :, cells].copy()
        return t

    def rotate(self, R: np.ndarray) -> None:
        """In-place rotation R K R^T of every cell tensor."""
        self.values = np.einsum("ij,jkc,lk->ilc", R, self.values, R)


class FourthOrderTensor:
    """Cell-wise isotropic elastic stiffness in Voigt-free (9x9) layout.

    C_ijkl = lambda delta_ij delta_kl + mu (delta_ik delta_jl +
    delta_il delta_jk), flattened to ``(9, 9, nc)`` with row index
    ``i*3 + j`` — matching the reference layout so MPSA-discretization
    goldens compare directly.
    """

    def __init__(self, mu: np.ndarray, lmbda: np.ndarray) -> None:
        mu = np.asarray(mu, dtype=float)
        lmbda = np.asarray(lmbda, dtype=float)
        if mu.shape != lmbda.shape or mu.ndim != 1:
            raise ValueError("mu and lmbda must be equal-length 1d arrays")
        nc = mu.size
        self.mu = mu
        self.lmbda = lmbda

        eye = np.eye(3)
        # c[i,j,k,l] per cell.
        c = (
            np.einsum("ij,kl->ijkl", eye, eye)[..., None] * lmbda
            + (
                np.einsum("ik,jl->ijkl", eye, eye)
                + np.einsum("il,jk->ijkl", eye, eye)
            )[..., None]
            * mu
        )
        self.values: np.ndarray = c.reshape(9, 9, nc)

    def copy(self) -> "FourthOrderTensor":
        t = FourthOrderTensor.__new__(FourthOrderTensor)
        t.values = self.values.copy()
        t.mu = self.mu.copy()
        t.lmbda = self.lmbda.copy()
        return t

    def restrict_to_cells(self, cells: np.ndarray) -> "FourthOrderTensor":
        t = FourthOrderTensor.__new__(FourthOrderTensor)
        t.values = self.values[:, :, cells].copy()
        t.mu = self.mu[cells].copy()
        t.lmbda = self.lmbda[cells].copy()
        return t
