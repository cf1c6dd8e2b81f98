"""Anderson acceleration for fixed-point iterations (reference
``numerics/nonlinear/anderson_acceleration.py:5``)."""

from __future__ import annotations

import numpy as np
from scipy.linalg import lstsq

__all__ = ["AndersonAcceleration"]


class AndersonAcceleration:
    """Depth-m Anderson mixing: the new iterate is the fixed-point
    application corrected by a least-squares combination of the last
    ``depth`` increment histories."""

    def __init__(self, dimension: int, depth: int) -> None:
        self._dimension = dimension
        self._depth = depth
        self.reset()
        self._fkm1 = self._Fk.copy()
        self._gkm1 = self._Gk.copy()

    def reset(self) -> None:
        self._Fk = np.zeros((self._dimension, self._depth))
        self._Gk = np.zeros((self._dimension, self._depth))

    def apply(self, gk: np.ndarray, fk: np.ndarray, iteration: int) -> np.ndarray:
        if iteration == 0:
            self.reset()
        mk = min(iteration, self._depth)
        if mk > 0:
            col = (iteration - 1) % self._depth
            self._Fk[:, col] = fk - self._fkm1
            self._Gk[:, col] = gk - self._gkm1
            gamma_k = lstsq(self._Fk[:, 0:mk], fk)[0]
            x_k_plus_1 = gk - self._Gk[:, 0:mk] @ gamma_k
        else:
            x_k_plus_1 = gk
        self._fkm1 = fk.copy()
        self._gkm1 = gk.copy()
        return x_k_plus_1
