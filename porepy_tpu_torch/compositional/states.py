"""Value containers for thermodynamic states (reference
``compositional/states.py:44-297``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["PhaseState", "FluidState"]


@dataclass
class PhaseState:
    """Values (and optional derivative rows) of one phase's properties at a
    set of points."""

    h: np.ndarray = field(default_factory=lambda: np.zeros(0))
    rho: np.ndarray = field(default_factory=lambda: np.zeros(0))
    mu: np.ndarray = field(default_factory=lambda: np.zeros(0))
    kappa: np.ndarray = field(default_factory=lambda: np.zeros(0))
    x: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    phis: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    # Derivatives w.r.t. the declared dependencies (row per dependency).
    dh: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    drho: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    dmu: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    dkappa: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))

    @property
    def v(self) -> np.ndarray:
        """Specific volume: reciprocal of density."""
        return 1.0 / self.rho

    @property
    def xn(self) -> np.ndarray:
        """Normalized (partial) fractions."""
        from porepy_tpu_torch.compositional.utils import normalize_rows

        return normalize_rows(self.x.T).T


@dataclass
class FluidState:
    """Global fluid state: intensive state, per-phase fractions and
    saturations, plus the phase states."""

    p: np.ndarray = field(default_factory=lambda: np.zeros(0))
    T: np.ndarray = field(default_factory=lambda: np.zeros(0))
    h: np.ndarray = field(default_factory=lambda: np.zeros(0))
    v: np.ndarray = field(default_factory=lambda: np.zeros(0))
    z: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    y: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    sat: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    phases: list = field(default_factory=list)

    @property
    def rho(self) -> np.ndarray:
        """Mixture density ``sum_j s_j rho_j``."""
        return np.sum(
            np.stack([s * ph.rho for s, ph in zip(self.sat, self.phases)]),
            axis=0,
        )

    def evaluate_saturations(self, eps: float = 1e-10) -> None:
        from porepy_tpu_torch.compositional.utils import compute_saturations

        rho = np.stack([ph.rho for ph in self.phases])
        self.sat = compute_saturations(self.y, rho, eps)
