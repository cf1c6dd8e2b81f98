"""Abstract interface for local phase-equilibrium (flash) computations
(reference ``compositional/flash.py:18``), and the constant-K flash on the
device (K17)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.compositional.base import Fluid
from porepy_tpu_torch.compositional.states import FluidState, PhaseState
from porepy_tpu_torch.utils import device_policy

__all__ = ["Flash", "ConstantKFlash"]


class Flash:
    """Interface of flash backends: given a fluid and an intensive state
    specification, compute the equilibrium fluid state."""

    def __init__(self, fluid: Fluid) -> None:
        self.fluid = fluid
        self.tolerance: float = 1e-8
        self.max_iter: int = 150

    def compute_flash(
        self,
        z: Sequence[np.ndarray],
        p: Optional[np.ndarray] = None,
        T: Optional[np.ndarray] = None,
        h: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        initial_state: Optional[FluidState] = None,
        parameters: Optional[dict] = None,
    ) -> tuple[FluidState, np.ndarray, np.ndarray]:
        """Perform the flash for the given specification (p-T, p-h or h-v).

        Returns the fluid state, a success flag per point (0 converged) and
        the number of iterations per point.
        """
        raise NotImplementedError("Flash backends must implement compute_flash")


class ConstantKFlash(Flash):
    """Two-phase p-T flash with constant K-values (distribution
    coefficients ``y_i = K_i x_i``): ``max_iter`` guarded Newton steps of
    the Rachford-Rice equation at every point at once, one thread per point
    in the K17 kernel (``kernels/csrc/flash.cu``) on the card, its plain
    version on the CPU.

    Parameters:
        fluid: The fluid; the reference phase is taken as liquid, the
            second phase as vapor.
        k_values: ``(num_components,)`` constant K-values.
        device: Where the flash runs (default: the card; ``"cpu"`` for the
            host).
    """

    def __init__(self, fluid: Fluid, k_values: Sequence[float], device=None) -> None:
        super().__init__(fluid)
        self.k_values = np.asarray(k_values, dtype=float)
        if self.k_values.size != fluid.num_components:
            raise ValueError("One K-value per component is required")
        if fluid.num_phases != 2:
            raise ValueError("ConstantKFlash is a two-phase flash")
        self.device = device_policy.resolve(device)

    def compute_flash(
        self,
        z: Sequence[np.ndarray],
        p: Optional[np.ndarray] = None,
        T: Optional[np.ndarray] = None,
        h: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        initial_state: Optional[FluidState] = None,
        parameters: Optional[dict] = None,
    ) -> tuple[FluidState, np.ndarray, np.ndarray]:
        zs = np.vstack([np.asarray(zi, dtype=float) for zi in z])
        z_dev = torch.tensor(zs, dtype=torch.float64, device=self.device)
        K_dev = torch.tensor(self.k_values, dtype=torch.float64, device=self.device)
        V, x, y, converged, _iters = (
            a.cpu().numpy()
            for a in kernels.rachford_rice(z_dev, K_dev, int(self.max_iter), float(self.tolerance))
        )

        state = FluidState()
        state.z = zs
        state.p = np.zeros(zs.shape[1]) if p is None else np.asarray(p)
        state.T = np.zeros(zs.shape[1]) if T is None else np.asarray(T)
        # Phase fraction order matches fluid.phases: [reference(liquid), vapor].
        state.y = np.vstack([1.0 - V, V])
        state.phases = [PhaseState(x=x), PhaseState(x=y)]
        if parameters and "phase_densities" in parameters:
            rho = parameters["phase_densities"]
            state.phases[0].rho = np.asarray(rho[0])
            state.phases[1].rho = np.asarray(rho[1])
            state.evaluate_saturations()
        success = np.where(converged, 0, 1)
        return state, success, np.full(zs.shape[1], self.max_iter)
