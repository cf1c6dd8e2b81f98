"""Biot poroelastic coupling terms, batched per interaction region.

Capability counterpart of reference ``numerics/fv/biot.py:40``: on top of
the MPSA-W stress discretization, produce the poromechanical coupling
matrices for each scalar field coupled through a Biot tensor ``alpha``
(given per keyword via the ``scalar_vector_mappings`` parameter):

- ``scalar_gradient``: the pressure contribution to face tractions. The
  total stress is ``sigma(G) - alpha p``; the local traction-balance rows
  acquire pressure RHS columns ``+sgn (n~.alpha)_i p_c`` and the stencil a
  direct term ``-(n~.alpha) p`` from the designated side.
- ``displacement_divergence`` / ``boundary_displacement_divergence``: per
  cell, ``sum_s V_s (alpha : G_s)`` over its subcells — the discrete
  ``alpha : grad u``.
- ``mpsa_consistency``: the same divergence rows applied to the
  pressure-induced gradients (the Nordbotten 2016 stabilization).
- ``bound_displacement_pressure``: pressure contribution to the boundary
  displacement reconstruction.

All rows/columns are produced in the single batched MPSA pass
(``mpsa._assemble_mpsa_w``); this module only unpacks them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.numerics.fv.mpsa import Mpsa, _assemble_mpsa_w
from porepy_tpu_torch.params.tensor import SecondOrderTensor
from porepy_tpu_torch.utils import common_constants as cc

__all__ = ["Biot"]


class Biot(Mpsa):
    def __init__(self, keyword: str = "mechanics") -> None:
        super().__init__(keyword)
        self.displacement_divergence_matrix_key = "displacement_divergence"
        self.bound_displacement_divergence_matrix_key = (
            "boundary_displacement_divergence"
        )
        self.scalar_gradient_matrix_key = "scalar_gradient"
        self.consistency_matrix_key = "mpsa_consistency"
        self.bound_pressure_matrix_key = "bound_displacement_pressure"

    def ndof(self, sd) -> int:
        return sd.num_cells * (sd.dim + 1)

    def update_discretization(self, sd, data: dict) -> None:
        """Partial update after a local modification, including the
        cell-row (divergence) matrices (reference
        ``biot.py:update_discretization``): cells sharing a node with the
        modification set are re-assembled along with the face closure."""
        from porepy_tpu_torch.numerics.fv._fvutils import (
            partial_update_discretization,
        )

        partial_update_discretization(
            sd,
            data,
            self.keyword,
            self.discretize,
            dim=sd.dim,
            scalar_cell_right=(
                self.scalar_gradient_matrix_key,
                self.consistency_matrix_key,
                self.bound_pressure_matrix_key,
            ),
            vector_cell_right=(
                self.stress_matrix_key,
                self.bound_displacement_cell_matrix_key,
                self.displacement_divergence_matrix_key,
            ),
            vector_face_right=(
                self.bound_stress_matrix_key,
                self.bound_displacement_face_matrix_key,
                self.bound_displacement_divergence_matrix_key,
            ),
            scalar_cell_left=(
                self.displacement_divergence_matrix_key,
                self.consistency_matrix_key,
                self.bound_displacement_divergence_matrix_key,
            ),
            vector_face_left=(
                self.stress_matrix_key,
                self.bound_stress_matrix_key,
                self.scalar_gradient_matrix_key,
                self.bound_displacement_cell_matrix_key,
                self.bound_displacement_face_matrix_key,
                self.bound_pressure_matrix_key,
            ),
        )

    def discretize(self, sd, data: dict) -> None:
        param = data[cc.PARAMETERS][self.keyword]
        matrices = data[cc.DISCRETIZATION_MATRICES][self.keyword]
        bound = param["bc"]
        constit = param["fourth_order_tensor"]
        eta = param.get("mpsa_eta", None)
        scalar_vector_mappings: dict = param["scalar_vector_mappings"]

        alphas: dict[str, np.ndarray] = {}
        for key, alpha in scalar_vector_mappings.items():
            if isinstance(alpha, (float, int)):
                alpha = SecondOrderTensor(float(alpha) * np.ones(sd.num_cells))
            alphas[key] = alpha.values

        from porepy_tpu_torch.numerics.fv._fvutils import restriction_from_params

        (
            stress,
            bound_stress,
            disp_cell,
            disp_bound,
            scalar_gradient,
            displacement_divergence,
            bound_displacement_divergence,
            consistency,
            disp_pressure,
        ) = _assemble_mpsa_w(
            sd,
            constit,
            bound,
            eta,
            eta,
            alphas=alphas,
            restrict=restriction_from_params(sd, param),
        )

        matrices[self.stress_matrix_key] = stress
        matrices[self.bound_stress_matrix_key] = bound_stress
        matrices[self.displacement_divergence_matrix_key] = displacement_divergence
        matrices[self.bound_displacement_divergence_matrix_key] = (
            bound_displacement_divergence
        )
        matrices[self.scalar_gradient_matrix_key] = scalar_gradient
        matrices[self.consistency_matrix_key] = consistency
        matrices[self.bound_displacement_cell_matrix_key] = disp_cell
        matrices[self.bound_displacement_face_matrix_key] = disp_bound
        matrices[self.bound_pressure_matrix_key] = disp_pressure
