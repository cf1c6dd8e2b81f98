"""Shared helpers for verification examples (reference
``utils/examples_utils.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["VerificationUtils"]


class VerificationUtils:
    """Mixin with quantities used by the verification setups."""

    def face_displacement(self, sd) -> np.ndarray:
        """Displacement reconstructed on faces from the MPSA/Biot boundary
        operators. Valid for single-subdomain models."""
        from porepy_tpu_torch.models.constitutive_laws import (
            LinearElasticMechanicalStress,
        )
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd, MpsaAd

        assert len(self.mdg.subdomains()) == 1 and sd.dim == self.mdg.dim_max()
        u = self.displacement([sd])
        p = self.pressure([sd])
        discr_mech = MpsaAd(self.stress_keyword, [sd], self.mdg)
        discr_poromech = BiotAd(self.stress_keyword, [sd], self.mdg)
        bc = LinearElasticMechanicalStress.combine_boundary_operators_mechanical_stress(
            self, subdomains=[sd]
        )
        u_faces_ad = (
            discr_mech.bound_displacement_cell() @ u
            + discr_mech.bound_displacement_face() @ bc
            + discr_poromech.bound_pressure(self.darcy_keyword) @ p
        )
        return np.asarray(self.equation_system.evaluate(u_faces_ad))
