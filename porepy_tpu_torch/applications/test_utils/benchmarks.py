"""Verification utilities for the flow benchmark models (reference
``applications/test_utils/benchmarks.py:12``): effective tangential and
normal permeabilities as defined in Eqs. 6a/6b of Berre et al. (2021)."""

from __future__ import annotations

import numpy as np

import porepy_tpu_torch as pt
from porepy_tpu_torch.numerics import ad


class EffectivePermeability:
    """Mixin exposing the effective permeabilities the benchmark tables
    specify; mix into a flow model before solving."""

    def effective_tangential_permeability(self, subdomains) -> ad.Operator:
        """Permeability tensor (xx component) times specific volume, per
        cell of the given subdomains (Eq. 6a)."""
        values = []
        size = self.mdg.num_subdomain_cells()
        for sd in subdomains:
            d = self.mdg.subdomain_data(sd)
            val_loc = d[pt.PARAMETERS][self.darcy_keyword][
                "second_order_tensor"
            ].values[0][0]
            values.append(np.asarray(val_loc))
        return ad.wrap_as_dense_ad_array(
            np.hstack(values), size, "effective_tangential_permeability"
        )

    def effective_normal_permeability(self, interfaces) -> ad.Operator:
        """The scalar multiplying the pressure jump in the interface Darcy
        law: specific volume x normal permeability x 2/aperture (Eq. 6b)."""
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = ad.MortarProjections(
            self.mdg, subdomains, interfaces, dim=1
        )
        normal_gradient = ad.Scalar(2) * (
            projection.secondary_to_mortar_avg()
            @ self.aperture(subdomains) ** ad.Scalar(-1)
        )
        out = (
            self.specific_volume(interfaces)
            * self.normal_permeability(interfaces)
            * normal_gradient
        )
        out.set_name("effective_normal_permeability")
        return out
