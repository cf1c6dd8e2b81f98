"""Fracture damage mechanics: history-dependent friction and dilation.

Parity counterpart of reference ``models/fracture_damage.py``: a damage
history variable ``h`` on fractures integrates the (tangential) plastic
slip over the simulation history (J. White 2014,
https://doi.org/10.1002/nag.2247); the damage laws
(:class:`~porepy_tpu.models.constitutive_laws.FrictionDamage` /
``DilationDamage``) turn ``h`` into evolving friction bounds and
dilation gaps.

Since the history equation sums increments over *all* previous time
steps, the slip-defining variables are kept at every time step (the
solution strategy's ``variables_stored_all_time_steps`` hook) and the
history equation is rebuilt at the start of each Newton loop to include
the newly completed increment.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad import functions as ad_fn
from porepy_tpu_torch.numerics.ad.time_derivatives import time_increment

__all__ = [
    "DamageHistoryVariable",
    "DamageHistoryEquation",
    "AnisotropicHistoryEquation",
    "IsotropicHistoryEquation",
]


class DamageHistoryVariable:
    """Cell-wise damage history variable on fracture subdomains
    (reference ``fracture_damage.py:9``)."""

    damage_history_variable = "damage_history"

    def damage_history(self, subdomains: Sequence) -> ad.Operator:
        for sd in subdomains:
            if sd.dim != self.nd - 1:
                raise ValueError("Damage history only defined on fractures")
        return self.equation_system.md_variable(
            self.damage_history_variable, subdomains
        )

    def create_variables(self) -> None:
        super().create_variables()
        self.equation_system.create_variables(
            self.damage_history_variable,
            dof_info={"cells": 1},
            subdomains=self.mdg.subdomains(dim=self.nd - 1),
            tags={"si_units": "-"},
        )

    def variables_stored_all_time_steps(self) -> list:
        """The plastic jump needs traction and interface displacement at
        every past step (reference ``fracture_damage.py:107``)."""
        names = [self.contact_traction_variable]
        if self.mdg.interfaces(codim=1):
            names.append(self.interface_displacement_variable)
        return names


class DamageHistoryEquation:
    """History equation scaffold: set once, rebuilt before every Newton
    loop so the completed increment enters the sum (reference
    ``fracture_damage.py:134``)."""

    damage_history_equation_name = "damage_history_equation"

    def set_equations(self):
        super().set_equations()
        fractures = self.mdg.subdomains(dim=self.nd - 1)
        eq = self.damage_history_equation(fractures)
        eq.set_name(self.damage_history_equation_name)
        self.equation_system.set_equation(eq, fractures, {"cells": 1})

    def before_nonlinear_loop(self):
        super().before_nonlinear_loop()
        fractures = self.mdg.subdomains(dim=self.nd - 1)
        eq = self.damage_history_equation(fractures)
        eq.set_name(self.damage_history_equation_name)
        self.equation_system.update_equation(
            self.damage_history_equation_name, eq
        )

    def damage_history_equation(self, subdomains: Sequence) -> ad.Operator:
        raise NotImplementedError("Subclass must implement this method.")

    # -- shared helpers -----------------------------------------------------

    def _tangential_jump(self, subdomains: Sequence) -> ad.Operator:
        return self.tangential_component(subdomains) @ (
            self.plastic_displacement_jump(subdomains)
        )

    def _tangential_to_scalar(self, subdomains: Sequence) -> ad.SparseArray:
        basis = self.basis(subdomains, dim=self.nd - 1)
        mat = basis[0].mat.T
        for e in basis[1:]:
            mat = mat + e.mat.T
        return ad.SparseArray(sps.csr_matrix(mat), "tangential_to_scalar")

    def _increment_is_negligible(self, op: ad.Operator, subdomains) -> bool:
        tol = 1e-12 * float(
            np.max(
                np.atleast_1d(
                    np.asarray(
                        self.equation_system.evaluate(
                            self.characteristic_displacement(subdomains)
                        )
                    )
                )
            )
        )
        vals = np.asarray(self.equation_system.evaluate(op))
        return bool(np.allclose(vals, 0.0, atol=tol))


class AnisotropicHistoryEquation(DamageHistoryEquation):
    r"""``h = \int H(m_t . u_t) |m_t . du_t|``: slip reversals against the
    current slip direction do not accumulate damage (reference
    ``fracture_damage.py:183``)."""

    def damage_history_equation(self, subdomains: Sequence) -> ad.Operator:
        u_t = self._tangential_jump(subdomains)
        to_scalar = self._tangential_to_scalar(subdomains)
        m_t = self._normalized_tangential_jump(subdomains)

        heavi = partial(ad_fn.heaviside, zerovalue=1.0)
        eq = self.damage_history(subdomains) - heavi(
            to_scalar @ (m_t * u_t)
        ) * ad_fn.abs(to_scalar @ (m_t * time_increment(u_t)))

        for i in range(1, self.time_manager.time_index):
            u_t_i = u_t.previous_timestep(i)
            incr_i = u_t_i - u_t.previous_timestep(i + 1)
            if self._increment_is_negligible(incr_i, subdomains):
                continue
            eq = eq - heavi(to_scalar @ (m_t * u_t_i)) * ad_fn.abs(
                to_scalar @ (m_t * incr_i)
            )
        return eq

    def _normalized_tangential_jump(self, subdomains: Sequence) -> ad.Operator:
        u_t = self._tangential_jump(subdomains)
        basis = self.basis(subdomains, dim=self.nd - 1)
        mat = basis[0].mat
        for e in basis[1:]:
            mat = mat + e.mat
        scalar_to_tangential = ad.SparseArray(
            sps.csr_matrix(mat), "scalar_to_tangential"
        )
        zero_tol = 1e-12 * float(
            np.max(
                np.atleast_1d(
                    np.asarray(
                        self.equation_system.evaluate(
                            self.characteristic_displacement(subdomains)
                        )
                    )
                )
            )
        )
        norm = scalar_to_tangential @ ad_fn.l2_norm(self.nd - 1, u_t)
        inv_norm = ad_fn.safe_power(
            -1.0, 1.0 / np.sqrt(self.nd - 1), zero_tol, norm
        )
        return inv_norm * u_t


class IsotropicHistoryEquation(DamageHistoryEquation):
    r"""``h = \int |du_t|``: every slip increment accumulates damage
    (reference ``fracture_damage.py:317``)."""

    def damage_history_equation(self, subdomains: Sequence) -> ad.Operator:
        u_t = self._tangential_jump(subdomains)
        norm = partial(ad_fn.l2_norm, self.nd - 1)

        eq = self.damage_history(subdomains) - norm(time_increment(u_t))
        for i in range(1, self.time_manager.time_index):
            incr_i = u_t.previous_timestep(i) - u_t.previous_timestep(i + 1)
            if self._increment_is_negligible(incr_i, subdomains):
                continue
            eq = eq - norm(incr_i)
        return eq
