"""Frictional fracture contact mechanics.

Parity counterpart of reference ``models/contact_mechanics.py``: the
semismooth complementarity formulation of Berge et al. (2020) — normal
non-penetration and tangential Coulomb friction conditions expressed with
``maximum`` / characteristic functions on nondimensionalized contact
tractions, solvable by (semismooth) Newton.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np

from porepy_tpu_torch.compositional.compositional_mixins import FluidMixin
from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models.abstract_equations import BalanceEquation, VariableMixin
from porepy_tpu_torch.models.boundary_condition import BoundaryConditionMixin
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.models.initial_condition import InitialConditionMixin
from porepy_tpu_torch.models.solution_strategy import SolutionStrategy
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad.forward import elementwise
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = [
    "ContactMechanicsEquations",
    "ContactTractionVariable",
    "InitialConditionsContactTraction",
    "SolutionStrategyContactMechanics",
    "ConstitutiveLawsContactMechanics",
]


class ContactMechanicsEquations(BalanceEquation):
    """Reference ``contact_mechanics.py:20``."""

    def set_equations(self) -> None:
        super().set_equations()
        fracture_subdomains = self.mdg.subdomains(dim=self.nd - 1)
        if not fracture_subdomains:
            return
        self.equation_system.set_equation(
            self.normal_fracture_deformation_equation(fracture_subdomains),
            fracture_subdomains,
            {"cells": 1},
        )
        self.equation_system.set_equation(
            self.tangential_fracture_deformation_equation(fracture_subdomains),
            fracture_subdomains,
            {"cells": self.nd - 1},
        )

    def normal_fracture_deformation_equation(
        self, subdomains: Sequence
    ) -> ad.Operator:
        nd_vec_to_normal = self.normal_component(subdomains)
        t_n = nd_vec_to_normal @ self.contact_traction(subdomains)
        u_n = nd_vec_to_normal @ self.displacement_jump(subdomains)

        num_cells = sum(sd.num_cells for sd in subdomains)
        zeros_frac = ad.DenseArray(np.zeros(num_cells), "zeros_frac")
        equation = t_n + ad.maximum(
            ad.Scalar(-1.0) * t_n
            - self.contact_mechanics_numerical_constant(subdomains)
            * (u_n - self.fracture_gap(subdomains)),
            zeros_frac,
        )
        equation.set_name("normal_fracture_deformation_equation")
        return equation

    def tangential_fracture_deformation_equation(
        self, subdomains: Sequence
    ) -> ad.Operator:
        num_cells = sum(sd.num_cells for sd in subdomains)
        nd_vec_to_tangential = self.tangential_component(subdomains)
        tangential_basis = self.basis(subdomains, dim=self.nd - 1)
        scalar_to_tangential = ad.sum_projection_list(tangential_basis)

        t_t = nd_vec_to_tangential @ self.contact_traction(subdomains)
        u_t = nd_vec_to_tangential @ self.plastic_displacement_jump(subdomains)
        u_t_increment = ad.time_increment(u_t)

        ones_frac = ad.DenseArray(np.ones(num_cells * (self.nd - 1)))
        zeros_frac = ad.DenseArray(np.zeros(num_cells))

        c_num = self.contact_mechanics_numerical_constant(subdomains)
        tangential_sum = t_t + (scalar_to_tangential @ c_num) * u_t_increment

        norm_tangential_sum = ad.l2_norm(self.nd - 1, tangential_sum)
        norm_tangential_sum.set_name("norm_tangential")

        b_p = ad.maximum(self.friction_bound(subdomains), zeros_frac)
        b_p.set_name("bp")

        bp_tang = (scalar_to_tangential @ b_p) * tangential_sum
        maxbp_abs = scalar_to_tangential @ ad.maximum(b_p, norm_tangential_sum)

        characteristic = self.contact_mechanics_open_state_characteristic(
            subdomains
        )
        equation = (ones_frac - characteristic) * (
            bp_tang - maxbp_abs * t_t
        ) + characteristic * t_t
        equation.set_name("tangential_fracture_deformation_equation")
        return equation


class ContactTractionVariable(VariableMixin):
    def create_variables(self) -> None:
        super().create_variables()
        fracture_subdomains = self.mdg.subdomains(dim=self.nd - 1)
        if fracture_subdomains:
            self.equation_system.create_variables(
                self.contact_traction_variable,
                dof_info={"cells": self.nd},
                subdomains=fracture_subdomains,
                tags={"si_units": "-"},
            )

    def contact_traction(self, subdomains: Sequence) -> ad.Operator:
        for sd in subdomains:
            if sd.dim != self.nd - 1:
                raise ValueError("Contact traction only defined on fractures")
        return self.equation_system.md_variable(
            self.contact_traction_variable, subdomains
        )


class InitialConditionsContactTraction(InitialConditionMixin):
    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains(dim=self.nd - 1):
            self.equation_system.set_variable_values(
                self.ic_values_contact_traction(sd),
                [self.equation_system.md_variable(
                    self.contact_traction_variable, [sd]
                )],
                iterate_index=0,
            )

    def ic_values_contact_traction(self, sd) -> np.ndarray:
        traction_vals = np.zeros((self.nd, sd.num_cells))
        traction_vals[-1] = -1.0
        return traction_vals.ravel("F")


class ConstitutiveLawsContactMechanics(
    constitutive_laws.FractureGap,
    constitutive_laws.CoulombFrictionBound,
    constitutive_laws.DisplacementJump,
    constitutive_laws.DimensionReduction,
    constitutive_laws.CharacteristicTractionFromDisplacement,
    constitutive_laws.ElasticTangentialFractureDeformation,
    constitutive_laws.ElasticModuli,
):
    """Reference ``contact_mechanics.py:246``."""


class SolutionStrategyContactMechanics(SolutionStrategy):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.contact_traction_variable: str = "contact_traction"

    def contact_mechanics_numerical_constant(
        self, subdomains: Sequence
    ) -> ad.Operator:
        constant = ad.Scalar(1.0) / self.characteristic_displacement(subdomains)
        constant.set_name("contact_mechanics_numerical_constant")
        return constant

    def contact_mechanics_open_state_characteristic(
        self, subdomains: Sequence
    ) -> ad.Operator:
        tol = self.numerical.open_state_tolerance
        f_characteristic = ad.Function(
            partial(_characteristic, tol),
            "characteristic_function_for_zero_normal_traction",
            dual_rule=elementwise(lambda E, x: E.op("leabs", x, E.imm(tol))),
        )
        num_cells = sum(sd.num_cells for sd in subdomains)
        zeros_frac = ad.DenseArray(np.zeros(num_cells))
        b_p = ad.maximum(self.friction_bound(subdomains), zeros_frac)
        b_p.set_name("bp")
        tangential_basis = self.basis(subdomains, dim=self.nd - 1)
        scalar_to_tangential = ad.sum_projection_list(tangential_basis)
        characteristic = scalar_to_tangential @ f_characteristic(b_p)
        characteristic.set_name("characteristic_function_of_b_p")
        return characteristic

    def _is_nonlinear_problem(self) -> bool:
        return self.mdg.dim_min() < self.nd or super()._is_nonlinear_problem()


def _characteristic(tol, x):
    """1 where ``|x| <= tol`` (the tie included), else 0, with no
    derivative: the selection is taken on the detached value."""
    import torch

    x = x.detach()
    return torch.where(torch.abs(x) <= tol, torch.ones_like(x), torch.zeros_like(x))


class InterfaceDisplacementArray:
    """Interface displacement as a PARAMETER (time-dependent dense array),
    not a primary variable — for running contact mechanics standalone with
    prescribed interface movement (reference ``contact_mechanics.py:258``)."""

    interface_displacement_parameter_key: str = "interface_displacement"

    def interface_displacement(self, interfaces: Sequence) -> ad.Operator:
        return ad.TimeDependentDenseArray(
            self.interface_displacement_parameter_key, interfaces
        )

    def interface_displacement_parameter_values(self, interface) -> np.ndarray:
        """Values per interface, shape ``(nd, num_cells)``; override to
        drive the fracture walls."""
        return np.zeros((self.nd, interface.num_cells))

    def update_time_dependent_ad_arrays(self) -> None:
        super().update_time_dependent_ad_arrays()
        self.update_interface_displacement_parameter()

    def update_interface_displacement_parameter(self) -> None:
        from porepy_tpu_torch.utils import common_constants as cc
        from porepy_tpu_torch.utils.solution_storage import (
            get_solution_values,
            set_solution_values,
            shift_solution_values,
        )

        name = self.interface_displacement_parameter_key
        for intf, data in self.mdg.interfaces(return_data=True):
            if intf.dim != self.nd - 1:
                continue
            if cc.ITERATE_SOLUTIONS in data and name in data[cc.ITERATE_SOLUTIONS]:
                vals = get_solution_values(name, data, iterate_index=0)
            else:
                vals = self.interface_displacement_parameter_values(
                    intf
                ).ravel("F")
            shift_solution_values(
                name,
                data,
                cc.TIME_STEP_SOLUTIONS,
                max_index=len(self.time_step_indices),
            )
            set_solution_values(name, vals, data, time_step_index=0)
            vals_new = self.interface_displacement_parameter_values(
                intf
            ).ravel("F")
            set_solution_values(name, vals_new, data, iterate_index=0)


class BoundaryConditionsContactMechanics(BoundaryConditionMixin):
    """No boundary values in pure contact mechanics; present for the model
    contract (reference ``contact_mechanics.py:442``)."""


class ContactMechanics(
    ContactMechanicsEquations,
    InterfaceDisplacementArray,
    ConstitutiveLawsContactMechanics,
    constitutive_laws.ElasticModuli,
    ContactTractionVariable,
    InitialConditionsContactTraction,
    BoundaryConditionsContactMechanics,
    SolutionStrategyContactMechanics,
    FluidMixin,
    ModelGeometry,
    DataSavingMixin,
):
    """Standalone contact mechanics: fracture deformation driven by a
    prescribed interface displacement parameter (reference
    ``contact_mechanics.py:577``). Primarily intended as mixin stock for
    the momentum balance model; usable alone for contact-state studies."""
