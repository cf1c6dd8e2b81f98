"""Momentum balance (linear elasticity).

Parity counterpart of reference ``models/momentum_balance.py``: quasi-static
force balance ``div(sigma) = -F`` discretized with MPSA, vectorial
Dirichlet/Neumann/Robin boundaries, displacement as primary variable.
Fracture contact mechanics (interface force balance + contact conditions)
activates with the contact-mechanics milestone; on unfractured domains the
model is complete.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid
from porepy_tpu_torch.models import constitutive_laws, contact_mechanics
from porepy_tpu_torch.models.abstract_equations import BalanceEquation, VariableMixin
from porepy_tpu_torch.models.boundary_condition import BoundaryConditionMixin
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.models.initial_condition import InitialConditionMixin
from porepy_tpu_torch.models.solution_strategy import SolutionStrategy
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.fv.mpsa import Mpsa
from porepy_tpu_torch.params.bc import BoundaryConditionVectorial
from porepy_tpu_torch.params.data import initialize_data
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = [
    "MomentumBalanceEquations",
    "VariablesMomentumBalance",
    "ConstitutiveLawsMomentumBalance",
    "BoundaryConditionsMomentumBalance",
    "InitialConditionsMomentumBalance",
    "SolutionStrategyMomentumBalance",
    "MomentumBalance",
]


class MomentumBalanceEquations(BalanceEquation):
    """Reference ``momentum_balance.py:38``."""

    @staticmethod
    def primary_equation_name() -> str:
        return "momentum_balance_equation"

    def set_equations(self) -> None:
        super().set_equations()
        matrix_subdomains = self.mdg.subdomains(dim=self.nd)
        eq = self.momentum_balance_equation(matrix_subdomains)
        self.equation_system.set_equation(
            eq, matrix_subdomains, {"cells": self.nd}
        )
        interfaces = self.mdg.interfaces(dim=self.nd - 1, codim=1)
        if interfaces:
            intf_eq = self.interface_force_balance_equation(interfaces)
            self.equation_system.set_equation(
                intf_eq, interfaces, {"cells": self.nd}
            )

    def momentum_balance_equation(self, subdomains: Sequence) -> ad.Operator:
        accumulation = self.inertia(subdomains)
        stress = ad.Scalar(-1.0) * self.stress(subdomains)
        body_force = self.body_force(subdomains)
        eq = self.balance_equation(
            subdomains, accumulation, stress, body_force, dim=self.nd
        )
        eq.set_name(MomentumBalanceEquations.primary_equation_name())
        return eq

    def inertia(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(0.0)

    def interface_force_balance_equation(self, interfaces: Sequence) -> ad.Operator:
        """Force balance on matrix-fracture interfaces: matrix stress projected
        to mortar equals the (area-scaled) contact traction (reference
        ``momentum_balance.py:127``)."""
        for interface in interfaces:
            if interface.dim != self.nd - 1:
                raise ValueError("Interface must be a fracture-matrix interface.")

        subdomains = self.interfaces_to_subdomains(interfaces)
        matrix_subdomains = [sd for sd in subdomains if sd.dim == self.nd]

        mortar_projection = ad.MortarProjections(
            self.mdg, subdomains, interfaces, self.nd
        )
        proj = ad.SubdomainProjections(subdomains, self.nd)

        contact_from_primary_mortar = (
            mortar_projection.primary_to_mortar_int()
            @ proj.face_prolongation(matrix_subdomains)
            @ self.internal_boundary_normal_to_outwards(
                matrix_subdomains, dim=self.nd
            )
            @ self.stress(matrix_subdomains)
        )
        traction_from_secondary = self.fracture_stress(interfaces)
        force_balance_eq: ad.Operator = contact_from_primary_mortar + (
            self.volume_integral(traction_from_secondary, interfaces, dim=self.nd)
        )
        force_balance_eq.set_name("interface_force_balance_equation")
        return force_balance_eq

    def body_force(self, subdomains: Sequence) -> ad.Operator:
        return self.volume_integral(
            self.gravity_force(subdomains, "solid"), subdomains, dim=self.nd
        )


class VariablesMomentumBalance(VariableMixin):
    def create_variables(self) -> None:
        super().create_variables()
        self.equation_system.create_variables(
            self.displacement_variable,
            dof_info={"cells": self.nd},
            subdomains=self.mdg.subdomains(dim=self.nd),
            tags={"si_units": "m"},
        )
        interfaces = self.mdg.interfaces(dim=self.nd - 1, codim=1)
        if interfaces:
            self.equation_system.create_variables(
                self.interface_displacement_variable,
                dof_info={"cells": self.nd},
                interfaces=interfaces,
                tags={"si_units": "m"},
            )

    def displacement(self, domains: Sequence) -> ad.Operator:
        if len(domains) > 0 and all(isinstance(g, BoundaryGrid) for g in domains):
            return self.create_boundary_operator(
                name=self.displacement_variable, domains=domains
            )
        if not all(getattr(g, "dim", -1) == self.nd for g in domains):
            raise ValueError(
                "Displacement is only defined on subdomains of max dimension"
            )
        return self.equation_system.md_variable(
            self.displacement_variable, domains
        )

    def interface_displacement(self, interfaces: Sequence) -> ad.Operator:
        return self.equation_system.md_variable(
            self.interface_displacement_variable, interfaces
        )


class ConstitutiveLawsMomentumBalance(
    constitutive_laws.ZeroGravityForce,
    constitutive_laws.ElasticModuli,
    constitutive_laws.LinearElasticMechanicalStress,
    constitutive_laws.ConstantSolidDensity,
):
    def stress(self, domains: Sequence) -> ad.Operator:
        return self.mechanical_stress(domains)


class BoundaryConditionsMomentumBalance(BoundaryConditionMixin):
    def bc_type_mechanics(self, sd) -> BoundaryConditionVectorial:
        boundary_faces = self.domain_boundary_sides(sd).all_bf
        bc = BoundaryConditionVectorial(sd, boundary_faces, "dir")
        bc.internal_to_dirichlet(sd)
        return bc

    def bc_values_displacement(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros((self.nd, bg.num_cells)).ravel("F")

    def bc_values_stress(self, bg: BoundaryGrid) -> np.ndarray:
        return np.zeros((self.nd, bg.num_cells)).ravel("F")

    def update_all_boundary_conditions(self) -> None:
        super().update_all_boundary_conditions()
        self.update_boundary_condition(
            self.stress_keyword, self.bc_values_stress
        )

    def update_boundary_values_primary_variables(self) -> None:
        super().update_boundary_values_primary_variables()
        self.update_boundary_condition(
            self.displacement_variable, self.bc_values_displacement
        )


class InitialConditionsMomentumBalance(InitialConditionMixin):
    def set_initial_values_primary_variables(self) -> None:
        super().set_initial_values_primary_variables()
        for sd in self.mdg.subdomains(dim=self.nd):
            self.equation_system.set_variable_values(
                self.ic_values_displacement(sd),
                [
                    self.equation_system.md_variable(
                        self.displacement_variable, [sd]
                    )
                ],
                iterate_index=0,
            )

    def ic_values_displacement(self, sd) -> np.ndarray:
        return np.zeros((self.nd, sd.num_cells)).ravel("F")


class SolutionStrategyMomentumBalance(SolutionStrategy):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.displacement_variable: str = "u"
        self.interface_displacement_variable: str = "u_interface"
        self.stress_keyword: str = "mechanics"

    def update_discretization_parameters(self) -> None:
        super().update_discretization_parameters()
        if not hasattr(self, "_discretizations"):
            self._discretizations = []
        for sd, data in self.mdg.subdomains(return_data=True):
            if sd.dim == self.nd:
                initialize_data(
                    data,
                    self.stress_keyword,
                    {
                        "bc": self.bc_type_mechanics(sd),
                        "fourth_order_tensor": self.stiffness_tensor(sd),
                    },
                )
                self._register_discretization(
                    Mpsa(self.stress_keyword), sd, data
                )

    def _is_nonlinear_problem(self) -> bool:
        return self.mdg.dim_min() < self.nd


class MomentumBalance(
    contact_mechanics.ContactMechanicsEquations,
    MomentumBalanceEquations,
    contact_mechanics.ContactTractionVariable,
    VariablesMomentumBalance,
    contact_mechanics.ConstitutiveLawsContactMechanics,
    ConstitutiveLawsMomentumBalance,
    BoundaryConditionsMomentumBalance,
    contact_mechanics.InitialConditionsContactTraction,
    InitialConditionsMomentumBalance,
    contact_mechanics.SolutionStrategyContactMechanics,
    SolutionStrategyMomentumBalance,
    ModelGeometry,
    DataSavingMixin,
):
    """Mixed-dimensional quasi-static momentum balance with fracture contact
    mechanics (reference ``momentum_balance.py:975``)."""
