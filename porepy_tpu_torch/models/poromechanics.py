"""Coupled poromechanics (Biot).

Parity counterpart of reference ``models/poromechanics.py``: mass balance
and momentum balance coupled through the constitutive laws — the stress
gains the pore-pressure term ``alpha p I`` and the porosity gains
``alpha div(u)`` plus the MPSA consistency stabilization. Fracture contact
coupling arrives with the contact-mechanics milestone; unfractured domains
are complete.
"""

from __future__ import annotations

from typing import Optional, Sequence

from porepy_tpu_torch.models import constitutive_laws as laws
from porepy_tpu_torch.models import contact_mechanics as contact
from porepy_tpu_torch.models import fluid_mass_balance as mass
from porepy_tpu_torch.models import momentum_balance as momentum
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.fv.biot import Biot
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = ["Poromechanics"]


class ConstitutiveLawsPoromechanics(
    laws.DisplacementJumpAperture,
    laws.BiotCoefficient,
    laws.SpecificStorage,
    laws.PressureStress,
    laws.PoroMechanicsPorosity,
    laws.ZeroGravityForce,
    laws.SecondOrderTensorUtils,
    laws.DarcysLaw,
    laws.DimensionReduction,
    laws.AdvectiveFlux,
    laws.FluidMobility,
    laws.ConstantPermeability,
    laws.FluidDensityFromPressure,
    laws.ConstantViscosity,
    laws.ElasticModuli,
    laws.CharacteristicTractionFromDisplacement,
    laws.ElasticTangentialFractureDeformation,
    laws.LinearElasticMechanicalStress,
    laws.ConstantSolidDensity,
    laws.FractureGap,
    laws.CoulombFrictionBound,
    laws.DisplacementJump,
):
    def stress(self, subdomains: Sequence) -> ad.Operator:
        return self.mechanical_stress(subdomains) + self.pressure_stress(
            subdomains
        )


class EquationsPoromechanics(
    momentum.MomentumBalanceEquations,
    mass.FluidMassBalanceEquations,
    contact.ContactMechanicsEquations,
):
    def set_equations(self) -> None:
        super().set_equations()

    def body_force(self, subdomains: Sequence) -> ad.Operator:
        """Bulk (solid+fluid) gravity, reference ``poromechanics.py:77``."""
        return self.volume_integral(
            self.gravity_force(subdomains, "bulk"), subdomains, dim=self.nd
        )


class VariablesPoromechanics(
    momentum.VariablesMomentumBalance,
    mass.VariablesSinglePhaseFlow,
    contact.ContactTractionVariable,
):
    def create_variables(self) -> None:
        super().create_variables()


class BoundaryConditionsPoromechanics(
    mass.BoundaryConditionsSinglePhaseFlow,
    momentum.BoundaryConditionsMomentumBalance,
):
    pass


class InitialConditionsPoromechanics(
    mass.InitialConditionsSinglePhaseFlow,
    momentum.InitialConditionsMomentumBalance,
    contact.InitialConditionsContactTraction,
):
    pass


class SolutionStrategyPoromechanics(
    mass.SolutionStrategySinglePhaseFlow,
    momentum.SolutionStrategyMomentumBalance,
    contact.SolutionStrategyContactMechanics,
):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)

    def update_discretization_parameters(self) -> None:
        super().update_discretization_parameters()
        # Swap the plain MPSA for the Biot discretization with the Darcy
        # coupling keyword, matching the reference
        # (``poromechanics.py:233``).
        self._discretizations = [
            entry
            for entry in self._discretizations
            if entry[0].keyword != self.stress_keyword
        ]
        for sd, data in self.mdg.subdomains(dim=self.nd, return_data=True):
            params = data["parameters"][self.stress_keyword]
            svm = params.get("scalar_vector_mappings", {})
            svm[self.darcy_keyword] = self.biot_tensor([sd])
            params["scalar_vector_mappings"] = svm
            self._register_discretization(
                Biot(self.stress_keyword), sd, data
            )

    def set_nonlinear_discretizations(self) -> None:
        """Darcy flux on sub-dimensional grids depends on the aperture
        (displacement jump), so it must be re-discretized every Newton
        iteration on fractured domains (reference ``poromechanics.py:252``)."""
        super().set_nonlinear_discretizations()
        if self.mdg.dim_min() < self.nd:
            self.add_nonlinear_discretization(self.darcy_keyword)

    def _is_nonlinear_problem(self) -> bool:
        return True

    def _amg_block_stabilization(self, var_name: str):
        """Fixed-stress stabilization of the pressure block inside the
        device preconditioner: ``alpha^2 / K_dr`` times the cell volume
        (the classical fixed-stress split parameter for Biot; reference
        solves the coupled system directly, ``solution_strategy.py:830``)."""
        if var_name != self.pressure_variable:
            return super()._amg_block_stabilization(var_name)
        import numpy as np

        alpha = self.solid.biot_coefficient
        k_dr = self.solid.lame_lambda + 2.0 * self.solid.shear_modulus / self.nd
        vols = [sd.cell_volumes for sd in self.mdg.subdomains()]
        if not vols:
            return None
        return alpha**2 / k_dr * np.concatenate(vols)


class Poromechanics(
    EquationsPoromechanics,
    VariablesPoromechanics,
    ConstitutiveLawsPoromechanics,
    BoundaryConditionsPoromechanics,
    InitialConditionsPoromechanics,
    SolutionStrategyPoromechanics,
    ModelGeometry,
    DataSavingMixin,
):
    """Coupled fluid mass and momentum balance (Biot poromechanics)."""
