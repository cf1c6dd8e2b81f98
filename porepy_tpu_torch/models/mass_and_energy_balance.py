"""Coupled fluid mass and energy balance (reference
``models/mass_and_energy_balance.py``)."""

from __future__ import annotations

from typing import Optional

from porepy_tpu_torch.models import energy_balance as energy
from porepy_tpu_torch.models import fluid_mass_balance as mass
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = ["MassAndEnergyBalance"]


class EquationsFluidMassAndEnergy(
    energy.TotalEnergyBalanceEquations,
    mass.FluidMassBalanceEquations,
):
    def set_equations(self) -> None:
        # Cooperative chain sets both families.
        super().set_equations()


class VariablesFluidMassAndEnergy(
    energy.VariablesEnergyBalance,
    mass.VariablesSinglePhaseFlow,
):
    def create_variables(self) -> None:
        super().create_variables()


from porepy_tpu_torch.models import constitutive_laws as laws  # noqa: E402


class ConstitutiveLawFluidMassAndEnergy(
    laws.ZeroGravityForce,
    laws.FluidDensityFromPressureAndTemperature,
    laws.ConstantSolidDensity,
    laws.EnthalpyFromTemperature,
    laws.SecondOrderTensorUtils,
    laws.FouriersLaw,
    laws.ThermalConductivityLTE,
    laws.DimensionReduction,
    laws.AdvectiveFlux,
    laws.DarcysLaw,
    laws.FluidMobility,
    laws.ConstantPorosity,
    laws.ConstantPermeability,
    laws.ConstantViscosity,
):
    """Flat re-composition of the two stacks (mirrors reference
    ``mass_and_energy_balance.py:22``, which avoids the MRO conflict
    between the per-physics law orderings)."""


class BoundaryConditionsFluidMassAndEnergy(
    energy.BoundaryConditionsEnergyBalance,
    mass.BoundaryConditionsSinglePhaseFlow,
):
    pass


class InitialConditionsMassAndEnergy(
    energy.InitialConditionsEnergy,
    mass.InitialConditionsSinglePhaseFlow,
):
    pass


class SolutionStrategyFluidMassAndEnergy(
    energy.SolutionStrategyEnergyBalance,
    mass.SolutionStrategySinglePhaseFlow,
):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)


class MassAndEnergyBalance(
    EquationsFluidMassAndEnergy,
    VariablesFluidMassAndEnergy,
    ConstitutiveLawFluidMassAndEnergy,
    BoundaryConditionsFluidMassAndEnergy,
    InitialConditionsMassAndEnergy,
    SolutionStrategyFluidMassAndEnergy,
    ModelGeometry,
    DataSavingMixin,
):
    """Coupled mass and energy balance in (mixed-dimensional) porous media."""
