"""Coupled thermoporomechanics (THM).

Parity counterpart of reference ``models/thermoporomechanics.py``: energy,
fluid mass and momentum balance with frictional fracture contact, coupled
through pressure and temperature stresses, thermo-poromechanical porosity
and the jump-dependent aperture.
"""

from __future__ import annotations

from typing import Optional, Sequence

from porepy_tpu_torch.models import constitutive_laws as laws
from porepy_tpu_torch.models import contact_mechanics as contact
from porepy_tpu_torch.models import energy_balance as energy
from porepy_tpu_torch.models import fluid_mass_balance as mass
from porepy_tpu_torch.models import momentum_balance as momentum
from porepy_tpu_torch.models.geometry import ModelGeometry
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin

__all__ = ["Thermoporomechanics"]


class ConstitutiveLawsThermoporomechanics(
    # Combined effects
    laws.DisplacementJumpAperture,
    laws.BiotCoefficient,
    laws.SpecificStorage,
    laws.ThermalExpansion,
    laws.ThermoPressureStress,
    laws.ThermoPoroMechanicsPorosity,
    laws.FluidDensityFromPressureAndTemperature,
    # Energy subproblem
    laws.SecondOrderTensorUtils,
    laws.EnthalpyFromTemperature,
    laws.FouriersLaw,
    laws.ThermalConductivityLTE,
    # Flow subproblem
    laws.ZeroGravityForce,
    laws.DarcysLaw,
    laws.DimensionReduction,
    laws.AdvectiveFlux,
    laws.FluidMobility,
    laws.ConstantPermeability,
    laws.ConstantViscosity,
    # Mechanical subproblem
    laws.ElasticModuli,
    laws.CharacteristicTractionFromDisplacement,
    laws.ElasticTangentialFractureDeformation,
    laws.LinearElasticMechanicalStress,
    laws.ConstantSolidDensity,
    laws.FractureGap,
    laws.CoulombFrictionBound,
    laws.DisplacementJump,
):
    """Reference ``thermoporomechanics.py:29``."""

    def stress(self, subdomains: Sequence) -> ad.Operator:
        traction = (
            self.mechanical_stress(subdomains)
            + self.pressure_stress(subdomains)
            + self.thermal_stress(subdomains)
        )
        traction.set_name("thermo_poro_mechanical_stress")
        return traction


class EquationsThermoporomechanics(
    energy.TotalEnergyBalanceEquations,
    mass.FluidMassBalanceEquations,
    momentum.MomentumBalanceEquations,
    contact.ContactMechanicsEquations,
):
    def set_equations(self) -> None:
        super().set_equations()

    def body_force(self, subdomains: Sequence) -> ad.Operator:
        return self.volume_integral(
            self.gravity_force(subdomains, "bulk"), subdomains, dim=self.nd
        )


class VariablesThermoporomechanics(
    energy.VariablesEnergyBalance,
    mass.VariablesSinglePhaseFlow,
    momentum.VariablesMomentumBalance,
    contact.ContactTractionVariable,
):
    def create_variables(self) -> None:
        super().create_variables()


class BoundaryConditionsThermoporomechanics(
    energy.BoundaryConditionsEnergyBalance,
    mass.BoundaryConditionsSinglePhaseFlow,
    momentum.BoundaryConditionsMomentumBalance,
):
    pass


class InitialConditionsThermoporomechanics(
    energy.InitialConditionsEnergy,
    mass.InitialConditionsSinglePhaseFlow,
    momentum.InitialConditionsMomentumBalance,
    contact.InitialConditionsContactTraction,
):
    pass


class SolutionStrategyThermoporomechanics(
    energy.SolutionStrategyEnergyBalance,
    mass.SolutionStrategySinglePhaseFlow,
    momentum.SolutionStrategyMomentumBalance,
    contact.SolutionStrategyContactMechanics,
):
    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)

    def update_discretization_parameters(self) -> None:
        """Swap the stress discretization to Biot with both the Darcy and
        the enthalpy scalar couplings (reference
        ``thermoporomechanics.py:167``)."""
        from porepy_tpu_torch.numerics.fv.biot import Biot
        from porepy_tpu_torch.numerics.fv.mpsa import Mpsa

        super().update_discretization_parameters()
        self._discretizations = [
            entry
            for entry in self._discretizations
            if not isinstance(entry[0], Mpsa)
        ]
        for sd, data in self.mdg.subdomains(dim=self.nd, return_data=True):
            params = data["parameters"][self.stress_keyword]
            svm = params.get("scalar_vector_mappings", {})
            svm[self.enthalpy_keyword] = self.solid_thermal_expansion_tensor(
                [sd]
            )
            svm[self.darcy_keyword] = self.biot_tensor([sd])
            params["scalar_vector_mappings"] = svm
            self._register_discretization(Biot(self.stress_keyword), sd, data)

    def set_nonlinear_discretizations(self) -> None:
        """Darcy and Fourier fluxes on sub-dimensional grids depend on the
        aperture (displacement jump): re-discretize them every iteration."""
        super().set_nonlinear_discretizations()
        if self.mdg.dim_min() < self.nd:
            self.add_nonlinear_discretization(self.darcy_keyword)
            self.add_nonlinear_discretization(self.fourier_keyword)

    def _is_nonlinear_problem(self) -> bool:
        return True


class Thermoporomechanics(
    SolutionStrategyThermoporomechanics,
    EquationsThermoporomechanics,
    VariablesThermoporomechanics,
    BoundaryConditionsThermoporomechanics,
    InitialConditionsThermoporomechanics,
    ConstitutiveLawsThermoporomechanics,
    ModelGeometry,
    DataSavingMixin,
):
    """Coupled energy, fluid mass and momentum balance with fracture
    contact (reference ``thermoporomechanics.py:225``)."""
