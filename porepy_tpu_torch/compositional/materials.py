"""Material constants with unit scaling.

Parity counterpart of reference ``compositional/materials.py:50-495``:
frozen dataclass-style constant containers storing SI values, converted to
the model's :class:`~porepy_tpu.models.units.Units` on construction.
Attribute sets and defaults match the reference so material dictionaries
transfer directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Optional

from porepy_tpu_torch.models.units import Units

__all__ = [
    "Constants",
    "FluidComponent",
    "SolidConstants",
    "NumericalConstants",
    "ReferenceVariableValues",
]


@dataclass(kw_only=True, eq=False)
class Constants:
    """Base material container: fields are declared in SI; after
    construction they are converted to ``units`` and frozen."""

    SI_units: ClassVar[dict[str, str]] = {}

    name: str = ""
    units: Units = field(default_factory=Units)

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.name in ("name", "units"):
                continue
            if f.name not in type(self).SI_units:
                raise ValueError(
                    f"Constant {f.name!r} lacks an SI unit declaration in "
                    f"{type(self).__name__}.SI_units"
                )
            si = type(self).SI_units[f.name]
            object.__setattr__(
                self, f.name, self.units.convert_units(getattr(self, f.name), si)
            )
        object.__setattr__(self, "_frozen", True)

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, "_frozen", False) and name in type(self).SI_units:
            raise AttributeError(f"Material constant {name!r} is immutable")
        object.__setattr__(self, name, value)

    def to_units(self, units: Units) -> "Constants":
        """Copy with all constants re-expressed in ``units`` (from their SI
        originals)."""
        kwargs = {}
        for f in dataclasses.fields(self):
            if f.name in ("name", "units"):
                continue
            si = type(self).SI_units[f.name]
            # Convert the stored (scaled) value back to SI first.
            si_value = self.units.convert_units(getattr(self, f.name), si, to_si=True)
            kwargs[f.name] = si_value
        return type(self)(name=self.name, units=units, **kwargs)

    @property
    def constants_in_SI(self) -> dict[str, float]:
        out = {}
        for f in dataclasses.fields(self):
            if f.name in ("name", "units"):
                continue
            si = type(self).SI_units[f.name]
            out[f.name] = self.units.convert_units(getattr(self, f.name), si, to_si=True)
        return out


@dataclass(kw_only=True, eq=False)
class FluidComponent(Constants):
    """Fluid component constants (reference ``materials.py:277``)."""

    SI_units: ClassVar[dict[str, str]] = {
        "density": "kg * m^-3",
        "molar_mass": "kg * mol^-1",
        "critical_pressure": "Pa",
        "critical_temperature": "K",
        "critical_specific_volume": "m^3 * kg^-1",
        "acentric_factor": "-",
        "compressibility": "Pa^-1",
        "specific_heat_capacity": "J * kg^-1 * K^-1",
        "thermal_expansion": "K^-1",
        "viscosity": "Pa * s",
        "thermal_conductivity": "W * m^-1 * K^-1",
        "normal_thermal_conductivity": "W * m^-1 * K^-1",
    }

    acentric_factor: float = 0.0
    compressibility: float = 0.0
    critical_pressure: float = 1.0
    critical_specific_volume: float = 1.0
    critical_temperature: float = 1.0
    density: float = 1.0
    molar_mass: float = 1.0
    normal_thermal_conductivity: float = 1.0
    thermal_conductivity: float = 1.0
    thermal_expansion: float = 0.0
    specific_heat_capacity: float = 1.0
    viscosity: float = 1.0


@dataclass(kw_only=True, eq=False)
class SolidConstants(Constants):
    """Solid species constants (reference ``materials.py:340``)."""

    SI_units: ClassVar[dict[str, str]] = {
        "density": "kg * m^-3",
        "biot_coefficient": "-",
        "dilation_angle": "rad",
        "dilation_damage_decay": "-",
        "friction_damage_decay": "-",
        "initial_dilation_damage": "-",
        "initial_friction_damage": "-",
        "fracture_gap": "m",
        "fracture_normal_stiffness": "Pa * m^-1",
        "fracture_tangential_stiffness": "Pa * m^-1",
        "friction_coefficient": "-",
        "lame_lambda": "Pa",
        "maximum_elastic_fracture_opening": "m",
        "normal_permeability": "m^2",
        "permeability": "m^2",
        "porosity": "-",
        "residual_aperture": "m",
        "shear_modulus": "Pa",
        "skin_factor": "-",
        "specific_heat_capacity": "J * kg^-1 * K^-1",
        "specific_storage": "Pa^-1",
        "thermal_conductivity": "W * m^-1 * K^-1",
        "thermal_expansion": "K^-1",
        "well_radius": "m",
    }

    biot_coefficient: float = 1.0
    density: float = 1.0
    dilation_angle: float = 0.0
    dilation_damage_decay: float = 0.0
    fracture_gap: float = 0.0
    fracture_normal_stiffness: float = 1.0
    fracture_tangential_stiffness: float = -1.0
    friction_coefficient: float = 1.0
    friction_damage_decay: float = 0.0
    initial_dilation_damage: float = 1.0
    initial_friction_damage: float = 1.0
    lame_lambda: float = 1.0
    maximum_elastic_fracture_opening: float = 0.0
    normal_permeability: float = 1.0
    permeability: float = 1.0
    porosity: float = 0.1
    residual_aperture: float = 0.1
    shear_modulus: float = 1.0
    skin_factor: float = 0.0
    specific_heat_capacity: float = 1.0
    specific_storage: float = 1.0
    thermal_conductivity: float = 1.0
    thermal_expansion: float = 0.0
    well_radius: float = 0.1


@dataclass(kw_only=True, eq=False)
class NumericalConstants(Constants):
    """Numerical method parameters (reference ``materials.py:447``)."""

    SI_units: ClassVar[dict[str, str]] = {
        "characteristic_displacement": "m",
        "characteristic_contact_traction": "Pa",
        "open_state_tolerance": "-",
    }

    characteristic_contact_traction: float = 1.0
    characteristic_displacement: float = 1.0
    open_state_tolerance: float = 1e-10


@dataclass(kw_only=True)
class ReferenceVariableValues(Constants):
    """Reference values for perturbation laws (reference
    ``materials.py:472``)."""

    SI_units: ClassVar[dict[str, str]] = {
        "pressure": "Pa",
        "temperature": "K",
    }

    pressure: float = 0.0
    temperature: float = 0.0
