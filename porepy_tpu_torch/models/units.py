"""SI-based unit scaling.

Parity counterpart of reference ``models/units.py:22``: base units (m, s,
kg, K, mol, rad) with derived units (Pa, J, N, W, degree) as properties;
:meth:`Units.convert_units` scales values between SI and the user-chosen
unit system via composed unit strings (``"Pa * s"``, ``"m^2"``). All model
computations run in scaled units.
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = ["Units"]

Number = Union[int, float, np.ndarray]


class Units:
    def __init__(self, **kwargs) -> None:
        for key, value in kwargs.items():
            if not isinstance(value, (float, int)):
                raise ValueError("Unit values must be numbers")
            if key not in ("m", "s", "kg", "K", "mol", "rad"):
                raise ValueError(f"Unknown base unit {key!r}")
        self.m: float = kwargs.get("m", 1)
        # Time scaling applies to material constants through to_units();
        # TimeManager schedules are given in scaled time by the user (same
        # contract as the reference, models/units.py:22).
        self.s: float = kwargs.get("s", 1)
        self.kg: float = kwargs.get("kg", 1)
        self.K: float = kwargs.get("K", 1)
        self.mol: float = kwargs.get("mol", 1)
        self.rad: float = kwargs.get("rad", 1)

    @property
    def Pa(self) -> float:
        return self.kg / (self.m * self.s**2)

    @property
    def J(self) -> float:
        return self.kg * self.m**2 / self.s**2

    @property
    def N(self) -> float:
        return self.kg * self.m / self.s**2

    @property
    def W(self) -> float:
        return self.kg * self.m**2 / self.s**3

    @property
    def degree(self) -> float:
        return self.rad * 180 / np.pi

    def convert_units(
        self, value: Number, units: str, to_si: bool = False
    ) -> Number:
        """Scale ``value`` given in SI to the unit system (or back with
        ``to_si=True``). ``units`` is a ``*``-composed string with optional
        ``^`` powers; ``""``/``"1"``/``"-"`` mean dimensionless."""
        if isinstance(value, np.ndarray):
            value = value.copy()
        units = units.replace(" ", "")
        if units in ("", "1", "-"):
            return value
        for sub in units.split("*"):
            if "^" in sub:
                name, power = sub.split("^")
                factor = getattr(self, name) ** float(power)
            else:
                factor = getattr(self, sub)
            if to_si:
                value = value * factor
            else:
                value = value / factor
        return value
