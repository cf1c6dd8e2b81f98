"""Representative fluid parameter values (water at 20 C; reference
``applications/material_values/fluid_values.py``)."""

water = {
    "name": "water",
    "compressibility": 4.559e-10,  # [Pa^-1]
    "density": 998.2,  # [kg * m^-3]
    "specific_heat_capacity": 4182.0,  # [J * kg^-1 * K^-1]
    "thermal_conductivity": 0.5975,  # [W * m^-1 * K^-1]
    "thermal_expansion": 2.068e-4,  # [K^-1]
    "viscosity": 1.002e-3,  # [Pa * s]
}

extended_water_values_for_testing = {
    **water,
    "normal_thermal_conductivity": 0.5975,
}
