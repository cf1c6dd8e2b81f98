"""Representative solid parameter values (reference
``applications/material_values/solid_values.py``)."""

granite = {
    "name": "granite",
    "biot_coefficient": 0.47,  # [-]
    "density": 2683.0,  # [kg * m^-3]
    "friction_coefficient": 0.6,  # [-]
    "lame_lambda": 7020826106,  # [Pa]
    "permeability": 5.0e-18,  # [m^2]
    "porosity": 1.3e-2,  # [-]
    "shear_modulus": 1.485472195e10,  # [Pa]
    "specific_heat_capacity": 720.7,  # [J * kg^-1 * K^-1]
    "specific_storage": 4.74e-10,  # [Pa^-1]
    "thermal_conductivity": 3.1,  # [W * m^-1 * K^-1]
    "thermal_expansion": 9.66e-6,  # [K^-1]
}

basalt = {
    "name": "basalt",
    "biot_coefficient": 0.35,  # [-]
    "density": 2950.0,  # [kg * m^-3]
    "friction_coefficient": 0.7,  # [-]
    "lame_lambda": 31.2e9,  # [Pa]
    "permeability": 1e-16,  # [m^2]
    "porosity": 0.10,  # [-]
    "shear_modulus": 31.2e9,  # [Pa]
    "specific_heat_capacity": 603.0,  # [J * kg^-1 * K^-1]
    "specific_storage": 2.5e-10,  # [Pa^-1]
    "thermal_conductivity": 1.6736,  # [W * m^-1 * K^-1]
    "thermal_expansion": 5.0e-6,  # [K^-1]
}

# Nontrivial values for testing purposes.
extended_granite_values_for_testing = {
    "fracture_normal_stiffness": 1.5e9,
    "maximum_elastic_fracture_opening": 1e-4,
    "fracture_gap": 1e-4,
    "residual_aperture": 0.01,
    "dilation_angle": 0.1,
    "normal_permeability": 5.0e-14,
}
