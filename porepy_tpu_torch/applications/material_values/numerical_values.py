"""Numerical constants for testing (reference
``applications/material_values/numerical_values.py``)."""

extended_numerical_values_for_testing = {
    "characteristic_displacement": 0.2,
}
