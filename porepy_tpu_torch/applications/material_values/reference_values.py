"""Reference variable values (reference
``applications/material_values/reference_values.py``)."""

extended_reference_values_for_testing = {
    "pressure": 101325.0,  # [Pa]
    "temperature": 293.15,  # [K]
}
