"""Central constants and data-dictionary keys.

Mirrors the data-dict schema of the reference framework
(``/root/reference/src/porepy/utils/common_constants.py:23-116``): the keys
below index the per-grid data dictionaries carried by the mixed-dimensional
grid. The TPU build keeps the same schema so that user-facing model code is
portable, but discretization "matrices" stored under these keys are static
index-map/COO pytrees rather than scipy matrices.
"""

# Keys into the per-grid data dictionaries -------------------------------

PARAMETERS = "parameters"
"""Key for physical parameter dictionaries (per keyword/physics)."""

DISCRETIZATION_MATRICES = "discretization_matrices"
"""Key for storage of discretization operators (per keyword/physics)."""

TIME_STEP_SOLUTIONS = "time_step_solutions"
"""Key for storing solutions of previous time steps (ring buffer)."""

ITERATE_SOLUTIONS = "iterate_solutions"
"""Key for storing solutions of previous nonlinear iterates (ring buffer)."""

DISCRETIZATION = "discretization"
"""Key for discretization-object storage (legacy assembler schema)."""

PRIMARY_VARIABLES = "primary_variables"
"""Key for primary-variable declarations (legacy assembler schema)."""

# Unit conversions (SI base) ---------------------------------------------

NANO = 1e-9
MICRO = 1e-6
MILLI = 1e-3
CENTI = 1e-2
DECI = 1e-1
KILO = 1e3
MEGA = 1e6
GIGA = 1e9

SECOND = 1.0
MINUTE = 60.0
HOUR = 3600.0
DAY = 86400.0
YEAR = 365 * DAY

METER = 1.0
KILOGRAM = 1.0
GRAM = 1e-3
NEWTON = 1.0  # kg m / s^2 in SI base
JOULE = 1.0
WATT = 1.0
KELVIN = 1.0
MOLE = 1.0
RADIAN = 1.0
DEGREE = 3.141592653589793 / 180.0

DARCY = 9.869233e-13
MILLIDARCY = 9.869233e-16

PASCAL = 1.0
BAR = 1e5
ATMOSPHERIC_PRESSURE = 101325.0

GRAVITY_ACCELERATION = 9.80665

CELSIUS = 273.15
"""Zero degrees Celsius in Kelvin."""


def CELSIUS_to_KELVIN(celsius: float) -> float:
    return celsius + CELSIUS


def KELVIN_to_CELSIUS(kelvin: float) -> float:
    return kelvin - CELSIUS


# Reference-compatible converter names.
Celsius_to_Kelvin = CELSIUS_to_KELVIN
Kelvin_to_Celsius = KELVIN_to_CELSIUS


# Standard tag keys -------------------------------------------------------

FACE_TAG_KEYS = ("fracture_faces", "tip_faces", "domain_boundary_faces")
NODE_TAG_KEYS = ("fracture_nodes", "tip_nodes", "domain_boundary_nodes")
