"""Fracture deformation and propagation (reference
``numerics/fracture_deformation/``)."""

from porepy_tpu_torch.numerics.fracture_deformation.propagate_fracture import (  # noqa: F401
    propagate_fractures,
)
from porepy_tpu_torch.numerics.fracture_deformation.propagation_model import (  # noqa: F401
    FracturePropagation,
)
