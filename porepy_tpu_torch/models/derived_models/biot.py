"""Classical Biot consolidation model (reference
``models/derived_models/biot.py``): poromechanics with incompressible
fluid and specific-storage-based porosity, recovering the textbook Biot
system."""

from __future__ import annotations

from porepy_tpu_torch.models import constitutive_laws
from porepy_tpu_torch.models.poromechanics import (
    Poromechanics,
    SolutionStrategyPoromechanics,
)

__all__ = ["BiotPoromechanics", "SolutionStrategyBiot"]


class SolutionStrategyBiot(SolutionStrategyPoromechanics):
    def set_materials(self):
        super().set_materials()
        if self._fluid_component.compressibility != 0:
            raise ValueError(
                "The Biot model requires an incompressible fluid"
            )


class BiotPoromechanics(
    constitutive_laws.BiotPoroMechanicsPorosity,
    SolutionStrategyBiot,
    Poromechanics,
):
    """Biot consolidation equations. SpecificStorage is inherited through
    the Poromechanics constitutive-law stack."""
