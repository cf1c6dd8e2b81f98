"""porepy_tpu_torch: the PyTorch/CUDA port of porepy_tpu for one NVIDIA H100.

Same model framework and the same flat ``pp.`` names as ``porepy_tpu``, for
the part ported so far: single-phase flow in fractured 2d and 3d domains
(TPFA/MPFA, mortar coupling) and poromechanics (MPSA/Biot, momentum
balance, frictional contact mechanics), tracer transport with upwinding
inside the residual and the differentiable-permeability Darcy flux
(``DarcysLawAd``), assembled and solved on a ``torch.device`` with the
hand-written kernels of :mod:`porepy_tpu_torch.kernels`, and the constant-K
and Peng-Robinson flashes::

    import porepy_tpu_torch as pp

Grid construction, meshing and discretization run on the host
(numpy/scipy; the interaction-region solves of MPFA/MPSA/Biot on the card
with ``PPT_LOCAL_SOLVE_DEVICE=1``); everything per Newton iteration runs on
``params["device"]`` (default ``"cuda"``). Importing the package imports no
jax, sets no global torch default and builds no kernel.
"""

from __future__ import annotations

__version__ = "0.1.0"

from porepy_tpu_torch.compositional.flash import ConstantKFlash, Flash  # noqa: F401
from porepy_tpu_torch.compositional.materials import (  # noqa: F401
    FluidComponent,
    SolidConstants,
)
from porepy_tpu_torch.compositional.peng_robinson import (  # noqa: F401
    PengRobinsonEoS,
    PengRobinsonFlash,
)
from porepy_tpu_torch.compositional.states import FluidState, PhaseState  # noqa: F401
from porepy_tpu_torch.fracs.fracture import LineFracture  # noqa: F401
from porepy_tpu_torch.geometry.domain import Domain  # noqa: F401
from porepy_tpu_torch.grids.structured import CartGrid  # noqa: F401
from porepy_tpu_torch.models import constitutive_laws  # noqa: F401
from porepy_tpu_torch.models.contact_mechanics import ContactMechanics  # noqa: F401
from porepy_tpu_torch.models.darcys_law_ad import (  # noqa: F401
    AdTpfaFlux,
    DarcysLawAd,
    FouriersLawAd,
)
from porepy_tpu_torch.models.fluid_mass_balance import SinglePhaseFlow  # noqa: F401
from porepy_tpu_torch.models.momentum_balance import MomentumBalance  # noqa: F401
from porepy_tpu_torch.models.poromechanics import Poromechanics  # noqa: F401
from porepy_tpu_torch.models.run_models import run_time_dependent_model  # noqa: F401
from porepy_tpu_torch.numerics import ad  # noqa: F401
from porepy_tpu_torch.numerics.fv.biot import Biot  # noqa: F401
from porepy_tpu_torch.numerics.fv.mpsa import Mpsa  # noqa: F401
from porepy_tpu_torch.numerics.time_step_control import TimeManager  # noqa: F401
from porepy_tpu_torch.params.bc import (  # noqa: F401
    BoundaryCondition,
    BoundaryConditionVectorial,
)
from porepy_tpu_torch.params.data import initialize_data  # noqa: F401
from porepy_tpu_torch.params.tensor import FourthOrderTensor  # noqa: F401
from porepy_tpu_torch.utils.common_constants import (  # noqa: F401
    DISCRETIZATION_MATRICES,
)

__all__ = [
    "constitutive_laws",
    "AdTpfaFlux",
    "DarcysLawAd",
    "FouriersLawAd",
    "SinglePhaseFlow",
    "MomentumBalance",
    "Poromechanics",
    "ContactMechanics",
    "Mpsa",
    "Biot",
    "CartGrid",
    "FourthOrderTensor",
    "BoundaryConditionVectorial",
    "initialize_data",
    "DISCRETIZATION_MATRICES",
    "LineFracture",
    "SolidConstants",
    "FluidComponent",
    "TimeManager",
    "Domain",
    "BoundaryCondition",
    "run_time_dependent_model",
    "ad",
    "Flash",
    "ConstantKFlash",
    "PengRobinsonFlash",
    "PengRobinsonEoS",
    "FluidState",
    "PhaseState",
]
