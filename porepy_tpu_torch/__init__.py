"""porepy_tpu_torch: the PyTorch/CUDA port of porepy_tpu for one NVIDIA H100.

Same model framework and the same flat ``pp.`` names as ``porepy_tpu``, for
the part ported so far: single-phase flow in fractured 2d and 3d domains
(TPFA/MPFA, mortar coupling; the Berre et al. 3d case 2 geometry of
``mdg_library`` on its native tet mesh, the Flemisch et al. 2d benchmark
cases of :mod:`porepy_tpu_torch.examples` on the native simplex mesher),
poromechanics (MPSA/Biot, momentum
balance, frictional contact mechanics), mass and energy balance and
thermoporomechanics, tracer transport with upwinding
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

from porepy_tpu_torch.applications.material_values import (  # noqa: F401
    fluid_values,
    numerical_values,
    reference_values,
    solid_values,
)
from porepy_tpu_torch.applications.md_grids import mdg_library  # noqa: F401
from porepy_tpu_torch.compositional.flash import ConstantKFlash, Flash  # noqa: F401
from porepy_tpu_torch.compositional.materials import (  # noqa: F401
    FluidComponent,
    ReferenceVariableValues,
    SolidConstants,
)
from porepy_tpu_torch.compositional.peng_robinson import (  # noqa: F401
    PengRobinsonEoS,
    PengRobinsonFlash,
)
from porepy_tpu_torch.compositional.states import FluidState, PhaseState  # noqa: F401
from porepy_tpu_torch.fracs.fracture import LineFracture  # noqa: F401
from porepy_tpu_torch.geometry.domain import Domain  # noqa: F401
from porepy_tpu_torch.geometry import geometry_property_checks  # noqa: F401
from porepy_tpu_torch.grids import match_grids  # noqa: F401
from porepy_tpu_torch.grids.structured import CartGrid  # noqa: F401
from porepy_tpu_torch.models import constitutive_laws  # noqa: F401
from porepy_tpu_torch.models.contact_mechanics import ContactMechanics  # noqa: F401
from porepy_tpu_torch.models.darcys_law_ad import (  # noqa: F401
    AdTpfaFlux,
    DarcysLawAd,
    FouriersLawAd,
)
from porepy_tpu_torch.models.fluid_mass_balance import SinglePhaseFlow  # noqa: F401
from porepy_tpu_torch.models.mass_and_energy_balance import (  # noqa: F401
    MassAndEnergyBalance,
)
from porepy_tpu_torch.models.momentum_balance import MomentumBalance  # noqa: F401
from porepy_tpu_torch.models.poromechanics import Poromechanics  # noqa: F401
from porepy_tpu_torch.models.run_models import run_time_dependent_model  # noqa: F401
from porepy_tpu_torch.models.solution_strategy import ContactIndicators  # noqa: F401
from porepy_tpu_torch.models.thermoporomechanics import (  # noqa: F401
    Thermoporomechanics,
)
from porepy_tpu_torch.numerics import ad  # noqa: F401
from porepy_tpu_torch.numerics.fv.biot import Biot  # noqa: F401
from porepy_tpu_torch.numerics.fv.mpsa import Mpsa  # noqa: F401
from porepy_tpu_torch.numerics.nonlinear.anderson_acceleration import (  # noqa: F401
    AndersonAcceleration,
)
from porepy_tpu_torch.numerics.nonlinear.line_search import (  # noqa: F401
    ConstraintLineSearch,
    LineSearchNewtonSolver,
    SplineInterpolationLineSearch,
)
from porepy_tpu_torch.numerics.time_step_control import TimeManager  # noqa: F401
from porepy_tpu_torch.params.bc import (  # noqa: F401
    BoundaryCondition,
    BoundaryConditionVectorial,
)
from porepy_tpu_torch.params.data import initialize_data  # noqa: F401
from porepy_tpu_torch.params.tensor import FourthOrderTensor  # noqa: F401
from porepy_tpu_torch.utils import grid_utils  # noqa: F401
from porepy_tpu_torch.utils.common_constants import (  # noqa: F401
    DISCRETIZATION_MATRICES,
    ITERATE_SOLUTIONS,
    PARAMETERS,
    TIME_STEP_SOLUTIONS,
)
from porepy_tpu_torch.utils.tangential_normal_projection import (  # noqa: F401
    set_local_coordinate_projections,
)
from porepy_tpu_torch.viz.exporter import Exporter  # noqa: F401

__all__ = [
    "constitutive_laws",
    "AdTpfaFlux",
    "DarcysLawAd",
    "FouriersLawAd",
    "SinglePhaseFlow",
    "MassAndEnergyBalance",
    "MomentumBalance",
    "Poromechanics",
    "Thermoporomechanics",
    "ContactMechanics",
    "Mpsa",
    "Biot",
    "CartGrid",
    "FourthOrderTensor",
    "BoundaryConditionVectorial",
    "initialize_data",
    "DISCRETIZATION_MATRICES",
    "PARAMETERS",
    "ITERATE_SOLUTIONS",
    "TIME_STEP_SOLUTIONS",
    "set_local_coordinate_projections",
    "Exporter",
    "match_grids",
    "grid_utils",
    "geometry_property_checks",
    "LineFracture",
    "SolidConstants",
    "FluidComponent",
    "ReferenceVariableValues",
    "TimeManager",
    "Domain",
    "BoundaryCondition",
    "run_time_dependent_model",
    "ad",
    "mdg_library",
    "Flash",
    "ConstantKFlash",
    "PengRobinsonFlash",
    "PengRobinsonEoS",
    "FluidState",
    "PhaseState",
    "ContactIndicators",
    "LineSearchNewtonSolver",
    "SplineInterpolationLineSearch",
    "ConstraintLineSearch",
    "AndersonAcceleration",
    "fluid_values",
    "numerical_values",
    "reference_values",
    "solid_values",
]
