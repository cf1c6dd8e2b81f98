"""porepy_tpu_torch: the PyTorch/CUDA port of porepy_tpu for one NVIDIA H100.

The same model framework and the same flat ``pp.`` namespace as
``porepy_tpu``: every public name that ``porepy_tpu`` binds is bound here to
the port's own object. Single-phase flow in fractured 2d and 3d domains
(TPFA/MPFA, mortar coupling, wells), poromechanics (MPSA/Biot, momentum
balance, frictional contact mechanics, fracture damage and conforming
fracture propagation), mass and energy balance and thermoporomechanics,
tracer transport with upwinding inside the residual and the
differentiable-permeability Darcy flux (``DarcysLawAd``) are assembled and
solved on a ``torch.device`` with the hand-written kernels of
:mod:`porepy_tpu_torch.kernels`; the constant-K and Peng-Robinson flashes
run there too. The host discretizations TPSA, mixed VEM and RT0 build their
scipy matrices as ``porepy_tpu``'s do::

    import porepy_tpu_torch as pp

Grid construction, meshing and discretization run on the host
(numpy/scipy; the interaction-region solves of MPFA/MPSA/Biot on the card
with ``PPT_LOCAL_SOLVE_DEVICE=1``); everything per Newton iteration runs on
``params["device"]`` (default ``"cuda"``). Importing the package imports no
jax, no matplotlib (the plotting functions import it when called) and no
triton, sets no global torch default and builds no kernel.
"""

from __future__ import annotations

__version__ = "0.1.0"

# -- constants & keys -----------------------------------------------------
from porepy_tpu_torch.utils.common_constants import (  # noqa: F401
    PARAMETERS,
    DISCRETIZATION_MATRICES,
    TIME_STEP_SOLUTIONS,
    ITERATE_SOLUTIONS,
    NANO,
    MICRO,
    MILLI,
    CENTI,
    DECI,
    KILO,
    MEGA,
    GIGA,
    DAY,
    HOUR,
    MINUTE,
    DARCY,
    MILLIDARCY,
    PASCAL,
    BAR,
    ATMOSPHERIC_PRESSURE,
    GRAVITY_ACCELERATION,
    CELSIUS,
    CELSIUS_to_KELVIN,
)

# -- geometry ---------------------------------------------------------------
from porepy_tpu_torch.geometry import (  # noqa: F401
    constrain_geometry,
    distances,
    half_space,
    intersections,
    map_geometry,
    point_in_polyhedron,
    sort_points,
)

# -- grids -------------------------------------------------------------------
from porepy_tpu_torch.grids.grid import Grid  # noqa: F401
from porepy_tpu_torch.grids.structured import CartGrid, TensorGrid  # noqa: F401
from porepy_tpu_torch.grids.simplex import (  # noqa: F401
    StructuredTetrahedralGrid,
    StructuredTriangleGrid,
    TetrahedralGrid,
    TriangleGrid,
)

# -- fractures -----------------------------------------------------------------
from porepy_tpu_torch.fracs.fracture import (  # noqa: F401
    LineFracture,
    PlaneFracture,
    create_elliptic_fracture,
)
from porepy_tpu_torch.fracs.fracture_network import (  # noqa: F401
    create_fracture_network,
)
from porepy_tpu_torch.fracs.fracture_network_2d import FractureNetwork2d  # noqa: F401
from porepy_tpu_torch.fracs.fracture_network_3d import FractureNetwork3d  # noqa: F401
from porepy_tpu_torch.fracs import fracture_importer  # noqa: F401
from porepy_tpu_torch.fracs.wells_3d import (  # noqa: F401
    Well,
    WellNetwork3d,
    compute_well_fracture_intersections,
    compute_well_rock_matrix_intersections,
)
from porepy_tpu_torch.grids import match_grids  # noqa: F401
from porepy_tpu_torch.grids.mdg_generation import create_mdg  # noqa: F401
from porepy_tpu_torch.grids.point_grid import PointGrid  # noqa: F401
from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid  # noqa: F401
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid  # noqa: F401

# -- parameters & materials --------------------------------------------------
from porepy_tpu_torch.params.bc import (  # noqa: F401
    BoundaryCondition,
    BoundaryConditionVectorial,
)
from porepy_tpu_torch.params.tensor import (  # noqa: F401
    SecondOrderTensor,
    FourthOrderTensor,
)
from porepy_tpu_torch.params.data import initialize_data  # noqa: F401

# -- discretizations ---------------------------------------------------------
from porepy_tpu_torch.numerics.fv.tpfa import Tpfa  # noqa: F401
from porepy_tpu_torch.numerics.fv.fv_mesh import FvMesh, BoundaryMasks  # noqa: F401

# -- AD / equation layer -----------------------------------------------------
from porepy_tpu_torch.numerics import ad  # noqa: F401
from porepy_tpu_torch.utils.solution_storage import (  # noqa: F401
    set_solution_values,
    get_solution_values,
    shift_solution_values,
)

# -- geometry / domain -------------------------------------------------------
from porepy_tpu_torch.geometry.domain import Domain, DomainSides  # noqa: F401

# -- discretizations (continued) ---------------------------------------------
from porepy_tpu_torch.numerics.fv.upwind import Upwind  # noqa: F401

# -- solvers / time stepping -------------------------------------------------
from porepy_tpu_torch.numerics.fracture_deformation import (  # noqa: F401
    propagate_fractures,
)
from porepy_tpu_torch.numerics.fracture_deformation.conforming_propagation import (  # noqa: F401
    ConformingFracturePropagation,
)
from porepy_tpu_torch.numerics import displacement_correlation  # noqa: F401
from porepy_tpu_torch.numerics.nonlinear.nonlinear_solvers import (  # noqa: F401
    NewtonSolver,
)
from porepy_tpu_torch.numerics.linear_solvers import LinearSolver  # noqa: F401
from porepy_tpu_torch.numerics.nonlinear.line_search import (  # noqa: F401
    ConstraintLineSearch,
    LineSearchNewtonSolver,
    SplineInterpolationLineSearch,
)
from porepy_tpu_torch.numerics.nonlinear.anderson_acceleration import (  # noqa: F401
    AndersonAcceleration,
)
from porepy_tpu_torch.numerics.time_step_control import TimeManager  # noqa: F401

# -- materials / units -------------------------------------------------------
from porepy_tpu_torch.models.units import Units  # noqa: F401
from porepy_tpu_torch.compositional.materials import (  # noqa: F401
    Constants,
    FluidComponent,
    SolidConstants,
    NumericalConstants,
    ReferenceVariableValues,
)
from porepy_tpu_torch.compositional._core import PhysicalState  # noqa: F401
from porepy_tpu_torch.compositional.base import (  # noqa: F401
    Component,
    Compound,
    EquationOfState,
    Fluid,
    Phase,
)
from porepy_tpu_torch.compositional.compositional_mixins import (  # noqa: F401
    CompositionalVariables,
    FluidMixin,
)
from porepy_tpu_torch.compositional.flash import (  # noqa: F401
    ConstantKFlash,
    Flash,
)
from porepy_tpu_torch.compositional.states import FluidState, PhaseState  # noqa: F401
from porepy_tpu_torch.compositional import utils as composite_utils  # noqa: F401

# -- model framework ---------------------------------------------------------
from porepy_tpu_torch.models.geometry import ModelGeometry  # noqa: F401
from porepy_tpu_torch.models.protocol import PorePyModel  # noqa: F401
from porepy_tpu_torch.models.abstract_equations import (  # noqa: F401
    BalanceEquation,
    LocalElimination,
    VariableMixin,
)
from porepy_tpu_torch.models.boundary_condition import (  # noqa: F401
    BoundaryConditionMixin,
)
from porepy_tpu_torch.models.initial_condition import (  # noqa: F401
    InitialConditionMixin,
)
from porepy_tpu_torch.models.solution_strategy import (  # noqa: F401
    ContactIndicators,
    SolutionStrategy,
)
from porepy_tpu_torch.models import constitutive_laws  # noqa: F401
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
from porepy_tpu_torch.models.thermoporomechanics import (  # noqa: F401
    Thermoporomechanics,
)
from porepy_tpu_torch.numerics.fv.biot import Biot  # noqa: F401
from porepy_tpu_torch.numerics.fv.mpfa import Mpfa  # noqa: F401
from porepy_tpu_torch.numerics.fv.mpsa import Mpsa  # noqa: F401
from porepy_tpu_torch.numerics.fv.tpsa import Tpsa  # noqa: F401
from porepy_tpu_torch.numerics.vem.mvem import MVEM  # noqa: F401
from porepy_tpu_torch.numerics.vem.hybrid import HybridDualVEM  # noqa: F401
from porepy_tpu_torch.numerics.vem.mass_matrix import (  # noqa: F401
    MixedInvMassMatrix,
    MixedMassMatrix,
)
from porepy_tpu_torch.numerics.vem.vem_source import (  # noqa: F401
    DualScalarSource,
)
from porepy_tpu_torch.numerics.fem.rt0 import RT0  # noqa: F401
from porepy_tpu_torch.models import energy_balance  # noqa: F401
from porepy_tpu_torch.models import compositional_flow  # noqa: F401
from porepy_tpu_torch.models import fracture_damage  # noqa: F401
from porepy_tpu_torch.models.compositional_flow import (  # noqa: F401
    CompositionalFlowTemplate,
    CompositionalFractionalFlowTemplate,
)
from porepy_tpu_torch.models.run_models import (  # noqa: F401
    run_stationary_model,
    run_time_dependent_model,
)
from porepy_tpu_torch.viz.data_saving_model_mixin import DataSavingMixin  # noqa: F401
from porepy_tpu_torch.viz.solver_statistics import SolverStatistics  # noqa: F401
from porepy_tpu_torch.viz.diagnostics_mixin import DiagnosticsMixin  # noqa: F401
from porepy_tpu_torch.viz.plot_grid import plot_grid, save_img  # noqa: F401

# -- reference-parity namespace breadth (modules, classes, helpers) -----------
from porepy_tpu_torch.utils.common_constants import (  # noqa: F401
    DISCRETIZATION,
    PRIMARY_VARIABLES,
    SECOND,
    YEAR,
    METER,
    KILOGRAM,
    GRAM,
    NEWTON,
    JOULE,
    WATT,
    KELVIN,
    MOLE,
    RADIAN,
    DEGREE,
    Celsius_to_Kelvin,
    Kelvin_to_Celsius,
)
from porepy_tpu_torch.utils.porepy_types import (  # noqa: F401
    DomainFunctionType,
    ExtendedDomainFunctionType,
    GridLike,
    GridLikeSequence,
    SubdomainsOrBoundaries,
    discretization_type,
    fracture_network,
    number,
)
from porepy_tpu_torch.utils import adtree  # noqa: F401
from porepy_tpu_torch.utils import array_operations  # noqa: F401
from porepy_tpu_torch.utils import grid_utils  # noqa: F401
from porepy_tpu_torch.utils import permutations  # noqa: F401
from porepy_tpu_torch.utils.interpolation_tables import (  # noqa: F401
    AdaptiveInterpolationTable,
    InterpolationTable,
)
from porepy_tpu_torch.utils.tangential_normal_projection import (  # noqa: F401
    TangentialNormalProjection,
    set_local_coordinate_projections,
    sides_of_fracture,
)
from porepy_tpu_torch.numerics.linalg import matrix_operations  # noqa: F401
from porepy_tpu_torch.numerics.ad.equation_system import EquationSystem  # noqa: F401
from porepy_tpu_torch.numerics.ad.operators import (  # noqa: F401
    wrap_as_dense_ad_array,
    wrap_as_sparse_ad_array,
)
from porepy_tpu_torch.numerics.fv.upwind import UpwindCoupling  # noqa: F401
from porepy_tpu_torch.numerics.vem.dual_elliptic import project_flux  # noqa: F401
from porepy_tpu_torch.numerics.fracture_deformation import (  # noqa: F401
    propagate_fracture,
)
from porepy_tpu_torch.params.bc import face_on_side  # noqa: F401
from porepy_tpu_torch.grids.mortar_grid import MortarGrid  # noqa: F401
from porepy_tpu_torch.grids import grid_extrusion, partition, refinement  # noqa: F401
from porepy_tpu_torch.geometry import geometry_property_checks  # noqa: F401
from porepy_tpu_torch.geometry import domain as domain  # noqa: F401
from porepy_tpu_torch.fracs import utils as frac_utils  # noqa: F401
from porepy_tpu_torch.fracs import meshing  # noqa: F401
from porepy_tpu_torch.models import (  # noqa: F401
    contact_mechanics,
    fluid_mass_balance,
    mass_and_energy_balance,
    momentum_balance,
    poromechanics,
    thermoporomechanics,
)
from porepy_tpu_torch import models  # noqa: F401
from porepy_tpu_torch.viz.exporter import Exporter  # noqa: F401
from porepy_tpu_torch.viz.fracture_visualization import (  # noqa: F401
    plot_fractures,
    plot_wells,
)
from porepy_tpu_torch import applications  # noqa: F401
from porepy_tpu_torch.applications.md_grids import (  # noqa: F401
    domains,
    fracture_sets,
    mdg_library,
    model_geometries,
)
from porepy_tpu_torch.applications.boundary_conditions import (  # noqa: F401
    model_boundary_conditions,
)
from porepy_tpu_torch.applications.material_values import (  # noqa: F401
    fluid_values,
    numerical_values,
    reference_values,
    solid_values,
)
from porepy_tpu_torch.numerics.fv.fv_elliptic import FVElliptic  # noqa: F401
from porepy_tpu_torch.models.contact_mechanics import ContactMechanics  # noqa: F401


# -- the port's own additions -------------------------------------------------
from porepy_tpu_torch.compositional.peng_robinson import (  # noqa: F401
    PengRobinsonEoS,
    PengRobinsonFlash,
)
