"""AD / equation layer: operator DAG front-end compiled to jitted jax.

Accessible as ``pp.ad.*`` for parity with the reference namespace.
"""

from porepy_tpu_torch.numerics.ad.operators import (  # noqa: F401
    AdArray,
    DenseArray,
    MixedDimensionalVariable,
    Operator,
    Scalar,
    SparseArray,
    TimeDependentDenseArray,
    Variable,
    sum_operator_list,
    wrap_as_dense_ad_array,
    wrap_as_sparse_ad_array,
)
from porepy_tpu_torch.numerics.ad.equation_system import EquationSystem  # noqa: F401
from porepy_tpu_torch.numerics.ad.time_derivatives import dt, time_increment  # noqa: F401
from porepy_tpu_torch.numerics.ad.grid_operators import (  # noqa: F401
    BoundaryProjection,
    Divergence,
    MortarProjections,
    SubdomainProjections,
    Trace,
)
from porepy_tpu_torch.numerics.ad.discretizations import (  # noqa: F401
    MergedOperator,
    MpfaAd,
    MpsaAd,
    TpfaAd,
    TpsaAd,
    UpwindAd,
    UpwindCouplingAd,
)
from porepy_tpu_torch.numerics.ad.operators import concat  # noqa: F401
from porepy_tpu_torch.numerics.ad.operators import (  # noqa: F401
    sum_operator_list as sum_projection_list,
)
from porepy_tpu_torch.numerics.ad.functions import (  # noqa: F401
    abs,
    arccos,
    arccosh,
    arcsin,
    arcsinh,
    arctan,
    arctanh,
    characteristic_function,
    cos,
    cosh,
    exp,
    heaviside,
    heaviside_smooth,
    l2_norm,
    log,
    maximum,
    sign,
    sin,
    sinh,
    tan,
    tanh,
)
from porepy_tpu_torch.numerics.ad import compiler  # noqa: F401
from porepy_tpu_torch.numerics.ad.surrogate_operator import (  # noqa: F401
    SurrogateFactory,
    SurrogateOperator,
)
from porepy_tpu_torch.numerics.ad.operator_functions import (  # noqa: F401
    DiagonalJacobianFunction,
    Function,
    InterpolatedFunction,
)
