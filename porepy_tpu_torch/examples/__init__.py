"""Runnable example models (reference ``src/porepy/examples``). The port
carries the poroelastic verification setups (Terzaghi, Mandel), the
Flemisch et al. (2018) 2d flow benchmark cases, case 3 of the Berre et al.
(2021) 3d flow benchmark and tracer transport so far."""

from porepy_tpu_torch.examples.flow_benchmark_2d_case_1 import (  # noqa: F401
    FlowBenchmark2dCase1Model,
    solid_constants_blocking_fractures,
    solid_constants_conductive_fractures,
)
from porepy_tpu_torch.examples.flow_benchmark_2d_case_3 import (  # noqa: F401
    FlowBenchmark2dCase3aModel,
    FlowBenchmark2dCase3bModel,
)
from porepy_tpu_torch.examples.flow_benchmark_2d_case_4 import (  # noqa: F401
    FlowBenchmark2dCase4Model,
)
from porepy_tpu_torch.examples.flow_benchmark_3d_case_3 import (  # noqa: F401
    FlowBenchmark3dCase3Model,
)
from porepy_tpu_torch.examples.mandel_biot import MandelModel  # noqa: F401
from porepy_tpu_torch.examples.terzaghi_biot import TerzaghiModel  # noqa: F401
from porepy_tpu_torch.examples.tracer_flow import TracerFlowModel  # noqa: F401
