from porepy_tpu_torch.numerics.fv.fv_mesh import BoundaryMasks, FvMesh  # noqa: F401
from porepy_tpu_torch.numerics.fv.tpfa import Tpfa  # noqa: F401
