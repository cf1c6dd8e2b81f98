from porepy_tpu_torch.grids.grid import Grid  # noqa: F401
from porepy_tpu_torch.grids.structured import CartGrid, TensorGrid  # noqa: F401
