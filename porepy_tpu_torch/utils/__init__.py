from porepy_tpu_torch.utils import common_constants  # noqa: F401
