from porepy_tpu_torch.fracs import meshing  # noqa: F401
