"""Runnable example models (reference ``src/porepy/examples``). The port
carries tracer transport so far."""

from porepy_tpu_torch.examples.tracer_flow import TracerFlowModel  # noqa: F401
