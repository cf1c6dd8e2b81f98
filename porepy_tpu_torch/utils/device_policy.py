"""Device placement: setup on the host CPU, the hot loop on an explicit
``torch.device``.

Setup (geometry, meshing, discretization, operator tracing) is numpy/scipy
work on the host. The iteration hot loop (device assembly, the
preconditioned Krylov solve, the Newton loop and the time block) runs on
the model's device, ``params["device"]`` (default ``"cuda"``). Nothing in
the port relies on a process-wide default device: every tensor is created
with an explicit ``device`` and ``dtype``.

Unlike ``porepy_tpu``, a missing accelerator is an error, never a silent
fall back to the CPU: ask for ``"cpu"`` explicitly to run there.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["host", "accelerator", "accel_scope", "on_accelerator", "put", "resolve"]


def host() -> torch.device:
    """The host CPU device."""
    return torch.device("cpu")


def resolve(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`accelerator`.
    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    if device is None:
        return accelerator()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    return dev


def accelerator() -> torch.device:
    """The first CUDA device. Raises ``RuntimeError`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    return torch.device("cuda", torch.cuda.current_device())


def accel_scope(device: Union[str, torch.device, None] = None):
    """Context manager making ``device`` (default :func:`accelerator`) the
    default device of tensor factories inside the scope."""
    return torch.device(resolve(device))


def on_accelerator(fn):
    """Decorator form of :func:`accel_scope`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with accel_scope():
            return fn(*args, **kwargs)

    return wrapped


def put(
    x, device: Union[str, torch.device, None] = None, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """A tensor copy of host array ``x`` on ``device`` (default
    :func:`accelerator`). Float arrays default to float64. Always a copy:
    a CPU tensor never aliases a host array that may change later."""
    dev = resolve(device)
    arr = np.asarray(x)
    if dtype is None and arr.dtype.kind == "f":
        dtype = torch.float64
    return torch.tensor(arr, dtype=dtype, device=dev)
