"""Host arrays into tensors, for handing state between packages.

:func:`tensors_from_numpy` converts a nested structure of dicts, lists and
tuples holding array-likes (numpy arrays, or anything ``np.asarray``
accepts) into the same structure of tensors on one device. Dtypes are kept:
float32 stays float32, int32 stays int32. This is how the tests feed state
computed elsewhere (a global vector, env tuples, Jacobian nonzeros, a
frozen preconditioner state) to the port, so that both sides compute from
identical inputs. :func:`structured_flow_kernel_from` and
:func:`tpfa_flow_kernel_from` carry the flow-step kernels of
``porepy_tpu.parallel`` (any object with the same array attributes) into
the port's dataclasses. Every function puts its tensors on the CUDA card
unless the caller names another device (``"cpu"`` for the host).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from porepy_tpu_torch.utils import device_policy

__all__ = ["tensors_from_numpy", "structured_flow_kernel_from", "tpfa_flow_kernel_from"]


def tensors_from_numpy(tree: Any, device: Union[str, torch.device, None] = None) -> Any:
    """``tree`` with every array leaf (anything with ``__array__``, numpy
    scalars included) replaced by a tensor copy on ``device`` (default: the
    CUDA card; pass ``"cpu"`` for the host). Dicts, lists and tuples are
    rebuilt with the same keys and order; other leaves (``None``, strings,
    Python numbers) pass through unchanged."""
    return _tensors(tree, device_policy.resolve(device))


def _tensors(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tensors(v, device) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if hasattr(tree, "__array__"):
        return torch.tensor(np.asarray(tree), device=device)
    return tree


_STRUCTURED_FIELDS = (
    "tx", "ty", "tz", "pbc_x", "pbc_y", "pbc_z", "pv",
    "rho_ref", "comp", "visc", "p_ref", "dt",
)
_TPFA_FIELDS = (
    "lo", "hi", "t", "is_neu", "bc_val", "pv", "rho_ref", "comp", "visc", "p_ref", "dt",
)


def structured_flow_kernel_from(kernel: Any, device: Union[str, torch.device, None] = None):
    """The port's :class:`~porepy_tpu_torch.parallel.structured_flow.StructuredFlowKernel`
    holding copies of ``kernel``'s arrays (a ``porepy_tpu``
    ``StructuredFlowKernel``, or anything with its attributes) on
    ``device`` (default: the CUDA card), dtypes kept."""
    from porepy_tpu_torch.parallel.structured_flow import StructuredFlowKernel

    device = device_policy.resolve(device)
    fields = {f: _tensors(np.asarray(getattr(kernel, f)), device) for f in _STRUCTURED_FIELDS}
    return StructuredFlowKernel(**fields, shape=tuple(kernel.shape))


def tpfa_flow_kernel_from(kernel: Any, device: Union[str, torch.device, None] = None):
    """The port's :class:`~porepy_tpu_torch.parallel.flow_step.TpfaFlowKernel`
    from ``kernel``'s arrays (a ``porepy_tpu`` ``TpfaFlowKernel``, or
    anything with its attributes), with the port's cell-to-face CSR built
    from ``lo``/``hi``, on ``device`` (default: the CUDA card)."""
    from porepy_tpu_torch.parallel.flow_step import TpfaFlowKernel

    fields = {f: np.asarray(getattr(kernel, f)) for f in _TPFA_FIELDS}
    return TpfaFlowKernel.from_numpy(**fields, device=device_policy.resolve(device))
