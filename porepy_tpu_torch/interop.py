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
the port's dataclasses. :func:`set_model_state` writes variable values by
name (as ``get_model_state`` of either package reads them) into a model, and
:func:`tpfa_ad_geometry_from` carries the arrays of a ``porepy_tpu``
differentiable-TPFA geometry into the K14 kernels' geometry, so that both
packages evaluate the same flux from the same inputs. Every function puts
its tensors on the CUDA card unless the caller names another device
(``"cpu"`` for the host).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from porepy_tpu_torch.utils import device_policy

__all__ = [
    "tensors_from_numpy",
    "structured_flow_kernel_from",
    "tpfa_flow_kernel_from",
    "get_model_state",
    "set_model_state",
    "tpfa_ad_geometry_from",
]


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


def get_model_state(model: Any, time_step_index=None, iterate_index=0) -> dict:
    """The model's variable values by variable name, as numpy arrays
    (each the concatenation over the variable's grids, in the equation
    system's order). Works on a model of either package."""
    es = model.equation_system
    names = sorted({v.name for v in es.variables})
    kwargs = (
        {"time_step_index": time_step_index}
        if time_step_index is not None
        else {"iterate_index": iterate_index}
    )
    return {n: np.asarray(es.get_variable_values([n], **kwargs)) for n in names}


def set_model_state(model: Any, state: dict, time_step_index=None, iterate_index=0) -> None:
    """Write ``state`` (variable name to values, as :func:`get_model_state`
    gives them, from a model of either package on the same grids) into
    ``model``'s equation system."""
    es = model.equation_system
    kwargs = (
        {"time_step_index": time_step_index}
        if time_step_index is not None
        else {"iterate_index": iterate_index}
    )
    for name, values in state.items():
        es.set_variable_values(np.asarray(values, dtype=float), [name], **kwargs)


def tpfa_ad_geometry_from(geometry: Any, device: Union[str, torch.device, None] = None) -> list:
    """One :class:`~porepy_tpu_torch.kernels.TpfaAdGeometry` per subdomain
    from a differentiable-TPFA geometry of ``porepy_tpu`` (anything with
    ``meshes`` holding ``fi``, ``ci``, ``sgn``, ``face_normals``,
    ``face_centers``, ``cell_centers``, ``num_faces`` and ``masks`` holding
    ``is_dir``, ``is_neu``, ``is_dir_raw``, ``is_neu_raw``), on ``device``
    (default: the CUDA card)."""
    from porepy_tpu_torch.kernels import TpfaAdGeometry

    dev = device_policy.resolve(device)
    out = []
    for mesh, bnd in zip(geometry.meshes, geometry.masks):
        fi = np.asarray(mesh.fi).astype(np.int64)
        ci = np.asarray(mesh.ci).astype(np.int64)
        sgn = np.asarray(mesh.sgn, dtype=float)
        face_ptr = np.concatenate([[0], np.cumsum(np.bincount(fi, minlength=int(mesh.num_faces)))])
        arrays = {
            "face_ptr": face_ptr.astype(np.int32),
            "face_hf": np.argsort(fi, kind="stable").astype(np.int32),
            "ci": ci.astype(np.int32),
            "sgn": sgn,
            "nrm": np.asarray(mesh.face_normals, dtype=float)[:, fi] * sgn,
            "dvec": np.asarray(mesh.face_centers, dtype=float)[:, fi]
            - np.asarray(mesh.cell_centers, dtype=float)[:, ci],
        }
        for name in ("is_dir", "is_neu", "is_dir_raw", "is_neu_raw"):
            arrays[name] = np.asarray(getattr(bnd, name), dtype=bool)
        out.append(TpfaAdGeometry(**_tensors(arrays, dev)))
    return out
