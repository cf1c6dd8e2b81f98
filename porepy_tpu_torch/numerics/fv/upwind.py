"""Single-point upstream weighting for advective transport.

Two faces of the same scheme:

- :class:`Upwind`: reference-parity discretization producing the matrices
  ``transport`` (upwind cell selection), ``rhs_dir`` (Dirichlet-inflow
  pickup) and ``rhs_neu`` (Neumann/interface influx pickup), keyed on a
  stored ``darcy_flux`` face field (reference ``numerics/fv/upwind.py:13``).
- :func:`upwind_apply` and friends: the in-residual path (K15). Upstream
  selection is a gather controlled by ``sign(q)`` evaluated *inside* the
  traced residual, so no per-iteration rediscretization exists at all —
  where the reference re-builds scipy matrices before every nonlinear
  iteration (``models/solution_strategy.py:988-1015``), the residual
  switches directions for free. The direction is detached so the Jacobian
  matches the reference's frozen-matrix linearization exactly. Gathers
  only: no scatter, so the result is deterministic on every device. On a
  CUDA tensor these run the K15 kernels (``kernels/csrc/upwind.cu``), on a
  CPU tensor their plain versions in :mod:`porepy_tpu_torch.kernels.reference`.
  The ``*_dual`` functions are the same operations on the
  :class:`~porepy_tpu_torch.numerics.ad.forward.Dual` values of the
  assembly's forward-mode pass: the value and the tangent rows of all color
  seeds in one ``upwind_dual`` launch a call, through a launcher made once
  per geometry, kind and device (:meth:`UpwindGeometry.launcher`; the
  interface selection's has no geometry).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch.kernels import functions as kfn
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad.forward import Dual
from porepy_tpu_torch.utils import common_constants as cc

__all__ = [
    "Upwind",
    "UpwindGeometry",
    "upwind_apply",
    "upwind_flux",
    "upwind_select_pair",
    "upwind_apply_dual",
    "upwind_flux_dual",
    "upwind_select_pair_dual",
    "upwind_interface_dual",
    "UpwindCoupling",
]


class UpwindGeometry:
    """Static index arrays for upwind selection on one or more grids
    (concatenated face/cell spaces).

    ``lo``/``hi`` are the cells behind/in front of each face (normal points
    lo -> hi); -1 where missing (boundary). ``sgn_div`` is the column sum of
    the divergence (+-1 on boundary faces). The attributes are host arrays;
    :meth:`on` gives their tensors on a device, made once per device, and
    :meth:`launcher` the K15 launchers over them.
    """

    def __init__(self, subdomains, bcs) -> None:
        lo_list, hi_list, is_dir, is_neu, sgn_div = [], [], [], [], []
        c_off = 0
        for sd, bc in zip(subdomains, bcs):
            cf = sd.cell_faces_as_dense()
            lo_list.append(np.where(cf[0] >= 0, cf[0] + c_off, -1))
            hi_list.append(np.where(cf[1] >= 0, cf[1] + c_off, -1))
            is_dir.append(np.asarray(bc.is_dir, dtype=bool))
            is_neu.append(np.asarray(bc.is_neu, dtype=bool))
            sgn_div.append(np.asarray(sd.divergence(1).sum(axis=0)).ravel())
            c_off += sd.num_cells
        self.lo = np.concatenate(lo_list or [np.zeros(0, int)]).astype(np.int64)
        self.hi = np.concatenate(hi_list or [np.zeros(0, int)]).astype(np.int64)
        self.is_dir = np.concatenate(is_dir or [np.zeros(0, bool)])
        self.is_neu = np.concatenate(is_neu or [np.zeros(0, bool)])
        self.sgn_div = np.concatenate(sgn_div or [np.zeros(0)]).astype(float)
        self.num_cells = c_off
        self._on: dict = {}
        self._launchers: dict = {}

    def on(self, device: Union[str, torch.device]) -> dict:
        """``{"lo", "hi", "is_dir", "is_neu", "sgn_div"}`` as tensors on
        ``device`` (int64, bool, float64)."""
        dev = torch.device(device)
        t = self._on.get(dev)
        if t is None:
            t = self._on[dev] = {
                name: torch.tensor(getattr(self, name), device=dev)
                for name in ("lo", "hi", "is_dir", "is_neu", "sgn_div")
            }
        return t

    def launcher(self, kind: str, device: int) -> ops.UpwindLauncher:
        """The :class:`~porepy_tpu_torch.kernels.ops.UpwindLauncher` of
        ``kind`` (``"flux"`` or ``"apply"``) over this geometry on card
        ``device`` (``-1``: the CPU, the plain version), made at the first
        call."""
        key = (kind, device)
        hit = self._launchers.get(key)
        if hit is None:
            g = self.on("cpu" if device < 0 else torch.device("cuda", device))
            hit = self._launchers[key] = ops.UpwindLauncher(
                kind, tuple(g[k] for k in ("lo", "hi", "is_dir", "is_neu", "sgn_div"))
            )
        return hit

    def structural_pattern(self) -> sps.csr_matrix:
        """Bool (faces x cells): each face may depend on both neighbors."""
        nf = self.lo.size
        rows, cols = [], []
        for arr in (self.lo, self.hi):
            mask = arr >= 0
            rows.append(np.where(mask)[0])
            cols.append(arr[mask])
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        return sps.csr_matrix(
            (np.ones(r.size, bool), (r, c)), shape=(nf, self.num_cells)
        )


def upwind_apply(geom: UpwindGeometry, q, w):
    """Upstream value of cell field ``w`` per face, directions from
    ``sign(q)`` (detached). Excluded faces (Neumann, or
    Dirichlet-inflow-from-outside) return 0 — their contribution enters
    through the boundary pickup terms, mirroring the reference's matrix
    split."""
    g = geom.on(q.device)
    return kfn.upwind_select(q, w, g["lo"], g["hi"], g["is_dir"], g["is_neu"])


def upwind_boundary_masks(geom: UpwindGeometry, q):
    """(dirichlet_inflow_mask, neumann_coeff) as in the reference's
    ``rhs_dir``/``rhs_neu`` diagonals. Plain tensor code: the residual takes
    these inside :func:`upwind_flux`."""
    g = geom.on(q.device)
    return reference.upwind_masks(
        q, g["lo"], g["hi"], g["is_dir"], g["is_neu"], g["sgn_div"]
    )


def upwind_flux(geom: UpwindGeometry, q, w, bc):
    """The upwinded advective face flux ``q up(w) + dir_mask q bc +
    neu_coeff bc`` with :func:`upwind_apply`'s ``up`` and
    :func:`upwind_boundary_masks`' masks, in one pass over the faces."""
    g = geom.on(q.device)
    nf = g["lo"].shape[0]
    bc = torch.atleast_1d(bc)
    if bc.shape[-1] != nf:
        bc = bc.expand(nf)
    return kfn.upwind_flux(
        q, w, bc, g["lo"], g["hi"], g["is_dir"], g["is_neu"], g["sgn_div"]
    )


def upwind_select_pair(s, a, b):
    """``a`` where ``s >= 0`` else ``b``, the choice taken from ``s`` as data
    (detached): the interface form of the upstream selection."""
    return kfn.upwind_select_pair(s, a, b)


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` over ``n`` elements with unit-strided rows, as the K15 kernels
    take a field: a one-element operand is broadcast."""
    if t.dim() == 0 or t.shape[-1] != n:
        t = t.reshape(t.shape[:-1] + (1,) if t.dim() else (1,)).expand(t.shape[:-1] + (n,))
    return t if n <= 1 or t.stride(-1) == 1 else t.contiguous()


def _seeds(duals, n: int):
    """The duals' tangents with unit-strided rows over ``n`` elements, or
    ``None`` when none has one."""
    if all(d.tan is None for d in duals):
        return None
    return tuple(None if d.tan is None else _rows(d.tan, n) for d in duals)


def upwind_apply_dual(geom: UpwindGeometry, q: Dual, w: Dual) -> Dual:
    """:func:`upwind_apply` on duals: the selection follows ``q``'s value
    and carries no tangent, so the tangent is the same selection of ``w``'s
    rows; one launch."""
    launcher = geom.launcher("apply", q.val.get_device())
    qv = _rows(q.val, geom.lo.size)
    seeds = None if w.tan is None else (None, w.tan, None)
    return Dual(*ops.upwind_dual(launcher, (qv, w.val, None), seeds))


def upwind_flux_dual(geom: UpwindGeometry, q: Dual, w: Dual, bc: Dual) -> Dual:
    """:func:`upwind_flux` on duals: the value and the tangent rows of all
    seeds in one launch."""
    nf = geom.lo.size
    launcher = geom.launcher("flux", q.val.get_device())
    primals = (_rows(q.val, nf), w.val, _rows(bc.val, nf))
    seeds = None
    if not (q.tan is None and w.tan is None and bc.tan is None):
        dq = None if q.tan is None else _rows(q.tan, nf)
        seeds = (dq, w.tan, None if bc.tan is None else _rows(bc.tan, nf))
    return Dual(*ops.upwind_dual(launcher, primals, seeds))


def _width(*duals: Dual) -> int:
    return max(d.val.shape[-1] if d.val.dim() else 1 for d in duals)


def upwind_select_pair_dual(s: Dual, a: Dual, b: Dual) -> Dual:
    """:func:`upwind_select_pair` on duals, one launch; the choice follows
    ``s``'s value."""
    n = _width(s, a, b)
    launcher = ops.upwind_pair_launcher("pair", s.val.get_device())
    primals = (_rows(s.val, n), _rows(a.val, n), _rows(b.val, n))
    return Dual(*ops.upwind_dual(launcher, primals, _seeds((Dual(s.val), a, b), n)))


def upwind_interface_dual(lam: Dual, a: Dual, b: Dual) -> Dual:
    """``lam * upwind_select_pair(lam, a, b)`` on duals, the interface
    advective flux, in one launch: the selection follows ``lam``'s value, and
    the product rounds as ``forward.mul``'s (``dlam sel + dsel lam``)."""
    n = _width(lam, a, b)
    launcher = ops.upwind_pair_launcher("interface", lam.val.get_device())
    primals = (_rows(lam.val, n), _rows(a.val, n), _rows(b.val, n))
    return Dual(*ops.upwind_dual(launcher, primals, _seeds((lam, a, b), n)))


class Upwind:
    """Reference-parity upwind discretization (host matrices)."""

    def __init__(self, keyword: str = "transport") -> None:
        self.keyword = keyword
        self.upwind_matrix_key = "transport"
        self.bound_transport_dir_matrix_key = "rhs_dir"
        self.bound_transport_neu_matrix_key = "rhs_neu"
        self._flux_array_key = "darcy_flux"

    @property
    def flux_array_key(self) -> str:
        return self._flux_array_key

    def ndof(self, sd) -> int:
        return sd.num_cells

    def discretize(self, sd, data: dict) -> None:
        param: dict[str, Any] = data[cc.PARAMETERS][self.keyword]
        matrices = data[cc.DISCRETIZATION_MATRICES][self.keyword]

        if sd.dim == 0:
            matrices[self.upwind_matrix_key] = sps.csr_matrix((0, 1))
            matrices[self.bound_transport_dir_matrix_key] = sps.csr_matrix((0, 0))
            matrices[self.bound_transport_neu_matrix_key] = sps.csr_matrix((0, 0))
            return

        sign_q = np.sign(param[self._flux_array_key])
        if "bc" in param:
            bc = param["bc"]
        else:
            from porepy_tpu_torch.params.bc import BoundaryCondition

            bc = BoundaryCondition(sd, sd.get_boundary_faces(), "dir")

        pos = sign_q >= 0
        cf = sd.cell_faces_as_dense()
        upstream = np.where(pos, cf[0], cf[1])

        neumann_ind = np.where(bc.is_neu)[0]
        inflow_ind = np.where(
            bc.is_dir & np.where(pos, cf[0] < 0, cf[1] < 0)
        )[0]
        drop = np.zeros(sd.num_faces, dtype=bool)
        drop[neumann_ind] = True
        drop[inflow_ind] = True
        keep = ~drop

        rows = np.arange(sd.num_faces)[keep]
        upstream_mat = sps.coo_matrix(
            (np.ones(rows.size), (rows, upstream[keep])),
            shape=(sd.num_faces, sd.num_cells),
        ).tocsr()

        num_components = param.get("num_components", 1)

        def expand(m):
            if num_components == 1:
                return m.tocsr()
            return sps.kron(m, sps.eye(num_components)).tocsr()

        matrices[self.upwind_matrix_key] = expand(upstream_mat)

        sgn_div = np.asarray(sd.divergence(dim=1).sum(axis=0)).ravel()
        matrices[self.bound_transport_neu_matrix_key] = expand(
            sps.coo_matrix(
                (sgn_div[neumann_ind], (neumann_ind, neumann_ind)),
                shape=(sd.num_faces, sd.num_faces),
            )
        )
        matrices[self.bound_transport_dir_matrix_key] = expand(
            sps.coo_matrix(
                (np.ones(inflow_ind.size), (inflow_ind, inflow_ind)),
                shape=(sd.num_faces, sd.num_faces),
            )
        )


class UpwindCoupling:
    """Interface upstream weighting keyed on the sign of a stored mortar
    flux (reference ``numerics/fv/upwind.py:377``).

    Matrix contract (stored under the keyword in the interface data dict):
    ``trace``/``inv_trace`` (primary cells <-> faces), ``upwind_primary`` /
    ``upwind_secondary`` (diagonal masks selecting the upstream side per
    mortar cell), ``flux`` (diagonal signs) and ``mortar_discr``
    (identity). The runtime upwinding in this framework happens inside the
    traced residual (``constitutive_laws.AdvectiveFlux``); these matrices
    serve API/golden parity and host-side assembly.
    """

    def __init__(self, keyword: str) -> None:
        self.keyword = keyword
        self.trace_primary_matrix_key = "trace"
        self.inv_trace_primary_matrix_key = "inv_trace"
        self.upwind_primary_matrix_key = "upwind_primary"
        self.upwind_secondary_matrix_key = "upwind_secondary"
        self.flux_matrix_key = "flux"
        self.mortar_discr_matrix_key = "mortar_discr"
        self._flux_array_key = "darcy_flux"

    @property
    def flux_array_key(self) -> str:
        return self._flux_array_key

    @flux_array_key.setter
    def flux_array_key(self, value: str) -> None:
        self._flux_array_key = value

    def ndof(self, intf) -> int:
        return intf.num_cells

    def discretize(
        self, sd_primary, sd_secondary, intf, data_primary, data_secondary,
        data_intf,
    ) -> None:
        if sd_primary.dim - sd_secondary.dim not in (1, 2):
            raise ValueError(
                "Implementation is only valid for grids one dimension apart."
            )
        matrices = data_intf[cc.DISCRETIZATION_MATRICES].setdefault(
            self.keyword, {}
        )
        lam_sign = np.sign(
            data_intf[cc.PARAMETERS][self.keyword][self._flux_array_key]
        )
        inv_trace = abs(sd_primary.divergence(dim=1))
        matrices[self.inv_trace_primary_matrix_key] = inv_trace
        matrices[self.trace_primary_matrix_key] = inv_trace.T
        take_primary = (lam_sign > 0).astype(float)
        matrices[self.upwind_primary_matrix_key] = sps.diags(take_primary)
        matrices[self.upwind_secondary_matrix_key] = sps.diags(
            1.0 - take_primary
        )
        matrices[self.flux_matrix_key] = sps.diags(lam_sign)
        matrices[self.mortar_discr_matrix_key] = sps.eye(intf.num_cells)
