"""The K14 and K15 kernels as forward-differentiable, batchable functions.

The assembly differentiates the residual by its own forward-mode pass on
dual numbers (:mod:`porepy_tpu_torch.numerics.ad.forward`), which calls the
K14 and K15 operators of :mod:`porepy_tpu_torch.kernels.ops` directly. The
functions here serve the *traced* residual, which ``torch.func.vmap`` over
``torch.func.jvp`` differentiates (``compiler.colored_jvps``: the plain
version of that pass, the host checks, evaluation of single operators).
Each is a ``torch.autograd.Function`` with its own ``jvp`` and ``vmap``
rules, after the pattern of the ELL matvec and the table lookup: the value
is one kernel launch, and the whole batch of seeds reaches the tangent
kernel as one ``(B, ...)`` launch. There is no backward rule: the port, as
``porepy_tpu``, differentiates forward only.

- :func:`upwind_flux`, :func:`upwind_select`, :func:`upwind_select_pair`
  (K15): the upstream selection is taken from the flux as data, so the flux
  direction carries no tangent (the stop-gradient of ``porepy_tpu``). Primal
  fields may themselves be batched. Each call is the value rows or the
  tangent rows of one ``upwind_dual`` launch through the launcher that
  ``ops`` keeps for the geometry tensors (found by their pointers).
- :func:`tpfa_ad_flux`, :func:`tpfa_ad_trace` (K14): batched seeds at
  unbatched primals; a batched primal raises. The geometry, and with it its
  launcher, is found by the tensors' pointers (``TpfaAdGeometry.cached``).
- :func:`segment_sum_sorted` (K14): linear, so its tangent is itself.
"""

from __future__ import annotations

import torch

from porepy_tpu_torch.kernels import ops

__all__ = [
    "upwind_flux",
    "upwind_select",
    "upwind_select_pair",
    "segment_sum_sorted",
    "tpfa_ad_flux",
    "tpfa_ad_trace",
]


def _unit_rows(t):
    """``t`` with unit-strided rows (a copy only if they are not)."""
    if t is None or t.dim() == 0 or t.shape[-1] <= 1 or t.stride(-1) == 1:
        return t
    return t.contiguous()


def _batch_first(tensors, in_dims):
    """Each batched tensor with its batch axis moved to the front."""
    return [
        t if t is None or d is None else _unit_rows(t.movedim(d, 0))
        for t, d in zip(tensors, in_dims)
    ]


def _constants_unbatched(name, in_dims) -> None:
    if any(d is not None for d in in_dims):
        raise NotImplementedError(f"{name}: batched index or mask arrays are not supported")


# -- K15 --------------------------------------------------------------------------


class _UpwindFlux(torch.autograd.Function):
    """``q up(w) + dir_mask q bc + neu_coeff bc`` through the K15 kernel."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, w, bc, lo, hi, is_dir, is_neu, sgn_div):
        return ops.upwind_flux(
            _unit_rows(q), _unit_rows(w), _unit_rows(bc), lo, hi, is_dir, is_neu, sgn_div
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dq, dw, dbc, *_constants):
        q, w, bc, *geom = ctx.saved_tensors
        return _UpwindFluxTangent.apply(q, w, bc, dq, dw, dbc, *geom)

    @staticmethod
    def vmap(info, in_dims, q, w, bc, *geom):
        _constants_unbatched("upwind_flux", in_dims[3:])
        if all(d is None for d in in_dims[:3]):
            return _UpwindFlux.apply(q, w, bc, *geom), None
        q, w, bc = _batch_first((q, w, bc), in_dims[:3])
        return _UpwindFlux.apply(q, w, bc, *geom), 0


class _UpwindFluxTangent(torch.autograd.Function):
    """The tangent of :class:`_UpwindFlux` for the seeds ``(dq, dw, dbc)``
    (``None``: zero); under ``vmap`` the seeds go to the kernel as one
    ``(B, ...)`` batch."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div):
        fields = [_unit_rows(t) for t in (q, w, bc, dq, dw, dbc)]
        return ops.upwind_flux_tangent(*fields, lo, hi, is_dir, is_neu, sgn_div)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        _constants_unbatched("upwind_flux", in_dims[6:])
        if all(d is None for d in in_dims[:6]):
            return _UpwindFluxTangent.apply(*args), None
        fields = _batch_first(args[:6], in_dims[:6])
        return _UpwindFluxTangent.apply(*fields, *args[6:]), 0


class _UpwindSelect(torch.autograd.Function):
    """``up(w)`` through the K15 selection kernel; linear in ``w``, no
    tangent through ``q``."""

    generate_vmap_rule = False

    @staticmethod
    def forward(q, w, lo, hi, is_dir, is_neu):
        return ops.upwind_select(_unit_rows(q), _unit_rows(w), lo, hi, is_dir, is_neu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, _dq, dw, *_constants):
        q, w, *geom = ctx.saved_tensors
        if dw is None:
            return torch.zeros_like(q)
        return _UpwindSelect.apply(q, dw, *geom)

    @staticmethod
    def vmap(info, in_dims, q, w, *geom):
        _constants_unbatched("upwind_select", in_dims[2:])
        if in_dims[0] is None and in_dims[1] is None:
            return _UpwindSelect.apply(q, w, *geom), None
        q, w = _batch_first((q, w), in_dims[:2])
        return _UpwindSelect.apply(q, w, *geom), 0


class _UpwindSelectPair(torch.autograd.Function):
    """``a`` where ``s >= 0`` else ``b``; the tangent selects the seeds the
    same way (a missing one reads 0)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(s, a, b):
        return ops.upwind_select_pair(_unit_rows(s), _unit_rows(a), _unit_rows(b))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, _ds, da, db):
        (s,) = ctx.saved_tensors
        if da is None and db is None:
            return torch.zeros_like(s)
        return _UpwindSelectPair.apply(s, da, db)

    @staticmethod
    def vmap(info, in_dims, s, a, b):
        if all(d is None for d in in_dims):
            return _UpwindSelectPair.apply(s, a, b), None
        s, a, b = _batch_first((s, a, b), in_dims)
        return _UpwindSelectPair.apply(s, a, b), 0


def upwind_flux(q, w, bc, lo, hi, is_dir, is_neu, sgn_div):
    """The upwinded advective face flux (K15 ``upwind_flux``; see
    :func:`porepy_tpu_torch.kernels.reference.upwind_flux`)."""
    return _UpwindFlux.apply(q, w, bc, lo, hi, is_dir, is_neu, sgn_div)


def upwind_select(q, w, lo, hi, is_dir, is_neu):
    """The upstream value of the cell field ``w`` per face (K15
    ``upwind_select``)."""
    return _UpwindSelect.apply(q, w, lo, hi, is_dir, is_neu)


def upwind_select_pair(s, a, b):
    """``a`` where ``s >= 0`` else ``b``, the choice taken from ``s`` as data
    (K15 ``upwind_select``, its two-candidate form)."""
    s, a, b = torch.broadcast_tensors(s, a, b)
    return _UpwindSelectPair.apply(s, a, b)


# -- K14 --------------------------------------------------------------------------


class _SegmentSum(torch.autograd.Function):
    """Fixed-order segment sums of ``(n,)`` or ``(B, n)`` rows."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, ptr, idx, num):
        return ops.segment_sum_sorted(_unit_rows(x), ptr, idx, num)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _x, ptr, idx, num = inputs
        ctx.num = num
        ctx.has_idx = idx is not None
        ctx.save_for_forward(*((ptr, idx) if ctx.has_idx else (ptr,)))

    @staticmethod
    def jvp(ctx, dx, *_constants):
        ptr, *rest = ctx.saved_tensors
        return _SegmentSum.apply(dx, ptr, rest[0] if ctx.has_idx else None, ctx.num)

    @staticmethod
    def vmap(info, in_dims, x, ptr, idx, num):
        _constants_unbatched("segment_sum_sorted", in_dims[1:3])
        if in_dims[0] is None:
            return _SegmentSum.apply(x, ptr, idx, num), None
        xb = x.movedim(in_dims[0], 0)
        out = _SegmentSum.apply(xb.reshape(-1, xb.shape[-1]), ptr, idx, num)
        return out.reshape(xb.shape[:-1] + (num,)), 0


def segment_sum_sorted(x, ptr, idx, num: int):
    """Sums of ``x`` (last axis; any leading axes) over ``num`` segments in
    fixed order (K14 ``segment_sum_sorted``): segment ``s`` holds the items
    ``idx[ptr[s]:ptr[s + 1]]``, or that range itself when ``idx`` is ``None``."""
    if x.dim() <= 2:
        return _SegmentSum.apply(x, ptr, idx, num)
    out = _SegmentSum.apply(x.reshape(-1, x.shape[-1]), ptr, idx, num)
    return out.reshape(x.shape[:-1] + (num,))


class _TpfaAd(torch.autograd.Function):
    """The differentiable TPFA face flux (``trace=False``) or boundary
    pressure trace (``trace=True``) of one subdomain through the K14
    kernels. The geometry's arrays are arguments like the fields (in
    ``TpfaAdGeometry.TENSORS`` order), so that they reach the kernel as plain
    tensors whatever transform built them. A call finds its geometry through
    ``TpfaAdGeometry.cached`` (by the tensors' pointers and shapes), so its
    launcher checks the geometry and writes its launch table once, as the
    dual rule's calls do through the model's geometry."""

    generate_vmap_rule = False

    @staticmethod
    def forward(trace, k9, vol, p, bco, lam, *geom):
        op = ops.tpfa_ad_trace if trace else ops.tpfa_ad_flux
        fields = (t.contiguous() for t in (k9, vol, p, bco, lam))
        return op(ops.TpfaAdGeometry.cached(geom), *fields)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.trace = inputs[0]
        ctx.save_for_forward(*inputs[1:])

    @staticmethod
    def jvp(ctx, _dtrace, *tangents):
        fields, geom = ctx.saved_tensors[:5], ctx.saved_tensors[5:]
        return _TpfaAdTangent.apply(ctx.trace, *fields, *tangents[:5], *geom)

    @staticmethod
    def vmap(info, in_dims, trace, *args):
        _constants_unbatched("tpfa_ad", in_dims[6:])
        if any(d is not None for d in in_dims[1:6]):
            raise NotImplementedError(
                "tpfa_ad: batched primal fields are not supported (only batched seeds)"
            )
        return _TpfaAd.apply(trace, *args), None


class _TpfaAdTangent(torch.autograd.Function):
    """The tangent of :class:`_TpfaAd` for five seeds (``None``: zero);
    under ``vmap`` they go to the kernel as one ``(B, ...)`` batch. The
    launch also writes the value row, which is dropped."""

    generate_vmap_rule = False

    @staticmethod
    def _op(trace, primals, seeds, geom):
        op = ops.tpfa_ad_trace_tangent if trace else ops.tpfa_ad_flux_tangent
        return op(
            ops.TpfaAdGeometry.cached(geom),
            [t.contiguous() for t in primals],
            [_unit_rows(s) for s in seeds],
        )

    @staticmethod
    def forward(trace, *args):
        seeds = [None if s is None else s[None] for s in args[5:10]]
        return _TpfaAdTangent._op(trace, args[:5], seeds, args[10:])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, trace, *args):
        _constants_unbatched("tpfa_ad", in_dims[11:])
        if any(d is not None for d in in_dims[1:6]):
            raise NotImplementedError(
                "tpfa_ad: batched primal fields are not supported (only batched seeds)"
            )
        seed_dims = in_dims[6:11]
        if all(d is None for d in seed_dims):
            return _TpfaAdTangent.apply(trace, *args), None
        seeds = _batch_first(args[5:10], seed_dims)
        # A seed shared by the batch becomes rows of stride 0.
        seeds = [
            s if s is None or d is not None else s[None].expand(info.batch_size, -1)
            for s, d in zip(seeds, seed_dims)
        ]
        return _TpfaAdTangent._op(trace, args[:5], seeds, args[10:]), 0


def tpfa_ad_flux(geom: ops.TpfaAdGeometry, k9, vol, p, bco, lam):
    """The differentiable TPFA face flux of one subdomain (K14
    ``tpfa_ad_flux``; see :func:`porepy_tpu_torch.kernels.reference.tpfa_ad_flux`)."""
    return _TpfaAd.apply(False, k9, vol, p, bco, lam, *geom.tensors())


def tpfa_ad_trace(geom: ops.TpfaAdGeometry, k9, vol, p, bco, lam):
    """The boundary pressure trace of one subdomain (K14 ``tpfa_ad_trace``)."""
    return _TpfaAd.apply(True, k9, vol, p, bco, lam, *geom.tensors())
