"""K15's calls (``kernels.upwind_dual``) at the shapes the card checks and
times them at, with what a check of them needs: the calls of one assembly
of a model, as its dual rules make them (:func:`assembly_calls`: md 1/128
and tracer 1/64 on the card), the parent's route on a call
(:func:`parent_dual`: a value and a tangent call of the parent's four
operators, and for the interface ``forward.mul``'s ``dual_ew`` launch) and
the parent's rules swapped into every model (:func:`parent_rules`), the
bytes a call must move (:func:`dual_bytes`), and the launch held against its
plain version, itself and another route (:func:`check_launch`).

The parent's operators are an object with ``upwind_flux``,
``upwind_flux_tangent``, ``upwind_select`` and ``upwind_select_pair`` of the
signatures they had: :mod:`porepy_tpu_torch.kernels.reference` (the
default; the plain versions), or on the card the parent's kernels that
``upwind_check.py`` builds. ``chip_smoke.py`` (phase 19), ``upwind_check.py``
and ``tests/test_torch_upwind_dual.py`` share them.
"""

from __future__ import annotations

from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import same_bits
from porepy_tpu_torch.kernels import ops, reference
from porepy_tpu_torch.numerics.ad import forward
from porepy_tpu_torch.numerics.ad.forward import Dual

#: The card's memory rate (NVIDIA's H100 SXM data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"K15 check failed: {what}")


def batch_of(call) -> int:
    return next((s.shape[0] for s in call["seeds"] or () if s is not None), 0)


def _clone(ts):
    return None if ts is None else [None if t is None else t.clone() for t in ts]


def assembly_calls(model, label: str) -> list:
    """The calls of ``kernels.upwind_dual`` in one assembly (Jacobian and
    residual, the compiled system's) of the prepared ``model`` at its
    current iterate: dicts of ``label``, ``kind``, ``launcher``, ``primals``
    and ``seeds`` (copies), in the order the assembly made them."""
    es = model.equation_system
    cs = es.compiled_system()
    calls = []
    one_call = ops.upwind_dual

    def capture(launcher, primals, seeds=None):
        calls.append({"kind": launcher.kind, "launcher": launcher, "primals": _clone(primals),
                      "seeds": _clone(seeds)})
        return one_call(launcher, primals, seeds)

    with mock.patch.object(ops, "upwind_dual", capture):
        cs.assemble(es)
    for i, c in enumerate(calls):
        c["label"] = f"{label} call {i}: {c['kind']}, n {c['primals'][0].shape[0]}, B = {batch_of(c)}"
    return calls


def launch(call, fn=None):
    """``call`` as a function of no argument through ``fn`` (of
    :func:`porepy_tpu_torch.kernels.upwind_dual`'s signature; by default
    that op)."""
    fn = fn or ops.upwind_dual
    return lambda: fn(call["launcher"], call["primals"], call["seeds"])


def parent_route(kernels=reference):
    """The parent's dual rules as a function of ``upwind_dual``'s signature
    over the parent's operators ``kernels``: the value call, then, with a
    seed, the tangent call; for the interface the selection's pair and then
    ``forward.mul`` (one ``dual_ew`` launch on the card)."""

    def dual(launcher, primals, seeds=None):
        kind, geometry = launcher.kind, launcher.geometry
        seeds = seeds or (None, None, None)
        if kind == "flux":
            q, w, bc = primals
            val = kernels.upwind_flux(q, w, bc, *geometry)
            live = any(s is not None for s in seeds)
            return val, (kernels.upwind_flux_tangent(q, w, bc, *seeds, *geometry) if live else None)
        if kind == "apply":
            q, w, _ = primals
            val = kernels.upwind_select(q, w, *geometry[:4])
            dw = seeds[1]
            return val, (None if dw is None else kernels.upwind_select(q, dw, *geometry[:4]))
        s, a, b = primals
        val = kernels.upwind_select_pair(s, a, b)
        da, db = seeds[1], seeds[2]
        tan = None if da is None and db is None else kernels.upwind_select_pair(s, da, db)
        if kind == "pair":
            return val, tan
        lam = Dual(s, seeds[0])
        batch = next((t.shape[0] for t in (lam.tan, tan) if t is not None), 0)
        return forward.mul(SimpleNamespace(batch=batch), lam, Dual(val, tan)).pair()

    return dual


def parent_dual(call, kernels=reference):
    """The parent's route (:func:`parent_route`) on one captured call."""
    return parent_route(kernels)(call["launcher"], call["primals"], call["seeds"])


@contextmanager
def parent_rules(kernels=reference):
    """Every K15 dual rule of every model takes the parent's route over
    ``kernels`` inside the block (the rules hand the same operands to
    ``upwind_dual`` as the parent's rules handed to their calls)."""
    with mock.patch.object(ops, "upwind_dual", parent_route(kernels)):
        yield


def dual_bytes(call) -> int:
    """The bytes one call must move, each input read once and each output
    written once, only what this call's data needs: per element the flux
    direction (8 B), for the flux and apply the one cell index the direction
    picks (4 B) and the flag byte, for the flux ``bc`` (8 B) and ``sgn_div``
    on Neumann faces, the cell field and its seed rows at the distinct cells
    the faces read, for the pair and interface the chosen candidate (8 B a
    row), and every face seed row the kind reads (8 B an element); the whole
    ``(1 + B, n)`` result."""
    kind, launcher = call["kind"], call["launcher"]
    primals, seeds = call["primals"], call["seeds"] or [None] * 3
    s = primals[0]
    n, B = s.shape[0], batch_of(call)
    out = 8 * (1 + B) * n
    if kind in ("flux", "apply"):
        lo, hi, is_dir, is_neu, _sgn = launcher.geometry
        up = torch.where(s >= 0, lo, hi)
        take = (up >= 0) & ~is_neu
        cells = int(torch.unique(up[take]).numel())
        total = n * (8 + 4 + 1) + 8 * cells + out
        if seeds[1] is not None:
            total += 8 * B * cells
        if kind == "flux":
            total += 8 * n + 8 * int(is_neu.sum())
            total += sum(8 * B * n for t in (seeds[0], seeds[2]) if t is not None)
        return total
    rows = 1 + (B if seeds[1] is not None or seeds[2] is not None else 0)
    total = 8 * n + 8 * rows * n + out
    if kind == "interface" and seeds[0] is not None:
        total += 8 * B * n
    return total


def bound_us(call) -> float:
    return 1e6 * dual_bytes(call) / HBM_BYTES_PER_S


def check_launch(call, other=None) -> None:
    """The launch against its plain version
    (:func:`porepy_tpu_torch.kernels.reference.upwind_dual` on the same
    operands), a second launch and, given ``other`` (of ``upwind_dual``'s
    signature), ``other``'s result: each to the bit (equal, NaN where the
    other is NaN)."""
    label = call["label"]
    got = launch(call)()
    want = reference.upwind_dual(call["kind"], call["launcher"].geometry, call["primals"], call["seeds"])
    again = launch(call)()
    routes = [("the plain version", want), ("a second launch", again)]
    if other is not None:
        routes.append(("the other route", launch(call, other)()))
    for what, ref in routes:
        for a, b in zip(got, ref):
            _require((a is None) == (b is None), f"{label}: tangents against {what}")
            _require(a is None or (a.shape == b.shape and same_bits(a, b)), f"{label}: differs from {what}")


def case_calls(dev, case: str) -> list:
    """The K15 calls of one assembly of ``"md"`` (``cases.build_md_flow``,
    cell size 1/128, the main path) or ``"tracer"`` (``cases.build_tracer``,
    1/64) at its first iterate on ``dev`` (see :func:`assembly_calls`)."""
    from porepy_tpu_torch.applications.benchmarking import cases

    build, cell_size = {"md": (cases.build_md_flow, 1.0 / 128), "tracer": (cases.build_tracer, 1.0 / 64)}[case]
    Model, params = build(cell_size, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    return assembly_calls(model, f"{case} 1/{round(1 / cell_size)}")
