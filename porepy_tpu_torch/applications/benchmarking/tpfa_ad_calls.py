"""K14's calls (``kernels.tpfa_ad_dual``) at the shapes the card is checked
and timed at, with what a check of them needs: ``DarcysLawAd``'s own calls
of one assembly (:func:`darcy_ad_calls`) and a 3d Cartesian grid with seeds
of every input (:func:`cube_call`), the bytes a call must move
(:func:`dual_bytes`), the launch held against its plain version and itself
(:func:`check_launch`), and a count of the assemblies a block makes
(:func:`assemblies`). ``chip_smoke.py`` (phases 19 and 21) and
``tpfa_ad_check.py`` share them.
"""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import same_bits
from porepy_tpu_torch.kernels import ops, reference

#: A launch's largest error against its plain version, over its largest
#: finite entry.
TOL = 1e-12


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"K14 check failed: {what}")


def darcy_ad_calls(dev, cell_size: float = 1.0 / 128) -> list:
    """The calls of ``kernels.tpfa_ad_dual`` in one assembly of the
    ``DarcysLawAd`` model (``cases.build_darcy_ad``) at its first iterate
    on ``dev``: dicts of ``label``,
    ``geom``, ``primals``, ``seeds`` (copies) and ``trace``, the largest
    subdomain first."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_darcy_ad

    Model, params = build_darcy_ad(cell_size, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    calls = []
    one_call = ops.tpfa_ad_dual

    def capture(geom, primals, seeds=None, trace=False):
        calls.append({
            "geom": geom, "trace": bool(trace),
            "primals": [t.clone() for t in primals],
            "seeds": None if seeds is None else [None if s is None else s.clone() for s in seeds],
        })
        return one_call(geom, primals, seeds, trace)

    with mock.patch.object(ops, "tpfa_ad_dual", capture):
        model.equation_system.assemble()
    calls.sort(key=lambda c: (-c["geom"].num_faces, c["trace"]))
    for c in calls:
        kind = "trace" if c["trace"] else "flux"
        c["label"] = f"DarcysLawAd 1/{round(1 / cell_size)}, {c['geom'].num_faces} faces, {kind}, B = {batch_of(c)}"
    return calls


def cube_call(dev, trace: bool, n3d: int = 32, B: int = 16, seed: int = 19) -> dict:
    """Phase 19's 3d ``n3d``³ shape: Dirichlet on the x faces, Neumann on
    the other boundary faces, full tensors, ``B`` seeds of every input
    (``dgeom``: the grid's ``_DiffTpfaGeometry``)."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.models.darcys_law_ad import _DiffTpfaGeometry

    rng = np.random.default_rng(seed)
    grid = pt.CartGrid(np.array([n3d] * 3), np.array([1.0, 1.0, 1.0]))
    grid.compute_geometry()
    bf = grid.get_all_boundary_faces()
    x_faces = bf[(grid.face_centers[0, bf] < 1e-9) | (grid.face_centers[0, bf] > 1 - 1e-9)]
    dgeom = _DiffTpfaGeometry([grid], lambda sd: pt.BoundaryCondition(sd, x_faces, "dir"))
    geom = dgeom.kernel_geometry(dev)[0]
    nc, nf = grid.num_cells, grid.num_faces
    sym = rng.standard_normal((nc, 3, 3))
    scale = 0.5 + rng.random(nc)
    k9 = (scale[:, None, None] * (np.eye(3)[None] + 0.1 * (sym + sym.transpose(0, 2, 1)))).reshape(-1)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    primals = [f64(k9), f64(0.5 + rng.random(nc)), f64(rng.standard_normal(nc)),
               f64(rng.standard_normal(nf)), f64(rng.standard_normal(nf))]
    seeds = [f64(rng.standard_normal((B, n))) for n in (9 * nc, nc, nc, nf, nf)]
    kind = "trace" if trace else "flux"
    return {"label": f"3d {n3d}^3, {nf} faces, {kind}, B = {B}", "geom": geom, "primals": primals,
            "seeds": seeds, "trace": trace, "dgeom": dgeom}


def batch_of(call) -> int:
    seeds = call["seeds"] or []
    return next((s.shape[0] for s in seeds if s is not None), 0)


def dual_bytes(call) -> int:
    """The bytes one call must move, each input read once and each output
    written once, only what the function needs: the flux reads the whole
    geometry (4 B a face and 64 a half-face, two mask bytes a face), the
    fields (88 B a cell, 16 a face) and each non-null seed row; the trace
    reads, of the listed faces only, the list entry, two mask bytes, bco and
    lam and their seed rows, and of a Neumann face also its face pointers,
    its half-faces' geometry (64 B), cell fields (88 B) and cell seed rows.
    Both write the whole ``(1 + B, nf)`` result."""
    geom, primals, seeds = call["geom"], call["primals"], call["seeds"] or [None] * 5
    nf, nhf, nc = geom.num_faces, geom.num_half_faces, primals[1].shape[0]
    B = batch_of(call)
    live = [s is not None for s in seeds]
    cell_row = 72 * live[0] + 8 * live[1] + 8 * live[2]
    face_row = 8 * live[3] + 8 * live[4]
    out = 8 * (1 + B) * nf
    if not call["trace"]:
        return 4 * (nf + 1) + 64 * nhf + 2 * nf + 88 * nc + 16 * nf + B * (cell_row * nc + face_row * nf) + out
    listed = geom["boundary_faces"].long()
    neu = (geom["is_neu_raw"][listed] & ~geom["is_dir_raw"][listed])
    ptr = geom["face_ptr"].long()
    n_hf = int((ptr[listed + 1] - ptr[listed])[neu].sum())
    n_list, n_neu = listed.shape[0], int(neu.sum())
    return (n_list * (4 + 2 + 16 + B * face_row) + n_neu * 8
            + n_hf * (64 + 88 + B * cell_row) + out)


def launch(call, fn=None):
    """``call`` as a function of no argument through ``fn`` (a function of
    :func:`porepy_tpu_torch.kernels.tpfa_ad_dual`'s signature; by default
    that op)."""
    fn = fn or ops.tpfa_ad_dual
    return lambda: fn(call["geom"], call["primals"], call["seeds"], call["trace"])


def check_launch(call, other=None) -> float:
    """The launch against its plain version (:data:`TOL` of the largest
    finite entry, non-finite on the same entries), a second launch (to the
    bit) and, given ``other`` (of ``tpfa_ad_dual``'s signature), ``other``'s
    result (to the bit); the trace's unlisted faces 0 in every row. Returns
    the error against the plain version."""
    label, geom = call["label"], call["geom"]
    got = launch(call)()
    want = reference.tpfa_ad_dual(geom, call["primals"], call["seeds"], call["trace"])
    pair = launch(call, other)() if other is not None else got
    again = launch(call)()
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        if b is None:
            _require(a is None, f"{label}: tangents without a seed")
            continue
        fin = torch.isfinite(b)
        _require(torch.equal(torch.isfinite(a), fin), f"{label}: non-finite entries differ from the plain version")
        scale = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
        err = max(err, float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-300) if bool(fin.any()) else 0.0)
    _require(err <= TOL, f"{label}: {err:.3e} from the plain version")
    for a, b in zip(got, pair):
        _require((a is None) == (b is None) and (a is None or same_bits(a, b)), f"{label}: differs from the other route")
    _require(all(a is None or same_bits(a, b) for a, b in zip(got, again)), f"{label}: two launches differ")
    if call["trace"]:
        unlisted = ~(geom["is_dir_raw"] | geom["is_neu_raw"])
        rows = torch.cat([got[0][None]] + ([got[1]] if got[1] is not None else []))
        _require(bool((rows[:, unlisted] == 0).all()), f"{label}: a face not listed is not 0")
    return err


@contextmanager
def assemblies():
    """Counts the assemblies (Jacobian and residual, or residual alone) made
    inside the block, in the dict it yields."""
    from porepy_tpu_torch.numerics.ad.equation_system import _CompiledSystem as cls

    counted = {"data_and_rhs": 0, "rhs_only": 0}
    orig = (cls._data_and_rhs, cls._rhs_only)

    def data_and_rhs(self, *args, **kwargs):
        counted["data_and_rhs"] += 1
        return orig[0](self, *args, **kwargs)

    def rhs_only(self, *args, **kwargs):
        counted["rhs_only"] += 1
        return orig[1](self, *args, **kwargs)

    cls._data_and_rhs, cls._rhs_only = data_and_rhs, rhs_only
    try:
        yield counted
    finally:
        cls._data_and_rhs, cls._rhs_only = orig
