"""K13's one-pass launches on the card against their plain versions and the
parent's kernels, and the unstructured Newton step through them.

    python3 -m porepy_tpu_torch.applications.benchmarking.tpfa_step_check [--n 32] [--probe]

At n^3 cells (default 32^3, ``chip_smoke.py`` phase 10's size) on the flow
steps' problem (``flow_cycle_check.tpfa_kernel``) and on a copy of it
with Neumann faces of both signs (:func:`neumann_kernel`), from states near
2e5 Pa, the script prints the card's ``nvidia-smi`` line and:

- the probe of the parent's compiled arithmetic (``parent_tpfa_flow/``,
  built here): its jvp face tangents (the parent's face scratch) and its
  Jacobian neighbour values against the plain forms with and without a
  fused multiply-add (:func:`probe`), f64 and f32;
- every mode of :class:`~porepy_tpu_torch.kernels.TpfaLauncher` (residual,
  jvp, linearize, step) and the custom operators against their plain
  versions and against the parent's kernels (and, for the step's diagonal,
  the parent's torch composition, :func:`parent_diagonal`), to the bit,
  f64 and f32;
- the residual and the jvp (one launch) against the parent's face and cell
  launches behind the parent's custom operator: device us a call by
  CUDA-graph replay and host us a call, in turns (new, parent, parent,
  new), beside the bound (bytes, each input read once and the output
  written once, over 3.35 TB/s);
- the step's operands, one ``tpfa_step`` launch, against its plain version
  (``reference.tpfa_step``) and the parent's route (``tpfa_residual``,
  ``tpfa_linearize``, the torch diagonal): ``r``, the values and the
  diagonal to the bit, device and host us in turns, the parent
  ``tpfa_linearize``'s own device us, the CUDA kernels of each;
- ``newton_step`` against the parent's step (the same code with the
  parent's operands) from p = 2e5, each route in turns over chained steps:
  every iterate and residual norm equal to the bit, the solves' iteration
  counts equal, ms a step (median), the CUDA kernels and the package's
  launch counters of one step.

``--probe`` runs the probe alone. Needs a CUDA card and ``nvcc``; exits
non-zero when a launch differs from its plain version or the routes
differ.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking import flow_cycle_check as fcc
from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report
from porepy_tpu_torch.applications.benchmarking.timing import (counted, cuda_kernels, cuda_ms, graph_us, host_us,
                                                                 nbytes)
from porepy_tpu_torch.kernels import build, ops, reference

HBM = 3.35e12
PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_tpfa_flow")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: The parent's library, once built (its custom operators call it).
_PARENT: list = []


def _so(workdir: str) -> str:
    return os.path.join(workdir, "k13_parent.so")


def start_build(workdir: str) -> subprocess.Popen:
    """The parent's ``tpfa_flow.cu``, an ``nvcc`` started in the background
    into ``workdir``, for :class:`ParentTpfa` to wait for."""
    return subprocess.Popen([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", _so(workdir),
                             os.path.join(PARENT_DIR, "tpfa_flow.cu")])


class ParentTpfa:
    """The parent's K13 kernels (``tpfa_flow.cu`` of ``parent_tpfa_flow/``:
    a face launch writing each face's mass flux or tangent into a scratch
    array, a cell launch gathering it; the linearization), called directly:
    the yardstick of the bits and of the times."""

    def __init__(self, workdir: str, job: subprocess.Popen = None) -> None:
        if job is None:
            job = start_build(workdir)
        if job.wait() != 0:
            raise RuntimeError(f"the parent's tpfa_flow.cu did not build: nvcc exit {job.returncode}")
        lib = ctypes.CDLL(_so(workdir))
        self.fns = {}
        for name, argtypes in (("residual", [_P] * 13 + [_I] * 2 + [_P]), ("jvp", [_P] * 13 + [_I] * 2 + [_P]),
                               ("linearize", [_P] * 13 + [_I, _P])):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, f"ppt_tpfa_{name}{suffix}")
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                self.fns[(name, suffix)] = fn
        _PARENT[:] = [self]

    def _fn(self, name, dtype):
        return self.fns[(name, "_f64" if dtype == torch.float64 else "_f32")]

    def faces(self, name, p, q, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef) -> tuple:
        """``(m, out)``: the parent's face scratch and result of its
        ``tpfa_residual`` or ``tpfa_jvp``, as its wrapper ran it (the
        arrays checked, ``m`` and ``out`` allocated, the two launches)."""
        tensors = ops._tpfa_topology(name, p.shape[0], lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)
        ops._check(name, {"p": p, "q": q}, p.dtype)
        nf = t.shape[0]
        m = torch.empty(nf, dtype=p.dtype, device=p.device)
        out = torch.empty_like(p)
        lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef = (x.data_ptr() for x in tensors.values())
        rc = self._fn(name[5:], p.dtype)(p.data_ptr(), q.data_ptr(), lo, hi, t, is_neu, bc_val, pv, cell_ptr,
                                         cell_faces, coef, m.data_ptr(), out.data_ptr(), p.shape[0], nf,
                                         ops._current_stream())
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
        return m, out

    def linearize(self, p, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot,
                  vals) -> None:
        """The parent's ``ops.tpfa_linearize`` on the card: its checks and
        its one launch into ``vals``."""
        if slot.shape != cell_faces.shape or diag_slot.shape != pv.shape:
            raise ValueError("tpfa_linearize: slot must be like cell_faces, diag_slot like pv")
        if vals.dtype != p.dtype or vals.dim() != 1:
            raise ValueError("tpfa_linearize: vals must be 1-d in p's dtype")
        tensors = ops._tpfa_topology("tpfa_linearize", p.shape[0], lo, hi, t, is_neu, bc_val, pv, cell_ptr,
                                     cell_faces, coef)
        ops._check("tpfa_linearize", {"p": p, "slot": slot, "diag_slot": diag_slot, "vals": vals}, p.dtype)
        rc = self._fn("linearize", p.dtype)(p.data_ptr(), *(x.data_ptr() for x in tensors.values()),
                                            slot.data_ptr(), diag_slot.data_ptr(), vals.data_ptr(), p.shape[0],
                                            ops._current_stream())
        if rc:
            raise RuntimeError(f"parent tpfa_linearize: CUDA error {rc}")


@torch.library.custom_op("porepy_tpu_torch_parent::tpfa_residual", mutates_args=())
def parent_residual(p: torch.Tensor, p_prev: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor,
                    is_neu: torch.Tensor, bc_val: torch.Tensor, pv: torch.Tensor, cell_ptr: torch.Tensor,
                    cell_faces: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """The parent's ``kernels.tpfa_residual``: its custom operator over its
    two launches."""
    return _PARENT[0].faces("tpfa_residual", p, p_prev, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces,
                            coef)[1]


@torch.library.custom_op("porepy_tpu_torch_parent::tpfa_jvp", mutates_args=())
def parent_jvp(p: torch.Tensor, dp: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, t: torch.Tensor,
               is_neu: torch.Tensor, bc_val: torch.Tensor, pv: torch.Tensor, cell_ptr: torch.Tensor,
               cell_faces: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """The parent's ``kernels.tpfa_jvp``: its custom operator over its two
    launches."""
    return _PARENT[0].faces("tpfa_jvp", p, dp, lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef)[1]


def parent_diagonal(kernel, p: torch.Tensor) -> torch.Tensor:
    """The parent's Jacobi diagonal, ``TpfaFlowKernel._jacobi_diagonal``'s
    torch composition as the parent wrote it (the density twice, the fluid
    scalars as they are): the yardstick of the step's diagonal, its bits and
    its launches."""
    w = kernel.density(p) / kernel.visc
    diag = kernel.t_sum * w
    diag = diag + kernel.pv * kernel.comp * kernel.density(p) / kernel.dt
    return torch.where(torch.abs(diag) > 1e-30, diag, torch.ones_like(diag))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, element by element (a NaN's payload too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    bits = reference._BITS[a.dtype]
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def neumann_kernel(kernel, dev, seed: int = 7):
    """``kernel`` with every third boundary face Neumann, its prescribed
    flux of either sign (about the Dirichlet faces' own flux, 1e-3 to 1e-1
    of a face's ``t`` times 1e4 Pa)."""
    from porepy_tpu_torch.parallel.flow_step import TpfaFlowKernel

    lo, hi = kernel.lo.cpu().numpy(), kernel.hi.cpu().numpy()
    t = kernel.t.cpu().numpy()
    is_neu = kernel.is_neu.cpu().numpy().copy()
    bc_val = kernel.bc_val.cpu().numpy().copy()
    bnd = np.flatnonzero((lo < 0) | (hi < 0))[::3]
    rng = np.random.default_rng(seed)
    is_neu[bnd] = True
    bc_val[bnd] = rng.choice([-1.0, 1.0], bnd.size) * rng.uniform(1e1, 1e3, bnd.size) * t[bnd]
    scal = {k: float(getattr(kernel, k)) for k in ("rho_ref", "comp", "visc", "p_ref", "dt")}
    return TpfaFlowKernel.from_numpy(lo, hi, t, is_neu, bc_val, kernel.pv.cpu().numpy(), device=dev, **scal)


def _states(n_cells, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    p, p_prev = ((2e5 + 1e4 * torch.randn(n_cells, generator=gen, dtype=torch.float64)) for _ in range(2))
    v = torch.randn(n_cells, generator=gen, dtype=torch.float64)
    return tuple(x.to(dtype).to(dev) for x in (p, p_prev, v))


def probe(parent: ParentTpfa, kernel, dev, seed: int = 5) -> dict:
    """The parent's compiled faces: its jvp face tangents (the face
    scratch ``m``) and its Jacobian neighbour values (a cell-cell entry is
    one face's ``a_hi`` or ``-a_lo`` on this grid) against plain forms with
    and without a fused multiply-add, f64 and f32. Returns, for each form,
    ``(faces equal, faces compared)``."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        args, _launcher, cycle = kernel._solver(dtype)
        lo, hi, t, is_neu, bc_val, pv, cell_ptr, cell_faces, coef, slot, diag_slot = args
        p, _p_prev, dp = _states(kernel.num_cells, dtype, dev, seed)
        comp, visc = coef[1], coef[2]
        m, _ = parent.faces("tpfa_jvp", p, dp, *args[:9])
        p_lo, p_hi = reference._tpfa_face_values(p, lo, hi, bc_val)
        d_lo, d_hi = reference._tpfa_face_values(dp, lo, hi, torch.zeros_like(bc_val))
        r_lo, r_hi = reference._density(p_lo, coef), reference._density(p_hi, coef)
        q, dq = t * (p_lo - p_hi), t * (d_lo - d_hi)
        up = q >= 0
        w = torch.where(up, r_lo, r_hi) / visc
        dw = torch.where(up, comp * r_lo * d_lo, comp * r_hi * d_hi) / visc
        live = ~is_neu
        for name, form in (("dw q + w dq", dw * q + w * dq), ("fma(w, dq, dw q)", reference.fma(w, dq, dw * q)),
                           ("fma(dw, q, w dq)", reference.fma(dw, q, w * dq))):
            out[f"jvp {tag}: {name}"] = (int((form[live] == m[live]).sum()), int(live.sum()))
        vals = torch.zeros_like(cycle.op[-1])
        parent.linearize(p, *args, vals)
        face, own, valid = reference.tpfa_rows(cell_ptr, cell_faces)
        entry_face, entry_own = face[valid], own[valid]
        k = slot.long()
        keep = (k >= 0) & ~is_neu[entry_face]
        got = vals[k[keep]]
        ef, eo = entry_face[keep], entry_own[keep]
        wt = w * t
        x_lo, x_hi = comp * r_lo / visc, comp * r_hi / visc
        # a_lo where q >= 0 (read as -a_lo by hi's row), a_hi where q < 0
        # (read as a_hi by lo's row): each against its forms.
        sel_lo, sel_hi = ~eo & up[ef], eo & ~up[ef]
        for side, sel, sign, forms in (
            ("a_lo", sel_lo, -1, (("x q + w t", x_lo * q + wt), ("fma(x, q, w t)", reference.fma(x_lo, q, wt)),
                                  ("fma(w, t, x q)", reference.fma(w, t, x_lo * q)))),
            ("a_hi", sel_hi, 1, (("x q - w t", x_hi * q - wt), ("fma(x, q, -w t)", reference.fma(x_hi, q, -wt)),
                                 ("fma(-w, t, x q)", reference.fma(-w, t, x_hi * q)))),
        ):
            for name, form in forms:
                same = int((got[sel] == sign * form[ef[sel]]).sum())
                out[f"linearize {tag} {side}: {name}"] = (same, int(sel.sum()))
    for k_, (same, n) in out.items():
        print(f"  probe, the parent's {k_}: {same} of {n} faces equal")
    return out


def check_modes(kernel, dev, parent: ParentTpfa = None, seed: int = 2, label: str = "") -> dict:
    """Every mode of ``kernel``'s launchers (f64, f32) and the custom
    operators against their plain versions and, with ``parent``, the
    parent's kernels and the torch diagonal, each to the bit."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = f"{label}{str(dtype)[6:]}"
        args, launcher, cycle = kernel._solver(dtype)
        arrays, (slot, diag_slot), nnz = args[:9], args[9:], cycle.op[-1].shape[0]
        p, p_prev, v = _states(kernel.num_cells, dtype, dev, seed)
        res, jvp = launcher.residual(p, p_prev), launcher.jvp(p, v)
        vals = torch.empty_like(cycle.op[-1])
        launcher.linearize(p, vals)
        s_vals, s_diag = torch.empty_like(vals), torch.empty(kernel.num_cells, dtype=dtype, device=dev)
        s_res = launcher.step(p, p_prev, s_vals, s_diag)
        want_r, want_v, want_d = reference.tpfa_step(p, p_prev, *arrays, launcher.t_sum, slot, diag_slot, nnz)
        out[f"residual {tag} = plain"] = same_bits(res, reference.tpfa_residual(p, p_prev, *arrays))
        out[f"jvp {tag} = plain"] = same_bits(jvp, reference.tpfa_jvp(p, v, *arrays))
        out[f"linearize {tag} = plain"] = same_bits(vals, reference.tpfa_linearize(p, *arrays, slot, diag_slot, nnz))
        out[f"step {tag} = plain"] = (same_bits(s_res, want_r) and same_bits(s_vals, want_v)
                                      and same_bits(s_diag, want_d))
        out[f"custom operators {tag} = launcher"] = (same_bits(kernels.tpfa_residual(p, p_prev, *arrays), res)
                                                     and same_bits(kernels.tpfa_jvp(p, v, *arrays), jvp))
        out[f"step {tag} = residual, linearize"] = same_bits(s_res, res) and same_bits(s_vals, vals)
        if parent is not None:
            out[f"residual {tag} = parent"] = same_bits(res, parent.faces("tpfa_residual", p, p_prev, *arrays)[1])
            out[f"jvp {tag} = parent"] = same_bits(jvp, parent.faces("tpfa_jvp", p, v, *arrays)[1])
            pv_ = torch.empty_like(vals)
            parent.linearize(p, *args, pv_)
            out[f"linearize {tag} = parent"] = same_bits(vals, pv_)
        # At a uniform p the faces carry no flux: the accumulation's bits
        # are the residual's.
        flat = torch.full_like(p, 2.0e5)
        for prev in (flat, p_prev):
            res0 = launcher.residual(flat, prev)
            ok = same_bits(res0, reference.tpfa_residual(flat, prev, *arrays))
            if parent is not None:
                ok &= same_bits(res0, parent.faces("tpfa_residual", flat, prev, *arrays)[1])
            out[f"residual {tag} at a uniform p{' = p_prev' if prev is flat else ''}"] = ok
        if dtype == torch.float64:
            out[f"step diag {tag} = the parent's diagonal"] = same_bits(s_diag, parent_diagonal(kernel, p))
    bad = [k for k, ok in out.items() if not ok]
    where = f" ({label.strip()})" if label else ""
    print(f"  K13 launches to the bit{where}: {len(out) - len(bad)} of {len(out)} hold"
          f"{'; DIFFERENT: ' + str(bad) if bad else ''}")
    return out


def _in_turns(routes: dict) -> dict:
    """Device us (graph replay) and host us a call of each route, in turns
    (new, parent, parent, new)."""
    turns = {k: {"device_us": [], "host_us": []} for k in routes}
    for route in ("new", "parent", "parent", "new"):
        turns[route]["device_us"].append(graph_us(routes[route]))
        turns[route]["host_us"].append(host_us(routes[route]))
    return turns


def _fmt(turns: dict, key: str, digits: int) -> str:
    return ", ".join(f"{r} {['%.*f' % (digits, x) for x in v[key]]}" for r, v in turns.items())


def ops_in_turns(kernel, dev, seed: int = 3) -> dict:
    """The residual and the jvp at 32^3 f64: the launcher's one launch
    against the parent's custom operator over its two launches, in turns;
    the bits; the bound; ms by events and the plain version's."""
    args, launcher, _cycle = kernel._solver(torch.float64)
    arrays = args[:9]
    p, p_prev, v = _states(kernel.num_cells, torch.float64, dev, seed)
    out = {}
    for name, second, new, old, plain in (
        ("tpfa_residual", p_prev, launcher.residual, parent_residual, reference.tpfa_residual),
        ("tpfa_jvp", v, launcher.jvp, parent_jvp, reference.tpfa_jvp),
    ):
        turns = _in_turns({"new": lambda: new(p, second), "parent": lambda: old(p, second, *arrays)})
        size = nbytes(p, second, *arrays) + 8 * p.numel()
        custom = getattr(kernels, name)
        r = {
            "turns": turns, "bytes": size, "bound_us": 1e6 * size / HBM,
            "equal": same_bits(new(p, second), old(p, second, *arrays)),
            "custom_host_us": host_us(lambda: custom(p, second, *arrays)),
            "ms": cuda_ms(lambda: new(p, second)), "plain_ms": cuda_ms(lambda: plain(p, second, *arrays), 10),
        }
        r["device_us"] = min(turns["new"]["device_us"])
        out[name] = r
        print(f"  {name} at {kernel.num_cells} cells f64, in turns: device us (graph replay) "
              f"{_fmt(turns, 'device_us', 2)}; host us {_fmt(turns, 'host_us', 1)} (the new custom operator "
              f"{r['custom_host_us']:.1f}); bound {r['bound_us']:.3f} us "
              f"({100 * r['bound_us'] / r['device_us']:.1f}%); "
              f"{r['ms']:.4f} ms by events, plain {r['plain_ms']:.4f}; "
              f"{'equal to the bit' if r['equal'] else 'DIFFERENT'}")
    return out


def step_in_turns(kernel, dev, seed: int = 4) -> dict:
    """The Newton step's operands at a random state, 32^3 f64: one
    ``tpfa_step`` launch against its plain version (``reference.tpfa_step``
    on the same inputs) and against the parent's route (its residual custom
    operator, its ``tpfa_linearize``, ``diag.copy_(parent_diagonal(p))``)
    into the step's own buffers: the bits of each and the launch's largest
    difference from the plain version, device and host us in turns, the
    parent ``tpfa_linearize``'s device us alone, the kernels of each, the
    bound of the new launch."""
    args, launcher, cycle = kernel._solver(torch.float64)
    arrays = args[:9]
    p, p_prev, _v = _states(kernel.num_cells, torch.float64, dev, seed)
    vals, diag = cycle.op[-1], cycle.diag
    o_vals, o_diag = torch.empty_like(vals), torch.empty_like(diag)

    def new():
        return launcher.step(p, p_prev, vals, diag)

    def old():
        r = parent_residual(p, p_prev, *arrays)
        _PARENT[0].linearize(p, *args, o_vals)
        o_diag.copy_(parent_diagonal(kernel, p))
        return r

    r_new, r_old = new(), old()
    plain = reference.tpfa_step(p, p_prev, *arrays, launcher.t_sum, *args[9:], vals.shape[0])
    got = (r_new, vals, diag)
    equal = {"r": same_bits(r_new, r_old), "vals": same_bits(vals, o_vals), "diag": same_bits(diag, o_diag)}
    equal.update({f"{k} = plain": same_bits(a, b) for k, a, b in zip(("r", "vals", "diag"), got, plain)})
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    # The profiler first: after a graph capture it may see no kernel.
    kernels_of = {"new": cuda_kernels(new, 3), "parent": cuda_kernels(old, 3)}
    turns = _in_turns({"new": new, "parent": old})
    lin_us = [graph_us(lambda: _PARENT[0].linearize(p, *args, o_vals)) for _ in range(2)]
    size = nbytes(p, p_prev, *arrays, launcher.t_sum, *args[9:]) + nbytes(r_new, vals, diag)
    face_entries = int(arrays[7].numel())
    out = {
        "turns": turns, "equal": equal, "err": err, "parent_linearize_us": lin_us, "bytes": size,
        "bound_us": 1e6 * size / HBM, "flops": 40 * face_entries + 30 * kernel.num_cells,
        "kernels": kernels_of,
        "ms": cuda_ms(new),
        "plain_ms": cuda_ms(lambda: reference.tpfa_step(p, p_prev, *arrays, launcher.t_sum, *args[9:],
                                                          vals.shape[0]), 10),
    }
    out["device_us"] = min(turns["new"]["device_us"])
    out["launches"] = {k: sum(v.values()) for k, v in out["kernels"].items()}
    out["counted"] = counted(new)
    print(f"  the step's operands (r, values, diagonal) at {kernel.num_cells} cells f64, in turns: device us (graph "
          f"replay) {_fmt(turns, 'device_us', 2)}; host us {_fmt(turns, 'host_us', 1)}; the parent tpfa_linearize "
          f"alone {['%.2f' % x for x in lin_us]} us device; bound {out['bound_us']:.3f} us "
          f"({size / 1e6:.2f} MB, {100 * out['bound_us'] / out['device_us']:.1f}%); {out['ms']:.4f} ms by events, "
          f"plain {out['plain_ms']:.4f}; bits {equal}, largest difference from the plain version {err!r}")
    for route, k in out["kernels"].items():
        print(f"    {route}: {out['launches'][route]} CUDA kernels {k}")
    print(f"    new: counted {out['counted']}")
    return out


def parent_newton_step(kernel, p, p_prev, tol: float = 1e-10, maxiter: int = 200, iterations=None):
    """``TpfaFlowKernel.newton_step`` as the parent ran it: the parent's
    residual custom operator, its ``tpfa_linearize`` into the step's
    values, the torch diagonal, then the same solve."""
    args, _launcher, cycle = kernel._solver(p.dtype)
    r = parent_residual(p, p_prev, *kernel._arrays(), kernel._coef())
    _PARENT[0].linearize(p, *args, cycle.op[-1])
    cycle.diag.copy_(parent_diagonal(kernel, p))
    nrm = torch.linalg.vector_norm(r)
    scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    dx, k = cycle.solve(-r / scale, tol=tol, atol=0.0, maxiter=maxiter)
    if iterations is not None:
        iterations.append(k)
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)) * scale
    return p + dx, nrm


def _lockstep(kernel, p0, steps: int) -> None:
    """Where the two routes part: both routes' operands and steps from the
    same state, step by step along the new route's iterates, and the first
    cells whose residual differs."""
    args, launcher, cycle = kernel._solver(p0.dtype)
    arrays = args[:9]
    p = p0
    for i in range(steps):
        vals, diag = torch.empty_like(cycle.op[-1]), torch.empty_like(cycle.diag)
        r = launcher.step(p, p0, vals, diag)
        o_vals = torch.empty_like(vals)
        o_r = parent_residual(p, p0, *arrays)
        _PARENT[0].linearize(p, *args, o_vals)
        o_diag = parent_diagonal(kernel, p)
        a, ra = kernel.newton_step(p, p0)
        b, rb = parent_newton_step(kernel, p, p0)
        print(f"    lockstep {i}: r {same_bits(r, o_r)} vals {same_bits(vals, o_vals)} "
              f"diag {same_bits(diag, o_diag)}; steps {same_bits(a, b)} norms {same_bits(ra, rb)}")
        bits = reference._BITS[r.dtype]
        plain = reference.tpfa_residual(p, p0, *arrays)
        for c in torch.nonzero(r.view(bits) != o_r.view(bits)).flatten()[:3].tolist():
            print(f"      cell {c}: new {float(r[c])!r} parent {float(o_r[c])!r} plain {float(plain[c])!r}")
        p = a


def steps_in_turns(kernel, dev, steps: int = 7) -> dict:
    """``newton_step`` against :func:`parent_newton_step` from p = 2e5,
    ``steps`` chained steps a turn, in turns (new, parent, parent, new):
    every iterate and residual norm to the bit, the solves' iteration
    counts, ms a step (median), the kernels and counters of one step."""
    p0 = torch.full((kernel.num_cells,), 2.0e5, dtype=torch.float64, device=dev)
    routes = {
        "new": lambda a, b, it=None: kernel.newton_step(a, b, iterations=it),
        "parent": lambda a, b, it=None: parent_newton_step(kernel, a, b, iterations=it),
    }
    ms, runs = {"new": [], "parent": []}, {}
    for route in ("new", "parent", "parent", "new"):
        step = routes[route]
        p, times, iters, states = p0, [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            p, rn = step(p, p0, iters)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - tic))
            states.append((p.clone(), rn.clone()))
        ms[route].append(float(np.median(times)))
        runs.setdefault(route, (states, iters))
    (s_new, it_new), (s_old, it_old) = runs["new"], runs["parent"]
    equal = all(same_bits(a, b) and same_bits(ra, rb) for (a, ra), (b, rb) in zip(s_new, s_old))
    if not equal:
        _lockstep(kernel, p0, steps)
    step_kernels = {}
    for route, step in routes.items():
        one = lambda: step(p0, p0)  # noqa: E731
        step_kernels[route] = {"kernels": cuda_kernels(one, 3), "counted": counted(one)}
    out = {"ms": ms, "equal": equal, "iterations": (it_new, it_old), "same_iterations": it_new == it_old,
           "step_kernels": step_kernels, "rnorm": [float(r) for _p, r in s_new]}
    print(f"  unstructured Newton steps at {kernel.num_cells} cells, {steps} chained from 2e5, in turns: ms a step "
          f"(median) new {['%.3f' % t for t in ms['new']]}, parent {['%.3f' % t for t in ms['parent']]}; iterates "
          f"and |r| {'equal to the bit' if equal else 'DIFFERENT'}; solves' iterations "
          f"{'equal' if it_new == it_old else 'DIFFERENT'} ({it_new}); |r| {['%.3e' % r for r in out['rnorm']]}")
    for route, r in step_kernels.items():
        print(f"  one step, {route} route: {sum(r['kernels'].values())} CUDA kernels {r['kernels']}; counted "
              f"{r['counted']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--probe", action="store_true", help="the probe of the parent's compiled faces alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tpfa_step_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernel = fcc.tpfa_kernel(args.n, dev)
    print(f"K13 at {args.n}^3: {kernel.num_cells} cells, {kernel.num_faces} faces")
    with tempfile.TemporaryDirectory() as work:
        job = start_build(work)
        build.library()
        ptxas_report([os.path.join(build.CSRC, "tpfa_flow.cu"), os.path.join(PARENT_DIR, "tpfa_flow.cu")], work)
        parent = ParentTpfa(work, job)
        probe(parent, kernel, dev)
        if args.probe:
            return 0
        bits = check_modes(kernel, dev, parent)
        bits.update(check_modes(neumann_kernel(kernel, dev), dev, parent, label="neumann "))
        calls = ops_in_turns(kernel, dev)
        operands = step_in_turns(kernel, dev)
        steps = steps_in_turns(kernel, dev)
    ok = (all(bits.values()) and all(r["equal"] for r in calls.values()) and all(operands["equal"].values())
          and steps["equal"] and steps["same_iterations"])
    print(f"tpfa_step_check on {smi}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
