"""K15 (``upwind_dual``: the value and every tangent of a dual rule in one
launch) on the card, against its plain version and against the parent's
route.

    python3 -m porepy_tpu_torch.applications.benchmarking.upwind_check [--no-models] [--other FILE ...]

The parent's route (:class:`ParentKernels` under
``upwind_calls.parent_route``) is what the dual rules did before: a value
and a tangent launch of the parent's kernels (one thread a (row, face), the
upstream found again in every row), built from ``upwind.cu`` in
``parent_upwind/`` beside this script and checked and dispatched on every
call as the parent's wrappers did, and for the interface rule the product
as one more launch, ``forward.mul``'s ``dual_ew``. It is the yardstick only;
no path of the package calls it.

The script prints the card's ``nvidia-smi`` line and what ``nvcc -Xptxas
-v`` reports for both sources; then, at the K15 calls of one assembly of md
1/128 (the main path) and of tracer 1/64 (``upwind_calls.case_calls``: the
first iterate's operands and the seeds the dual rules hand the op), it holds
each launch against its plain version, a second launch and the parent's
route (each to the bit) and times the launch and the parent's route in
turns (new, parent, parent, new): device us a call by CUDA-graph replay,
host us a call, ms by CUDA events over back-to-back calls, beside the bound
(bytes, ``upwind_calls.dual_bytes``), and the selection alone by
``torch.where`` + ``index_select`` on the same rows (device us). Then,
unless ``--no-models``, one md 1/128 and one tracer 1/64 assembly (the K8
pass at the first iterate) through the new rules and through the parent's,
in turns (new, parent, parent, new, new, parent): median and least ms of 50
assemblies a turn, launches an assembly, the two results against
each other. ``--other FILE ...``: other versions of ``upwind.cu`` with the
same launch table, each timed in turns with the package's kernel at the
first call of each kind and held to it to the bit. Needs a CUDA card and
``nvcc``; exits non-zero when a launch disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking import upwind_calls
from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report, same_bits
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.kernels import LAUNCHES, ops, reset_launches

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_upwind")
#: Launches of the parent's kernels since the last reset.
PARENT_LAUNCHES = {"upwind_flux": 0, "upwind_select": 0}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"upwind_check failed: {what}")


class ParentKernels:
    """The parent's three K15 kernels behind the parent's four wrappers
    (``ops.upwind_flux``, ``upwind_flux_tangent``, ``upwind_select``,
    ``upwind_select_pair`` as they were: the geometry checked, the fields'
    pointers and strides gathered, one launch a call)."""

    def __init__(self, workdir: str) -> None:
        so = os.path.join(workdir, "parent_k15.so")
        subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                        os.path.join(PARENT_DIR, "upwind.cu")], check=True)
        lib = ctypes.CDLL(so)
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            "ppt_upwind_flux_f64": [P] * 6 + [L] * 6 + [P] * 6 + [I] * 3 + [P],
            "ppt_upwind_select_f64": [P] * 2 + [L] * 2 + [P] * 5 + [I] * 2 + [P],
            "ppt_upwind_select_pair_f64": [P] * 3 + [L] * 3 + [P] + [I] * 2 + [P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        self.lib = lib

    def _launch(self, name, count_as, *args):
        rc = getattr(self.lib, f"ppt_{name}_f64")(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
        PARENT_LAUNCHES[count_as] += 1

    def _flux(self, q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div, tangent):
        nf, nc = q.shape[-1], w.shape[-1]
        ops._check_upwind_geometry("upwind_flux", nf, lo, hi, is_dir, is_neu, sgn_div)
        b_face, p_face, s_face = ops._rows("upwind_flux", nf, q=q, bc=bc, dq=dq, dbc=dbc)
        b_cell, p_cell, s_cell = ops._rows("upwind_flux", nc, w=w, dw=dw)
        batch = b_face or b_cell
        out = torch.empty((batch, nf) if batch else (nf,), dtype=torch.float64, device=q.device)
        if nf:
            self._launch(
                "upwind_flux", "upwind_flux",
                p_face[0], p_cell[0], p_face[1], p_face[2], p_cell[1], p_face[3],
                s_face[0], s_cell[0], s_face[1], s_face[2], s_cell[1], s_face[3],
                lo.data_ptr(), hi.data_ptr(), is_dir.data_ptr(), is_neu.data_ptr(),
                sgn_div.data_ptr(), out.data_ptr(), nf, max(batch, 1), int(tangent),
            )
        return out

    def upwind_flux(self, q, w, bc, lo, hi, is_dir, is_neu, sgn_div):
        return self._flux(q, w, bc, None, None, None, lo, hi, is_dir, is_neu, sgn_div, False)

    def upwind_flux_tangent(self, q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div):
        return self._flux(q, w, bc, dq, dw, dbc, lo, hi, is_dir, is_neu, sgn_div, True)

    def upwind_select(self, q, w, lo, hi, is_dir, is_neu):
        nf, nc = q.shape[-1], w.shape[-1]
        ops._check_upwind_geometry("upwind_select", nf, lo, hi, is_dir, is_neu)
        bq, (pq,), (sq,) = ops._rows("upwind_select", nf, q=q)
        bw, (pw,), (sw,) = ops._rows("upwind_select", nc, w=w)
        batch = bq or bw
        out = torch.empty((batch, nf) if batch else (nf,), dtype=torch.float64, device=q.device)
        if nf:
            self._launch("upwind_select", "upwind_select", pq, pw, sq, sw, lo.data_ptr(), hi.data_ptr(),
                         is_dir.data_ptr(), is_neu.data_ptr(), out.data_ptr(), nf, max(batch, 1))
        return out

    def upwind_select_pair(self, s, a, b):
        n = s.shape[-1]
        batch, ptrs, strides = ops._rows("upwind_select_pair", n, s=s, a=a, b=b)
        out = torch.empty((batch, n) if batch else (n,), dtype=torch.float64, device=s.device)
        if n:
            self._launch("upwind_select_pair", "upwind_select", *ptrs, *strides, out.data_ptr(), n,
                         max(batch, 1))
        return out


def _selection_library(call):
    """``torch.where`` + ``index_select`` on the call's value and seed rows:
    the selection alone (the flux's products and the interface's product
    are not in it), as one PyTorch expression."""
    kind, (s, a, b), seeds = call["kind"], call["primals"], call["seeds"] or [None] * 3
    if kind in ("flux", "apply"):
        lo, hi = (t.clamp_min(0) for t in call["launcher"].geometry[:2])
        rows = torch.cat([a[None]] + ([seeds[1]] if seeds[1] is not None else []))
        return lambda: torch.where(s >= 0, rows.index_select(1, lo), rows.index_select(1, hi))
    first = torch.cat([a[None]] + ([seeds[1]] if seeds[1] is not None else []))
    second = torch.cat([b[None]] + ([seeds[2]] if seeds[2] is not None else []))
    return lambda: torch.where(s >= 0, first, second)


def time_call(call, parent) -> dict:
    """The launch and the parent's route in turns (new, parent, parent,
    new): device us a call by graph replay, host us a call, ms by events;
    the bound and the selection's library expression."""
    routes = {"new": upwind_calls.launch(call), "parent": upwind_calls.launch(call, parent)}
    order = ("new", "parent", "parent", "new")
    device = {k: [] for k in routes}
    host = {k: [] for k in routes}
    ms = {k: [] for k in routes}
    for route in order:
        device[route].append(graph_us(routes[route]))
    for route in order:
        host[route].append(host_us(routes[route]))
    for route in order:
        ms[route].append(cuda_ms(routes[route]))
    r = {"device_us": device, "host_us": host, "ms": ms, "bound_us": upwind_calls.bound_us(call),
         "bytes": upwind_calls.dual_bytes(call), "library_us": graph_us(_selection_library(call))}
    r["share"] = r["bound_us"] / min(device["new"])
    print(f"  {call['label']}, in turns (new, parent, parent, new): device us a call {device} (graph "
          f"replay); host us a call {host}; ms by events {ms}; bound {r['bound_us']:.3f} us "
          f"({r['bytes'] / 1e6:.3f} MB), the new launch at {100 * r['share']:.1f}% of it; the selection by "
          f"torch.where + index_select {r['library_us']:.2f} us")
    return r


def other_kernel(src: str, workdir: str, tag: str):
    """``ppt_upwind_dual_f64`` of another ``upwind.cu`` with the same launch
    table (a version not kept), built with ``nvcc``."""
    so = os.path.join(workdir, f"other_k15_{tag}.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    fn = ctypes.CDLL(so).ppt_upwind_dual_f64
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    return fn


def time_others(call, others: dict) -> dict:
    """The package's launch and each other version's (``{name: fn}``, run
    through the same launcher and launch table) in turns (package, others,
    others reversed, package): device us a call by graph replay, each result
    held to the package's to the bit."""
    launcher = call["launcher"]
    kept = launcher._fn
    run = upwind_calls.launch(call)
    want = run()
    names = list(others)
    us = {name: [] for name in ["package"] + names}
    try:
        for name in ["package"] + names + names[::-1] + ["package"]:
            launcher._fn = kept if name == "package" else others[name]
            got = run()
            _require(all(a is None or same_bits(a, b) for a, b in zip(got, want)),
                     f"{call['label']}: {name} differs from the package's kernel")
            us[name].append(graph_us(run))
    finally:
        launcher._fn = kept
    print(f"  {call['label']}, other versions in turns, device us a call (graph replay): {us}")
    return us


def assembly_turns(dev, case: str, parent, repeats: int = 50) -> dict:
    """One assembly of ``case`` at its first iterate (the compiled system's
    K8 pass) through the new rules and the parent's, in turns (new, parent,
    parent, new, new, parent): median and least ms of ``repeats``
    assemblies a turn, launches an assembly by kernel, the results' largest
    difference."""
    from porepy_tpu_torch.applications.benchmarking import cases

    build, cell_size = {"md": (cases.build_md_flow, 1.0 / 128), "tracer": (cases.build_tracer, 1.0 / 64)}[case]
    Model, params = build(cell_size, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    es = model.equation_system
    cs = es.compiled_system()
    ms = {"new": [], "parent": []}
    least = {"new": [], "parent": []}
    launches, results = {}, {}
    for route in ("new", "parent", "parent", "new", "new", "parent"):
        ctx = upwind_calls.parent_rules(parent) if route == "parent" else nullcontext()
        with ctx:
            torch.cuda.synchronize()
            reset_launches()
            for k in PARENT_LAUNCHES:
                PARENT_LAUNCHES[k] = 0
            results[route] = [t.clone() for t in cs.assemble(es)]
            torch.cuda.synchronize()
            launches[route] = {k: v for k, v in LAUNCHES.items() if v}
            launches[route].update({f"parent {k}": v for k, v in PARENT_LAUNCHES.items() if v})
            times = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                cs.assemble(es)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - tic))
        ms[route].append(float(np.median(times)))
        least[route].append(min(times))
    same = all(same_bits(a, b) for a, b in zip(results["new"], results["parent"]))
    diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for a, b in zip(results["new"], results["parent"]))
    print(f"  {case} 1/{round(1 / cell_size)} assembly in turns (new, parent, parent, new, new, parent), median "
          f"ms {ms}, least ms {least}; "
          f"launches an assembly: new {launches['new']}, parent {launches['parent']}; results "
          f"{'equal to the bit' if same else f'{diff:.3e} apart (of the largest entry)'}")
    _require(same or diff <= 1e-12, f"{case}: the rules' assemblies differ by {diff}")
    return {"ms": ms, "least_ms": least, "launches": launches, "same_bits": same, "diff": diff}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-models", action="store_true", help="skip the assemblies in turns")
    parser.add_argument("--other", nargs="*", default=[], metavar="FILE",
                        help="other upwind.cu versions (same launch table) to time in turns with the package's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("upwind_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"upwind_check on {torch.cuda.get_device_name(0)} ({smi})")
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(os.path.dirname(ops.__file__), "csrc", "upwind.cu")
        ptxas_report([src, os.path.join(PARENT_DIR, "upwind.cu")], work)
        kernels = ParentKernels(work)
        parent = upwind_calls.parent_route(kernels)
        others = {os.path.relpath(src): other_kernel(src, work, str(i)) for i, src in enumerate(args.other)}
        for case in ("md", "tracer"):
            calls = upwind_calls.case_calls(dev, case)
            for call in calls:
                reset_launches()
                upwind_calls.launch(call)()
                _require(LAUNCHES[call["launcher"].name] == 1 and sum(LAUNCHES.values()) == 1,
                         f"{call['label']}: launches {LAUNCHES} for one call")
                upwind_calls.check_launch(call, parent)
                print(f"  {call['label']}: one launch a call, equal to the plain version, a second launch and "
                      f"the parent's route to the bit")
            # The kinds once each: the first call of a kind (md's two
            # interface calls have the same operands).
            seen = set()
            for call in calls:
                if call["kind"] not in seen:
                    seen.add(call["kind"])
                    time_call(call, parent)
                    if others:
                        time_others(call, others)
            del calls
        if not args.no_models:
            for case in ("md", "tracer"):
                assembly_turns(dev, case, kernels)
    print("upwind_check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
