"""K14 (``tpfa_ad_dual``: the value and all tangents of the differentiable
TPFA flux or pressure trace of one subdomain in one launch) on the card,
against its plain version and against the parent's two launches.

    python3 -m porepy_tpu_torch.applications.benchmarking.tpfa_ad_check [--no-models]

The parent's route (:func:`parent_dual`) is a value launch and a tangent
launch of the parent's kernels (one thread a face, the seeds in a serial
loop, the trace over every face), built from ``tpfa_ad.cu`` in
``parent_tpfa_ad/`` beside this script and checked and dispatched on every
call as the parent's wrapper did. It is the yardstick only; no path of the
package calls it.

The script prints what ``nvcc -Xptxas -v`` reports for both sources; then,
at two shapes, (a) ``DarcysLawAd`` 1/128's own calls of one assembly
(:func:`darcy_ad_calls`: the matrix and the fracture subdomain, flux and
trace, the first iterate's fields and the seeds the dual rule hands the op,
their batch read from the run) and (b) phase 19's 3d 32³ grid with 16 seeds
of every input (:func:`cube_call`), it holds each launch against its plain
version (1e-12 of the largest entry; the same non-finite entries) and the
parent's pair (to the bit), two launches against each other (to the bit)
and the trace's unlisted faces at 0 in every row; and, at the matrix
subdomain and the cube, times the launch and the parent's pair in turns
(new, parent, parent, new): device µs a call by CUDA-graph replay, host µs a
call, ms by CUDA events over back-to-back calls, beside the bound (bytes,
:func:`dual_bytes`), and the value alone (no seed) by graph replay. Then, unless
``--no-models``, ``DarcysLawAd`` 1/128 for 26 steps with each route swapped
into the dual rule, in turns (:func:`model_turns`): ms a Newton iteration,
assembly ms at the final state, Newton and Krylov counts, K14 launches
against the assemblies, the final states' distance. Needs a CUDA card and
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
from unittest import mock

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.applications.benchmarking.tpfa_ad_calls import (
    assemblies, check_launch, cube_call, darcy_ad_calls, dual_bytes, launch,
)
from porepy_tpu_torch.kernels import LAUNCHES, ops, reset_launches

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_tpfa_ad")
#: The card's memory rate (NVIDIA's H100 SXM data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
#: Launches of the parent's route since the last reset.
PARENT_LAUNCHES = {"tpfa_ad_flux": 0, "tpfa_ad_trace": 0}
_PARENT = {}
_NAMES = ("tpfa_ad_flux", "tpfa_ad_trace")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"tpfa_ad_check failed: {what}")


def _build(src: str, so: str) -> ctypes.CDLL:
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    return ctypes.CDLL(so)


# -- the parent's route -----------------------------------------------------------


def parent_library(workdir: str) -> ctypes.CDLL:
    """The parent's ``tpfa_ad.cu`` built with ``nvcc`` into a library with a
    plain C interface."""
    if "lib" not in _PARENT:
        lib = _build(os.path.join(PARENT_DIR, "tpfa_ad.cu"), os.path.join(workdir, "parent_k14.so"))
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name in _NAMES:
            fn = getattr(lib, f"ppt_{name}_f64")
            fn.argtypes, fn.restype = [P] * 10 + [L] * 5 + [P] * 9 + [I] * 3 + [P], ctypes.c_int
        _PARENT["lib"] = lib
    return _PARENT["lib"]


def _parent_launch(name, geom, primals, seeds):
    """One launch of the parent's kernel with the parent's wrapper's checks
    (``_tpfa_ad_cuda``): the value without ``seeds``, else the tangents."""
    vol = primals[1]
    nc, nf = vol.shape[0], geom.num_faces
    sizes = (9 * nc, nc, nc, nf, nf)
    for arg, t, n in zip(("k9", "vol", "p", "bco", "lam"), primals, sizes):
        if t.dtype != torch.float64 or t.shape != (n,):
            raise ValueError(f"{name}: {arg} must be float64 of shape ({n},)")
    ops._check(name, dict(zip(("k9", "vol", "p", "bco", "lam"), primals)), torch.float64)
    if geom.device != vol.device:
        raise ValueError(f"{name}: geometry on {geom.device}, fields on {vol.device}")
    raw = name == "tpfa_ad_trace"
    masks = (geom["is_dir_raw"], geom["is_neu_raw"]) if raw else (geom["is_dir"], geom["is_neu"])
    if seeds is None:
        batch, s_ptrs, s_strides = 0, [None] * 5, [0] * 5
        out = torch.empty(nf, dtype=torch.float64, device=vol.device)
    else:
        batch, s_ptrs, s_strides = 0, [], []
        for arg, t, n in zip(("dk9", "dvol", "dp", "dbco", "dlam"), seeds, sizes):
            b, (ptr,), (stride,) = ops._rows(name, n, **{arg: t})
            if t is not None and t.dim() != 2:
                raise ValueError(f"{name}: {arg} must be (B, {n})")
            if b and batch and b != batch:
                raise ValueError(f"{name}: seeds differ in batch size")
            batch = batch or b
            s_ptrs.append(ptr)
            s_strides.append(stride)
        out = torch.empty((batch, nf), dtype=torch.float64, device=vol.device)
    if nf:
        rc = getattr(_PARENT["lib"], f"ppt_{name}_f64")(
            *(t.data_ptr() for t in primals), *s_ptrs, *s_strides,
            geom["face_ptr"].data_ptr(), geom["face_hf"].data_ptr(), geom["ci"].data_ptr(),
            geom["sgn"].data_ptr(), geom["nrm"].data_ptr(), geom["dvec"].data_ptr(),
            masks[0].data_ptr(), masks[1].data_ptr(), out.data_ptr(),
            nf, geom.num_half_faces, batch, torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
        PARENT_LAUNCHES[name] += 1
    return out


def parent_dual(geom, primals, seeds=None, trace=False):
    """What the dual rule did before the one-launch kernel: the value
    launch, then, with a seed, the tangent launch; the signature of
    :func:`porepy_tpu_torch.kernels.tpfa_ad_dual`, so that it can stand in
    for it."""
    name = _NAMES[bool(trace)]
    val = _parent_launch(name, geom, tuple(primals), None)
    if seeds is None or all(s is None for s in seeds):
        return val, None
    return val, _parent_launch(name, geom, tuple(primals), tuple(seeds))


# -- the bound --------------------------------------------------------------------


def bound_us(call) -> float:
    return 1e6 * dual_bytes(call) / HBM_BYTES_PER_S


# -- the checks -------------------------------------------------------------------


def check_call(call) -> float:
    """The launch against its plain version and itself, the trace's
    unlisted faces (:func:`tpfa_ad_calls.check_launch`), and against the
    parent's pair to the bit. Returns the error against the plain version."""
    return check_launch(call, parent_dual)


def time_call(call) -> dict:
    """The launch and the parent's pair in turns (new, parent, parent, new):
    device µs a call by graph replay, host µs a call, ms by events; the
    bound."""
    routes = {"new": launch(call), "parent": launch(call, parent_dual)}
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
    # The value alone (no seed): the launch, and the parent's value launch.
    value = dict(call, seeds=None)
    value_us = {"new": graph_us(launch(value)), "parent": graph_us(launch(value, parent_dual))}
    r = {"device_us": device, "host_us": host, "ms": ms, "bound_us": bound_us(call), "bytes": dual_bytes(call),
         "value_us": value_us}
    r["share"] = r["bound_us"] / min(device["new"])
    print(f"  {call['label']}, in turns (new, parent, parent, new): "
          f"device us a call {device} (graph replay); host us a call {host}; ms by events {ms}; bound "
          f"{r['bound_us']:.3f} us ({r['bytes'] / 1e6:.3f} MB), the new launch at {100 * r['share']:.1f}% of it; "
          f"the value alone, device us {value_us}")
    return r


# -- the model --------------------------------------------------------------------


def _assembly_ms(model, repeats: int = 10) -> float:
    es = model.equation_system
    cs = es.compiled_system()
    cs.assemble(es)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        cs.assemble(es)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - tic))
    return float(np.median(times))


def _timed_run(dev, cell_size: float):
    """One 26-step ``DarcysLawAd`` run on ``dev``, each fused block timed
    with a device sync: ms a Newton iteration, (Newton, Krylov) a block,
    K14 launches of the route, assemblies, assembly ms at the final state,
    the final state."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_darcy_ad

    Model, params = build_darcy_ad(cell_size, device=str(dev))
    blocks = []

    class Timed(Model):
        def fused_time_block(self, n_steps, nl_params):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            done = super().fused_time_block(n_steps, nl_params)
            torch.cuda.synchronize()
            if done:
                blocks.append((time.perf_counter() - tic, dict(self._ftb_last)))
            return done

    model = Timed(params)
    model.prepare_simulation()
    model._prepared = True
    reset_launches()
    for k in PARENT_LAUNCHES:
        PARENT_LAUNCHES[k] = 0
    with assemblies() as counted:
        pt.run_time_dependent_model(model, params)
        torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] + PARENT_LAUNCHES[k] for k in _NAMES}
    newton = sum(rec["newton_iters"] for _s, rec in blocks)
    return {
        "ms": 1e3 * sum(s for s, _rec in blocks) / max(newton, 1),
        "counts": [(rec["newton_iters"], rec["krylov_iters"]) for _s, rec in blocks],
        "launches": launches, "assemblies": sum(counted.values()),
        "subdomains": len([sd for sd in model.mdg.subdomains() if sd.dim > 0]),
        "assembly_ms": _assembly_ms(model),
        "state": model.equation_system.get_variable_values(time_step_index=0),
    }


def model_turns(dev, cell_size: float = 1.0 / 128) -> dict:
    """``DarcysLawAd`` at ``cell_size``, 26 steps, with the one-launch op and
    with the parent's pair (:func:`parent_dual`) in the dual rule, in turns:
    new, parent, parent, new."""
    runs = {"new": [], "parent": []}
    for route in ("new", "parent", "parent", "new"):
        patch = mock.patch.object(ops, "tpfa_ad_dual", parent_dual) if route == "parent" else nullcontext()
        with patch:
            runs[route].append(_timed_run(dev, cell_size))
    new, parent = runs["new"][0], runs["parent"][0]
    r = {
        "ms": {k: [x["ms"] for x in v] for k, v in runs.items()},
        "assembly_ms": {k: [x["assembly_ms"] for x in v] for k, v in runs.items()},
        "counts": {k: v[0]["counts"] for k, v in runs.items()},
        "launches": {k: v[0]["launches"] for k, v in runs.items()},
        "assemblies": new["assemblies"], "subdomains": new["subdomains"],
        "state_diff": float(np.abs(new["state"] - parent["state"]).max()),
        "state_scale": float(np.abs(parent["state"]).max()),
    }
    print(f"  DarcysLawAd 1/{round(1 / cell_size)}, 26 steps, in turns (new, parent, parent, new): ms a Newton "
          f"iteration {r['ms']}; assembly ms at the final state {r['assembly_ms']}; Newton / Krylov a block "
          f"{r['counts']}; K14 launches {r['launches']} over {r['assemblies']} assemblies of "
          f"{r['subdomains']} subdomains; final states {r['state_diff']:.3e} apart (largest {r['state_scale']:.3e})")
    for route, v in runs.items():
        _require(all(x["counts"] == v[0]["counts"] for x in v), f"{route} runs' counts differ")
    once = new["subdomains"] * new["assemblies"]
    _require(all(n == once for n in r["launches"]["new"].values()),
             f"the one-launch route: {r['launches']['new']} K14 launches, expected {once} each")
    _require(all(n == 2 * once for n in r["launches"]["parent"].values()),
             f"the parent's route: {r['launches']['parent']} K14 launches, expected {2 * once} each")
    _require(r["state_diff"] <= 1e-8 * r["state_scale"], "the routes' final states differ")
    return r


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-models", action="store_true", help="skip DarcysLawAd 1/128 in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tpfa_ad_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"tpfa_ad_check on {torch.cuda.get_device_name(0)} ({smi})")
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(os.path.dirname(ops.__file__), "csrc", "tpfa_ad.cu")
        ptxas_report([src, os.path.join(PARENT_DIR, "tpfa_ad.cu")], work)
        parent_library(work)
        calls = darcy_ad_calls(dev)
        for call in calls:
            err = check_call(call)
            print(f"  {call['label']}: within {err:.3e} of the plain version, the parent's pair and a second "
                  f"launch to the bit")
        timed = [c for c in calls if c["geom"] is calls[0]["geom"]]
        for trace in (False, True):
            cube = cube_call(dev, trace)
            err = check_call(cube)
            print(f"  {cube['label']}: within {err:.3e} of the plain version, the parent's pair and a second "
                  f"launch to the bit")
            timed.append(cube)
        for call in timed:
            time_call(call)
        del calls, timed
        if not args.no_models:
            model_turns(dev)
    print("tpfa_ad_check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
