"""K10 (the batched region solve) and K16 (the table lookup) on the card,
against their plain versions and the parent's kernels.

    python3 -m porepy_tpu_torch.applications.benchmarking.region_lookup_check [--no-disc]

The parent's kernels are built from ``region_solve.cu`` and
``interp_lookup.cu`` in ``parent_region_lookup/`` beside this script (K10: a
block a region, [A | RHS] in shared memory, rows swapped, warp 0's pivot
search, W read once an output column; K16: the flat table, a value and a
tangent launch) and called as the parent's wrappers called them; the
parent's dual rule is its two launches around two ``torch.stack``. They are
the yardstick only; no path of the package calls them.

The script prints the card's ``nvidia-smi`` line and what ``nvcc -Xptxas
-v`` reports for the four sources; then

- K10 at every bucket of ``chip_smoke.py`` phase 11 (``cases.region_batches``:
  the first chunk of each bucket of biot 1/64's discretization and of the
  Biot discretization of a 3d 16³ grid, and two synthetic batches): the
  kernel against ``reference.region_solve_ordered`` (to the bit), against
  ``region_solve_contract`` and the parent (1e-12 of the largest entry), and
  the kernel and the parent in turns (new, parent, parent, new): device us
  by CUDA-graph replay, host us a call, ms by CUDA events, beside the bound;
  the copies of the main 2d and the 3d bucket, pageable and pinned, in
  turns; unless ``--no-disc``, biot 1/64's discretization by K10 and by host
  LAPACK in turns (seconds);
- K16 at 2048² points of a 201 x 201 table (``chip_smoke.py`` phase 16's
  inputs): the value, the B = 4 tangents and the dual call, each against the
  plain versions and the parent (to the bit) and in turns with the parent,
  as for K10; then the 1024² ``EquationSystem`` (``tab(p, T) = 0``) through
  the package's dual rule and the parent's, in turns: ms an evaluation and
  assembly, K16 launches, the results against each other (to the bit).

Bounds: the larger of the bytes (each input read once, each output written
once) over 3.35 TB/s and the operations over 34 TFLOP/s (f64). Needs a CUDA
card and ``nvcc``; exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from porepy_tpu_torch.applications.benchmarking.cases import (
    N_POINTS, NX_TABLE, local_solves, lookup_inputs, region_batches, table_system,
)
from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.kernels import LAUNCHES, ops, reference

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_region_lookup")
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12
#: Launches of the parent's kernels since the last reset.
PARENT_LAUNCHES = {"region_solve": 0, "interp_lookup": 0}
TURNS = ("new", "parent", "parent", "new")
_PARENT = {}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"region_lookup_check failed: {what}")


def bound_ms(nbytes: float, flops: float) -> tuple:
    """``(ms, "bytes" or "operations")`` of f64 work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def region_bound(B: int, n: int, m: int, q: int) -> tuple:
    """K10's bound: A, RHS, W in and OUT out; the LU, the solves and the
    contraction's operations."""
    return bound_ms(8.0 * B * (n * n + n * m + q * n + q * m),
                    B * (2.0 / 3.0 * n**3 + 2.0 * n * n * m + 2.0 * q * n * m))


# -- the parent's kernels ------------------------------------------------------------


def parent_library(workdir: str) -> ctypes.CDLL:
    """The parent's ``region_solve.cu`` and ``interp_lookup.cu`` built with
    ``nvcc`` into one library with a plain C interface."""
    if "lib" not in _PARENT:
        so = os.path.join(workdir, "parent_k10_k16.so")
        srcs = [os.path.join(PARENT_DIR, f) for f in ("region_solve.cu", "interp_lookup.cu")]
        subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so, *srcs], check=True)
        lib = ctypes.CDLL(so)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ppt_region_solve_f64.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.ppt_interp_lookup_f64.argtypes = [P] * 7 + [I, L, I, P]
        lib.ppt_region_solve_f64.restype = lib.ppt_interp_lookup_f64.restype = ctypes.c_int
        _PARENT["lib"] = lib
    return _PARENT["lib"]


def parent_region_solve(a, rhs, w):
    """The parent's K10 launch with its wrapper's checks and allocations
    ([A | RHS] in a workspace where it does not fit shared memory)."""
    B, n = a.shape[0], a.shape[1]
    m, q = rhs.shape[2], w.shape[1]
    ops._check("region_solve", {"a": a, "rhs": rhs, "w": w}, a.dtype)
    out = torch.empty((B, q, m), dtype=a.dtype, device=a.device)
    work = None
    if 8 * n * (n + m + 1) > ops._SMEM_MAX:
        work = torch.empty((B, n, n + m), dtype=a.dtype, device=a.device)
    rc = _PARENT["lib"].ppt_region_solve_f64(
        a.data_ptr(), rhs.data_ptr(), w.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
        B, n, m, q, torch.cuda.current_stream().cuda_stream)
    _require(rc == 0, f"parent region_solve: CUDA error {rc}")
    PARENT_LAUNCHES["region_solve"] += 1
    return out


def parent_interp(values, fgeom, igeom, x, dx=None):
    """The parent's K16 launch (the value, or the tangents for ``dx`` ``(B,
    d, N)``) with its wrapper's checks and allocation."""
    d, n = x.shape
    tensors = {"values": values, "fgeom": fgeom, "igeom": igeom, "x": x}
    if dx is not None:
        _require(dx.dim() == 3 and dx.shape[1:] == (d, n), "parent interp_lookup: dx must be (B, d, N)")
        tensors["dx"] = dx
    ops._check("interp_lookup", tensors, torch.float64)
    if dx is None:
        out = torch.empty(n, dtype=x.dtype, device=x.device)
        dx_ptr, out_ptr, dout_ptr, batch = None, out.data_ptr(), None, 0
    else:
        out = torch.empty((dx.shape[0], n), dtype=x.dtype, device=x.device)
        dx_ptr, out_ptr, dout_ptr, batch = dx.data_ptr(), None, out.data_ptr(), dx.shape[0]
    rc = _PARENT["lib"].ppt_interp_lookup_f64(
        values.data_ptr(), fgeom.data_ptr(), igeom.data_ptr(), x.data_ptr(), dx_ptr, out_ptr, dout_ptr, d, n,
        batch, torch.cuda.current_stream().cuda_stream)
    _require(rc == 0, f"parent interp_lookup: CUDA error {rc}")
    PARENT_LAUNCHES["interp_lookup"] += 1
    return out


def parent_dual(table: dict, vals, tans):
    """The parent's dual rule: the values stacked, a value launch, the
    tangents stacked into ``(B, d, N)`` (zero rows for a constant argument),
    a tangent launch. Returns ``(value, tangents)``."""
    args = (table["values"], table["fgeom"], table["igeom"])
    x = torch.stack(vals).contiguous()
    val = parent_interp(*args, x)
    if all(t is None for t in tans):
        return val, None
    batch = next(t.shape[0] for t in tans if t is not None)
    zeros = None
    rows = []
    for t, v in zip(tans, vals):
        if t is None:
            zeros = v.new_zeros((batch, v.shape[0])) if zeros is None else zeros
            t = zeros
        rows.append(t)
    return val, parent_interp(*args, x, torch.stack(rows, dim=1).contiguous())


def parent_rule(fun):
    """The parent's dual rule for the ``InterpolatedFunction`` ``fun``."""
    from porepy_tpu_torch.numerics.ad import forward

    def rule(run, *duals):
        table = fun.device_table(duals[0].val.device)
        val, tan = parent_dual(table, [torch.atleast_1d(d.val) for d in duals], [d.tan for d in duals])
        return forward.Dual(val, tan)

    return rule


# -- timing ---------------------------------------------------------------------------


def in_turns(routes: dict, label: str, bound: tuple, reps: int = 20, launches: int = 20) -> dict:
    """``routes`` (``{"new": fn, "parent": fn}``) in turns (new, parent,
    parent, new): device us a call by graph replay (captured in relaxed
    mode: the parent's K10 sets its kernel's shared-memory limit on every
    launch), host us a call, ms by
    CUDA events over back-to-back calls; printed beside ``bound``."""
    device = {k: [] for k in routes}
    host = {k: [] for k in routes}
    ms = {k: [] for k in routes}
    for k in TURNS:
        device[k].append(graph_us(routes[k], launches=launches, replays=3, mode="relaxed"))
    for k in TURNS:
        host[k].append(host_us(routes[k], calls=reps))
    for k in TURNS:
        ms[k].append(cuda_ms(routes[k], reps))
    share = 1e3 * bound[0] / min(device["new"])
    fmt = lambda v: ", ".join(f"{t:.2f}" for t in v)
    print(f"  {label}, in turns: device us (graph replay) new {fmt(device['new'])}, parent "
          f"{fmt(device['parent'])}; host us new {fmt(host['new'])}, parent {fmt(host['parent'])}; ms (events) "
          f"new {', '.join(f'{t:.4f}' for t in ms['new'])}, parent {', '.join(f'{t:.4f}' for t in ms['parent'])}; "
          f"bound {bound[0]:.4f} ms ({bound[1]}), the new kernel at {100 * share:.1f}% of it")
    return {"device_us": device, "host_us": host, "ms": ms, "bound": bound, "share": share}


# -- K10 --------------------------------------------------------------------------------


def check_region(dev, batches) -> dict:
    """Every bucket: the bits against the ordered plain version, the
    contract plain version and the parent; the kernel and the parent in
    turns."""
    out = {}
    for source, (n, m, q), arrays in batches:
        B = arrays[0].shape[0]
        a, rhs, w = (torch.from_numpy(x).to(dev) for x in arrays)
        label = f"K10 {source} (B {B}, n {n}, m {m}, q {q}; route {ops.region_solve_route(n, m)})"
        before = LAUNCHES["region_solve"]
        got = ops.region_solve(a, rhs, w)
        torch.cuda.synchronize()
        _require(LAUNCHES["region_solve"] == before + 1, f"{label}: not one launch")
        ordered = reference.region_solve_ordered(a, rhs, w)
        contract = reference.region_solve_contract(a, rhs, w)
        parent = parent_region_solve(a, rhs, w)
        scale = float(contract.abs().max())
        equal = reference.same_bits(got, ordered)
        err_c = float((got - contract).abs().max())
        err_p = float((got - parent).abs().max())
        print(f"  {label}: the ordered plain version's bits: {equal}; max |kernel - contract| {err_c:.3e}, "
              f"|kernel - parent| {err_p:.3e} (max {scale:.3e})")
        _require(equal, f"{label}: kernel and ordered plain version differ")
        _require(err_c <= 1e-12 * scale and err_p <= 1e-12 * scale, f"{label}: kernel off by {max(err_c, err_p)}")
        timed = {"new": lambda: ops.region_solve(a, rhs, w), "parent": lambda: parent_region_solve(a, rhs, w)}
        out[(source, n, m, q)] = in_turns(timed, label, region_bound(B, n, m, q), reps=10, launches=10)
    return out


def copies_in_turns(arrays, dev, label: str, reps: int = 10) -> dict:
    """The copies around a K10 chunk: ``a``, ``rhs``, ``w`` to the card and
    the result back, pageable and pinned, in turns (pageable, pinned,
    pinned, pageable), ms by CUDA events."""
    host = [torch.from_numpy(x) for x in arrays]
    pinned = [x.pin_memory() for x in host]
    B, n, m, q = arrays[0].shape[0], arrays[0].shape[1], arrays[1].shape[2], arrays[2].shape[1]
    res = torch.empty((B, q, m), dtype=torch.float64, device=dev)
    back = torch.empty(res.shape, dtype=torch.float64, pin_memory=True)
    routes = {
        "pageable": (lambda: [x.to(dev) for x in host], lambda: res.cpu()),
        "pinned": (lambda: [x.to(dev, non_blocking=True) for x in pinned],
                   lambda: back.copy_(res, non_blocking=True)),
    }
    out = {k: {"to": [], "back": []} for k in routes}
    for k in ("pageable", "pinned", "pinned", "pageable"):
        out[k]["to"].append(cuda_ms(routes[k][0], reps))
        out[k]["back"].append(cuda_ms(routes[k][1], reps))
    for k, v in out.items():
        print(f"  K10 copies {label}, {k}, in turns: to the card {', '.join(f'{t:.4f}' for t in v['to'])} ms, "
              f"back {', '.join(f'{t:.4f}' for t in v['back'])} ms")
    return out


def disc_in_turns(dev) -> dict:
    """biot 1/64's discretization by host LAPACK and by K10, in turns (host,
    k10, k10, host), on one prepared model: seconds."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot

    Model, params = build_biot(1.0 / 64, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    out = {"host": [], "k10": []}
    for route in ("host", "k10", "k10", "host"):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        with local_solves(route):
            model.discretize()
        torch.cuda.synchronize()
        out[route].append(time.perf_counter() - tic)
    print(f"  biot 1/64 discretization in turns, s: host LAPACK {out['host']}, K10 {out['k10']}")
    return out


# -- K16 --------------------------------------------------------------------------------


def check_lookup(dev) -> dict:
    """The value, the B = 4 tangents and the dual call at 2048² points."""
    tab, x, dx = lookup_inputs(dev)
    launcher = tab["launcher"]
    args = (tab["values"], tab["fgeom"], tab["igeom"])
    xs, tans = list(x.unbind(0)), list(dx.unbind(1))
    B = dx.shape[0]
    want_v = reference.interp_lookup(*args, x)
    want_t = reference.interp_tangent(*args, x, dx)
    before = LAUNCHES["interp_lookup"]
    got_v = launcher.rows(xs)
    got_t = launcher.rows(xs, tans)
    got_d = launcher(xs, tans)
    torch.cuda.synchronize()
    _require(LAUNCHES["interp_lookup"] == before + 3, "K16: not one launch a call")
    par_v, par_t = parent_dual(tab, xs, tans)
    for name, got, want, par in (
        ("value", got_v, want_v, par_v), ("tangents", got_t, want_t, par_t),
        ("dual value row", got_d[0], want_v, par_v), ("dual tangent rows", got_d[1:], want_t, par_t),
    ):
        same = reference.same_bits(got, want) and reference.same_bits(got, par)
        print(f"  K16 {name}: the plain version's and the parent's bits: {same}")
        _require(same, f"K16 {name} differs")
    # The table as the function needs it, the flat one; the kernel's
    # corner-block copy (2^d times as large) is its own layout.
    corners = launcher.corners()[0]
    table_bytes = 8.0 * tab["values"].numel()
    n = N_POINTS
    # Operations: ~20 a point for the cell and the 4 weights, ~36 a seed for
    # the weight tangents and sums.
    cases = {
        "value": ({"new": lambda: launcher.rows(xs), "parent": lambda: parent_interp(*args, x)},
                  bound_ms(8.0 * n * 3 + table_bytes, 20.0 * n)),
        f"tangents B={B}": ({"new": lambda: launcher.rows(xs, tans), "parent": lambda: parent_interp(*args, x, dx)},
                            bound_ms(8.0 * n * (2 + 2 * B + B) + table_bytes, 36.0 * B * n)),
        f"dual, value + {B} tangents": ({"new": lambda: launcher(xs, tans), "parent": lambda: parent_dual(tab, xs, tans)},
                                        bound_ms(8.0 * n * (2 + 2 * B + 1 + B) + table_bytes, (20.0 + 36.0 * B) * n)),
    }
    print(f"  K16 corner table {tuple(corners.shape)}, {8e-6 * corners.numel():.2f} MB (flat {table_bytes / 1e6:.2f} MB, "
          f"which the bounds count)")
    return {label: in_turns(routes, f"K16 {label}, {n} points", bound) for label, (routes, bound) in cases.items()}


def assembly_in_turns(dev, nx: int = NX_TABLE, repeats: int = 10) -> dict:
    """The ``tab(p, T)`` system on ``nx``²: an evaluation and an assembly
    through the package's dual rule and through the parent's, in turns (new,
    parent, parent, new, new, parent): median and least ms of ``repeats`` a
    turn, K16 launches of one, the results against each other."""
    systems = {"new": table_system(nx, str(dev)), "parent": table_system(nx, str(dev), parent_rule)}
    results, launches = {}, {}
    for k, (es, op, _fun) in systems.items():
        ops.reset_launches()
        PARENT_LAUNCHES["interp_lookup"] = 0
        val = es.evaluate(op)
        data, b, _cs = es.assemble_device()
        torch.cuda.synchronize()
        launches[k] = LAUNCHES["interp_lookup"] + PARENT_LAUNCHES["interp_lookup"]
        results[k] = (torch.as_tensor(val), data.cpu(), b.cpu())
    same = all(reference.same_bits(g, p) for g, p in zip(results["new"], results["parent"]))
    print(f"  K16 EquationSystem {nx}^2: launches of an evaluation and an assembly {launches}; the two routes' "
          f"value, Jacobian and residual the same bits: {same}")
    _require(same, "the EquationSystem results differ between the routes")
    ms = {k: [] for k in systems}
    for k in ("new", "parent", "parent", "new", "new", "parent"):
        es, op, _fun = systems[k]
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            es.evaluate(op)
            es.assemble_device()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - tic))
        ms[k].append((statistics.median(times), min(times)))
    for k, v in ms.items():
        print(f"  K16 EquationSystem {nx}^2, {k} rule, in turns: evaluation + assembly median ms "
              f"{', '.join(f'{t[0]:.3f}' for t in v)}, least {', '.join(f'{t[1]:.3f}' for t in v)}")
    return {"launches": launches, "ms": ms}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-disc", action="store_true", help="skip the discretization in turns")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("region_lookup_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"region_lookup_check on {torch.cuda.get_device_name(0)} ({smi})")
    csrc = os.path.join(os.path.dirname(ops.__file__), "csrc")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(csrc, "region_solve.cu"), os.path.join(csrc, "interp_lookup.cu"),
                      os.path.join(PARENT_DIR, "region_solve.cu"), os.path.join(PARENT_DIR, "interp_lookup.cu")],
                     work)
        tic = time.perf_counter()
        parent_library(work)
        print(f"parent kernels built in {time.perf_counter() - tic:.1f} s")
    batches = region_batches(dev)
    check_region(dev, batches)
    for source, k, arrays in batches:
        if (source, k[0]) in (("biot 1/64", 20), ("biot 3d 16^3", 81)):
            copies_in_turns(arrays, dev, f"{source} n {k[0]}")
    if not opts.no_disc:
        disc_in_turns(dev)
    check_lookup(dev)
    assembly_in_turns(dev)
    print(f"region_lookup_check on {smi}: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
