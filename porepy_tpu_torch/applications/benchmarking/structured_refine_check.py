"""K12's residual and refinement launches on the card, and the
residual/tangent kernels of the flow steps (K12, K13) they stand beside.

    python3 -m porepy_tpu_torch.applications.benchmarking.structured_refine_check [--n 32]

At n^3 cells (default 32^3, ``chip_smoke.py`` phase 10's size) in f64, on
the flow steps' problem (``flow_cycle_check.structured_kernel`` and
``tpfa_kernel``) from a state near 2e5 Pa, the script prints the card's
``nvidia-smi`` line and:

- the four residual/tangent kernels (``structured_residual``, ``structured_jvp``,
  ``tpfa_residual``, ``tpfa_jvp``; the two TPFA ones each a face and a cell
  launch): device us a call by CUDA-graph replay, host us a call, ms by
  CUDA events, beside the bound (bytes: each input read once, the output
  written once, over 3.35 TB/s), and whether each equals its plain version
  to the bit;
- the residual launch that also writes the densities
  (``StructuredLauncher.residual``) and the refinement launch ``c - J(p)
  dx`` (``StructuredLauncher.refine``) against their plain versions (to the
  bit) and against the parent's route (``structured_residual``, then
  ``-r - structured_jvp(p, dx)``: a launch and two torch operations a
  round), to the bit; a round's device us by graph replay and host us, in
  turns (new, parent, parent, new);
- ``newton_step`` against the parent's step (the same code with the
  parent's round) from p = 2e5, each route in turns over chained steps:
  every iterate and residual norm equal to the bit, the solves' iteration
  counts equal, ms a step (median), the launches of one step by kernel
  (``torch.profiler``'s CUDA kernels, and the package's counters).

Needs a CUDA card; exits non-zero when a kernel differs from its plain
version or the routes differ.
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
from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc
from porepy_tpu_torch.applications.benchmarking.timing import (counted, cuda_kernels, cuda_ms, graph_us, host_us,
                                                                 nbytes)
from porepy_tpu_torch.kernels import ops, reference

HBM = 3.35e12
PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_structured_flow")
#: Refinement rounds a step (``newton_step``'s default).
ROUNDS = 3


class ParentStructured:
    """The parent's K12 residual and tangent kernels (``structured_flow.cu``
    of ``parent_structured_flow/``), called directly: the yardstick of the
    bits."""

    def __init__(self, workdir: str) -> None:
        so = os.path.join(workdir, "parent_k12.so")
        subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                        os.path.join(PARENT_DIR, "structured_flow.cu")], check=True)
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        self.fns = {}
        for name in ("residual", "jvp"):
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, f"ppt_structured_{name}{suffix}")
                fn.argtypes, fn.restype = [P] * 11 + [I] * 3 + [P], ctypes.c_int
                self.fns[(name, suffix)] = fn

    def __call__(self, name, p, q, *args):
        out = torch.empty_like(p)
        fn = self.fns[(name, "_f64" if p.dtype == torch.float64 else "_f32")]
        rc = fn(p.data_ptr(), q.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(), *p.shape,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent structured_{name}: CUDA error {rc}")
        return out


def parent_newton_step(kernel, p, p_prev, inner_iter: int = 200, refine: int = ROUNDS, iterations=None):
    """``StructuredFlowKernel.newton_step`` as the parent ran it: the
    residual, then ``-r`` and, in each refinement round, ``-r -
    structured_jvp(p, dx)`` (a custom-op launch and two torch operations)."""
    arrays, coef = kernel._arrays(), kernel._coef()
    r64 = kernels.structured_residual(p, p_prev, *arrays, coef)
    rnorm = torch.linalg.vector_norm(r64)
    cycle = kernel._linearized(p, torch.float32)

    def solve32(rhs64):
        nrm = torch.linalg.vector_norm(rhs64)
        scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        rhs32 = (rhs64 / scale).to(torch.float32).reshape(-1)
        x, k = cycle.solve(rhs32, tol=1e-6, atol=0.0, maxiter=inner_iter)
        if iterations is not None:
            iterations.append(k)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        return x.view(p.shape).to(torch.float64) * scale

    dx = solve32(-r64)
    for _ in range(refine):
        rr = -r64 - kernels.structured_jvp(p, dx, *arrays, coef)
        dx = dx + solve32(rr)
    return p + dx, rnorm


def flow_kernels(dev, n: int = 32, seed: int = 1) -> dict:
    """The four residual/tangent kernels at n^3 in f64: device us (graph replay), host
    us, events ms, the bound, and whether each equals its plain version."""
    ks, ku = fcc.structured_kernel(n, dev), fcc.tpfa_kernel(n, dev)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for names, args, shape in (
        (("structured_residual", "structured_jvp"), (*ks._arrays(), ks._coef()), (n,) * 3),
        (("tpfa_residual", "tpfa_jvp"), (*ku._arrays(), ku._coef()), (ku.num_cells,)),
    ):
        p, q = ((2e5 + 1e4 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dev) for _ in range(2))
        v = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
        for name, second in zip(names, (q, v)):
            kern, plain = getattr(ops, name), getattr(reference, name)
            got, want = kern(p, second, *args), plain(p, second, *args)
            equal = bool(torch.equal(got, want))
            err = float((got - want).abs().max() / want.abs().max())
            size = nbytes(p, second, *args) + 8 * p.numel()
            r = {
                "device_us": graph_us(lambda: kern(p, second, *args)),
                "host_us": host_us(lambda: kern(p, second, *args)),
                "ms": cuda_ms(lambda: kern(p, second, *args)),
                "plain_ms": cuda_ms(lambda: plain(p, second, *args)),
                "bytes": size, "bound_us": 1e6 * size / HBM, "equal": equal, "err": err,
            }
            r["share"] = r["bound_us"] / r["device_us"]
            out[name] = r
            print(f"  {name} at {n}^3 f64: device {r['device_us']:.2f} us (graph replay), host {r['host_us']:.1f} us "
                  f"a call, {r['ms']:.4f} ms by events, plain {r['plain_ms']:.4f} ms; bound {r['bound_us']:.3f} us "
                  f"({100 * r['share']:.1f}%); plain version {'equal to the bit' if equal else 'within %.2e' % err}")
    return out


def check_launches(kernel, dev, parent: ParentStructured = None, seed: int = 2) -> dict:
    """The library's K12 kernels against their plain versions and, with
    ``parent``, the parent's kernels (residual and tangent, f64 and f32),
    and the launcher's residual and refinement against their plain versions
    and the route they replaced (``-r - structured_jvp``), each to the bit,
    at the flow steps' shape from a random state."""
    gen = torch.Generator().manual_seed(seed)
    shape = tuple(kernel.shape)
    out = {}
    for dtype in (torch.float64, torch.float32):
        k = kernel if dtype == torch.float64 else kernel._as_dtype(dtype)
        args = (*k._arrays(), k._coef())
        p, q = ((2e5 + 1e4 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dtype).to(dev)
                for _ in range(2))
        v = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype).to(dev)
        res, jvp = ops.structured_residual(p, q, *args), ops.structured_jvp(p, v, *args)
        tag = str(dtype)[6:]
        if parent is not None:
            out[f"residual {tag} = parent"] = torch.equal(res, parent("residual", p, q, *args))
            out[f"jvp {tag} = parent"] = torch.equal(jvp, parent("jvp", p, v, *args))
        out[f"residual {tag} = plain"] = torch.equal(res, reference.structured_residual(p, q, *args))
        out[f"jvp {tag} = plain"] = torch.equal(jvp, reference.structured_jvp(p, v, *args))
        launcher = kernels.StructuredLauncher(*args)
        r, rho = launcher.residual(p, q)
        want_r, want_rho = reference.structured_residual_rho(p, q, *args)
        c = -r
        refined = launcher.refine(p, v, c, rho)
        out[f"residual_rho {tag} = plain"] = torch.equal(r, want_r) and torch.equal(rho, want_rho)
        out[f"refine {tag} = plain"] = torch.equal(refined, reference.structured_refine(p, v, c, rho, *args))
        out[f"refine {tag} = -r - structured_jvp"] = torch.equal(refined, -res - jvp)
        if parent is not None:
            out[f"refine {tag} = parent route"] = torch.equal(refined, -parent("residual", p, q, *args)
                                                              - parent("jvp", p, v, *args))
    print(f"  K12 launches to the bit: {out}")
    return out


def round_in_turns(kernel, dev, seed: int = 3) -> dict:
    """A refinement round at a random state: the launcher's one launch
    against the parent's ``-r - structured_jvp(p, dx)`` (a launch and two
    torch operations), device us by graph replay and host us a round in
    turns (new, parent, parent, new), beside the bound of the new launch."""
    gen = torch.Generator().manual_seed(seed)
    shape = tuple(kernel.shape)
    p, q = ((2e5 + 1e4 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dev) for _ in range(2))
    dx = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
    arrays, coef = kernel._arrays(), kernel._coef()
    launcher = kernel._launcher
    r, rho = launcher.residual(p, q)
    c = -r

    def new():
        return launcher.refine(p, dx, c, rho)

    def old():
        return -r - kernels.structured_jvp(p, dx, *arrays, coef)

    turns = {"new": {"device_us": [], "host_us": []}, "parent": {"device_us": [], "host_us": []}}
    for route in ("new", "parent", "parent", "new"):
        fn = new if route == "new" else old
        turns[route]["device_us"].append(graph_us(fn))
        turns[route]["host_us"].append(host_us(fn))
    # Bytes the round must move: p, dx, c and rho, the transmissibilities,
    # the ghosts and pv read once, the result written once.
    size = nbytes(p, dx, c, rho, *arrays, coef) + 8 * p.numel()
    out = {"turns": turns, "bytes": size, "bound_us": 1e6 * size / HBM, "equal": torch.equal(new(), old()),
           "ms": cuda_ms(new), "plain_ms": cuda_ms(lambda: reference.structured_refine(p, dx, c, rho, *arrays, coef))}
    print(f"  a refinement round at {shape} f64, in turns: device us (graph replay) new "
          f"{['%.2f' % t for t in turns['new']['device_us']]}, parent {['%.2f' % t for t in turns['parent']['device_us']]}; "
          f"host us new {['%.1f' % t for t in turns['new']['host_us']]}, parent "
          f"{['%.1f' % t for t in turns['parent']['host_us']]}; bound {out['bound_us']:.3f} us; routes "
          f"{'equal to the bit' if out['equal'] else 'DIFFERENT'}; {out['ms']:.4f} ms by events, plain {out['plain_ms']:.4f} ms")
    return out


def _step_kernels(step, p, p_prev) -> dict:
    """The CUDA kernels of one ``step(p, p_prev)`` by name and the
    package's launch counters of one step."""
    return {"kernels": cuda_kernels(lambda: step(p, p_prev)), "counted": counted(lambda: step(p, p_prev))}


def steps_in_turns(kernel, dev, steps: int = 7) -> dict:
    """``newton_step`` against the parent's step from p = 2e5, ``steps``
    chained steps a turn, in turns (new, parent, parent, new): every
    iterate and residual norm to the bit, the solves' iteration counts, ms
    a step (median), and the kernels of one step by route."""
    shape = tuple(kernel.shape)
    p0 = torch.full(shape, 2.0e5, dtype=torch.float64, device=dev)
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
    equal = all(torch.equal(a, b) and torch.equal(ra, rb) for (a, ra), (b, rb) in zip(s_new, s_old))
    kernels_of = {route: _step_kernels(routes[route], p0, p0) for route in ("new", "parent")}
    # The launches around the linearization and the solves that the
    # refinement makes: the residual, the negations, the tangent or
    # refinement launches and, in the parent's route, one subtraction a
    # round (its torch additions beyond the new route's).
    for route, r in kernels_of.items():
        k = r["kernels"]
        own = sum(v for name, v in k.items() if name.startswith("structured_kernel<double")) + k.get("torch neg", 0)
        r["refinement_launches"] = own + (k.get("torch add", 0) - kernels_of["new"]["kernels"].get("torch add", 0))
    out = {"ms": ms, "equal": equal, "iterations": (it_new, it_old), "same_iterations": it_new == it_old,
           "step_kernels": kernels_of, "rnorm": [float(r) for _p, r in s_new]}
    print(f"  structured Newton steps at {shape}, {steps} chained from 2e5, in turns: ms a step (median) new "
          f"{['%.3f' % t for t in ms['new']]}, parent {['%.3f' % t for t in ms['parent']]}; iterates and |r| "
          f"{'equal to the bit' if equal else 'DIFFERENT'}; solves' iterations {'equal' if it_new == it_old else 'DIFFERENT'} "
          f"({it_new}); |r| {['%.3e' % r for r in out['rnorm']]}")
    for route, r in kernels_of.items():
        print(f"  one step, {route} route: {sum(r['kernels'].values())} CUDA kernels {r['kernels']}; counted "
              f"{r['counted']}; the residual and the refinement's launches {r['refinement_launches']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("structured_refine_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"the flow steps' residual/tangent kernels at {args.n}^3")
    flow_kernels(dev, args.n)
    kernel = fcc.structured_kernel(args.n, dev)
    with tempfile.TemporaryDirectory() as work:
        parent = ParentStructured(work)
        bits = check_launches(kernel, dev, parent)
    rnd = round_in_turns(kernel, dev)
    steps = steps_in_turns(kernel, dev)
    ok = all(bits.values()) and rnd["equal"] and steps["equal"] and steps["same_iterations"]
    print(f"structured_refine_check on {smi}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
