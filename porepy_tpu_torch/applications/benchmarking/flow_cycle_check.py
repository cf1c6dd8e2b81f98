"""The flow steps' BiCGStab on the card (K12's stencil and K13's cell-cell
matrix, :class:`~porepy_tpu_torch.kernels.FlowCycle`: two cooperative
launches a solve) and the linearizations that write their coefficients,
against their plain versions.

    python3 -m porepy_tpu_torch.applications.benchmarking.flow_cycle_check [--n 32]

At n^3 cells (default 32^3, the flow steps' size in ``chip_smoke.py``
phase 10), in f32 and f64, for the stencil and for TPFA, from a state
near 2e5 Pa and the normalized negative residual as the right-hand side,
it prints what ``nvcc -Xptxas -v`` reports for the three sources, holds
each linearization launch against its plain version (TPFA to the bit, the
stencil within ``TOL`` of
the largest coefficient) and every cycle launch of one solve (the start, 1
and 7 iterations, then the rest) against its plain version from the same
state (the same bits), and times: device µs an iteration (CUDA-graph
replay, the start's launch subtracted), host µs a launch, ms of a solve
(CUDA events) and of the plain solve on the card. ``chip_smoke.py`` phase
10b runs :func:`check` on phase 10's kernels. Needs a CUDA card and ``nvcc``;
exits non-zero when a kernel and its plain version differ.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import ptxas_report, same_bits

#: The stencil's linearization against its plain version, relative to the
#: largest coefficient (``exp`` and contractions differ by an ulp or two);
#: TPFA's equals its plain version to the bit.
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
#: Tolerance and iteration budget of each solve, as the Newton steps call
#: them: the structured f32 inner solve, its f64 variant
#: (``newton_step_f64``), the unstructured f64 solve; TPFA in f32 at the
#: structured inner solve's.
SOLVES = {
    ("stencil", torch.float32): (1e-6, 200),
    ("stencil", torch.float64): (1e-9, 400),
    ("tpfa", torch.float64): (1e-10, 200),
    ("tpfa", torch.float32): (1e-6, 200),
}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
_STATE = ("x", "r", "rhat", "p", "q", "phat", "s", "shat", "t", "partials", "st", "cont")
#: The flow steps' fluid on the unit box, with a linear Dirichlet pressure
#: in x (``chip_smoke.py`` phases 3b, 10 and 10b).
FLUID = dict(permeability=1.0, porosity=0.1, viscosity=1e-3, compressibility=1e-6,
             rho_ref=1000.0, p_ref=1.0e5, dt=1.0)


def bc_x(x, y, z):
    return 1e5 + 1e4 * (1 - np.asarray(x))


def bc_faces(fc):
    return 1e5 + 1e4 * (1 - fc[0])


def structured_kernel(n: int, dev):
    """The structured flow kernel of the n^3 unit box with :data:`FLUID`
    and the pressure of :func:`bc_x` on its boundary."""
    from porepy_tpu_torch.parallel.structured_flow import build_structured_flow_kernel

    return build_structured_flow_kernel((n,) * 3, (1.0, 1.0, 1.0), bc_pressure=bc_x, device=dev, **FLUID)[0]


def tpfa_kernel(n: int, dev):
    """The unstructured (``CartGrid``) twin of :func:`structured_kernel`."""
    from porepy_tpu_torch.parallel.flow_step import build_cart_flow_kernel

    return build_cart_flow_kernel([n] * 3, [1, 1, 1], bc_pressure=bc_faces, device=dev, **FLUID)[0]


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    H100's 3.35 TB/s and the operations over its peak outside the tensor
    cores (67 TFLOP/s f32, 34 f64)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def right_hand_side(kind: str, kernel, p, p_prev, dtype) -> torch.Tensor:
    """The Newton step's first right-hand side: ``-r / |r|`` in ``dtype``."""
    from porepy_tpu_torch import kernels

    if kind == "stencil":
        r = kernels.structured_residual(p, p_prev, *kernel._arrays(), kernel._coef())
    else:
        r = kernels.tpfa_residual(p, p_prev, *kernel._arrays(), kernel._coef())
    return (-r / torch.linalg.vector_norm(r)).to(dtype).reshape(-1).contiguous()


def linearization(kind: str, kernel, p, dtype) -> tuple:
    """``(cycle, launch, plain, jvp)`` of ``kernel`` linearized at ``p`` in
    ``dtype`` by its own ``_linearized``: its :class:`FlowCycle` over the
    buffers the Newton steps use, the linearization's launch into them and
    its plain version (both at ``p`` cast to ``dtype``), and ``(the jvp
    kernel, its arguments, the plain matvec over the coefficients)``."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference

    cycle = kernel._linearized(p, dtype)
    args = kernel._solvers[dtype][0]
    pd, out = p.to(dtype), cycle.op[-1]
    if kind == "stencil":
        return (cycle, lambda: kernels.structured_linearize(pd, *args, out),
                lambda: reference.structured_linearize(pd, *args),
                (kernels.structured_jvp, args, lambda v: reference.stencil_matvec(out, v.reshape(-1))))
    row_ptr, cols, _vals = cycle.op
    return (cycle, lambda: kernels.tpfa_linearize(pd, *args, out),
            lambda: reference.tpfa_linearize(pd, *args, out.shape[0]),
            (kernels.tpfa_jvp, args[:-2],
             lambda v: reference.ell_spmv_ordered(*reference.csr_ell(row_ptr, cols, out, v.shape[0]), v)))


def plain_solve(cycle, b, iterations: int, state, tol: float) -> None:
    """``cycle``'s launch of ``iterations`` by its plain version, on ``state``."""
    from porepy_tpu_torch.kernels import reference

    plain = reference.bicgstab_stencil if cycle.kind == "stencil" else reference.bicgstab_tpfa
    plain(*cycle.op, cycle.diag, b, *state, iterations, tol**2, 0.0)


def check(kind: str, kernel, p, p_prev, dtype, chunks=(1, 7), timing: bool = True) -> dict:
    """The linearization and one solve of ``kind`` at ``p`` in ``dtype``
    against their plain versions, on the buffers and the
    :class:`FlowCycle` of ``kernel``'s own linearization, and, with
    ``timing``, their times and bounds; see the head of the module."""
    from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us

    tol, maxiter = SOLVES[(kind, dtype)]
    cycle, launch, plain_lin, (jvp, jvp_args, matvec) = linearization(kind, kernel, p, dtype)
    out, want = cycle.op[-1], plain_lin()
    lin_err = float((out - want).abs().max())
    lin_scale = float(want.abs().max())
    v = torch.randn(p.shape, generator=torch.Generator(device=p.device).manual_seed(12), dtype=dtype,
                    device=p.device)
    want_jv = jvp(p.to(dtype), v, *jvp_args)
    jv_err = float((matvec(v).reshape(want_jv.shape) - want_jv).abs().max() / want_jv.abs().max())
    b = right_hand_side(kind, kernel, p, p_prev, dtype)
    state = cycle.state
    held, equal = 0, True
    for budget in (0,) + tuple(chunks) + (maxiter,):
        flag, k = state[-1].tolist()
        if budget:
            if not flag or k >= maxiter:
                break
            budget = min(budget, maxiter - k)
        plain = [t.clone() for t in state]
        cycle.launch(b, budget, tol)
        plain_solve(cycle, b, budget, plain, tol)
        same = [same_bits(g, w) for g, w in zip(state, plain)]
        equal &= all(same)
        held += 1
        if not all(same):
            print(f"    {kind} {str(dtype)[6:]} launch of {budget}: differs in "
                  f"{[n for n, s in zip(_STATE, same) if not s]}")
    flag, iters = state[-1].tolist()
    x = state[0].clone()
    res = float(torch.linalg.vector_norm(matvec(x).reshape(-1) - b) / torch.linalg.vector_norm(b))
    report = {
        "kind": kind, "dtype": str(dtype)[6:], "n": p.numel(), "grid": cycle.grid,
        "lin_err": lin_err, "lin_scale": lin_scale,
        "lin_ok": torch.equal(out, want) if kind == "tpfa" else lin_err <= TOL[dtype] * lin_scale,
        "jvp_rel": jv_err, "held": held,
        "equal": equal, "iterations": iters, "flag": flag, "res": res,
    }
    if not timing:
        return report
    n, s = b.shape[0], b.element_size()

    def solve():
        cycle.launch(b, 0, tol)
        cycle.launch(b, maxiter, tol)

    us_solve = graph_us(solve, launches=10, replays=3)
    us_start = graph_us(lambda: cycle.launch(b, 0, tol), launches=10, replays=3)
    solve()
    torch.cuda.synchronize()
    host = host_us(lambda: cycle.launch(b, maxiter, tol), 50)
    ms = cuda_ms(solve, 10)
    plain_state = [t.clone() for t in state]
    torch.cuda.synchronize()
    tic = time.perf_counter()
    plain_solve(cycle, b, 0, plain_state, tol)
    plain_solve(cycle, b, maxiter, plain_state, tol)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - tic)
    # An iteration: two matvecs (the stencil's 7 coefficient arrays; the
    # CSR's values, columns and row pointers), each row's input counted in
    # the 14 vector passes (r, p, q, diag twice, rhat twice, phat, s, shat,
    # t, x, and r and x written); ~13 operations a stencil row, 2 a
    # nonzero, ~30 a row for the rest.
    if kind == "stencil":
        mat_bytes, mat_flops = 7.0 * n * s, 13.0 * n
    else:
        nnz = cycle.op[1].numel()
        mat_bytes, mat_flops = float((s + 4) * nnz + 4 * (n + 1)), 2.0 * nnz
    bytes_it = 2.0 * mat_bytes + 14.0 * n * s
    flops_it = 2.0 * mat_flops + 30.0 * n
    bound_it = bound_ms(bytes_it, flops_it, dtype)
    # The linearization: p, its arguments once (the kernel's arrays and
    # scalars; TPFA's pattern slots too), the coefficients out.
    args = kernel._solvers[dtype][0]
    lin_in = p.numel() * s + sum(a.numel() * a.element_size() for a in args)
    lin_bound = bound_ms(lin_in + out.numel() * s, 60.0 * n, dtype)
    report.update(
        us_solve=us_solve, us_start=us_start, us_per_iteration=(us_solve - us_start) / max(iters, 1),
        host_us=host, ms=ms, plain_ms=plain_ms, bytes_it=bytes_it, bound_it=bound_it,
        bound=bound_ms(iters * bytes_it + n * 6 * s, iters * flops_it, dtype),
        lin_ms=cuda_ms(launch), lin_plain_ms=cuda_ms(plain_lin, 10), lin_bound=lin_bound,
    )
    return report


def describe(r: dict, smi: str) -> str:
    line = (f"{r['kind']} {r['dtype']}, {r['n']} rows, grid {r['grid']}: linearization within {r['lin_err']:.3e} of max {r['lin_scale']:.3e} "
            f"(ok {r['lin_ok']}), its matvec against the jvp {r['jvp_rel']:.3e}; {r['held']} cycle launches "
            f"held, same bits {r['equal']}; {r['iterations']} iterations, |J x - b| / |b| {r['res']:.3e}")
    if "ms" in r:
        line += (f"\n    on {smi}: device {r['us_per_iteration']:.3f} us an iteration (graph replay; a solve "
                 f"{r['us_solve']:.2f} us, its start {r['us_start']:.2f}), host {r['host_us']:.2f} us a launch, "
                 f"a solve {r['ms']:.4f} ms (events), plain {r['plain_ms']:.2f} ms; bound "
                 f"{1e3 * r['bound_it'][0]:.3f} us an iteration ({r['bound_it'][1]}, {r['bytes_it'] / 1e6:.2f} MB); "
                 f"linearization {r['lin_ms']:.4f} ms, plain {r['lin_plain_ms']:.4f}, bound "
                 f"{r['lin_bound'][0]:.5f} ms")
    return line


def iteration_floor(dev, sizes=(8, 16)) -> dict:
    """The f32 stencil solve's device µs an iteration at ``n^3`` for each
    ``n`` of ``sizes`` (few tiles, few blocks: what the 5 grid syncs and
    the reductions cost with almost no work), checked as :func:`check`
    does."""
    out = {}
    for n in sizes:
        ks = structured_kernel(n, dev)
        gen = torch.Generator().manual_seed(n)
        p = (2e5 + 1e4 * torch.randn((n,) * 3, generator=gen, dtype=torch.float64)).to(dev)
        out[n] = check("stencil", ks, p, torch.full_like(p, 2e5), torch.float32)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=32)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flow_cycle_check: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.library()
    print(f"kernels built in {build.build_seconds():.2f} s")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(build.CSRC, f) for f in ("krylov.cu", "structured_flow.cu", "tpfa_flow.cu")],
                     work)
    ks, ku = structured_kernel(args.n, dev), tpfa_kernel(args.n, dev)
    gen = torch.Generator().manual_seed(10)
    ok = True
    for kind, kernel, shape in (("stencil", ks, (args.n,) * 3), ("tpfa", ku, (ku.num_cells,))):
        p = (2e5 + 1e4 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dev)
        p_prev = torch.full(shape, 2e5, dtype=torch.float64, device=dev)
        for dtype in (torch.float32, torch.float64):
            r = check(kind, kernel, p, p_prev, dtype)
            print(describe(r, smi))
            ok &= r["equal"] and r["lin_ok"]
    for n, r in iteration_floor(dev).items():
        print(f"{n}^3: " + describe(r, smi))
        ok &= r["equal"] and r["lin_ok"]
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
