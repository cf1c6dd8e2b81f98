"""The one-launch Krylov kernels on the card (K18a ``bicgstab_cycle``, a
BiCGStab solve; K18b ``gmres_cycle``, a GMRES(30) restart) against their
plain versions, and K18a against the launches it replaced.

    python3 -m porepy_tpu_torch.applications.benchmarking.krylov_cycle_check [--old-dir DIR]

On the first Newton system of the biot case at cell size 1/64 (12,288
dofs) it prints what ``nvcc -Xptxas -v`` reports for ``krylov.cu``
(registers, shared memory, spills) and both cooperative grids; holds every
GMRES restart of one solve, and every BiCGStab launch of one solve run in
chunks (the start, 1 and 7 iterations, then the rest), against its plain
version from the same state (the same bits expected); and, with
``--old-dir`` (a directory holding a ``krylov.cu`` whose eight BiCGStab
kernels ran each iteration around two K1 launches, with a host flag read),
runs that route's whole solve and compares every vector, the scalars and
the iteration count with the kernel's. Then, by CUDA events, the ms of one
restart, of one BiCGStab solve's launch (its µs per iteration) and of the
old route's solve, and the host µs of a launch. Needs a CUDA card and
``nvcc``; exits non-zero when a kernel and its plain version differ.
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

_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
_GMRES = ("x", "V", "H", "y", "w", "partials", "flags", "st", "cont")
_BICG = ("x", "r", "rhat", "p", "q", "phat", "s", "shat", "t", "partials", "st", "cont")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def ptxas_report(sources, workdir) -> None:
    """``nvcc -Xptxas -v`` of each source, the lines about its kernels."""
    for src in sources:
        out = subprocess.run(
            [_nvcc(), *_CFLAGS, "-Xptxas", "-v", "-c", src, "-o", os.path.join(workdir, "x.o")],
            capture_output=True, text=True,
        )
        print(f"ptxas {os.path.basename(src)} (exit {out.returncode}):")
        for line in out.stderr.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line or "spill" in line):
                print("   ", line.strip())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, NaN where the other is NaN (a breakdown's 0/0)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan], b[~nan])


def first_newton_system(dev, cell_size: float = 1.0 / 64):
    """The first Newton system of the biot case, host-assembled (scipy)."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_biot

    Model, params = build_biot(cell_size, device=str(dev))
    params.pop("fused_time_steps")
    params.pop("fused_commit_states")
    params["linear_solver"] = "jax_gmres"
    model = Model(params)
    model.prepare_simulation()
    model.before_nonlinear_loop()
    model.before_nonlinear_iteration()
    model.assemble_linear_system()
    A, b = model.linear_system
    return A.tocsr(), np.asarray(b)


def _operands(A, b, dev):
    from porepy_tpu_torch.numerics.linalg import krylov

    csr = krylov.csr_arrays(A, dev)
    dinv = torch.tensor(krylov._inverse_diagonal(A), device=dev)
    return csr, dinv, torch.tensor(b, device=dev), float(b @ b)


# -- K18a -------------------------------------------------------------------------


def old_library(old_dir: str, workdir: str) -> ctypes.CDLL:
    """The replaced ``krylov.cu`` (its eight-launch BiCGStab kernels) built
    into a library with a plain C interface."""
    so = os.path.join(workdir, "old_k18a.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(old_dir, "krylov.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "ppt_bicgstab_p_f64": [P] * 6 + [I, P],
        "ppt_krylov_dots_f64": [P] * 5 + [I, I, P],
        "ppt_bicgstab_s_f64": [P] * 7 + [I, P],
        "ppt_bicgstab_xr_f64": [P] * 9 + [I, P],
        "ppt_bicgstab_scalars_f64": [P] * 3 + [I, I, P],
    }
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def old_bicgstab(lib, A, b, dev, atol2: float, maxiter: int) -> tuple:
    """The replaced route's whole solve: per iteration the eight K18a
    launches and two K1 launches (the ELL matrix's launcher), the continue
    flag read on the host. Returns ``([x, r, rhat, p, q, phat, s, shat, t],
    st, iterations)``."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference
    from porepy_tpu_torch.numerics.ad.compiler import _device_const_matrix
    from porepy_tpu_torch.numerics.linalg import krylov

    mat = _device_const_matrix(A, dev)
    mv = kernels.EllOperator(mat.val, mat.col)
    _csr, dinv, bt, _b_dot = _operands(A, b, dev)
    n = A.shape[0]

    def call(name, *args):
        ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        rc = getattr(lib, f"ppt_{name}_f64")(*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.zeros(n, **f64)
    r = bt - mv(x)
    rhat, p, q = r.clone(), r.clone(), r.clone()
    phat, s, shat, t = (torch.zeros(n, **f64) for _ in range(4))
    partials = torch.zeros(3, -(-n // reference.KRYLOV_BLOCK), **f64)
    st = krylov.bicgstab_state(n, atol2, dev)[-2]
    cont = torch.zeros(1, dtype=torch.int32, device=dev)
    call("krylov_dots", r, r, r, r, partials, n, 1)
    call("bicgstab_scalars", partials, st, cont, n, reference.STAGE_INIT)
    k = 0
    while k < maxiter and bool(cont):
        call("bicgstab_p", r, q, dinv, st, p, phat, n)
        q = mv(phat)
        call("krylov_dots", rhat, q, rhat, q, partials, n, 1)
        call("bicgstab_scalars", partials, st, cont, n, reference.STAGE_ALPHA)
        call("bicgstab_s", r, q, dinv, st, s, shat, partials, n)
        t = mv(shat)
        call("krylov_dots", t, s, t, t, partials[1:], n, 2)
        call("bicgstab_scalars", partials, st, cont, n, reference.STAGE_OMEGA)
        call("bicgstab_xr", x, r, phat, shat, s, t, rhat, st, partials, n)
        call("bicgstab_scalars", partials, st, cont, n, reference.STAGE_NEXT)
        k += 1
    return [x, r, rhat, p, q, phat, s, shat, t], st, k


def compare_bicgstab(A, b, dev, chunks=(1, 7)) -> dict:
    """One BiCGStab solve by the kernel: the start, launches of ``chunks``
    iterations, then one of the rest; each launch against the plain version
    from the same state."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference
    from porepy_tpu_torch.numerics.linalg import krylov

    csr, dinv, bt, b_dot = _operands(A, b, dev)
    n = A.shape[0]
    maxiter = max(200, 4 * n)
    atol2 = 1e-24 * b_dot
    state = krylov.bicgstab_state(n, atol2, dev)
    report = {"plain_equal": True, "launches": 0}
    for budget in (0,) + tuple(chunks) + (maxiter,):
        flag, k = state[-1].tolist()
        if budget and not flag:
            break
        budget = min(budget, maxiter - k)
        plain = [t.clone() for t in state]
        kernels.bicgstab_cycle(*csr, dinv, bt, *state, budget)
        reference.bicgstab_cycle(*csr, dinv, bt, *plain, budget)
        same = {name: same_bits(g, w) for name, g, w in zip(_BICG, state, plain)}
        report["plain_equal"] &= all(same.values())
        report["launches"] += 1
        label = f"launch of {budget} iterations" if budget else "start"
        print(f"  bicgstab {label}: kernel == plain {same}; iterations {state[-1].tolist()[1]}")
    report["iterations"] = int(state[-1][1])
    report["state"] = state
    report["res"] = float(np.linalg.norm(b - A @ state[0].cpu().numpy()) / np.linalg.norm(b))
    return report


def time_bicgstab(A, b, dev, repeats: int = 5) -> dict:
    """ms of one BiCGStab solve's launch (every iteration, from the state
    after the start; CUDA events, the restore of that state subtracted), its
    iterations and µs per iteration, and host µs of a launch call."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.numerics.linalg import krylov

    csr, dinv, bt, b_dot = _operands(A, b, dev)
    n = A.shape[0]
    maxiter = max(200, 4 * n)
    state = krylov.bicgstab_state(n, 1e-24 * b_dot, dev)
    kernels.bicgstab_cycle(*csr, dinv, bt, *state, 0)
    saved = [t.clone() for t in state]

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)

    def solve():
        kernels.bicgstab_cycle(*csr, dinv, bt, *state, maxiter)

    restore()
    solve()
    torch.cuda.synchronize()
    iters = int(state[-1][1])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    for _ in range(repeats):
        restore()
    ev[1].record()
    for _ in range(repeats):
        restore()
        solve()
    ev[2].record()
    torch.cuda.synchronize()
    ms = (ev[1].elapsed_time(ev[2]) - ev[0].elapsed_time(ev[1])) / repeats
    # A launch on the solved state runs no iteration: the host's part alone.
    tic = time.perf_counter()
    for _ in range(50):
        solve()
    host_us = 1e6 * (time.perf_counter() - tic) / 50
    torch.cuda.synchronize()
    return {"ms": ms, "iterations": iters, "us_per_iteration": 1e3 * ms / iters, "host_us": host_us}


# -- K18b -------------------------------------------------------------------------


def compare_gmres(A, b, dev, max_restarts: int = 40) -> dict:
    """Every restart of one solve by the kernel and its plain version, each
    from the kernel's state."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference
    from porepy_tpu_torch.numerics.linalg import krylov

    csr, dinv, bt, b_dot = _operands(A, b, dev)
    state = krylov.gmres_state(A.shape[0], 30, 1e-12 * np.sqrt(b_dot), dev)
    report = {"plain_equal": True, "restarts": 0}
    for arnoldi in [0] + [1] * max_restarts:
        if arnoldi and not bool(state[-1]):
            break
        plain = [t.clone() for t in state]
        kernels.gmres_cycle(*csr, dinv, bt, *state, arnoldi)
        reference.gmres_cycle(*csr, dinv, bt, *plain, arnoldi)
        same = [torch.equal(k, p) for k, p in zip(state, plain)]
        report["plain_equal"] &= all(same)
        label = f"restart {report['restarts']}" if arnoldi else "start"
        print(f"  gmres {label}: kernel == plain {dict(zip(_GMRES, same))}; residual norm {float(state[7][1]):.3e}")
        report["restarts"] += arnoldi
    report["res"] = float(np.linalg.norm(b - A @ state[0].cpu().numpy()) / np.linalg.norm(b))
    return report


def time_restart(A, b, dev, repeats: int = 20) -> float:
    """ms of one GMRES(30) restart (one launch) from the state after the
    start of a solve: CUDA events, the restore of that state subtracted."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.numerics.linalg import krylov

    csr, dinv, bt, b_dot = _operands(A, b, dev)
    state = krylov.gmres_state(A.shape[0], 30, 1e-12 * np.sqrt(b_dot), dev)
    kernels.gmres_cycle(*csr, dinv, bt, *state, 0)
    saved = [t.clone() for t in state]
    work = [t.clone() for t in state]

    def restore():
        for t, s in zip(work, saved):
            t.copy_(s)

    restore()
    kernels.gmres_cycle(*csr, dinv, bt, *work, 1)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    for _ in range(repeats):
        restore()
    ev[1].record()
    for _ in range(repeats):
        restore()
        kernels.gmres_cycle(*csr, dinv, bt, *work, 1)
    ev[2].record()
    torch.cuda.synchronize()
    return (ev[1].elapsed_time(ev[2]) - ev[0].elapsed_time(ev[1])) / repeats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-dir", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("krylov_cycle_check: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.library()
    print(f"kernels built in {build.build_seconds():.2f} s")
    ok = True
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(build.CSRC, "krylov.cu")], work)
        tic = time.perf_counter()
        A, b = first_newton_system(dev)
        n = A.shape[0]
        print(f"biot 1/64 first Newton system: n {n}, nnz {A.nnz}, built in "
              f"{time.perf_counter() - tic:.1f} s; grids: bicgstab_cycle "
              f"{kernels.bicgstab_cycle_grid(n)}, gmres_cycle {kernels.gmres_cycle_grid(n)} blocks of 128")
        bicg = compare_bicgstab(A, b, dev)
        print(f"bicgstab: {bicg['iterations']} iterations in {bicg['launches']} launches, |b - A x| / |b| "
              f"{bicg['res']:.3e}, every launch kernel == plain: {bicg['plain_equal']}")
        gm = compare_gmres(A, b, dev)
        print(f"gmres: {gm['restarts']} restarts, |b - A x| / |b| {gm['res']:.3e}, every restart "
              f"kernel == plain: {gm['plain_equal']}")
        ok = bicg["plain_equal"] and gm["plain_equal"]
        t = time_bicgstab(A, b, dev)
        print(f"bicgstab_cycle on {smi}: one solve's launch {t['ms']:.4f} ms for {t['iterations']} iterations, "
              f"{t['us_per_iteration']:.2f} us an iteration; {t['host_us']:.2f} us of host time a launch")
        print(f"gmres_cycle on {smi}: {time_restart(A, b, dev):.4f} ms a restart")
        if args.old_dir:
            _csr, _dinv, _bt, b_dot = _operands(A, b, dev)
            lib = old_library(args.old_dir, work)
            maxiter = max(200, 4 * n)
            torch.cuda.synchronize()
            tic = time.perf_counter()
            vecs, st, k = old_bicgstab(lib, A, b, dev, 1e-24 * b_dot, maxiter)
            torch.cuda.synchronize()
            old_ms = 1e3 * (time.perf_counter() - tic)
            new = bicg["state"]
            same = {name: same_bits(g, w) for name, g, w in zip(_BICG[:9] + ("st",), new[:9] + [new[10]], vecs + [st])}
            rel = float((new[0] - vecs[0]).abs().max()) / float(vecs[0].abs().max())
            print(f"bicgstab against the eight-launch route: iterations {bicg['iterations']} and {k}; same bits "
                  f"{same}; max |x - x_old| / max |x_old| {rel:.3e}; the old route's solve {old_ms:.2f} ms "
                  f"(host clock, {k} flag reads)")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
