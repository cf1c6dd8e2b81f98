"""The one-launch GMRES(30) restart (K18b, ``gmres_cycle``) on the card,
against its plain version and against the launches it replaced.

    python3 -m porepy_tpu_torch.applications.benchmarking.gmres_cycle_check [--old-dir DIR]

On the first Newton system of the biot case at cell size 1/64 (12,288
dofs) it prints what ``nvcc -Xptxas -v`` reports for ``krylov.cu`` and
``ell_spmv.cu`` (registers, shared memory, spills), the cooperative grid,
and for every restart of one solve, each run from the same state: the
kernel against its plain version (the same bits expected) and, with
``--old-dir`` (a directory holding the ``krylov.cu`` and ``ell_spmv.cu``
that this design replaced: seven K18b kernels around K1 matvecs, 125
launches a restart), against that route, with the largest difference of
each array relative to its largest entry. Then the ms of one restart by
each route (CUDA events) and the whole solves. Needs a CUDA card and
``nvcc``; exits non-zero when the kernel and its plain version differ.
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
_NAMES = ("x", "V", "H", "y", "w", "partials", "flags", "st", "cont")


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


def old_library(old_dir: str, workdir: str) -> ctypes.CDLL:
    """The replaced ``krylov.cu`` and ``ell_spmv.cu`` built into one
    library with a plain C interface."""
    so = os.path.join(workdir, "old_k18b.so")
    cmd = [_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
           os.path.join(old_dir, "krylov.cu"), os.path.join(old_dir, "ell_spmv.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "ppt_ell_spmv_f64": [P] * 4 + [I] * 4 + [P],
        "ppt_cgs_project_f64": [P] * 6 + [I, I, P],
        "ppt_cgs_update_f64": [P] * 4 + [I, I, P],
        "ppt_cgs_normalize_f64": [P] * 5 + [I, I, I, P],
        "ppt_gmres_lstsq_f64": [P] * 3 + [I, P],
        "ppt_gmres_correct_f64": [P] * 3 + [I, I, P],
        "ppt_gmres_residual_f64": [P] * 5 + [I, P],
        "ppt_gmres_restart_f64": [P] * 7 + [I, I, P],
    }
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def old_route(lib, val, col, dinv, b):
    """One restart (``arnoldi=1``) or the start of a solve through the
    replaced launches, on the same state as ``gmres_cycle``."""
    n, K = val.shape

    def call(name, *args):
        ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        rc = getattr(lib, f"ppt_{name}_f64")(*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def mv(v):
        y = torch.empty(n, dtype=torch.float64, device=v.device)
        call("ell_spmv", val, col, v.contiguous(), y, n, K, n, 1)
        return y

    def restart(state, arnoldi):
        x, V, H, y, w, partials, flags, st, cont = state
        R = H.shape[0]
        if arnoldi:
            for k in range(R):
                call("cgs_project", mv(V[k]), dinv, V, w, partials, flags, n, k)
                call("cgs_update", V, w, partials, flags, n, k)
                call("cgs_normalize", w, V, H, partials, flags, n, k, R)
            call("gmres_lstsq", H, st, y, R)
            call("gmres_correct", V, y, x, n, R)
        call("gmres_residual", b, mv(x), dinv, w, partials, n)
        call("gmres_restart", w, V, H, partials, flags, st, cont, n, R)

    return restart


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


def _rel(a, b) -> float:
    if a.dtype != torch.float64:
        return float((a != b).sum())
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / (scale or 1.0) if b.numel() else 0.0


def compare(A, b, dev, old=None, max_restarts: int = 40) -> dict:
    """Every restart of one solve by the kernel, its plain version and (with
    ``old``) the replaced route, each from the kernel's state."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import reference
    from porepy_tpu_torch.numerics.linalg import krylov

    n = A.shape[0]
    csr = krylov.csr_arrays(A, dev)
    dinv = torch.tensor(krylov._inverse_diagonal(A), device=dev)
    bt = torch.tensor(b, device=dev)
    atol = 1e-12 * float(np.linalg.norm(b))
    state = krylov.gmres_state(n, 30, atol, dev)
    val, col = reference.csr_ell(*csr, n)
    old_restart = None if old is None else old_route(old, val, col, dinv, bt)
    report = {"plain_equal": True, "old_rel": {k: 0.0 for k in _NAMES}, "restarts": 0}
    for arnoldi in [0] + [1] * max_restarts:
        if arnoldi and not bool(state[-1]):
            break
        plain = [t.clone() for t in state]
        before = [t.clone() for t in state]
        kernels.gmres_cycle(*csr, dinv, bt, *state, arnoldi)
        reference.gmres_cycle(*csr, dinv, bt, *plain, arnoldi)
        same = [torch.equal(k, p) for k, p in zip(state, plain)]
        label = f"restart {report['restarts']}" if arnoldi else "start"
        line = f"  {label}: kernel == plain {dict(zip(_NAMES, same))}"
        report["plain_equal"] &= all(same)
        if old_restart is not None:
            old_state = before
            old_restart(old_state, arnoldi)
            rel = {k: _rel(s, o) for k, s, o in zip(_NAMES, state, old_state)}
            for k, v in rel.items():
                report["old_rel"][k] = max(report["old_rel"][k], v)
            line += "; |kernel - old route| / max " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        print(line, f"; residual norm {float(state[7][1]):.3e}")
        report["restarts"] += arnoldi
    x = state[0].cpu().numpy()
    report["res"] = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    report["x"] = state[0]
    report["args"] = (csr, dinv, bt, atol, val, col)
    return report


def time_restart(A, b, dev, args, old=None, repeats: int = 20) -> dict:
    """ms of one restart from the state after the start of a solve: the
    kernel (one launch), and the replaced route (125 launches)."""
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.numerics.linalg import krylov

    csr, dinv, bt, atol, val, col = args
    n = A.shape[0]
    state = krylov.gmres_state(n, 30, atol, dev)
    kernels.gmres_cycle(*csr, dinv, bt, *state, 0)
    saved = [t.clone() for t in state]
    work = [t.clone() for t in state]

    def restore():
        for t, s in zip(work, saved):
            t.copy_(s)

    routes = {"kernel": lambda: kernels.gmres_cycle(*csr, dinv, bt, *work, 1)}
    if old is not None:
        restart = old_route(old, val, col, dinv, bt)
        routes["old"] = lambda: restart(work, 1)
    out = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for name in list(routes) + list(routes):
        run = routes[name]
        restore()
        run()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(repeats):
            restore()
        ev[1].record()
        for _ in range(repeats):
            restore()
            run()
        ev[2].record()
        torch.cuda.synchronize()
        ms = (ev[1].elapsed_time(ev[2]) - ev[0].elapsed_time(ev[1])) / repeats
        out.setdefault(name, []).append(ms)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-dir", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gmres_cycle_check: no CUDA device available", file=sys.stderr)
        return 1
    from porepy_tpu_torch import kernels
    from porepy_tpu_torch.kernels import build
    from porepy_tpu_torch.numerics.linalg import krylov

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.library()
    print(f"kernels built in {build.build_seconds():.2f} s")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(build.CSRC, s) for s in ("krylov.cu", "ell_spmv.cu")], work)
        old = old_library(args.old_dir, work) if args.old_dir else None
        tic = time.perf_counter()
        A, b = first_newton_system(dev)
        print(f"biot 1/64 first Newton system: n {A.shape[0]}, nnz {A.nnz}, "
              f"built in {time.perf_counter() - tic:.1f} s; gmres_cycle grid "
              f"{kernels.gmres_cycle_grid(A.shape[0])} blocks of 128 threads")
        rep = compare(A, b, dev, old)
        print(f"restarts {rep['restarts']}, |b - A x| / |b| {rep['res']:.3e}, every restart kernel == plain: "
              f"{rep['plain_equal']}; largest |kernel - old route| / max over the restarts {rep['old_rel']}")
        if old is not None:
            x_new, _ = krylov._gmres_fused(rep["args"][0], rep["args"][2], rep["args"][1],
                                           rep["args"][3], 4 * A.shape[0], 30)
            print(f"whole solve by the kernel: max |x - x of the held run| {float((x_new - rep['x']).abs().max()):.3e}")
        times = time_restart(A, b, dev, rep["args"], old)
        print(f"ms per restart on {smi} (CUDA events, 20 restarts from one state, restore subtracted): {times}")
    return 0 if rep["plain_equal"] else 2


if __name__ == "__main__":
    sys.exit(main())
