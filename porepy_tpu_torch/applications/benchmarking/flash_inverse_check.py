"""K17 (the constant-K flash) and K11 (the batched block inverse) on the
card, against their plain versions and the parent's kernels.

    python3 -m porepy_tpu_torch.applications.benchmarking.flash_inverse_check

The parent's kernels are built from ``flash.cu`` and ``block_inverse.cu`` in
``parent_flash_inverse/`` beside this script (every flash point iterating to
a fixed point or ``max_iter``; Gauss-Jordan on ``[A | I]`` with warp 0's
pivot search) and called as the parent's wrappers called them. They are
the yardstick only; no path of the package calls them.

The script prints what ``nvcc -Xptxas -v`` reports for both pairs of
sources; then

- K17 at 2048² points, nc = 2 and 3 (``chip_smoke.py`` phase 15's
  generator and K-values): the kernel's V, x, y and flags against the
  parent's kernel (to the bit: both end at the ``max_iter``-th iterate) and
  against the plain version (to the bit, and the same iteration counts),
  the iterations a point needs (mean, the mean over warps of each warp's
  slowest lane, the points at ``max_iter``), and the kernel's two launches
  and the parent's one timed in turns by CUDA events over back-to-back
  calls;
- K11 at (1374, 81) and (3969, 20) (the biot region batches' shapes), dense
  and with the real batches' share of zeros, (3, 160) and (64, 20): seeded
  blocks, rows scaled over six decades so that every block swaps rows; the kernel against its plain version (to the
  bit) and the parent's (1e-12 of the largest entry), the residual, and the
  kernel, the parent and ``torch.linalg.inv_ex`` in turns, by CUDA events
  over back-to-back calls and, for the kernel and the parent, by CUDA-graph
  replay (device µs a call; ``inv_ex`` refuses a stream capture).

Each time is printed beside its bound: the larger of the bytes (each input
read once, each output written once) over 3.35 TB/s and the operations
(for K17 the iterations these inputs need) over 34 TFLOP/s (f64). Needs a
CUDA card and ``nvcc``; exits non-zero when a check fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us
from porepy_tpu_torch.kernels import LAUNCHES, ops, reference

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_flash_inverse")
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12
N_POINTS = 2048 * 2048
FLASH_K = {2: [2.5, 0.3], 3: [3.0, 0.8, 0.2]}
# (B, n, share of zero entries): the biot region batches' shapes, dense and
# with their own share of zeros (96% at 81, 87% at 20, chip_smoke.py phase
# 11's matrices), and two more sizes.
INVERSE_SHAPES = ((1374, 81, 0.0), (1374, 81, 0.96), (3969, 20, 0.0), (3969, 20, 0.87), (3, 160, 0.0),
                  (64, 20, 0.0))
#: Back-to-back calls a timing.
REPS = 10
#: The iterations of K17's first launch (``flash.cu``'s ``kTailCap``).
TAIL_CAP = 12
_PARENT = {}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"flash_inverse_check failed: {what}")


def bound_ms(nbytes: float, flops: float) -> tuple:
    """``(ms, "bytes" or "operations")`` of f64 work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(iters: torch.Tensor, nc: int) -> tuple:
    """K17's bound at these inputs (``reference.flash_work``)."""
    return bound_ms(*reference.flash_work(iters, nc))


def inverse_bound(batch: int, n: int) -> tuple:
    """K11's bound: the batch in and the inverses out; 2 n^3 operations a
    block."""
    return bound_ms(2 * 8.0 * batch * n * n, 2.0 * batch * n**3)


# -- the parent's kernels ---------------------------------------------------------


def parent_library(workdir: str) -> ctypes.CDLL:
    """The parent's ``flash.cu`` and ``block_inverse.cu`` built with ``nvcc``
    into one library with a plain C interface."""
    if "lib" not in _PARENT:
        so = os.path.join(workdir, "parent_k17_k11.so")
        srcs = [os.path.join(PARENT_DIR, f) for f in ("flash.cu", "block_inverse.cu")]
        subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so, *srcs], check=True)
        lib = ctypes.CDLL(so)
        P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        lib.ppt_rachford_rice_f64.argtypes = [P] * 7 + [I, L, I, D, P]
        lib.ppt_block_inverse_f64.argtypes = [P] * 3 + [I, I, P]
        lib.ppt_rachford_rice_f64.restype = lib.ppt_block_inverse_f64.restype = ctypes.c_int
        _PARENT["lib"] = lib
    return _PARENT["lib"]


def parent_flash(zs, K, max_iter: int, tol: float):
    """The parent's K17 launch with its wrapper's allocations."""
    nc, n = zs.shape
    V = torch.empty(n, dtype=zs.dtype, device=zs.device)
    x, y = torch.empty_like(zs), torch.empty_like(zs)
    conv = torch.empty(n, dtype=torch.bool, device=zs.device)
    iters = torch.empty(n, dtype=torch.int32, device=zs.device)
    rc = _PARENT["lib"].ppt_rachford_rice_f64(
        zs.data_ptr(), K.data_ptr(), V.data_ptr(), x.data_ptr(), y.data_ptr(), conv.data_ptr(),
        iters.data_ptr(), nc, n, max_iter, float(tol), torch.cuda.current_stream().cuda_stream)
    _require(rc == 0, f"parent rachford_rice: CUDA error {rc}")
    return V, x, y, conv, iters


def parent_inverse(a):
    """The parent's K11 launch with its wrapper's allocations ([A | I] in a
    workspace above n = 120)."""
    B, n = a.shape[0], a.shape[1]
    out = torch.empty_like(a)
    work = None
    if 8 * n * (2 * n + 1) > ops._SMEM_MAX:
        work = torch.empty((B, n, 2 * n), dtype=a.dtype, device=a.device)
    rc = _PARENT["lib"].ppt_block_inverse_f64(
        a.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), B, n,
        torch.cuda.current_stream().cuda_stream)
    _require(rc == 0, f"parent block_inverse: CUDA error {rc}")
    return out


# -- K17 ------------------------------------------------------------------------------


def flash_inputs(nc: int, dev, n: int = N_POINTS):
    """``chip_smoke.py`` phase 15's feeds: ``(zs, K)`` on ``dev``."""
    raw = np.random.default_rng(15 + nc).random((nc, n)) + 0.02
    return torch.tensor(raw / raw.sum(axis=0), device=dev), torch.tensor(FLASH_K[nc], dtype=torch.float64, device=dev)


def check_flash(dev, reps: int) -> dict:
    """K17 at 2048² points, in turns with the parent."""
    out = {}
    for nc in (2, 3):
        zs, K = flash_inputs(nc, dev)
        parent = parent_flash(zs, K, 150, 1e-8)
        got = ops.rachford_rice(zs, K, 150, 1e-8)
        want = reference.rachford_rice(zs, K, 150, 1e-8)
        torch.cuda.synchronize()
        for name, g, p, w in zip(("V", "x", "y", "converged"), got, parent, want):
            _require(reference.same_bits(g, p), f"nc {nc}: {name} differs from the parent's")
            _require(reference.same_bits(g, w), f"nc {nc}: {name} differs from the plain version's")
        _require(torch.equal(got[4], want[4]), f"nc {nc}: iteration counts differ from the plain version's")
        for tag, iters in (("kernel", got[4]), ("parent", parent[4])):
            stats = reference.flash_iteration_stats(iters, 150)
            print(f"  K17 nc {nc}, {tag}: iterations mean {stats['mean']:.3f}, warp's slowest lane "
                  f"{stats['warp_slowest']:.3f}, {stats['at_max']} points at 150")
        print(f"  K17 nc {nc}: V, x, y, flags the parent's and the plain version's to the bit, the plain "
              f"version's counts; {int((want[4] > TAIL_CAP).sum())} points in the second launch")
        bound = flash_bound(want[4], nc)
        parent_bound = flash_bound(parent[4], nc)
        timed = {"parent": lambda: parent_flash(zs, K, 150, 1e-8), "kernel": lambda: ops.rachford_rice(zs, K, 150, 1e-8)}
        order = list(timed) + list(reversed(timed))
        ms = {k: [] for k in timed}
        for k in order:
            ms[k].append(cuda_ms(timed[k], reps))
        for k, v in ms.items():
            print(f"  K17 nc {nc}, {k}: {', '.join(f'{t:.4f}' for t in v)} ms (in turns); bound {bound[0]:.4f} ms "
                  f"({bound[1]}), {100 * bound[0] / min(v):.1f}% of it")
        print(f"  K17 nc {nc}: the parent's own bound (its iterations) {parent_bound[0]:.4f} ms ({parent_bound[1]})")
        out[nc] = {"ms": ms, "bound": bound}
    return out


# -- K11 ------------------------------------------------------------------------------


def inverse_inputs(batch: int, n: int, dev, zeros: float = 0.0, seed: int = 11):
    """Seeded well-conditioned blocks with rows scaled over six decades and
    the share ``zeros`` of the off-diagonal entries set to 0."""
    gen = np.random.default_rng(seed + n)
    a = gen.standard_normal((batch, n, n)) + 0.5 * n * np.eye(n)
    a[(gen.random((batch, n, n)) < zeros) & ~np.eye(n, dtype=bool)] = 0.0
    a *= 10.0 ** gen.uniform(-3, 3, (batch, n, 1))
    return torch.tensor(a, device=dev)


def check_inverse(dev, reps: int) -> dict:
    """K11 at each shape, in turns with the parent and ``inv_ex``."""
    out = {}
    for B, n, zeros in INVERSE_SHAPES:
        A = inverse_inputs(B, n, dev, zeros)
        label = f"({B}, {n}" + (f", {zeros:.0%} zeros)" if zeros else ")")
        before = LAUNCHES["block_inverse"]
        X = ops.block_inverse(A)
        torch.cuda.synchronize()
        _require(LAUNCHES["block_inverse"] == before + 1, f"{label}: not one launch")
        W = reference.block_inverse(A)
        P = parent_inverse(A)
        scale = float(W.abs().max())
        equal = torch.equal(X, W)
        err_parent = float((X - P).abs().max())
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        norms = A.abs().sum(2).amax(1) * X.abs().sum(2).amax(1)
        resid = float(((A @ X - eye).abs().amax(dim=(1, 2)) / norms).max())
        print(f"  K11 {label}: equal to the plain version: {equal} (max |diff| "
              f"{float((X - W).abs().max()):.3e}); max |kernel - parent| {err_parent:.3e} (max {scale:.3e}); "
              f"max |A X - I| / (||A|| ||X||) {resid:.3e}")
        _require(float((X - W).abs().max()) <= 1e-12 * scale, f"{label}: kernel and plain version differ")
        _require(err_parent <= 1e-12 * scale, f"{label}: kernel and parent differ")
        _require(resid <= 1e-10, f"{label}: residual {resid}")
        timed = {
            "kernel": lambda: ops.block_inverse(A),
            "parent": lambda: parent_inverse(A),
            "inv_ex": lambda: torch.linalg.inv_ex(A),
        }
        order = list(timed) + list(reversed(timed))
        ms = {k: [] for k in timed}
        us = {k: [] for k in timed}
        for k in order:
            ms[k].append(cuda_ms(timed[k], reps))
            # torch.linalg.inv_ex refuses a stream capture: events alone.
            us[k].append(float("nan") if k == "inv_ex" else graph_us(timed[k], launches=10, replays=5))
        bound = inverse_bound(B, n)
        for k in timed:
            print(f"  K11 {label}, {k}: {', '.join(f'{t:.4f}' for t in ms[k])} ms by events, "
                  f"{', '.join(f'{t:.2f}' for t in us[k])} us device (graph replay); bound {bound[0]:.4f} ms "
                  f"({bound[1]}), {100 * bound[0] / min(ms[k]):.1f}% of it by events")
        out[(B, n, zeros)] = {"ms": ms, "us": us, "bound": bound, "equal": equal}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_inverse_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"flash_inverse_check on {torch.cuda.get_device_name(0)} ({smi})")
    csrc = os.path.join(os.path.dirname(ops.__file__), "csrc")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(csrc, "flash.cu"), os.path.join(csrc, "block_inverse.cu"),
                      os.path.join(PARENT_DIR, "flash.cu"), os.path.join(PARENT_DIR, "block_inverse.cu")], work)
        parent_library(work)
        check_inverse(dev, REPS)
        check_flash(dev, REPS)
    print("flash_inverse_check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
