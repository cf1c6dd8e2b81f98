"""K4 (``fgmres_arnoldi``: an FGMRES Arnoldi step a launch, the matvec
inside) on the card, against its plain version and against the composition
it replaced.

    python3 -m porepy_tpu_torch.applications.benchmarking.arnoldi_check [--no-models]

The composition (:class:`ParentStep`) is the Arnoldi step as ``_fgmres``
ran it before: K1's launcher for ``w = A z``, CGS2 as ``torch.matmul``
GEMVs, ``vector_norm``, the copies into ``V``, ``Z`` and ``Ht``, and the
Givens step in the one-thread K4g kernel behind a custom operator, built
from the parent's ``fgmres_givens.cu`` in ``parent_arnoldi/`` beside this
script: ~17 launches a step. It is the yardstick only; no path of the
package calls it.

The script prints what ``nvcc -Xptxas -v`` reports for
``fgmres_arnoldi.cu``; then, on md 1/128's first Jacobian in the solver's
ELL layout, Ruiz-equilibrated as the solve runs it (n 18,157, K 9), in f32
and f64 at restart 70 (:func:`check_step`): every column of a cycle from
seeded ``z``, the launch against its plain version and the split form (the
sharded solve's four launches, identity sums) to the bit, with
breakdowns (``z = Z[j - 1]``, so ``A z`` lies in the span of ``V[:j+1]``) at
columns 8, 35 and 69; at columns 0, 8, 35 and 69, in turns with the
composition, device µs a step by CUDA-graph replay (``j`` reset inside the
graph; the reset alone timed and taken off), host µs a call, ms by CUDA
events, the plain version's ms and the bound (bytes). Then, unless
``--no-models``, md 1/128 and md 1/256 for 26 steps with each route
swapped into ``_fgmres``, in turns (kernel, parent, parent, kernel): ms a
Newton iteration, Newton and Krylov counts a block, K1 and K4 launches,
the final states' distance (:func:`model_turns`). Needs a CUDA card and
``nvcc``; exits non-zero when a launch and its plain version differ.
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

from porepy_tpu_torch import kernels
from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc, ptxas_report, same_bits
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.kernels import reference

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_arnoldi")
#: The card's memory rate and peaks outside the tensor cores (NVIDIA's H100
#: SXM data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
RESTART = 70
TIMED = (0, 8, 35, 69)
BREAKDOWNS = (8, 35, 69)
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
_STATE = ("V", "Z", "Ht", "cs", "sn", "g", "j", "atol", "flag")
_PARENT = {}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"arnoldi_check failed: {what}")


# -- the parent's composition ---------------------------------------------------------


def parent_givens(workdir: str):
    """The parent's K4g custom operator (``fgmres_givens``: the Givens step,
    one thread) over ``PARENT_DIR/fgmres_givens.cu`` built with ``nvcc`` into
    a library with a plain C interface; checked and dispatched on every call,
    as the parent's ``kernels.fgmres_givens`` was."""
    if "givens" in _PARENT:
        return _PARENT["givens"]
    so = os.path.join(workdir, "parent_k4g.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(PARENT_DIR, "fgmres_givens.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in _SUFFIX.values():
        fn = getattr(lib, "ppt_fgmres_givens" + suffix)
        fn.argtypes, fn.restype = [P] * 7 + [I, P], ctypes.c_int

    @torch.library.custom_op("ppt_arnoldi_check::fgmres_givens", mutates_args=("hcol", "cs", "sn", "g", "j", "flag"))
    def fgmres_givens(hcol: torch.Tensor, cs: torch.Tensor, sn: torch.Tensor, g: torch.Tensor, j: torch.Tensor,
                      atol: torch.Tensor, flag: torch.Tensor) -> None:
        raise NotImplementedError("the parent's Givens step runs on the card only")

    @fgmres_givens.register_kernel("cuda")
    def _(hcol, cs, sn, g, j, atol, flag):
        dtype = hcol.dtype
        if any(t.dtype != dtype for t in (cs, sn, g, atol)) or j.dtype != torch.int32 or flag.dtype != torch.int32:
            raise TypeError("fgmres_givens: hcol, cs, sn, g, atol of one dtype, int32 j and flag")
        for arg, t in {"hcol": hcol, "cs": cs, "sn": sn, "g": g, "j": j, "atol": atol, "flag": flag}.items():
            if not t.is_cuda or not t.is_contiguous():
                raise ValueError(f"fgmres_givens: {arg} must be a contiguous CUDA tensor")
        rc = getattr(lib, "ppt_fgmres_givens" + _SUFFIX[dtype])(
            hcol.data_ptr(), cs.data_ptr(), sn.data_ptr(), g.data_ptr(), j.data_ptr(), atol.data_ptr(),
            flag.data_ptr(), hcol.shape[0] - 1, torch.cuda.current_stream().cuda_stream,
        )
        if rc:
            raise RuntimeError(f"fgmres_givens: CUDA error {rc}")

    _PARENT["givens"] = fgmres_givens
    return fgmres_givens


class ParentStep:
    """One Arnoldi step as ``_fgmres`` composed it before the K4 kernel, on
    the same state and with the constructor of
    :class:`~porepy_tpu_torch.kernels.FgmresArnoldi`, so that it can stand
    in for it inside ``_fgmres``: ``step(z)`` finishes the next column (a
    host count kept in step with ``j``), ``step(z, j)`` column ``j``."""

    givens = None

    def __init__(self, V, Z, Ht, cs, sn, g, j, atol, flag, matrix=None) -> None:
        self.V, self.Z, self.Ht, self.cs, self.sn, self.g = V, Z, Ht, cs, sn, g
        self.j_dev, self.atol, self.flag, self.matrix = j, atol, flag, matrix
        self.k = 0

    def __call__(self, z: torch.Tensor, j=None) -> None:
        j = self.k if j is None else j
        V = self.V
        w = self.matrix(z)
        Vj = V[: j + 1]
        h = torch.matmul(Vj, w)
        w = w - Vj.T @ h
        h2 = torch.matmul(Vj, w)
        w = w - Vj.T @ h2
        hj1 = torch.linalg.vector_norm(w)
        V[j + 1] = w / torch.clamp(hj1, min=1e-30)
        self.Z[j] = z
        hcol = self.Ht[j]
        hcol[: j + 1] = h + h2
        hcol[j + 1] = hj1
        type(self).givens(hcol, self.cs, self.sn, self.g, self.j_dev, self.atol, self.flag)
        self.k = j + 1


# -- the step ---------------------------------------------------------------------


def solve_matrix(val: torch.Tensor, col: torch.Tensor, m_state: dict) -> torch.Tensor:
    """The solve's Ruiz-equilibrated ELL values ``dr A dc`` (float64), as
    ``DeviceLinearSolver._solve`` forms them."""
    return (m_state["dr"][:, None] * val * m_state["dc1"][col]).contiguous()


def fresh_state(n: int, dtype, dev, seed: int) -> list:
    """A cycle's state after its start: ``V[0]`` a seeded unit vector, ``g[0]
    = 1``, the rest zero, ``j = 0``, ``atol`` below any ``|g|`` of the
    cycle, ``flag = 1``."""
    gen = torch.Generator().manual_seed(seed)
    v0 = torch.randn(n, generator=gen, dtype=torch.float64)
    V = torch.zeros(RESTART + 1, n, dtype=dtype, device=dev)
    V[0] = (v0 / torch.linalg.vector_norm(v0)).to(dtype)
    g = torch.zeros(RESTART + 1, dtype=dtype, device=dev)
    g[0] = 1.0

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return [V, zeros(RESTART, n), zeros(RESTART, RESTART + 1), zeros(RESTART), zeros(RESTART), g,
            torch.zeros((), dtype=torch.int32, device=dev), torch.tensor(1e-30, dtype=dtype, device=dev),
            torch.ones((), dtype=torch.int32, device=dev)]


def _copy(state):
    return [t.clone() for t in state]


def _same(a, b) -> list:
    """The names of the state arrays in which ``a`` and ``b`` differ."""
    return [name for name, x, y in zip(_STATE, a, b) if not same_bits(x, y)]


def step_bound(n: int, K: int, nnz: int, j: int, dtype) -> tuple:
    """``(bound_us, bound_by, nbytes)`` of one step at column ``j``: the ELL
    matrix, ``z`` and ``V[:j+1]`` read once, ``Z[j]`` and ``V[j + 1]``
    written once, the Hessenberg column, rotations and ``g`` (bytes); the
    matvec, CGS2's four GEMVs, the norm and the scaling (operations)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = n * K * (size + 4) + (3 + j + 1) * n * size + (3 * (RESTART + 1) + 2 * j) * size
    flops = 2 * nnz + 8 * (j + 1) * n + 3 * n + 6 * j
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e6 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def check_step(val64: torch.Tensor, col: torch.Tensor, label: str, workdir: str, seed: int = 41) -> dict:
    """K4 on the ELL matrix ``(val64, col)`` (float64 values, cast for f32):
    see the head of the file. Returns, by dtype, the times at the columns of
    :data:`TIMED` and the counts of columns held to the bit."""
    ParentStep.givens = parent_givens(workdir)
    dev = val64.device
    n, K = val64.shape
    nnz = int((col < n).sum())
    gen = torch.Generator().manual_seed(seed)
    zs64 = torch.randn(RESTART, n, generator=gen, dtype=torch.float64).to(dev)
    out = {"n": n, "K": K, "nnz": nnz}
    for dtype in (torch.float32, torch.float64):
        tag = f"fgmres_arnoldi at {label}, {str(dtype)[6:]}"
        val = val64.to(dtype)
        op = kernels.EllOperator(val, col)
        zs = zs64.to(dtype)
        state = fresh_state(n, dtype, dev, seed + 1)
        step = kernels.FgmresArnoldi(*state, op)
        held, breakdowns, timed = 0, 0, {}
        for j in range(RESTART):
            if j in TIMED:
                timed[j] = _time_step(step, op, state, zs[j], j, dtype, n, K, nnz, tag)
            # The launch, its split form and the plain version from one
            # state: first a breakdown (then the state put back), then the
            # cycle's own z.
            cases = ([(state[1][j - 1].clone(), True)] if j in BREAKDOWNS else []) + [(zs[j], False)]
            for z, breakdown in cases:
                split, plain, keep = _copy(state), _copy(state), _copy(state)
                before = dict(kernels.LAUNCHES)
                kernels.FgmresArnoldi(*split).split(z, op(z), lambda t: t)
                reference.fgmres_arnoldi(val, col, z, *plain)
                step(z)
                launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
                torch.cuda.synchronize()
                what = f"{tag}, column {j}{' (breakdown)' if breakdown else ''}"
                bad = _same(state, plain) + [f"split {x}" for x in _same(state, split)]
                _require(not bad, f"{what}: differs from its plain version in {bad}")
                _require(launches == {"fgmres_arnoldi": 5, "ell_spmv": 1},
                         f"{what}: launches of the step, its split form and K1 {launches}")
                _require(bool(torch.isfinite(state[0][j + 1]).all()), f"{what}: non-finite V[j + 1]")
                held += 1
                if breakdown:
                    breakdowns += 1
                    col_j = state[2][j]
                    print(f"  {what}, z = Z[j - 1]: equal to the plain version and the split form; R's "
                          f"diagonal |Ht[j][j]| = |w''| {float(col_j[j].abs()):.3e} against max |Ht[j]| "
                          f"{float(col_j.abs().max()):.3e}, V[j + 1] finite, flag {int(state[8])}")
                    for t, k in zip(state, keep):
                        t.copy_(k)
        print(f"  {tag}: {held} launches equal to their plain version and split form to the bit "
              f"({breakdowns} breakdowns), j = {int(state[6])}, flag {int(state[8])}")
        out[str(dtype)[6:]] = {"held": held, "breakdowns": breakdowns, "timed": timed}
    return out


def _time_step(step, op, state, z, j: int, dtype, n: int, K: int, nnz: int, tag: str) -> dict:
    """Times of one step at column ``j`` from ``state`` (left as it was):
    the kernel and the parent's composition in turns (device µs by graph
    replay with ``j`` reset inside the graph, less the reset's own time;
    host µs a call; ms by CUDA events with the reset), the plain version's
    ms and the bound."""
    saved = _copy(state)
    j_dev = state[6]
    parent = ParentStep(*state, op)
    routes = {"kernel": lambda: step(z), "parent": lambda: parent(z, j)}
    turns = ("kernel", "parent", "parent", "kernel")

    def reset_then(route):
        def fn():
            j_dev.fill_(j)
            routes[route]()
        return fn

    reset_us = graph_us(lambda: j_dev.fill_(j))
    device_us = {k: [] for k in routes}
    host = {k: [] for k in routes}
    ms = {k: [] for k in routes}
    for route in turns:
        device_us[route].append(graph_us(reset_then(route)) - reset_us)
    for route in turns:
        host[route].append(host_us(routes[route], 100))
        j_dev.fill_(j)
    for route in turns:
        ms[route].append(cuda_ms(reset_then(route), 100))
    plain = _copy(saved)

    def plain_step():
        plain[6].fill_(j)
        reference.fgmres_arnoldi(op.val, op.col, z, *plain)

    plain_ms = cuda_ms(plain_step, 3)
    for t, s in zip(state, saved):
        t.copy_(s)
    bound_us, bound_by, nbytes = step_bound(n, K, nnz, j, dtype)
    dev_k = min(device_us["kernel"])
    r = {"device_us": device_us, "reset_us": reset_us, "host_us": host, "ms_turns": ms, "ms": min(ms["kernel"]),
         "plain_ms": plain_ms, "bound_us": bound_us, "bound_by": bound_by, "nbytes": nbytes,
         "share": bound_us / dev_k}
    print(f"  {tag}, column {j}, in turns (kernel, parent, parent, kernel): device us a step {device_us} "
          f"(graph replay, less the reset's {reset_us:.2f}); host us a call {host}; ms with the reset {ms}; "
          f"plain {plain_ms:.3f} ms; bound {bound_us:.3f} us ({bound_by}, {nbytes / 1e6:.3f} MB), device time "
          f"at {100 * r['share']:.1f}% of it")
    return r


# -- the models -------------------------------------------------------------------


def _timed_run(make, dev):
    """One 26-step run of the case ``make()`` (``(Model, params)``) on ``dev``, each
    fused block timed with a device sync: ``(ms per Newton iteration,
    [(Newton, Krylov) a block], launches, final state)``."""
    import porepy_tpu_torch as pt

    Model, params = make()
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
    kernels.reset_launches()
    pt.run_time_dependent_model(model, params)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    newton = sum(rec["newton_iters"] for _s, rec in blocks)
    ms = 1e3 * sum(s for s, _rec in blocks) / max(newton, 1)
    counts = [(rec["newton_iters"], rec["krylov_iters"]) for _s, rec in blocks]
    return ms, counts, launches, model.equation_system.get_variable_values(time_step_index=0)


def model_turns(dev, workdir: str, cases=None) -> dict:
    """md 1/128 (``md``) and md 1/256 (``md256``), 26 steps each (or the
    cases of ``cases``, ``{name: () -> (Model, params)}``), with the
    kernel's step and with the parent's composition swapped into
    ``_fgmres`` (``kernels.FgmresArnoldi`` patched to :class:`ParentStep`),
    in turns: kernel, parent, parent, kernel."""
    from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS, build_md_flow

    ParentStep.givens = parent_givens(workdir)
    if cases is None:
        cases = {"md": lambda: build_md_flow(1.0 / 128, device=str(dev)),
                 "md256": lambda: CASE_BUILDERS["md256"]()}
    out = {}
    for case in cases:
        runs = {"kernel": [], "parent": []}
        for route in ("kernel", "parent", "parent", "kernel"):
            patch = mock.patch.object(kernels, "FgmresArnoldi", ParentStep) if route == "parent" else nullcontext()
            with patch:
                runs[route].append(_timed_run(cases[case], dev))
        k, p = runs["kernel"][0], runs["parent"][0]
        diff = float(np.abs(k[3] - p[3]).max())
        r = {
            "ms": {route: [x[0] for x in v] for route, v in runs.items()},
            "counts": {route: v[0][1] for route, v in runs.items()},
            "launches": {route: {name: v[0][2].get(name, 0) for name in ("ell_spmv", "fgmres_arnoldi", "amg_vcycle")}
                         for route, v in runs.items()},
            "state_diff": diff, "state_scale": float(np.abs(p[3]).max()),
        }
        out[case] = r
        steps = r["launches"]["kernel"]["fgmres_arnoldi"]
        print(f"  {case}: ms a Newton iteration in turns {r['ms']}; Newton / Krylov a block {r['counts']}; launches "
              f"{r['launches']} (the kernel route's ell_spmv plus one a step: "
              f"{r['launches']['kernel']['ell_spmv'] + steps}); final states {diff:.3e} apart (largest "
              f"{r['state_scale']:.3e})")
        for route in runs:
            _require(all(x[1] == runs[route][0][1] for x in runs[route]), f"{case}: {route} runs' counts differ")
        _require(r["launches"]["kernel"]["fgmres_arnoldi"] == r["launches"]["kernel"]["amg_vcycle"],
                 f"{case}: fgmres_arnoldi launches {r['launches']['kernel']}")
    return out


def md_first_jacobian(dev):
    """md 1/128's first Jacobian in its solver's ELL layout, equilibrated
    with the preconditioner state built from it: ``(val, col)``."""
    from porepy_tpu_torch.applications.benchmarking.cases import build_md_flow

    Model, params = build_md_flow(1.0 / 128, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    data, _b, cs = model.equation_system.assemble_device()
    solver = model._device_solver_for(cs)
    data = torch.as_tensor(data, dtype=torch.float64, device=dev)
    solver.refresh_preconditioner(data)
    val = torch.cat([data, data.new_zeros(1)])[solver._ell_sel]
    return solve_matrix(val, solver._ell_col, solver._m_state), solver._ell_col


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-models", action="store_true", help="skip md 1/128 and md 1/256 in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("arnoldi_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"arnoldi_check on {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as work:
        ptxas_report([os.path.join(os.path.dirname(kernels.ops.__file__), "csrc", "fgmres_arnoldi.cu")], work)
        val, col = md_first_jacobian(dev)
        check_step(val, col, "md 1/128's first Jacobian", work)
        if not args.no_models:
            model_turns(dev, work)
    print("arnoldi_check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
