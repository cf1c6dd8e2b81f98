"""K6's pivot inverse and K8's ``dual_ew`` on the card, against the kernels
they replaced and one PyTorch call.

    python3 -m porepy_tpu_torch.applications.benchmarking.dual_pivot_check [--old-dir DIR] [--quick]

Prints the card, what ``nvcc -Xptxas -v`` reports for ``dense_block.cu`` and
``dual_ad.cu`` (registers, shared memory, spills), then:

- K6 (``gj_pivot_inverse``) on one b x b block for b = 128 (the dense
  build's launch, f32 and f64), 64 and 7: held against
  ``torch.linalg.inv_ex``, device microseconds a launch by CUDA-graph
  replay, in turns (kernel, ``inv_ex``, ``inv_ex``, kernel; with
  ``--old-dir`` the older kernel beside them);
- K8's ``dual_ew`` at phase 22's program of ``chip_smoke.py`` (16,969
  elements, 16 tangent rows): device microseconds by graph replay and host
  microseconds a call of the launcher; with ``--old-dir`` the same for the
  route it replaced (the older kernel, one thread an element and every
  tangent row in series, behind the functional wrapper it had: checks, two
  ctypes tables and the output's constness looked up a call), in turns;
- md 1/128 (and with ``--cases md,md256`` md 1/256): every ``dual_ew`` call
  of one assembly, captured at the prepared state, with the histogram of
  ``(instructions, inputs, n, B)``, each call held against its plain
  version, the slots the lowering needs, and the device and host
  microseconds summed over the calls by both routes; then ms per assembly
  and ms per Newton iteration (26 time steps through
  ``run_time_dependent_model``) with every ``dual_ew`` call through the
  older route and through the launchers, in turns (older, new, new, older).

``--old-dir`` names a directory holding the older ``dense_block.cu`` and
``dual_ad.cu``, built here into a library of their own. ``--quick`` stops
after the kernels' checks and one timing each. ``--phases`` builds copies of
the two kernels with ``clock64`` reads at their barriers and prints the SM
cycles of each phase: a K6 elimination step (search, pivot barrier,
scaling, row barrier, update and look-ahead, step barrier; warp 0 and the
mean over warps) on one 128^2 f32 block, and a ``dual_ew`` block (the
asynchronous loads, the value pass, the barrier, the tangent pass; the mean
over blocks) at phase 22's program. Needs a CUDA card and ``nvcc``; exits
non-zero when a kernel and its plain version differ.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.timing import graph_us, host_us

_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def ptxas_report(sources, workdir) -> None:
    """``nvcc -Xptxas -v`` of each source, the lines about its kernels."""
    for src in sources:
        out = subprocess.run(
            [_nvcc(), *_CFLAGS, "-Xptxas", "-v", "-c", src, "-o", os.path.join(workdir, "x.o")],
            capture_output=True, text=True,
        )
        print(f"ptxas {src} (exit {out.returncode}):")
        for line in out.stderr.splitlines():
            if "ptxas" in line and ("Used" in line or "Compiling" in line or "spill" in line or "error" in line):
                print("   ", line.strip())


def old_library(old_dir: str, workdir: str) -> ctypes.CDLL:
    """The older ``dense_block.cu`` and ``dual_ad.cu`` in a library of their
    own, with the C interface they had."""
    so = os.path.join(workdir, "old_k6_k8.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(old_dir, "dense_block.cu"), os.path.join(old_dir, "dual_ad.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.ppt_gj_pivot_inverse_f32.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.ppt_gj_pivot_inverse_f64.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.ppt_dual_ew_f64.argtypes = [_P, _P, _I, _P, _P, _I, _P, _P, _L, _I, _I, _P]
    for fn in (lib.ppt_gj_pivot_inverse_f32, lib.ppt_gj_pivot_inverse_f64, lib.ppt_dual_ew_f64):
        fn.restype = ctypes.c_int
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_gj(lib, a: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(a)
    fn = lib.ppt_gj_pivot_inverse_f32 if a.dtype == torch.float32 else lib.ppt_gj_pivot_inverse_f64
    rc = fn(a.data_ptr(), out.data_ptr(), flag.data_ptr(), a.shape[0], a.shape[1], _stream())
    if rc:
        raise RuntimeError(f"older gj_pivot_inverse: CUDA error {rc}")
    return out


class OldDualEw:
    """The route the launchers replaced: the functional wrapper of the older
    kernel as it was, a call checking every operand, building two ctypes
    tables, looking up the output's constness and allocating, then the older
    kernel. Counts under ``dual_ew``, as it did."""

    def __init__(self, lib) -> None:
        self.fn = lib.ppt_dual_ew_f64
        self._on: dict = {}

    def code(self, program, device):
        key = (id(program), device)
        hit = self._on.get(key)
        if hit is None:
            hit = self._on[key] = (
                program,
                torch.tensor(program.instrs, dtype=torch.int32, device=device),
                torch.tensor(program.imm or (0.0,), dtype=torch.float64, device=device),
            )
        return hit[1], hit[2]

    def __call__(self, program, inputs, batch: int):
        from porepy_tpu_torch.kernels import ops

        ref = inputs[0][0]
        if len(inputs) != program.n_inputs:
            raise ValueError(f"dual_ew: {len(inputs)} inputs for a program of {program.n_inputs}")
        n, one_d = -1, False
        for val, _tan in inputs:
            if val.dim() == 1:
                one_d = True
                if val.shape[0] != 1:
                    if n not in (-1, val.shape[0]):
                        raise ValueError(f"dual_ew: operands of {n} and {val.shape[0]} elements")
                    n = val.shape[0]
        shape = (n,) if n >= 0 else ((1,) if one_d else ())
        n = 1 if n < 0 else n
        ptrs_v, ptrs_t, es, rs, keep = [], [], [], [], []
        for val, tan in inputs:
            pv, pt, e, r, kept = ops._dual_rows("dual_ew", val, tan, batch, n)
            ptrs_v.append(pv)
            ptrs_t.append(pt)
            es.append(e)
            rs.append(r)
            keep.append(kept)
        const = program.out_const(tuple(p is None for p in ptrs_t))
        if const or not batch:
            out_v, out_t = torch.empty(n, dtype=torch.float64, device=ref.device), None
        else:
            buf = torch.empty((batch + 1, n), dtype=torch.float64, device=ref.device)
            out_v, out_t = buf[0], buf[1:]
        if n:
            code, imm = self.code(program, ref.device)
            rc = self.fn(
                ops._host_table(ctypes.c_void_p, ptrs_v + ptrs_t),
                ops._host_table(ctypes.c_longlong, es + rs),
                len(inputs), code.data_ptr(), imm.data_ptr(), len(program.instrs),
                out_v.data_ptr(), None if out_t is None else out_t.data_ptr(), n, n,
                0 if out_t is None else batch, ops._current_stream(),
            )
            if rc:
                raise RuntimeError(f"older dual_ew kernel launch failed with CUDA error {rc}")
            ops.LAUNCHES["dual_ew"] += 1
        return (out_v if shape == (n,) else out_v.reshape(shape)), out_t


class OlderRoute:
    """Every ``DualEwLauncher`` call through ``old`` while inside."""

    def __init__(self, old) -> None:
        self.old = old

    def __enter__(self):
        from porepy_tpu_torch.kernels import ops

        self.saved = ops.DualEwLauncher.__call__
        old = self.old
        ops.DualEwLauncher.__call__ = lambda launcher, inputs, batch: old(launcher.program, inputs, batch)
        return self

    def __exit__(self, *exc):
        from porepy_tpu_torch.kernels import ops

        ops.DualEwLauncher.__call__ = self.saved


def _rel_err(got, want) -> float:
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    scale = float(want.masked_fill(nan, 0.0).abs().max()) if want.numel() else 0.0
    diff = float((got - want).masked_fill(nan, 0.0).abs().max()) if want.numel() else 0.0
    return diff / max(scale, 1e-300)


def _turns(routes: dict, measure) -> dict:
    """``measure(fn)`` of each route in turns: the first, the others, then
    back in reverse."""
    names = list(routes)
    order = names + names[::-1]
    out = {name: [] for name in names}
    for name in order:
        out[name].append(measure(routes[name]))
    return out


# -- phases -----------------------------------------------------------------------

_MARK = (
    "#define PPT_MARK(n) { const long long ppt_now = clock64(); ppt_t[n] += ppt_now - ppt_c; "
    "ppt_c = ppt_now; }\n"
)


def _insert(text: str, anchor: str, before: str = "", after: str = "") -> str:
    if text.count(anchor) != 1:
        raise RuntimeError(f"phases: the kernel source no longer has one {anchor!r}")
    return text.replace(anchor, before + anchor + after)


def phases_library(workdir: str) -> ctypes.CDLL:
    """Copies of K6's pivot inverse and of ``dual_ew`` with ``clock64`` reads
    at their barriers, in a library of their own."""
    from porepy_tpu_torch.kernels import build

    dense = open(os.path.join(build.CSRC, "dense_block.cu")).read()
    dense = dense[: dense.index("template <typename T>\n__global__ void dense_block_apply_kernel")]
    dense = _insert(dense, "int* __restrict__ flag, int b) {", after="\n  long long ppt_t[8] = {0}, ppt_c = 0;")
    dense = _insert(dense, "    const int cur = k & 1;\n", after="    ppt_c = clock64();\n")
    for n, anchor in enumerate(("    __syncthreads();  // the pivot is known\n",
                                "    __syncthreads();  // the pivot row is published\n",
                                "    __syncthreads();  // column k + 1 is published; every thread has read the pivot row\n")):
        dense = _insert(dense, anchor, before=f"    PPT_MARK({2 * n});\n", after=f"    PPT_MARK({2 * n + 1});\n")
    dense = _insert(dense, "  if (bad) flag[blockIdx.x] = 1;\n}", before=(
        "  if (blockIdx.x == 0 && lane == 0)\n"
        "    for (int z = 0; z < 8; ++z) ppt_prof[8 * w + z] = ppt_t[z];\n"))
    dense = dense.replace("int* __restrict__ flag, int b) {", "int* __restrict__ flag, int b, long long* ppt_prof) {")
    dense += """}
extern "C" int ppt_phases_gj(const float* a, float* out, int* flag, int b, long long* prof, void* stream) {
  gj_pivot_inverse_kernel<float, 16><<<1, 512, 0, (cudaStream_t)stream>>>(a, out, flag, b, prof);
  return (int)cudaGetLastError();
}
"""
    dual = open(os.path.join(build.CSRC, "dual_ad.cu")).read()
    entry = dual[dual.index('extern "C" int ppt_dual_ew_f64('):dual.index('extern "C" int ppt_dual_gather_value_f64')]
    dual = dual[: dual.index("// The value row of the unknowns' dual")]
    dual = _insert(dual, "dual_ew_kernel(const __grid_constant__ EwLaunch p) {",
                   after="\n  long long ppt_t[8] = {0}, ppt_c = clock64();")
    dual = _insert(dual, "  cp_async_wait_all();\n", after="  PPT_MARK(0);\n")
    dual = _insert(dual, "  if (!tangents) return;\n", before="  PPT_MARK(1);\n")
    dual = _insert(dual, "  __syncthreads();  // the partials and every thread's rows are in\n", after="  PPT_MARK(2);\n")
    dual = _insert(dual, "p.out_rs + i] = res[r * nt];\n  }\n", after=(
        "  PPT_MARK(3);\n  if (tid == 0) for (int z = 0; z < 8; ++z) ppt_prof[8 * blockIdx.x + z] = ppt_t[z];\n"))
    dual = dual.replace("dual_ew_kernel(const __grid_constant__ EwLaunch p) {",
                        "dual_ew_kernel(const __grid_constant__ EwLaunch p, long long* ppt_prof) {")
    entry = entry.replace('extern "C" int ppt_dual_ew_f64(const long long* table, void* stream) {',
                          'extern "C" int ppt_phases_dual_ew(const long long* table, long long* ppt_prof, void* stream) {')
    entry = _insert(entry, "(cudaStream_t)stream>>>(p);", before="").replace(
        "(cudaStream_t)stream>>>(p);", "(cudaStream_t)stream>>>(p, ppt_prof);")
    src = os.path.join(workdir, "phases.cu")
    with open(src, "w") as fh:
        fh.write(_MARK + dense.replace("#include <stdint.h>", "#include <stdint.h>\n#include <string.h>\n#include <math.h>", 1))
        fh.write("namespace {\n" + dual[dual.index("constexpr int kThreads = 128;"):] + "}\n" + entry)
    so = os.path.join(workdir, "phases.so")
    subprocess.run([_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.ppt_phases_gj.argtypes = [_P, _P, _P, _I, _P, _P]
    lib.ppt_phases_dual_ew.argtypes = [_P, _P, _P]
    lib.ppt_phases_gj.restype = lib.ppt_phases_dual_ew.restype = ctypes.c_int
    return lib


def print_phases(dev, workdir: str) -> None:
    from porepy_tpu_torch.kernels import ops

    lib = phases_library(workdir)
    b = 128
    a = torch.tensor(np.random.default_rng(6).standard_normal((1, b, b)) / np.sqrt(b) + 4 * np.eye(b),
                     dtype=torch.float32, device=dev)
    out, flag = torch.empty_like(a), torch.zeros(1, dtype=torch.int32, device=dev)
    prof = torch.zeros(16 * 8, dtype=torch.int64, device=dev)
    for _ in range(2):
        prof.zero_()
        lib.ppt_phases_gj(a.data_ptr(), out.data_ptr(), flag.data_ptr(), b, prof.data_ptr(), _stream())
        torch.cuda.synchronize()
    cyc = prof.view(16, 8)[:, :6].cpu().numpy() / b
    names = ["search", "pivot barrier", "scaling", "row barrier", "update and look-ahead", "step barrier"]
    print("K6 phases, SM cycles a step (one 128^2 f32 block; clock64 copy): warp 0 "
          f"{dict(zip(names, cyc[0].round(1).tolist()))}; mean over the 16 warps "
          f"{dict(zip(names, cyc.mean(0).round(1).tolist()))}")
    program, inputs = phase22_inputs(dev)
    launch = ops.DualEwLauncher(program)
    keep = launch(inputs, 16)  # fills the launcher's table; keeps its output alive
    blocks = (16969 + 31) // 32
    prof = torch.zeros(blocks * 8, dtype=torch.int64, device=dev)
    for _ in range(2):
        prof.zero_()
        lib.ppt_phases_dual_ew(launch._table, prof.data_ptr(), _stream())
        torch.cuda.synchronize()
    cyc = prof.view(blocks, 8)[:, :4].cpu().numpy().astype(float)
    names = ["loads", "value pass", "barrier", "tangent pass"]
    print("dual_ew phases at phase 22's program, SM cycles of thread 0 a block (clock64 copy): mean "
          f"{dict(zip(names, cyc.mean(0).round(0).tolist()))}, max {dict(zip(names, cyc.max(0).round(0).tolist()))}")
    del keep


# -- K6 ---------------------------------------------------------------------------


def pivot_blocks(b: int, seed: int) -> np.ndarray:
    """Four b x b blocks: integer-valued with many equal magnitudes (ties in
    the pivot search), one with a zero leading entry, one singular (a zero
    column, which stays zero under any elimination order and rounding, so
    every route meets a zero pivot), one well conditioned."""
    rng = np.random.default_rng(seed)
    while True:
        ties = rng.choice([-2.0, -1.0, 1.0, 2.0], size=(b, b)) * (rng.random((b, b)) < 0.7)
        ties[np.arange(b), rng.permutation(b)] = rng.choice([-2.0, 2.0], size=b)
        if np.linalg.cond(ties) < 1e4:
            break
    lead = rng.standard_normal((b, b)) / np.sqrt(b) + 3 * np.eye(b)
    lead[0, 0] = 0.0
    good = rng.standard_normal((b, b)) / np.sqrt(b) + 4 * np.eye(b)
    singular = good.copy()
    singular[:, b // 2] = 0.0
    return np.stack([ties, lead, singular, good])


def check_pivot(dev, old) -> dict:
    from porepy_tpu_torch.kernels import ops, reference

    rng = np.random.default_rng(6)
    report = {}
    for b, dtype in ((128, torch.float32), (128, torch.float64), (64, torch.float32), (7, torch.float32)):
        a_np = rng.standard_normal((1, b, b)) / np.sqrt(b) + 4 * np.eye(b)
        a = torch.tensor(a_np, dtype=dtype, device=dev)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        got = ops.gj_pivot_inverse(a, flag)
        want = reference.gj_pivot_inverse(a, torch.zeros(1, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        err = _rel_err(got, want)
        tol = 1e-12 if dtype == torch.float64 else 1e-4
        ok = err <= tol and int(flag[0]) == 0
        routes = {"kernel": lambda: ops.gj_pivot_inverse(a, flag),
                  "inv_ex": lambda: torch.linalg.inv_ex(a)}
        if old is not None:
            routes["older kernel"] = lambda: old_gj(old, a, flag)
        us = _turns(routes, graph_us)
        tag = f"b {b} {str(dtype)[6:]}"
        print(f"K6 gj_pivot_inverse, one block, {tag}: max rel err against inv_ex {err:.3e} (bound {tol:g}, ok {ok}); "
              f"device us a launch (graph replay, in turns): {us}")
        report[tag] = {"err": err, "ok": ok, "device_us": us}
    return report


# -- K8 dual_ew -------------------------------------------------------------------


def phase22_program():
    """Phase 22's program of ``chip_smoke.py`` and its inputs' order."""
    from porepy_tpu_torch.numerics.ad import forward

    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(5)]
    larger = E.op("select", E.op("gt", ins[1], ins[0]), ins[1], ins[0])
    density = E.op("exp", E.op("mul", ins[3], E.op("sub", ins[2], E.imm(0.5))))
    expr = E.op("div", E.op("add", E.op("mul", larger, ins[4]), density), E.op("pow", ins[2], E.imm(-2.0)))
    return forward.compile_expr(expr)


def family_programs() -> dict:
    """``(program, input order)`` of one program a family of opcodes:
    every unary opcode (four programs), the binary ones, the masks and
    selections, and ``custom``."""
    from porepy_tpu_torch.numerics.ad import forward

    E = forward.ExprOps
    ins = [forward._Expr("in", (), k) for k in range(4)]
    pos = E.op("add", E.op("abs", ins[0]), E.imm(1.5))
    small = E.op("mul", E.op("tanh", ins[1]), E.imm(0.8))
    exprs = {
        "unary_a": E.op("add", E.op("add", E.op("exp", small), E.op("log", pos)),
                        E.op("add", E.op("sin", ins[2]), E.op("cos", ins[3]))),
        "unary_b": E.op("add", E.op("add", E.op("tan", small), E.op("arcsin", small)),
                        E.op("add", E.op("arccos", small), E.op("arctan", ins[2]))),
        "unary_c": E.op("add", E.op("add", E.op("sinh", small), E.op("cosh", small)),
                        E.op("add", E.op("arcsinh", ins[3]), E.op("arccosh", pos))),
        "unary_d": E.op("add", E.op("add", E.op("arctanh", small), E.op("sqrt", pos)),
                        E.op("add", E.op("neg", ins[0]), E.op("sign", ins[1]))),
        "binary": E.op("div", E.op("sub", E.op("mul", ins[0], ins[1]), E.op("pow", pos, ins[2])),
                       E.op("add", pos, ins[3])),
        "masks": E.op("select", E.op("ge", ins[0], ins[1]),
                      E.op("select", E.op("leabs", ins[2], E.imm(0.5)), ins[3], E.imm(2.0)),
                      E.op("detach", ins[1])),
        "custom": E.op("custom", ins[0], ins[1], E.op("mul", ins[2], ins[3])),
    }
    return {name: forward.compile_expr(e) for name, e in exprs.items()}


def phase22_inputs(dev, B: int = 16, nc: int = 16969):
    program, order = phase22_program()
    rng = np.random.default_rng(22)
    f64 = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    fields = [
        (f64(rng.standard_normal(nc)), f64(rng.standard_normal((B, nc)))),
        (f64(rng.standard_normal(nc)), f64(rng.standard_normal((B, nc)))),
        (f64(0.5 + rng.random(nc)), f64(rng.standard_normal((B, nc)))),
        (f64(1e-2), None),
        (f64(rng.standard_normal(nc)), None),
    ]
    return program, [fields[k] for k in order]


def time_calls(calls, call_fn, launches: int = 20, replays: int = 3, host_calls: int = 50) -> dict:
    """Device us (graph replay) and host us a call, summed over ``calls``
    (``(launcher, inputs, batch)``) through ``call_fn``."""
    dev_us = sum(graph_us(lambda c=c: call_fn(*c), launches, replays) for c in calls)
    hst_us = sum(host_us(lambda c=c: call_fn(*c), host_calls) for c in calls)
    return {"device_us": dev_us, "host_us": hst_us}


def check_dual_ew(dev, old) -> dict:
    from porepy_tpu_torch.kernels import ops, reference

    program, inputs = phase22_inputs(dev)
    B = 16
    launch = ops.DualEwLauncher(program)
    got = launch(inputs, B)
    want = reference.dual_ew(program.instrs, program.imm, inputs, B)
    torch.cuda.synchronize()
    err = max(_rel_err(g, w) for g, w in zip(got, want))
    again = launch(inputs, B)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    pattern = tuple(t is None for _v, t in inputs)
    tape = program.tape(pattern)
    print(f"dual_ew at phase 22's program ({len(program.instrs)} instructions, {program.n_inputs} inputs, "
          f"16,969 elements, {B} rows): max rel err {err:.3e} (bound 1e-13), two launches the same bits {same}; "
          f"tape {len(tape.tape)} entries, {tape.n_slot} slots, {tape.n_part} partials")
    routes = {"launcher": lambda: launch(inputs, B)}
    if old is not None:
        old_got = old(program, inputs, B)
        print(f"  the older kernel against the plain version: {max(_rel_err(g, w) for g, w in zip(old_got, want)):.3e}")
        routes["older route"] = lambda: old(program, inputs, B)
    dev_us = _turns(routes, graph_us)
    hst_us = _turns(routes, host_us)
    print(f"  device us a call (graph replay, in turns) {dev_us}; host us a call (in turns) {hst_us}")
    return {"err": err, "same": same, "ok": err <= 1e-13 and same, "device_us": dev_us, "host_us": hst_us,
            "n_slot": tape.n_slot}


def capture_assembly(cs, eq_sys) -> list:
    """``(launcher, inputs, batch)`` of every ``dual_ew`` call of one
    assembly, the calls made as usual."""
    from porepy_tpu_torch.kernels import ops

    calls = []
    real = ops.DualEwLauncher.__call__

    def record(self, inputs, batch):
        calls.append((self, list(inputs), batch))
        return real(self, inputs, batch)

    ops.DualEwLauncher.__call__ = record
    try:
        cs.assemble(eq_sys)
    finally:
        ops.DualEwLauncher.__call__ = real
    torch.cuda.synchronize()
    return calls


def check_case_programs(label: str, calls, old) -> dict:
    """The captured ``dual_ew`` calls of one assembly: the histogram of
    ``(instructions, inputs, n, B)``, the slots their tapes need, each call
    against its plain version, and the device and host us summed over the
    calls by the launchers and, with ``old``, by the older route, in turns."""
    from porepy_tpu_torch.kernels import reference

    hist = collections.Counter()
    worst, slots = 0.0, collections.Counter()
    for launcher, inputs, batch in calls:
        n = max(v.numel() for v, _t in inputs)
        hist[(len(launcher.program.instrs), launcher.program.n_inputs, n, batch)] += 1
        pattern = tuple(t is None for _v, t in inputs) if batch else (True,) * len(inputs)
        slots[launcher.program.tape(pattern).n_slot] += 1
        got = launcher(inputs, batch)
        want = reference.dual_ew(launcher.program.instrs, launcher.program.imm, inputs, batch)
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                worst = float("inf")
            elif g is not None and g.numel():
                worst = max(worst, _rel_err(g, w))
    print(f"{label}: {len(calls)} dual_ew calls an assembly; (instructions, inputs, n, B): count "
          f"{dict(sorted(hist.items()))}; slots by call {dict(sorted(slots.items()))}; largest error against the "
          f"plain version {worst:.3e}")
    routes = {"launchers": lambda launcher, inputs, batch: launcher(inputs, batch)}
    if old is not None:
        routes["older route"] = lambda launcher, inputs, batch: old(launcher.program, inputs, batch)
    sums = _turns(routes, lambda fn: time_calls(calls, fn))
    print(f"  summed over the {len(calls)} calls, in turns: {sums}")
    return {"calls": len(calls), "hist": hist, "err": worst, "max_slots": max(slots), "sums": sums}


def _timed_model(Model):
    class Timed(Model):
        def fused_time_block(self, n_steps, nl_params):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            n = super().fused_time_block(n_steps, nl_params)
            torch.cuda.synchronize()
            if n:
                self.block_log.append((time.perf_counter() - tic, dict(self._ftb_last)))
            return n

    return Timed


def run_case(case: str, route) -> dict:
    """One 26-step run of ``case`` with ``route`` in force: ms per Newton
    iteration over the fused blocks, their Newton and Krylov counts, and the
    median ms of 10 assemblies at the final state."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS

    Model, params = CASE_BUILDERS[case]()
    model = _timed_model(Model)(params)
    model.block_log = []
    with route:
        model.prepare_simulation()
        model._prepared = True
        pt.run_time_dependent_model(model, params)
        eq_sys = model.equation_system
        cs = eq_sys.compiled_system()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            cs.assemble(eq_sys)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - tic))
    newton = sum(rec["newton_iters"] for _s, rec in model.block_log)
    return {
        "ms_per_newton": 1e3 * sum(s for s, _rec in model.block_log) / max(newton, 1),
        "per_block": [(rec["newton_iters"], rec["krylov_iters"]) for _s, rec in model.block_log],
        "assembly_ms": float(np.median(times)),
        "state": eq_sys.get_variable_values(time_step_index=0),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-dir", default=None)
    parser.add_argument("--cases", default="md")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("dual_pivot_check: no CUDA device available", file=sys.stderr)
        return 1
    import contextlib

    from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS
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
        srcs = [os.path.join(build.CSRC, s) for s in ("dense_block.cu", "dual_ad.cu")]
        if args.old_dir:
            srcs += [os.path.join(args.old_dir, s) for s in ("dense_block.cu", "dual_ad.cu")]
        ptxas_report(srcs, work)
        old = old_library(args.old_dir, work) if args.old_dir else None
        pivot = check_pivot(dev, old)
        ok &= all(r["ok"] for r in pivot.values())
        old_ew = OldDualEw(old) if old is not None else None
        ew = check_dual_ew(dev, old_ew)
        ok &= ew["ok"]
        if args.phases:
            print_phases(dev, work)
        if args.quick:
            print(f"dual_pivot_check on {smi}: ok {ok}")
            return 0 if ok else 2
        for case in args.cases.split(","):
            Model, params = CASE_BUILDERS[case]()
            model = Model(params)
            model.prepare_simulation()
            eq_sys = model.equation_system
            cs = eq_sys.compiled_system()
            cs.assemble(eq_sys)
            calls = capture_assembly(cs, eq_sys)
            r = check_case_programs(f"{case} ({eq_sys.num_dofs()} dofs)", calls, old_ew)
            ok &= r["err"] <= 1e-13
            del calls, cs, model
            runs = {"launchers": contextlib.nullcontext()}
            if old_ew is not None:
                runs = {"older route": OlderRoute(old_ew), "launchers": contextlib.nullcontext()}
            results = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                results[name].append(run_case(case, runs[name]))
            for name, rs in results.items():
                print(f"{case} on {smi}, {name} (in turns): ms per Newton iteration "
                      f"{[round(x['ms_per_newton'], 3) for x in rs]}, ms per assembly "
                      f"{[round(x['assembly_ms'], 3) for x in rs]}, Newton / Krylov per block "
                      f"{[x['per_block'] for x in rs]}")
            states = [x["state"] for rs in results.values() for x in rs]
            diff = max(float(np.abs(s - states[0]).max()) for s in states)
            scale = float(np.abs(states[0]).max())
            print(f"  final states of every run within {diff:.3e} of the first (largest value {scale:.3e})")
            ok &= diff <= 1e-8 * max(scale, 1.0)
    print(f"dual_pivot_check on {smi}: ok {ok}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
