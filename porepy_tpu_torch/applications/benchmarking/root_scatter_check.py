"""K8's root scatter (``dual_ew_scatter``: each equation's root program
writes its Jacobian nonzeros and its rows of the right-hand side) on the
card, against its plain version and against the parent's route.

    python3 -m porepy_tpu_torch.applications.benchmarking.root_scatter_check [--cases md,tracer] [--repeats 50]

The parent's route (:class:`ParentJacGather` under :func:`parent_route`)
is what the assembly did before: each equation's root ``dual_ew`` in its
row layout (a ``(1 + B, n)`` buffer of the value and every colored tangent
row), then one ``jac_gather`` launch that gathers ``compressed[gc, rj]`` of
every equation into the nonzero order and negates the residual, built from
``dual_ad.cu`` in ``parent_jac_gather/`` beside this script and called
through the parent's wrapper (its checks and tables made a call). It is the
yardstick only; no path of the package calls it.

For each case (md 1/128 by default) at the first iterate, the script
prints the card's ``nvidia-smi`` line, then: one assembly and one residual
by both routes, which must be equal to the bit; each root's scatter launch
against its plain version (``reference.dual_ew_scatter``) on the same
inputs, to the bit; the roots' device us by CUDA-graph replay and host us a
call in turns (new, parent, parent, new: the roots' scatter launches
against the roots' row launches and the parent's ``jac_gather``); the
assembly's host us, its least and median ms of ``--repeats`` assemblies a
turn, and its launches, by both routes in turns. Needs a CUDA card and
``nvcc``; exits non-zero when the routes disagree.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.krylov_cycle_check import _CFLAGS, _nvcc
from porepy_tpu_torch.applications.benchmarking.timing import cuda_ms, graph_us, host_us
from porepy_tpu_torch.kernels import LAUNCHES, ops, reference, reset_launches

PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parent_jac_gather")
#: Launches of the parent's kernel since the last reset.
PARENT_LAUNCHES = {"jac_gather": 0}
_JOINT = 8  # equations a parent jac_gather launch


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"root_scatter_check failed: {what}")


def _build_command(workdir: str) -> list:
    return [_nvcc(), *_CFLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", os.path.join(workdir, "parent_k8.so"),
            os.path.join(PARENT_DIR, "dual_ad.cu")]


def start_build(workdir: str) -> subprocess.Popen:
    """The parent's build started in the background (``nvcc`` into
    ``workdir``), for :class:`ParentJacGather` to wait for."""
    return subprocess.Popen(_build_command(workdir))


class ParentJacGather:
    """The parent's ``jac_gather`` kernel behind the parent's wrapper
    (``ops.jac_gather`` as it was: the index tensors checked, the pointer
    and offset tables built, eight equations a launch), built into
    ``workdir`` (or by ``build``, a :func:`start_build` still running)."""

    def __init__(self, workdir: str, build: subprocess.Popen = None) -> None:
        if build is None:
            subprocess.run(_build_command(workdir), check=True)
        elif build.wait() != 0:
            raise RuntimeError(f"the parent's dual_ad.cu did not build: nvcc exit {build.returncode}")
        fn = ctypes.CDLL(os.path.join(workdir, "parent_k8.so")).ppt_jac_gather_f64
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [P, P, I, P, P, P, P, P], ctypes.c_int
        self._fn = fn

    def __call__(self, vals, tans, gather_color, gather_row, nnz_offsets, row_offsets):
        ref = vals[0]
        nnz, n_rows = nnz_offsets[-1], row_offsets[-1]
        if gather_color.dtype != torch.int32 or gather_row.dtype != torch.int32:
            raise TypeError("jac_gather: gather_color and gather_row must be int32")
        if gather_color.shape != (nnz,) or gather_row.shape != (nnz,):
            raise ValueError(f"jac_gather: gather_color and gather_row must have shape ({nnz},)")
        ops._check("jac_gather", {"gather_color": gather_color, "gather_row": gather_row}, torch.float64)
        data = torch.empty(nnz, dtype=torch.float64, device=ref.device)
        rhs = torch.empty(n_rows, dtype=torch.float64, device=ref.device)
        for lo in range(0, len(vals), _JOINT):
            hi = min(lo + _JOINT, len(vals))
            ptrs_v, ptrs_t, rs, keep = [], [], [], []
            for e in range(lo, hi):
                rows = row_offsets[e + 1] - row_offsets[e]
                val = vals[e]
                if val.shape != (rows,):
                    raise ValueError(f"jac_gather: equation {e} has shape {tuple(val.shape)}, expected ({rows},)")
                val = val.contiguous()
                pv, pt, _es, r, kept = ops._dual_rows(
                    "jac_gather", val, tans[e], 0 if tans[e] is None else tans[e].shape[0], rows
                )
                ptrs_v.append(pv)
                ptrs_t.append(pt)
                rs.append(r)
                keep.append((val, kept))
            rc = self._fn(
                ops._host_table(ctypes.c_void_p, ptrs_v + ptrs_t),
                ops._host_table(
                    ctypes.c_longlong,
                    rs + list(nnz_offsets[lo : hi + 1]) + list(row_offsets[lo : hi + 1]),
                ),
                hi - lo, gather_color.data_ptr(), gather_row.data_ptr(),
                data.data_ptr(), rhs.data_ptr(), ops._current_stream(),
            )
            if rc:
                raise RuntimeError(f"parent jac_gather: CUDA error {rc}")
            PARENT_LAUNCHES["jac_gather"] += 1
        return data, rhs


def _static(cs):
    """The parent's static inputs of the compiled system ``cs``: the joined
    int32 colors and rows of every nonzero, made once."""
    hit = cs.__dict__.get("_parent_static")
    if hit is None:
        join = lambda arrays: torch.tensor(np.concatenate(arrays), dtype=torch.int32, device=cs.device)  # noqa: E731
        hit = cs._parent_static = (join([ce.gather_color for ce in cs.ces]), join([ce.rows for ce in cs.ces]))
    return hit


def parent_data_and_rhs(parent: ParentJacGather, cs, x, envs):
    """The parent's ``_CompiledSystem._data_and_rhs``: each equation's pass
    in the row layout, then ``parent``."""
    if not cs.ces:
        return cs._empty(), cs._empty()
    vals, tans = [], []
    for ce, env, colors in zip(cs.ces, envs, cs._colors):
        val, tan = ce.fn.dual(x, env, colors, ce.n_colors)
        vals.append(val)
        tans.append(tan)
    gc, gr = _static(cs)
    return parent(vals, tans, gc, gr, cs._nnz_offsets, cs._row_offsets)


def parent_rhs_only(cs, x, envs):
    """The parent's ``_CompiledSystem._rhs_only``: the values, a ``cat`` and
    a negation."""
    vals = [ce.fn.dual(x, env, None, 0)[0] for ce, env in zip(cs.ces, envs)]
    return -torch.cat(vals) if vals else cs._empty()


@contextlib.contextmanager
def parent_route(parent: ParentJacGather):
    """Every compiled system assembles by the parent's route inside the
    block."""
    from porepy_tpu_torch.numerics.ad.equation_system import _CompiledSystem as cls

    kept = (cls._data_and_rhs, cls._rhs_only)
    cls._data_and_rhs = lambda cs, x, envs: parent_data_and_rhs(parent, cs, x, envs)
    cls._rhs_only = parent_rhs_only
    try:
        yield
    finally:
        cls._data_and_rhs, cls._rhs_only = kept


def capture_roots(cs, eq_sys) -> list:
    """The root launches of one assembly of ``cs``: ``(launcher, inputs,
    batch, target)`` a call, the inputs kept alive."""
    calls = []
    scatter = ops.DualEwLauncher.scatter

    def capture(self, inputs, batch, target, data, rhs):
        calls.append((self, list(inputs), batch, target))
        return scatter(self, inputs, batch, target, data, rhs)

    ops.DualEwLauncher.scatter = capture
    try:
        cs.assemble(eq_sys)
    finally:
        ops.DualEwLauncher.scatter = scatter
    return calls


def root_bytes(calls) -> float:
    """Bytes that the roots' scatter must move: every input value read once,
    each nonzero's tangent entry of every loaded input, its color and row
    (int32 each), the tile offsets, the rows of the right-hand side and the
    nonzeros written once."""
    total = 0
    for launcher, inputs, batch, target in calls:
        tape = launcher.program.tape(tuple(t is None for _v, t in inputs))
        total += sum(8 * v.numel() for v, _t in inputs) + 8 * target.rows
        if batch:
            total += target.nnz * (8 + 4 + 4 + 8 * tape.n_load) + 4 * target.tile.numel()
    return float(total)


def check_roots(calls, label: str) -> dict:
    """Each root's scatter against its plain version on the same inputs (to
    the bit: ``rhs`` and ``data`` slices); the largest difference."""
    out = {"equal": True, "err": 0.0}
    for launcher, inputs, batch, target in calls:
        n_rhs = target.row_off + target.rows
        n_data = target.nnz_off + target.nnz
        dev = inputs[0][0].device
        rhs = torch.full((n_rhs,), float("nan"), dtype=torch.float64, device=dev)
        data = torch.full((n_data,), float("nan"), dtype=torch.float64, device=dev)
        launcher.scatter(inputs, batch, target, data, rhs)
        prog = launcher.program
        want_v, want_d = reference.dual_ew_scatter(prog.instrs, prog.imm, inputs, batch, target.gather_color,
                                                   target.gather_row)
        got_v, got_d = rhs[target.row_off:], data[target.nnz_off:]
        pairs = [(got_v, want_v)] + ([(got_d, want_d)] if batch else [])
        for got, want in pairs:
            same = bool(torch.equal(got, want))
            out["equal"] &= same
            if not same:
                scale = max(float(want.abs().max()), 1e-300)
                out["err"] = max(out["err"], float((got - want).abs().max()) / scale)
    print(f"  {label}: {len(calls)} root scatter launches against their plain version: "
          f"{'equal to the bit' if out['equal'] else 'largest difference %.3e of the largest entry' % out['err']}")
    return out


def roots_in_turns(calls, parent: ParentJacGather, cs, label: str) -> dict:
    """The roots' device us by graph replay and host us a call in turns
    (new, parent, parent, new): the scatter launches into one assembly's
    buffers against the row launches and the parent's gather of all the
    equations."""
    dev = calls[0][1][0][0].device
    data = torch.empty(cs._nnz_offsets[-1], dtype=torch.float64, device=dev)
    rhs = torch.empty(cs.num_rows, dtype=torch.float64, device=dev)
    gc, gr = _static(cs)

    def new():
        for launcher, inputs, batch, target in calls:
            launcher.scatter(inputs, batch, target, data, rhs)

    def old():
        vals, tans = [], []
        for launcher, inputs, batch, _target in calls:
            v, t = launcher(inputs, batch)
            vals.append(v)
            tans.append(t)
        return parent(vals, tans, gc, gr, cs._nnz_offsets, cs._row_offsets)

    new()
    got = (data.clone(), rhs.clone())
    want = old()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    turns = {"new": {"device_us": [], "host_us": []}, "parent": {"device_us": [], "host_us": []}}
    for route in ("new", "parent", "parent", "new"):
        fn = new if route == "new" else old
        turns[route]["device_us"].append(graph_us(fn))
        turns[route]["host_us"].append(host_us(fn))
    bound_us = 1e6 * root_bytes(calls) / 3.35e12

    def plain():
        for launcher, inputs, batch, target in calls:
            prog = launcher.program
            reference.dual_ew_scatter(prog.instrs, prog.imm, inputs, batch, target.gather_color, target.gather_row)

    # The gather alone by PyTorch calls (index_select x2, cat x2 and the
    # negation) on the roots' row-layout results.
    rows = [launcher(inputs, batch) for launcher, inputs, batch, _t in calls]
    flat = [(t.gather_color.long() * t.rows + t.gather_row.long()) for _l, _i, _b, t in calls]

    def library():
        data_l = torch.cat([tan.reshape(-1).index_select(0, f) for (_v, tan), f in zip(rows, flat)])
        return data_l, -torch.cat([v for v, _tan in rows])

    times = {"ms": cuda_ms(new), "parent_ms": cuda_ms(old), "plain_ms": cuda_ms(plain),
             "library_ms": cuda_ms(library), "library_device_us": graph_us(library)}
    print(f"  {label}: the roots ({[c[3].rows for c in calls]} rows, {[c[3].nnz for c in calls]} nonzeros, "
          f"B {[c[2] for c in calls]}) by both routes {'equal to the bit' if equal else 'DIFFERENT'}; in turns, "
          f"device us (graph replay) new {['%.2f' % t for t in turns['new']['device_us']]}, parent "
          f"{['%.2f' % t for t in turns['parent']['device_us']]}; host us new "
          f"{['%.1f' % t for t in turns['new']['host_us']]}, parent "
          f"{['%.1f' % t for t in turns['parent']['host_us']]}; the scatter's bound {bound_us:.3f} us; ms by events "
          f"new {times['ms']:.4f}, parent {times['parent_ms']:.4f}, plain {times['plain_ms']:.4f}; the gather by "
          f"index_select x2 + cat x2 + negation {times['library_ms']:.4f} ms, {times['library_device_us']:.2f} us device")
    return {"equal": equal, "turns": turns, "bound_us": bound_us, "bytes": root_bytes(calls), **times}


def breakdown(calls, cs, label: str) -> list:
    """Each root alone, device us by graph replay: the scatter launch, the
    same launch without seeds (the value pass and the right-hand side
    alone), and the root's row-layout launch (the parent's, without the
    gather): what sets the scatter's time."""
    dev = calls[0][1][0][0].device
    data = torch.empty(cs._nnz_offsets[-1], dtype=torch.float64, device=dev)
    rhs = torch.empty(cs.num_rows, dtype=torch.float64, device=dev)
    out = []
    for launcher, inputs, batch, target in calls:
        r = {
            "scatter": graph_us(lambda: launcher.scatter(inputs, batch, target, data, rhs)),
            "value_only": graph_us(lambda: launcher.scatter(inputs, 0, target, data, rhs)),
            "rows": graph_us(lambda: launcher(inputs, batch)),
            "rows_value_only": graph_us(lambda: launcher(inputs, 0)),
        }
        out.append(r)
        print(f"  {label}, root of {target.rows} rows, {target.nnz} nonzeros, B {batch}, "
              f"{len(launcher.program.instrs)} instructions: device us "
              + ", ".join(f"{k} {v:.2f}" for k, v in r.items()))
    return out


def _assemblies(cs, eq_sys, repeats: int) -> tuple:
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        cs.assemble(eq_sys)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - tic))
    return float(min(times)), float(np.median(times))


def assembly_in_turns(cs, eq_sys, parent: ParentJacGather, label: str, repeats: int = 50) -> dict:
    """One assembly and one residual by both routes (to the bit), then in
    turns (new, parent, parent, new, new, parent): least and median ms of
    ``repeats`` assemblies, host us an assembly (the host clock over
    back-to-back assemblies), and the launches of one assembly by kernel."""
    new = (*cs.assemble(eq_sys), cs.residual(eq_sys))
    with parent_route(parent):
        old = (*cs.assemble(eq_sys), cs.residual(eq_sys))
    equal = all(torch.equal(a, b) for a, b in zip(new, old))
    turns = {"new": {"least": [], "median": [], "host_us": []},
             "parent": {"least": [], "median": [], "host_us": []}}
    launches = {}
    for route in ("new", "parent", "parent", "new", "new", "parent"):
        with (parent_route(parent) if route == "parent" else contextlib.nullcontext()):
            least, median = _assemblies(cs, eq_sys, repeats)
            turns[route]["least"].append(least)
            turns[route]["median"].append(median)
            turns[route]["host_us"].append(host_us(lambda: cs.assemble(eq_sys), calls=repeats))
            torch.cuda.synchronize()
            reset_launches()
            PARENT_LAUNCHES["jac_gather"] = 0
            cs.assemble(eq_sys)
            torch.cuda.synchronize()
            counted = {k: v for k, v in LAUNCHES.items() if v}
            if PARENT_LAUNCHES["jac_gather"]:
                counted["jac_gather"] = PARENT_LAUNCHES["jac_gather"]
            launches[route] = counted
    fmt = lambda xs: ["%.4f" % x for x in xs]  # noqa: E731
    print(f"  {label} assembly and residual by both routes {'equal to the bit' if equal else 'DIFFERENT'}; in "
          f"turns, ms least of {repeats}: new {fmt(turns['new']['least'])}, parent {fmt(turns['parent']['least'])}; "
          f"median: new {fmt(turns['new']['median'])}, parent {fmt(turns['parent']['median'])}; host us an "
          f"assembly: new {['%.1f' % t for t in turns['new']['host_us']]}, parent "
          f"{['%.1f' % t for t in turns['parent']['host_us']]}")
    for route, counted in launches.items():
        print(f"  {label} launches of one assembly, {route} route: {sum(counted.values())} {counted}")
    return {"equal": equal, "turns": turns, "launches": launches}


def _build(case: str, dev):
    from porepy_tpu_torch.applications.benchmarking import cases

    make, size = {
        "md": (cases.build_md_flow, 1.0 / 128),
        "md256": (cases.build_md_flow, 1.0 / 256),
        "tracer": (cases.build_tracer, 1.0 / 64),
        "biot": (cases.build_biot, 1.0 / 64),
        "darcy_ad": (cases.build_darcy_ad, 1.0 / 128),
    }[case]
    Model, params = make(size, device=str(dev))
    model = Model(params)
    model.prepare_simulation()
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="md")
    ap.add_argument("--repeats", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("root_scatter_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    ok = True
    with tempfile.TemporaryDirectory() as work:
        parent = ParentJacGather(work)
        for case in args.cases.split(","):
            model = _build(case, dev)
            eq_sys = model.equation_system
            cs = eq_sys.compiled_system()
            calls = capture_roots(cs, eq_sys)
            plain = check_roots(calls, case)
            roots = roots_in_turns(calls, parent, cs, case)
            breakdown(calls, cs, case)
            asm = assembly_in_turns(cs, eq_sys, parent, case, args.repeats)
            ok &= plain["equal"] and roots["equal"] and asm["equal"]
    print(f"root_scatter_check on {smi}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
