"""Profiling harness: the Flemisch et al. 2d benchmark models timed phase by
phase, with an optional ``torch.profiler`` trace of the run.

Counterpart of ``porepy_tpu``'s ``applications/profiling/run_profiling.py``
with the same command line and the same JSON line, on ``torch.profiler``:
``prepare_simulation`` is timed, ``assemble_linear_system`` and
``solve_linear_system`` are wrapped to time each call, and
``run_time_dependent_model`` runs the model. ``--trace DIR`` records the
run with CPU and CUDA activities and exports it as a Chrome trace
(``DIR/trace.json``); the line then also holds what :func:`read_trace`
reads from it: the card's busy ms over the run (the union of the kernel,
memcpy and memset intervals, so that overlapping work cannot push the share
past 1), the busy share, the kernel launches and the 12 device ops with the
most total time. On the CPU the trace holds host events only, and the busy
share is 0.

Usage::

    python -m porepy_tpu_torch.applications.profiling.run_profiling \\
        --physics flow --geometry 1 --grid-refinement 0 [--trace DIR] [--device cpu]

Geometries: 0 = benchmark 2d case 1 (cartesian), 1 = case 3a, 2 = case 4
(simplex); refinements 0-2 from the coarsest cell size. The models solve on
the host (``scipy_sparse``, as in ``porepy_tpu``), assembling on
``--device`` (default ``cuda``; without a card the script exits non-zero
unless ``--device cpu`` is given).

The device Newton loops (a ``device*`` solver: fused time blocks,
``params["fused_time_steps"]``, and the per-step loop of the steps before
them) call neither wrapped method, so their iterations do not show in
``iterations`` and the medians: md at 1/16 on the CPU reports 0 iterations
and no medians. Their iterations are read from the trace: the port marks each
block (``fused_time_block``) and, inside it, each Newton iteration's
assembly, solve and flag read (``newton.assemble``, ``newton.solve``,
``newton.flags``) with ``record_function`` ranges, which
:func:`read_trace` splits by (``ranges=``).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time

import numpy as np

#: The range :func:`profile_run` puts around the traced run: the window of
#: :func:`read_trace`.
RUN_RANGE = "run_time_dependent_model"
#: The device ops :func:`read_trace` lists, and the idle gaps it describes.
TOP_OPS, GAPS = 12, 5
#: Trace categories of work on the card.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Hand-written kernels by family (:func:`read_trace`'s ``family_ms``), for
#: device work whose launch is not inside a range of :data:`_FAMILY_OF_RANGE`.
FAMILIES = {
    "assembly (K8, K15)": ("dual_", "upwind", "tpfa_ad", "segment_sum", "interp_"),
    "solve (K1, K3, K4, K2, K6)": ("fgmres_arnoldi", "amg_vcycle", "ell_spmv", "jacobi", "dense_block",
                                   "gj_pivot"),
}
#: Ranges whose device work joins a family: a kernel or copy counts to the
#: family of the range open on the host when it was launched.
_FAMILY_OF_RANGE = {"newton.assemble": "assembly (K8, K15)", "newton.solve": "solve (K1, K3, K4, K2, K6)"}


def build_model(physics: str, geometry: int, refinement: int, device: str = "cuda"):
    """The benchmark model ``geometry`` at refinement ``refinement`` on
    ``device``, and its parameters (``porepy_tpu``'s cell sizes, solid
    constants and grid types)."""
    import porepy_tpu_torch as pt
    from porepy_tpu_torch.examples.flow_benchmark_2d_case_1 import (
        FlowBenchmark2dCase1Model,
        solid_constants_conductive_fractures,
    )
    from porepy_tpu_torch.examples.flow_benchmark_2d_case_3 import (
        FlowBenchmark2dCase3aModel,
    )
    from porepy_tpu_torch.examples.flow_benchmark_2d_case_4 import (
        FlowBenchmark2dCase4Model,
        solid_constants,
    )

    cell_sizes = {
        0: [1 / 16, 1 / 32, 1 / 64],
        1: [0.1, 0.05, 0.025],
        2: [60.0, 30.0, 15.0],
    }
    cs = cell_sizes[geometry][refinement]
    if geometry == 0:
        cls, solids = FlowBenchmark2dCase1Model, solid_constants_conductive_fractures
        grid_type = "cartesian"
    elif geometry == 1:
        cls, solids = FlowBenchmark2dCase3aModel, pt.SolidConstants(
            residual_aperture=1e-4
        )
        grid_type = "simplex"
    else:
        cls, solids = FlowBenchmark2dCase4Model, solid_constants
        grid_type = "simplex"

    params = {
        "grid_type": grid_type,
        "meshing_arguments": {"cell_size": cs},
        "cell_size": cs,
        "material_constants": {"solid": solids},
        "suppress_export": True,
        "device": device,
    }
    if physics != "flow":
        raise SystemExit(
            "Only --physics flow is wired; compose a Poromechanics variant "
            "from the same geometry mixins for poroelastic profiling."
        )
    return cls(params), params


def _sync(model) -> None:
    import torch

    if getattr(model, "device", None) is not None and model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def profile_run(model, params: dict, trace_dir=None) -> dict:
    """Prepare ``model`` (unless it is prepared) and run it through
    ``run_time_dependent_model``, timing each assembly and solve call; with
    ``trace_dir``, under ``torch.profiler`` (CPU and, on a card, CUDA
    activities) exported to ``trace_dir/trace.json`` and read by
    :func:`read_trace`. Returns the JSON line's numbers (``time_steps``
    the time steps run, ``trace`` the trace's summary and path)."""
    import torch

    import porepy_tpu_torch as pt

    t_prepare = 0.0
    if not getattr(model, "_prepared", False):
        t0 = time.perf_counter()
        model.prepare_simulation()
        model._prepared = True
        _sync(model)
        t_prepare = time.perf_counter() - t0

    iter_times = []
    orig_assemble = model.assemble_linear_system
    orig_solve = model.solve_linear_system

    def assemble():
        t = time.perf_counter()
        orig_assemble()
        iter_times.append(["assemble", time.perf_counter() - t])

    def solve():
        t = time.perf_counter()
        out = orig_solve()
        iter_times.append(["solve", time.perf_counter() - t])
        return out

    model.assemble_linear_system = assemble
    model.solve_linear_system = solve

    prof = contextlib.nullcontext()
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
    try:
        with prof:
            _sync(model)
            t0 = time.perf_counter()
            with torch.profiler.record_function(RUN_RANGE):
                pt.run_time_dependent_model(model, params)
                _sync(model)
            t_run = time.perf_counter() - t0
    finally:
        del model.assemble_linear_system, model.solve_linear_system

    asm = [t for k, t in iter_times if k == "assemble"]
    slv = [t for k, t in iter_times if k == "solve"]
    out = {
        "num_dofs": int(model.equation_system.num_dofs()),
        "prepare_s": round(t_prepare, 3),
        "run_s": round(t_run, 3),
        "iterations": len(asm),
        "time_steps": int(model.time_manager.time_index),
        "assembly_ms_median": round(1e3 * float(np.median(asm)), 3) if asm else None,
        "solve_ms_median": round(1e3 * float(np.median(slv)), 3) if slv else None,
    }
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        out["trace"] = dict(read_trace(path), path=path)
    return out


def _union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def _innermost(events, lo: float, hi: float) -> list:
    """``(start, end, name)`` segments covering ``[lo, hi]``, each labelled
    with the innermost of the nested ``events`` (``(start, end, name)`` on
    one thread) open during it, or None."""
    segs, stack, cur = [], [], lo

    def emit(end, name):
        nonlocal cur
        end = min(end, hi)
        if end > cur:
            segs.append((cur, end, name))
            cur = end

    for s, e, name in sorted(events, key=lambda v: (v[0], -v[1])):
        if s >= hi:
            break
        while stack and stack[-1][0] <= s:
            emit(*stack.pop())
        emit(s, stack[-1][1] if stack else None)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        emit(*stack.pop())
    emit(hi, None)
    return segs


def _overlaps(gaps, segs) -> list:
    """For each gap, ``[(label, us), ...]``: how long each segment's label
    was open during it (both lists sorted and disjoint)."""
    out, j = [], 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k, share = j, {}
        while k < len(segs) and segs[k][0] < ge:
            ov = min(ge, segs[k][1]) - max(gs, segs[k][0])
            if ov > 0:
                share[segs[k][2]] = share.get(segs[k][2], 0.0) + ov
            k += 1
        out.append(sorted(share.items(), key=lambda kv: -kv[1]))
    return out


def _family(name: str):
    for fam, prefixes in FAMILIES.items():
        if name.startswith(prefixes):
            return fam
    return None


def read_trace(path: str, ranges=None, window: str = RUN_RANGE) -> dict:
    """What a Chrome trace of ``torch.profiler`` says of the card, over the
    window of the range named ``window`` (the whole trace without one):
    ``window_ms``; ``busy_ms``, the union of the kernel, memcpy and memset
    intervals in it; ``busy_share``; ``kernel_launches``; ``top_ops``, the
    :data:`TOP_OPS` device ops by total time as ``[name, count, ms]`` (names by
    :func:`~porepy_tpu_torch.applications.benchmarking.timing.short_name`).

    ``ranges`` (names of ``record_function`` ranges, such as
    ``"fused_time_block"``) adds ``ranges``, over the union of their
    occurrences: their count and ms, the other ranges that start inside
    them (``inner``: count and host ms), the busy ms and share, the device ms
    by family (each kernel and copy by the range open when the host launched
    it, ``newton.assemble`` or ``newton.solve``, else a kernel by its name,
    :data:`FAMILIES`, else ``other``), the host time with the card idle by
    the innermost CPU op or range open during it (``idle_by_op``) and by
    the innermost range alone (``idle_by_range``), in ms (the
    :data:`TOP_OPS` largest, the rest summed), and the :data:`GAPS` longest
    idle gaps with what the host was doing."""
    from porepy_tpu_torch.applications.benchmarking.timing import short_name

    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    for e in events:
        e["ts"], e["dur"] = float(e["ts"]), float(e.get("dur", 0.0))
    run = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == window]
    if run:
        lo, hi = run[0]["ts"], run[0]["ts"] + run[0]["dur"]
        tid = run[0]["tid"]
    else:
        lo = min((e["ts"] for e in events), default=0.0)
        hi = max((e["ts"] + e["dur"] for e in events), default=0.0)
        tid = None
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = _union(_clip([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi))
    busy_us = sum(e - s for s, e in busy)
    totals: dict = {}
    for e in dev:
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        n, us = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, us + e["dur"])
    out = {
        "window_ms": (hi - lo) / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (hi - lo) if hi > lo else 0.0,
        "kernel_launches": sum(1 for e in dev if e["cat"] == "kernel"),
        "top_ops": [[k, n, us / 1e3] for k, (n, us) in sorted(totals.items(), key=lambda kv: -kv[1][1])[:TOP_OPS]],
    }
    if not ranges:
        return out

    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation") and (tid is None or e["tid"] == tid)]
    marks = [e for e in host if e["cat"] == "user_annotation"]
    spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in marks if e["name"] in ranges])
    spans = _clip(spans, lo, hi)
    span_us = sum(e - s for s, e in spans)
    by_range = _innermost([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in marks], lo, hi)
    by_op = _innermost([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in host], lo, hi)
    # The host time at which each kernel was launched, by its correlation id.
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    starts = [s for s, _e, _n in by_range]

    def range_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return by_range[i][2] if i >= 0 and t < by_range[i][1] else None

    fam_ms: dict = {}
    for e in dev:
        for s, t in spans:
            ov = min(t, e["ts"] + e["dur"]) - max(s, e["ts"])
            if ov <= 0:
                continue
            at = launched.get(e.get("args", {}).get("correlation"))
            fam = _FAMILY_OF_RANGE.get(range_at(at)) if at is not None else None
            if fam is None and e["cat"] == "kernel":
                fam = _family(e["name"])
            fam_ms[fam or "other"] = fam_ms.get(fam or "other", 0.0) + ov / 1e3
    busy_in = [(max(a, s), min(b, t)) for s, t in spans for a, b in busy if b > s and a < t]
    idle = []
    for s, t in spans:
        cur = s
        for a, b in busy_in:
            if a >= t or b <= s:
                continue
            if a > cur:
                idle.append((cur, a))
            cur = max(cur, b)
        if t > cur:
            idle.append((cur, t))
    sums = {}
    for key, segs in (("idle_by_op", by_op), ("idle_by_range", by_range)):
        acc: dict = {}
        for share in _overlaps(idle, segs):
            for label, us in share:
                acc[label or "(no op)"] = acc.get(label or "(no op)", 0.0) + us / 1e3
        ranked = sorted(acc.items(), key=lambda kv: -kv[1])
        sums[key] = dict(ranked[:TOP_OPS])
        if len(ranked) > TOP_OPS:
            sums[key]["(the rest)"] = sum(ms for _label, ms in ranked[TOP_OPS:])
    idle_ops, idle_ranges = _overlaps(idle, by_op), _overlaps(idle, by_range)
    longest = sorted(range(len(idle)), key=lambda i: idle[i][0] - idle[i][1])[:GAPS]
    inner: dict = {}
    for e in marks:
        if e["name"] not in ranges and any(s <= e["ts"] < t for s, t in spans):
            n, us = inner.get(e["name"], (0, 0.0))
            inner[e["name"]] = (n + 1, us + e["dur"])
    out["ranges"] = {
        "names": list(ranges),
        "count": sum(1 for e in marks if e["name"] in ranges),
        "ms": span_us / 1e3,
        "inner": {k: [n, us / 1e3] for k, (n, us) in sorted(inner.items())},
        "busy_ms": sum(b - a for a, b in busy_in) / 1e3,
        "busy_share": sum(b - a for a, b in busy_in) / span_us if span_us else 0.0,
        "family_ms": fam_ms,
        "idle_ms": sum(b - a for a, b in idle) / 1e3,
        **sums,
        "longest_gaps": [
            {"ms": (idle[i][1] - idle[i][0]) / 1e3, "at_ms": (idle[i][0] - lo) / 1e3,
             "range": idle_ranges[i][0][0] if idle_ranges[i] else None,
             "ops": [[label or "(no op)", us / 1e3] for label, us in idle_ops[i][:3]]}
            for i in longest
        ],
    }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--physics", default="flow")
    parser.add_argument("--geometry", type=int, default=0)
    parser.add_argument("--grid-refinement", type=int, default=0)
    parser.add_argument("--trace", default=None, help="directory of the torch.profiler Chrome trace")
    parser.add_argument("--device", default="cuda", help="the device the model assembles on (cuda or cpu)")
    args = parser.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("run_profiling: no CUDA device available (pass --device cpu to run on the host)", file=sys.stderr)
        return 1

    model, params = build_model(args.physics, args.geometry, args.grid_refinement, device=args.device)
    out = profile_run(model, params, trace_dir=args.trace)
    print(json.dumps({"physics": args.physics, "geometry": args.geometry, "refinement": args.grid_refinement,
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
