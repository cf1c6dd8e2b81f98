"""Where one device assembly of a bench case spends its time.

``python3 -m porepy_tpu_torch.applications.benchmarking.profile_assembly
[case]`` (``md``, ``md256``, ``3d``, ``biot``, ``tracer``; default ``md``)
prepares the case's model on the card and, at its initial state, prints the
card's name and power limit, the median wall time and the kernel launches of
one assembly, the host functions by ``cProfile`` (own time), and the card's
busy share and device ops by ``torch.profiler`` (a Chrome trace read by
:func:`~porepy_tpu_torch.applications.profiling.run_profiling.read_trace`).
It needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS
from porepy_tpu_torch.applications.profiling.run_profiling import read_trace
from porepy_tpu_torch.kernels import LAUNCHES, build, reset_launches


def _timed(cs, eq_sys, repeats: int) -> list[float]:
    """Wall ms of each of ``repeats`` synchronized assemblies."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        cs.assemble(eq_sys)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - tic))
    return times


def profile_assembly(case: str = "md", repeats: int = 30) -> None:
    Model, params = CASE_BUILDERS[case]()
    model = Model(params)
    model.prepare_simulation()
    eq_sys = model.equation_system
    cs = eq_sys.compiled_system()
    for _ in range(3):
        cs.assemble(eq_sys)
    reset_launches()
    cs.assemble(eq_sys)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    wall = float(np.median(_timed(cs, eq_sys, repeats)))
    print(f"{case}: {eq_sys.num_dofs()} dofs, median {wall:.3f} ms per assembly, launches of one {launches}")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(repeats):
        cs.assemble(eq_sys)
    torch.cuda.synchronize()
    prof.disable()
    pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as tprof:
        with torch.profiler.record_function("assemblies"):
            span_ms = sum(_timed(cs, eq_sys, repeats))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        tprof.export_chrome_trace(path)
        got = read_trace(path, window="assemblies")
    print(
        f"{case}: under torch.profiler {span_ms / repeats:.3f} ms per assembly, card busy "
        f"{got['busy_ms'] / repeats:.3f} ms of it ({100 * (1 - got['busy_share']):.1f}% idle; the union of the "
        f"device intervals over the traced window of {got['window_ms']:.3f} ms)"
    )
    for name, count, ms in got["top_ops"]:
        print(f"  {name}: {count // repeats} a call, {ms / repeats:.4f} ms a call")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_assembly: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    build.library()
    profile_assembly(*argv[:1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
