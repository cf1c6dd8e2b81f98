"""Where one device assembly of a bench case spends its time.

``python3 -m porepy_tpu_torch.applications.benchmarking.profile_assembly
[case]`` (``md``, ``md256``, ``3d``, ``biot``, ``tracer``; default ``md``)
prepares the case's model on the card and, at its initial state, prints the
card's name and power limit, the median wall time and the kernel launches of
one assembly, the host functions by ``cProfile`` (own time), and the card's
busy share and kernels by ``torch.profiler``. It needs a CUDA device.
"""

from __future__ import annotations

import cProfile
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

from porepy_tpu_torch.applications.benchmarking.cases import CASE_BUILDERS
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
        span_ms = sum(_timed(cs, eq_sys, repeats))
    events = tprof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(
        f"{case}: under torch.profiler {span_ms / repeats:.3f} ms per assembly, card busy "
        f"{busy_ms / repeats:.3f} ms of it ({100 * (1 - busy_ms / span_ms):.1f}% idle)"
    )
    print(events.table(sort_by="self_device_time_total", row_limit=12))


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
