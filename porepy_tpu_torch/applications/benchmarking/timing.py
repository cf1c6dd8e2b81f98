"""Timing on the card: CUDA events over back-to-back calls, device time by
CUDA-graph replay, and the host's time to issue a call; the CUDA kernels of
a call by ``torch.profiler`` and the package's launch counters of a call;
the bytes of a set of tensors. Each but :func:`nbytes` and
:func:`short_name` needs a CUDA card."""

from __future__ import annotations

import time

import torch

__all__ = ["counted", "cuda_kernels", "cuda_ms", "graph_us", "host_us", "nbytes", "short_name"]


def cuda_ms(fn, repeats: int = 100) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def graph_us(fn, launches: int = 100, replays: int = 5, mode: str = "global") -> float:
    """Device microseconds per call of ``fn``: a CUDA graph of ``launches``
    calls, replayed ``replays`` times between two CUDA events (no host
    dispatch in the interval); ``mode`` is the capture's error mode
    (``"relaxed"`` lets ``fn`` make calls that are not stream work, such as
    setting a kernel's attribute)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=mode):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / (launches * replays)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: the host clock over ``calls``
    back-to-back calls, read before the synchronization that ends them."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - tic
    torch.cuda.synchronize()
    return 1e6 * host / calls


def nbytes(*tensors) -> int:
    """The bytes of the tensors among ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


#: Kernels named with their template arguments: the flow steps' own.
_TEMPLATED = ("structured_kernel<", "tpfa_", "bicgstab_kernel")
#: The elementwise functors by which torch's kernels are named, first match.
_FUNCTORS = ("neg", "exp", "Mul", "Div", "add", "where", "Fill", "copy", "Norm", "compare", "Abs", "Eq", "Cat",
             "isfinite", "reduce")


def short_name(name: str) -> str:
    """A CUDA kernel's name without its call arguments: torch's by the
    elementwise functor it runs (``torch neg``, ``torch add``...), the flow
    steps' kernels with their template arguments, others without."""
    if name.startswith(("void at::native", "void at::")):
        for key in _FUNCTORS:
            if key in name:
                return "torch " + key
    head = name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    return head if head.startswith(_TEMPLATED) else head.split("<")[0]


def cuda_kernels(fn, reps: int = 1) -> dict:
    """The CUDA kernels of one ``fn()`` by :func:`short_name`:
    ``torch.profiler`` over ``reps`` calls after one that warms it up (the
    profiler's first step loses its first kernels), each count over
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for calls in (1, reps):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = short_name(e.name)
            names[name] = names.get(name, 0) + 1
    return {k: v // reps if v % reps == 0 else v / reps for k, v in names.items()}


def counted(fn) -> dict:
    """The package's launch counters (``kernels.LAUNCHES``) of one
    ``fn()``, those that moved."""
    from porepy_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in LAUNCHES.items() if v}
