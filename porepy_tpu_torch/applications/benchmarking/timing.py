"""Timing on the card: CUDA events over back-to-back calls, device time by
CUDA-graph replay, and the host's time to issue a call. Each needs a CUDA
card."""

from __future__ import annotations

import time

import torch

__all__ = ["cuda_ms", "graph_us", "host_us"]


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


def graph_us(fn, launches: int = 100, replays: int = 5) -> float:
    """Device microseconds per call of ``fn``: a CUDA graph of ``launches``
    calls, replayed ``replays`` times between two CUDA events (no host
    dispatch in the interval)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
