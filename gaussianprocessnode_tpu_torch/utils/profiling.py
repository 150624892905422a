"""Timing helpers for the card.

Counterpart of ``gaussianprocessnode_tpu/utils/profiling.py``. PyTorch
returns before the device finishes, so a host clock measures work only
between two ``synchronize`` calls. ``cuda_time_ms`` puts CUDA events
around a Python loop of calls, so it also holds each call's host cost
where that exceeds the device's; ``cuda_graph_time_ms`` replays the calls
from a CUDA graph, so it holds device time alone; ``cuda_kernel_times``
reads each kernel's device time from a ``torch.profiler`` trace;
``count_syncs`` counts the host synchronisations of a call.
"""

import subprocess
import time

import torch

__all__ = ["synchronize", "card_info", "cuda_time_ms", "cuda_graph_time_ms",
           "cuda_kernel_times", "count_syncs"]


def synchronize(device=None) -> None:
    """Wait for all work queued on ``device`` (the current card by default).
    A no-op for CPU devices, whose work is done when the call returns."""
    if device is not None and torch.device(device).type != "cuda":
        return
    torch.cuda.synchronize(device)


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(0)}


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn()`` on the current CUDA stream, by
    CUDA events around ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn()``: ``warmup`` calls, then
    ``iters`` calls captured into one ``torch.cuda.CUDAGraph`` on a side
    stream, replayed once (to warm the graph) and then timed by CUDA events
    around one replay. The Python and launch cost of each call is not in
    the figure. Outputs that ``fn`` allocates come from the graph's private
    pool, so successive calls inside the graph may write the same memory.
    It counts no launches as ``ops._build.CallGraph`` does: a kernel
    wrapper counts the warm-up and the captured calls, not the replays, so
    a caller that keeps a launch count restores it around this function.
    Raises without a CUDA card: there is no device time to give."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_time_ms needs a CUDA card")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_kernel_times(fn, warmup: int = 1):
    """Device time of one call of ``fn()`` by kernel, from a
    ``torch.profiler`` trace (CUPTI) of that call after ``warmup`` calls.
    Returns ``(wall_ms, {kernel name: (launches, device ms)})``: the host
    clock around the call and its closing synchronisation (the profiler's
    own cost included), and each kernel's summed device time. The dict is
    empty where the profiler records no device activity. The trace's raw
    events are summed as they are: building the profiler's per-event
    Python objects (``key_averages``) takes minutes for the ~10⁶ kernels of
    a graphed toy epoch. Raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_kernel_times needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n, ms = kernels.get(e.name(), (0, 0.0))
            kernels[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return wall_ms, kernels


def count_syncs(fn):
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``. Returns
    its result and the number of synchronising operations that the warnings
    name."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)
