#!/usr/bin/env python3
"""Host and device cost of each step of a graphed serving call, on the card.

Run from the root of the repository on a machine with one NVIDIA card:

    python3 scripts/serve_call_costs.py --workload banana.serve.grid512 --seed N [--calls 2000]

It sets up one serving cell of the benchmark as ``portbench`` does (its
warm-up calls capture the handle's graph) and prints one JSON line:

- each step of a call timed alone on the host's clock between two device
  synchronizations, median µs over ``--calls`` calls: the pool lookup,
  ``as_tensor``, ``no_grad``, the capture check, the cache's key, the
  input copy, ``replay()``, one output clone, the graph's part (a
  ``CallGraph`` call: the copy, the replay, the launch counts, the clones)
  and a whole call;
- device µs by CUDA events (median of 200): the replay alone and a whole
  call with its host lead; the closed loop's µs a call (call, synchronize);
- ``api_us``: count and mean host µs of each CUDA runtime call and ATen
  operator over 50 calls under ``torch.profiler`` (CUPTI adds to them);
- ``svgp_var``, in an SVGP cell: the variance stage alone on the first
  pool batch's Gram, device ms by CUDA graph: the kernel
  (``ops.svgp_var.svgp_var_cuda``, 20 launches a graph, twice), the plain
  version (``svgp_var_reference``: cuBLAS trsm, GEMM and reductions; 5
  calls a graph) and the Gram itself, beside the stage's least time
  (``portbench.svgp_counts.var_least_seconds`` at the card's peaks) and
  the kernel's FLOP rate on 2M²B.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def svgp_var_costs(h, X) -> dict:
    """The SVGP handle's variance stage on the Gram of X, timed alone."""
    import torch

    from gaussianprocessnode_tpu_torch.ops.svgp_var import svgp_var_cuda, svgp_var_reference
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms
    from portbench import peaks, svgp_counts

    launches = svgp_var_cuda.launches
    with torch.no_grad():
        Kux, kxx = h.kernel(h.theta, h.Xu, X), h.kernel.diag(h.theta, X)
        args = (Kux, h.Lu, h.A, h.m_white, kxx)
        kernel_ms = [cuda_graph_time_ms(lambda: svgp_var_cuda(*args), iters=20) for _ in range(2)]
        plain_ms = cuda_graph_time_ms(lambda: svgp_var_reference(*args), iters=5)
        gram_ms = cuda_graph_time_ms(lambda: h.kernel(h.theta, h.Xu, X), iters=20)
    svgp_var_cuda.launches = launches
    M, B = Kux.shape
    pk = peaks.for_card(torch.cuda.get_device_name())
    bound_ms = svgp_counts.var_least_seconds(M, B, pk) * 1e3 if pk else None
    return {"shape": [M, B, X.shape[1]], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "gram_ms": gram_ms, "bound_ms": bound_ms,
            "roofline_share": bound_ms / min(kernel_ms) if pk else None,
            "kernel_tflop_per_s": 2 * M * M * B / min(kernel_ms) / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussianprocessnode_tpu_torch import serve
    from portbench import card, manifest as mf, trace as bench_trace
    from portbench.card import sync

    card.require(1)
    torch.set_num_threads(1)
    cfg, traffic, spec = mf.cell_files(mf.load_manifest(), args.workload)
    s = mf.driver(spec["driver"]).Session(cfg, traffic, spec, args.seed, "cuda",
                                          bench_trace.Tracer())
    pool, fn, h = s.pool, s.fn, s.handle
    (g,) = h._graphs.graphs.values()
    X = pool[0]
    outs = g.out if isinstance(g.out, tuple) else (g.out,)
    res = {}

    def host_us(name, f):
        ts = []
        for k in range(args.calls):
            sync("cuda")
            a = time.perf_counter_ns()
            f(k)
            ts.append((time.perf_counter_ns() - a) / 1e3)
        sync("cuda")
        res[name] = statistics.median(ts)

    def no_grad(k):
        with torch.no_grad():
            pass

    host_us("call", lambda k: fn(pool[k % pool.shape[0]]))
    host_us("pool_index", lambda k: pool[k % pool.shape[0]])
    host_us("as_tensor", lambda k: torch.as_tensor(X, dtype=h.Xu.dtype, device=h.Xu.device))
    host_us("no_grad", no_grad)
    host_us("capturable", lambda k: serve._capturable(X))
    host_us("key", lambda k: (fn, tuple(X.shape), X.dtype, X.device))
    host_us("copy_in", lambda k: g.x.copy_(X))
    host_us("replay", lambda k: g.graph.replay())
    host_us("clone_one", lambda k: outs[0].clone())
    host_us("graph_call", lambda k: g(X))

    def device_us(f, n=200):
        ts = []
        for k in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync("cuda")
            e0.record()
            f(k)
            e1.record()
            sync("cuda")
            ts.append(e0.elapsed_time(e1) * 1e3)
        return statistics.median(ts)

    res["device_us_replay"] = device_us(lambda k: g.graph.replay())
    res["device_us_call"] = device_us(lambda k: fn(pool[k % pool.shape[0]]))
    t0 = time.perf_counter()
    for k in range(args.calls):
        fn(pool[k % pool.shape[0]])
        sync("cuda")
    res["loop_us_per_call"] = (time.perf_counter() - t0) / args.calls * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(50):
            fn(pool[k % pool.shape[0]])
            sync("cuda")
    res["api_us"] = {e.key: [e.count, e.cpu_time_total / e.count] for e in prof.key_averages()
                     if e.key.startswith(("cuda", "aten::"))}
    if isinstance(h, serve.SVGPRegressor):
        res["svgp_var"] = svgp_var_costs(h, X)
    res["graph_counts"] = dict(serve.graph_counts)
    res["device"] = {"kind": torch.cuda.get_device_name(), "power_limit": card.power_limit()}
    print(json.dumps({"cell": args.workload, "seed": args.seed, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
