"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, data and state from the seed, the kernel library's build
or load, the first calls) is timed from the start of this module to the
start of the window. ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` profiles a sub-window in the middle of the window and reports
the per-layer metrics, the device's busy and window seconds and a
breakdown, and writes the run's spans to ``portbench_out/``. After the
window the program's counters (``se_gram_cuda.launches``) are printed on
lines of their own before the result line (``counter <name> <value> ...``),
and its answers are compared with the plain reference: each compared number
is printed beside its limit, on the last lines of standard error and under
``checks``, the last key of the result line. Without a CUDA
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import manifest as mf  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianprocessnode_tpu")
OUT = mf.ROOT / "portbench_out"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    its libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             manifest=None, cfg=None, traffic=None, spec=None, t_start=None):
    """One run of cell ``name``. Returns the result line's object. ``cfg``,
    ``traffic`` and ``spec`` replace the cell's files (tests run cells at
    small sizes on the CPU)."""
    import torch

    from . import card, compare, peaks
    from .trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or mf.load_manifest()
    files = mf.cell_files(manifest, name)
    cfg, traffic, spec = cfg or files[0], traffic or files[1], spec or files[2]
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(name, 1)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(on=bool(trace))
    session = mf.driver(spec["driver"]).Session(cfg, traffic, spec, seed, device, tracer)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    work = session.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    session.release()
    gaps, failed = session.check(spec["limits"])
    checks = compare.judge(gaps, spec["limits"])

    kind = torch.cuda.get_device_name() if on_card else str(device)
    run = SimpleNamespace(setup_s=setup_s, work=work, trace=tracer.trace,
                          trace_work=session.trace_work, enqueue_s=session.enqueue_s,
                          shapes=session.shapes, classifier=spec.get("head") == "classifier",
                          peaks=peaks.for_card(kind))
    metrics = {}
    for m in mf.metrics(manifest, name, "per_layer" if trace else "end_to_end"):
        value = mf.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else str(device), "kind": kind,
           "count": chips, "memory_peak_bytes": peak,
           "power_limit": card.power_limit() if on_card else "not read"}
    result = {"counters": work.get("counters", {}),
              "correct": compare.passed(checks), "attempted": session.attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = tracer.trace
        dev["busy_s"], dev["window_s"] = t.busy_s(), t.window_s
        result["trace_edges_s"] = list(t.edges())
        result["breakdown"] = {"device_ops": [list(x) for x in t.top_ops()],
                               "idle_gaps": [list(x) for x in t.idle_gaps()]}
        tracer.write(OUT / f"spans-{name}-{seed}.jsonl")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = mf.load_manifest()
    chips = mf.workload(manifest, args.workload)["chips"]

    import torch

    from . import card

    card.require(chips)
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      manifest=manifest, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result.pop("counters").items():
        print(f"counter {k} {v} in {result['attempted']} window units")
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
