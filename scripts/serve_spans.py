#!/usr/bin/env python3
"""Where a serving call's host time and the device's idle gaps go, by span.

Run from the root of the repository on a machine with one NVIDIA card:

    python3 scripts/serve_spans.py --workload kin40k.serve.b262k --seed N [--seconds 50]

It runs one traced run of a serving cell of the benchmark, as
``python3 -m portbench.run --trace 1`` runs it (``portbench.run.run_cell``),
with the benchmark's ``Tracer`` replaced by one that also turns the
program's span recorder (``gaussianprocessnode_tpu_torch.utils.tracing``)
on when it is made: so the program's spans, set-up included, and the
benchmark's (``serve.call``, ``serve.sync``) lie on one clock, the
profiler's. It writes both kinds, with ``parent`` and ``request``, to
``portbench_out/spans-<cell>-<seed>.jsonl`` and prints one JSON line:

- ``bench``: the run's own result line (per-layer metrics, ``correct``);
- ``calls``: the window calls outside the profiled sub-window (the calls
  ``enqueue_us.serve`` averages; the warm-up calls are not window calls),
  and over them, per call, ``predict_host_us`` (the ``serve.predict``
  span), ``gram_dispatch_us`` (``se_gram.dispatch``), ``params_fill_us``
  (``kernel.params`` + ``serve.fill``) and ``self_us`` (each span name's
  self time);
- ``setup``: ``program_setup_s`` (``ops.load_library`` + ``serve.from_natural``),
  each of them, whether the library was built, the warm-up calls, and the
  set-up's seconds from this script's start to the window's first call;
- ``idle``: the sub-window's idle gaps put down to the span of either kind
  that overlaps each most (the shorter on a tie, ``portbench.trace.label``):
  the largest gaps, every gap over 1 ms with the shortest spans inside it,
  and idle seconds by that label and by the innermost span open through
  each part of a gap;
- ``launches``: ``se_gram.launch`` spans in the sub-window against the
  trace's ``se_gram_kernel`` records;
- ``gc``: the collections during the window, by generation.
"""

import time

T0_NS = time.time_ns()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gaussianprocessnode_tpu_torch.utils import tracing  # noqa: E402
from portbench import faults, manifest as mf  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402

SETUP_SPANS = ("ops.load_library", "serve.from_natural")
OUT = ROOT / "portbench_out"


class RecordingTracer(bench_trace.Tracer):
    """The benchmark's ``Tracer`` that, when on, turns the program's
    recorder on too. ``made`` keeps the last one made."""

    made = None

    def __init__(self, on: bool = False):
        super().__init__(on=on)
        if on:
            tracing.start()
        RecordingTracer.made = self


def traced_run(cell: str, seed: int, seconds: float, **run_cell_args):
    """(result line, program spans, the benchmark's Trace and spans) of one
    traced run of ``cell``."""
    from portbench.run import run_cell

    with faults.patched((bench_trace, "Tracer", lambda orig: RecordingTracer)):
        try:
            result = run_cell(cell, seed, seconds, True, **run_cell_args)
        finally:
            tracing.stop()
    tr = RecordingTracer.made
    return result, tracing.spans(), tr.trace, tr.spans


def _us(ns) -> float:
    return ns / 1e3


def window_calls(program, bench_spans, window_ns):
    """Requests of the ``serve.predict`` roots that window calls made
    outside the profiled sub-window ``window_ns`` (start, end): those that
    start at or after the first ``serve.call``."""
    calls = [s for s in bench_spans if s[0] == "serve.call"]
    if not calls:
        return []
    first = min(s[1] for s in calls)
    lo, hi = window_ns
    return [s.request for s in program
            if s.name == "serve.predict" and s.parent is None and s.end_ns is not None
            and s.start_ns >= first and not lo <= s.start_ns <= hi]


def per_call(program, requests):
    """Per call of ``requests``, means in µs: ``predict_host_us``,
    ``gram_dispatch_us``, ``params_fill_us``, and ``self_us`` by span name
    (None where there is no call)."""
    if not requests:
        return None
    want = set(requests)
    selfs = tracing.self_ns(program)
    total, own = {}, {}
    for s, si in zip(program, selfs):
        if s.request in want and s.end_ns is not None:
            total[s.name] = total.get(s.name, 0) + (s.end_ns - s.start_ns)
            own[s.name] = own.get(s.name, 0) + si
    n = len(want)
    return {"n": n,
            "predict_host_us": _us(total.get("serve.predict", 0)) / n,
            "gram_dispatch_us": _us(total.get("se_gram.dispatch", 0)) / n,
            "params_fill_us": _us(total.get("kernel.params", 0)
                                  + total.get("serve.fill", 0)) / n,
            "self_us": {k: _us(v) / n for k, v in sorted(own.items())}}


def setup_part(program, bench_spans, t0_ns=None):
    """The program's share of set-up: the spans before the first window
    call (``ops.load_library``, ``serve.from_natural``, the warm-up
    ``serve.predict`` calls), in seconds; ``setup_s`` from ``t0_ns`` to that
    call where given."""
    calls = [s[1] for s in bench_spans if s[0] == "serve.call"]
    first = min(calls) if calls else None
    before = [s for s in program if s.end_ns is not None
              and (first is None or s.start_ns < first)]

    def secs(name):
        return sum(s.end_ns - s.start_ns for s in before if s.name == name) / 1e9

    lib = [s for s in before if s.name == "ops.load_library"]
    out = {name: secs(name) for name in SETUP_SPANS}
    out["program_setup_s"] = sum(out[n] for n in SETUP_SPANS)
    out["built"] = lib[0].attrs["built"] if lib and lib[0].attrs else None
    out["warmup_calls"] = sum(1 for s in before if s.name == "serve.predict"
                              and s.parent is None)
    out["warmup_s_less_library"] = secs("serve.predict") - out["ops.load_library"]
    if t0_ns is not None and first is not None:
        out["setup_s"] = (first - t0_ns) / 1e9
    return out


def inside(gap, spans, n: int = 4):
    """The ``n`` shortest spans that overlap ``gap`` by a tenth of it or
    more: (name, overlap s, duration s)."""
    hits = [(name, min(e, gap[1]) - max(s, gap[0]), e - s) for name, s, e, _ in spans]
    return sorted((h for h in hits if h[1] >= 0.1 * (gap[1] - gap[0])), key=lambda h: h[2])[:n]


def innermost(gap, spans, by: dict) -> None:
    """Add to ``by`` each part of ``gap`` under the deepest span open
    through it (the shorter on a tie; "no span" where none is)."""
    cuts = sorted({gap[0], gap[1]} | {t for _, s, e, _ in spans for t in (s, e)
                                      if gap[0] < t < gap[1]})
    for a, b in zip(cuts, cuts[1:]):
        m = (a + b) / 2
        open_ = [(d, -(e - s), name) for name, s, e, d in spans if s <= m < e]
        name = max(open_)[2] if open_ else "no span"
        by[name] = by.get(name, 0.0) + (b - a)


def labelled(trace, program, n: int = 10):
    """The sub-window's idle gaps labelled by both kinds of span (the span
    that overlaps a gap most, the shorter on a tie, as the benchmark labels
    them): the ``n`` largest, every gap over 1 ms with the spans inside it,
    idle seconds by label, and idle seconds by the innermost span open
    through each part of a gap (the benchmark's spans at depth 0, a root
    of the program's at 1)."""
    lo, hi = trace.window
    depth = []
    for s in program:
        depth.append(1 if s.parent is None else depth[s.parent] + 1)
    spans = [(name, s, e, 0) for name, s, e in trace.spans] + [
        (s.name, s.start_ns / 1e9, s.end_ns / 1e9, d) for s, d in zip(program, depth)
        if s.end_ns is not None and s.end_ns / 1e9 > lo and s.start_ns / 1e9 < hi]
    spans.sort(key=lambda x: x[1])
    starts = [x[1] for x in spans]
    longest = max((e - s for _, s, e, _ in spans), default=0.0)
    intervals = [(s, e) for _, s, e in trace.ops]
    labels, over, by_label, by_inner = [], [], {}, {}
    for g in bench_trace.gaps(intervals, *trace.window):
        near = [x for x in spans[bisect.bisect_left(starts, g[0] - longest):
                                 bisect.bisect_left(starts, g[1])] if x[2] > g[0]]
        name, d = bench_trace.label(g, [x[:3] for x in near]), g[1] - g[0]
        labels.append((name, d))
        by_label[name] = by_label.get(name, 0.0) + d
        innermost(g, near, by_inner)
        if d > 1e-3:
            over.append((name, d, inside(g, near)))

    def ranked(by):
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    return {"largest": sorted(labels, key=lambda x: -x[1])[:n], "over_1ms": over,
            "by_label_s": ranked(by_label), "by_innermost_s": ranked(by_inner),
            "idle_s": sum(by_label.values()), "window_s": trace.window_s}


def launches(trace, program):
    """``se_gram.launch`` spans that started in the sub-window, and the
    trace's ``se_gram_kernel`` records."""
    lo, hi = trace.window
    spans = sum(1 for s in program if s.name == "se_gram.launch"
                and lo <= s.start_ns / 1e9 <= hi)
    return {"launch_spans": spans, "kernel_records": trace.kernel_time("se_gram_kernel")[0]}


def gc_during(program, bench_spans):
    """Collections after the first window call, by generation: count and
    total ms, and the longest in ms."""
    calls = [s[1] for s in bench_spans if s[0] == "serve.call"]
    first = min(calls) if calls else 0
    out = {}
    for s in program:
        if s.name == "python.gc" and s.start_ns >= first and s.end_ns is not None:
            g = out.setdefault(str(s.attrs["generation"]), {"n": 0, "ms": 0.0, "max_ms": 0.0})
            d = (s.end_ns - s.start_ns) / 1e6
            g["n"] += 1
            g["ms"] += d
            g["max_ms"] = max(g["max_ms"], d)
    return out


def write_spans(path, program, bench_spans) -> None:
    """Both kinds of span, one JSON object a line: the program's with their
    store index ``id``, ``parent`` and ``request``; the benchmark's with no
    parent and the request of the ``serve.predict`` root they hold."""
    roots = sorted((s.start_ns, s.request) for s in program
                   if s.name == "serve.predict" and s.parent is None)
    starts = [r[0] for r in roots]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for i, s in enumerate(program):
            f.write(json.dumps({"id": i, "span": s.name, "start_ns": s.start_ns,
                                "end_ns": s.end_ns, "parent": s.parent,
                                "request": s.request, "attrs": s.attrs}) + "\n")
        for name, t0, t1 in bench_spans:
            k = bisect.bisect_left(starts, t0)
            req = roots[k][1] if k < len(roots) and roots[k][0] <= t1 else None
            f.write(json.dumps({"span": name, "start_ns": t0, "end_ns": t1,
                                "parent": None, "request": req}) + "\n")


def report(cell, seed, seconds, **run_cell_args) -> dict:
    result, program, trace, bench_spans = traced_run(cell, seed, seconds, **run_cell_args)
    write_spans(OUT / f"spans-{cell}-{seed}.jsonl", program, bench_spans)
    window_ns = (int(trace.window[0] * 1e9), int(trace.window[1] * 1e9))
    return {"cell": cell, "seed": seed, "bench": result,
            "calls": per_call(program, window_calls(program, bench_spans, window_ns)),
            "setup": setup_part(program, bench_spans, T0_NS),
            "idle": labelled(trace, program),
            "launches": launches(trace, program),
            "gc": gc_during(program, bench_spans),
            "spans": len(program)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import card

    card.require(mf.workload(mf.load_manifest(), args.workload)["chips"])
    torch.set_num_threads(1)
    out = report(args.workload, args.seed, args.seconds)
    out["device"] = {"kind": torch.cuda.get_device_name(), "power_limit": card.power_limit()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
