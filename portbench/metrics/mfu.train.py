"""Share of the card's float32 peak, %, of the collapsed steps' FLOPs, forward
and backward (``counts.collapsed_step_flops``), over the profiled
sub-window's seconds, over 67 TFLOP/s (the result's
``device.power_limit`` gives the card's limit)."""

from portbench.counts import collapsed_step_flops


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    flops = collapsed_step_flops(s["M"], s["N"], s["D"]) * run.trace_work["steps"]
    return 100.0 * flops / run.trace.window_s / run.peaks["fp32_flop_per_s"]
