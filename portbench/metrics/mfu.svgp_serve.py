"""Share of the card's float32 peak, %, of the SVGP handle calls' FLOPs: the
predictions completed in the profiled sub-window times
``svgp_counts.flops_per_prediction`` (the Gram's column, the solve, the
product with Ãᵀ, the mean), over the sub-window's seconds, over 67 TFLOP/s
(the result's ``device.power_limit`` gives the card's limit)."""

from portbench.svgp_counts import flops_per_prediction


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    s = run.shapes
    flops = flops_per_prediction(s["M"], s["D"]) * run.trace_work["predictions"]
    return 100.0 * flops / run.trace.window_s / run.peaks["fp32_flop_per_s"]
