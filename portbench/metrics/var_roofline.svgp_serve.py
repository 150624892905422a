"""The SVGP predictive variance's share of its roofline, %: the least time of
the variance stage of one call (``svgp_counts.var_least_seconds``: its
FLOPs at the float32 peak or its bytes at the HBM peak, the larger) over
the device's busy time per call outside ``se_gram_kernel`` in the profiled
sub-window. No other kernel is read by name, so the stage's kernels may
change; the busy time also holds the mean, the input copy and the output
clones, so the share is a floor of the stage's own."""

from portbench.svgp_counts import var_least_seconds


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    _, gram_s = run.trace.kernel_time("se_gram_kernel")
    rest = (run.trace.busy_s() - gram_s) / run.trace_work["calls"]
    s = run.shapes
    return 100.0 * var_least_seconds(s["M"], s["B"], run.peaks) / rest
