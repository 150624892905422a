"""The SE Gram kernel's share of its roofline, %: the least time for one
Gram of the call's shape (``counts.gram_least_seconds``: the larger of its
FLOPs at the float32 peak and its bytes at the HBM peak) over the mean
measured time of ``se_gram_kernel`` in the profiled sub-window."""

from portbench.counts import gram_least_seconds


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    n, seconds = run.trace.kernel_time("se_gram_kernel")
    if n == 0:
        return None
    s = run.shapes
    return 100.0 * gram_least_seconds(s["M"], s["B"], s["D"], run.peaks) / (seconds / n)
