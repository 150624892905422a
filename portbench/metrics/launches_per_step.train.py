"""Kernel records per collapsed step in the profiled sub-window (whole
chunks, each with its host read): a count."""


def read(run):
    if run.trace is None or not run.trace_work.get("steps"):
        return None
    n, _ = run.trace.kernel_time()
    return n / run.trace_work["steps"]
