"""Device kernel milliseconds per collapsed step: the summed time of the
kernels in the profiled sub-window (whole chunks, each with its host read)
over its steps."""


def read(run):
    if run.trace is None or not run.trace_work.get("steps"):
        return None
    _, seconds = run.trace.kernel_time()
    return 1e3 * seconds / run.trace_work["steps"]
