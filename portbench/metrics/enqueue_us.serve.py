"""Host microseconds from a handle call's start to its return, before the
synchronize, averaged over the traced run's calls outside the profiled
sub-window (the profiler adds to each call's host cost)."""


def read(run):
    if not run.enqueue_s:
        return None
    return 1e6 * sum(run.enqueue_s) / len(run.enqueue_s)
