"""Device idle share, %: one minus the union of the device operations'
intervals (kernels, copies, sets) over the profiled sub-window."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share()
