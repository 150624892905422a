"""The 95th percentile (nearest rank), over every call of the window, of a
serving call's time from its start to the end of the synchronize that
follows it, when its predictions are ready on the device: host clock, ms."""

from portbench.trace import percentile


def read(run):
    lat = run.work.get("call_seconds")
    return 1e3 * percentile(lat, 95) if lat else None
