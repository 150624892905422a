"""Share of the window's handle calls answered by a CUDA graph's replay, %:
the program's ``serve.graph_counts["replays"]`` over the window
(``graph_replays``, a counter of the run) over the window's calls."""


def read(run):
    n = run.work.get("counters", {}).get("graph_replays")
    if n is None or not run.work.get("calls"):
        return None
    return 100.0 * n / run.work["calls"]
