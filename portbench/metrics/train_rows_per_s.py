"""Training rows processed per second: every step of the window processes
the full batch, so steps × N over the window's seconds (host clock from the
window's start to the end of its last chunk's host read)."""


def read(run):
    rows = run.work.get("rows")
    return None if rows is None else rows / run.work["seconds"]
