"""Predictions completed per second: every call of the window answers a whole
batch, so calls × rows over the window's seconds (host clock from the
window's start to the synchronize that ends its last call)."""


def read(run):
    n = run.work.get("predictions")
    return None if n is None else n / run.work["seconds"]
