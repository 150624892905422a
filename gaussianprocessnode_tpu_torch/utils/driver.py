"""Chunked training driver.

Counterpart of ``gaussianprocessnode_tpu/utils/driver.py`` without its
retry loop: the JAX package re-ran a chunk on a transient fault of its TPU
link, which has no counterpart on the card (a CUDA error is not transient
and must propagate). What stays is the chunking: a trainer resumable from
its carry runs in chunks of epochs, so that a runner can checkpoint between
chunks and each chunk ends with one host read.
"""

import torch

__all__ = ["chunked_run"]


def chunked_run(step_fn, total: int, chunk: int, state):
    """Run ``step_fn(n_epochs, resume_state) -> out`` in chunks of at most
    ``chunk`` epochs until ``total`` epochs are done. ``out[-1]`` must be
    the resume carry and ``out[0]`` a tensor, which is read on the host
    once per chunk (so a chunk's work is done when the next starts).
    Returns the last chunk's ``out`` (None when ``total`` is 0)."""
    done = 0
    out = None
    while done < total:
        e = min(chunk, total - done)
        out = step_fn(e, state)
        torch.as_tensor(out[0]).cpu()
        state = out[-1]
        done += e
    return out
