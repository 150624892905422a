"""Parallel prefix scan over the leading axis (``jax.lax.associative_scan``).

PyTorch has no associative scan. This one follows JAX's recursive odd/even
scheme (``jax/_src/lax/control_flow/loops.py::associative_scan``): combine
adjacent pairs, scan the half-length result recursively, then combine it
with the even-indexed elements and interleave. The elements are combined in
the same order as in JAX, so a scan whose ``fn`` does the same arithmetic
rounds the same way. ``fn`` works on whole batches: it takes two tuples of
tensors with equal leading lengths and returns one; each call is a handful
of batched ops, O(log T) rounds in all.
"""

import torch

__all__ = ["associative_scan"]


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], … along the leading axis; len(a) is len(b)
    or len(b) + 1."""
    out = torch.empty((a.shape[0] + b.shape[0],) + a.shape[1:], dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def _scan(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    # combine adjacent pairs: (0, 1), (2, 3), …
    reduced = fn(tuple(e[0:n - 1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _scan(fn, tuple(reduced))
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(tuple(odd), tuple(e[2::2] for e in elems))
    # the first element of a scan is the first element of ``elems``
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of ``elems`` (a tuple of tensors sharing their leading
    length T) under the associative ``fn(a, b) -> c`` on tuples: element t
    of the result is elems[0] ∘ … ∘ elems[t], or, with ``reverse``, elems[t]
    ∘ … ∘ elems[T−1] combined from the end (the elements are reversed,
    scanned and reversed back, so ``fn``'s first argument is the later
    element), as ``jax.lax.associative_scan``."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, dims=(0,)) for e in elems)
    out = _scan(fn, elems)
    if reverse:
        out = tuple(torch.flip(e, dims=(0,)) for e in out)
    return out
