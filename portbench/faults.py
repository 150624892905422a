"""Planting a fault in the port's timed path, to show that ``correct``
catches it (``tests/test_portbench_correct.py`` at small sizes on the CPU,
``calibrate.py`` at the cells' sizes on the card).

Each driver declares the faults that its cells can have in its ``FAULTS``:
{name: a function of no arguments that returns a context manager, which
plants the fault for the duration of a ``with`` block}, most often
:func:`patched` over functions of the port."""

import contextlib


@contextlib.contextmanager
def patched(*patches):
    """For the block, replace each ``(module, name, wrap)``'s function
    ``module.name`` by ``wrap(original)``; the originals come back after it."""
    origs = [(module, name, getattr(module, name)) for module, name, _ in patches]
    try:
        for (module, name, wrap), (_, _, orig) in zip(patches, origs):
            setattr(module, name, wrap(orig))
        yield
    finally:
        for module, name, orig in origs:
            setattr(module, name, orig)
