"""Drivers: each drives one kind of cell through the port's library calls.

A driver module defines ``Session(cfg, traffic, spec, seed, device,
tracer)``, whose constructor is the set-up (data and state from the seed,
the first calls that build and warm up every shape the cell uses), and
whose methods are ``window(seconds)`` (the measured window; returns the
work done), ``release()`` (frees the program's state) and
``check(limits)`` (the comparison with the reference; returns the compared
numbers and the count of failed answers). It also holds ``shapes``,
``attempted``, ``trace_work`` (the work inside the profiled sub-window)
and ``enqueue_s`` for the metric readers. Its module-level ``FAULTS``
names the faults that its cells can have and plants each (``faults.py``)."""
