"""One reader per metric, ``<metric>.py``, loaded by path (a metric's name
may hold dots). ``read(run)`` returns the metric's value, or None where the
run has nothing for it to read (the harness then leaves it out). ``run``
holds ``setup_s``, ``work`` (the window's seconds and work done),
``trace`` (``portbench.trace.Trace`` of the profiled sub-window, or None),
``trace_work`` (the work inside it), ``enqueue_s``, ``shapes``,
``classifier`` and ``peaks`` (the card's, or None)."""
