"""portbench: the benchmark of ``gaussianprocessnode_tpu_torch`` on one NVIDIA H100.

One command runs one cell once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line. ``BENCHMARK.json`` at the root of the checkout
names the cells and metrics; everything that belongs to one configuration,
traffic mix, cell, driver, reference or metric sits in a file of its own,
found by name:

- ``configs/<config>.json``: the model's sizes and constants, and under
  ``small`` the sizes that the CPU tests run it at;
- ``datasets/<data>.py``: the seeded data that a configuration names;
- ``traffic/<traffic>.json``: parameters that ``traffic.py`` reads (with
  their own ``small`` sizes);
- ``workloads/<cell>.json``: the cell's driver, reference and limits;
- ``drivers/<driver>.py``: set-up, the measured window, the outputs and the
  faults that its cells can have (``FAULTS``);
- ``reference/<name>.py``: the plain PyTorch reference that a driver
  compares with (imports nothing of the port);
- ``metrics/<metric>.py``: one reader per metric.

The yardstick (data and traffic generation, trace reduction, peaks, the
operation and byte counts, the comparison that decides ``correct``) lives
here too. Nothing here imports ``jax`` or the JAX package.
"""
