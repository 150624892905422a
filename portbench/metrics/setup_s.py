"""Set-up seconds: from the start of the benchmark's module (before torch and
the port are imported) to the start of the window, host clock; it holds the
imports, the data and state made from the seed, the kernel library's build
or load, and the first calls."""


def read(run):
    return run.setup_s
