"""The cells at sizes that a CPU test run holds: the same files, with the
sizes that each configuration and traffic file gives under ``small``
(widths and traffic kinds unchanged)."""

from portbench import manifest as mf

CELLS = tuple(mf.cells())


def files(name: str):
    """(cfg, traffic, spec) of cell ``name`` at a small size."""
    cfg, tr, spec = mf.cell_files(mf.load_manifest(), name)
    cfg.update(cfg.pop("small"))
    tr.update(tr.pop("small"))
    return cfg, tr, spec
