"""Finding a cell's files by the names in ``BENCHMARK.json``."""

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path=MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest, name) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest, name) -> dict:
    """The configuration's file, as JSON."""
    entry = _by_name(manifest["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def cell_spec(name) -> dict:
    """``workloads/<cell>.json``: the cell's configuration and traffic (as its
    ``BENCHMARK.json`` entry names them), driver, options and limits."""
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def cell_files(manifest, name):
    """(configuration, traffic, spec) of the cell, by its spec's names."""
    spec = cell_spec(name)
    return config(manifest, spec["config"]), traffic(spec["traffic"]), spec


def cells() -> list:
    """Every cell that has a spec file, entered in ``BENCHMARK.json`` or not."""
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def metrics(manifest, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def driver(name):
    return importlib.import_module(f"portbench.drivers.{name}")


def drivers() -> list:
    """Every driver's name (``drivers/<name>.py``)."""
    return sorted(p.stem for p in (HERE / "drivers").glob("*.py") if p.stem != "__init__")


def metric_reader(name):
    """``metrics/<name>.py``, loaded from its path (a metric's name may hold
    dots); its ``read(run)`` gives the value or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
