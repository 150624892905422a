"""What the benchmark loads: nothing of JAX or the JAX package (whole
top-level names), and a reference that loads nothing of the port; a run
without a card, or without the port beside it, prints no result."""

import ast
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import manifest as mf
from portbench.run import FORBIDDEN, forbidden_modules

LOAD_ALL = """
import sys
import portbench.run, portbench.calibrate
from portbench import manifest as mf
man = mf.load_manifest()
for d in mf.drivers():
    mf.driver(d)
for m in man["end_to_end"] + man["per_layer"]:
    mf.metric_reader(m["name"])
print(",".join(portbench.run.forbidden_modules()))
print("gaussianprocessnode_tpu_torch" in sys.modules)
"""


def _python(code, cwd=mf.ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_nothing_loaded_is_jax_or_the_jax_package():
    out = _python(LOAD_ALL)
    assert out.returncode == 0, out.stderr
    found, port = out.stdout.splitlines()
    assert found == "" and port == "True"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussianprocessnode_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gaussianprocessnode_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["gaussianprocessnode_tpu", "jax"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "gaussianprocessnode_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    for path in (mf.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] in ("", "math", "torch", "numpy"), (path.name, n)
    mods = ",".join(f"portbench.reference.{p.stem}" for p in (mf.HERE / "reference").glob("*.py"))
    out = _python(f"import importlib, sys\nfor m in '{mods}'.split(','): "
                  "importlib.import_module(m)\nprint(sorted({m.split('.')[0] for m in "
                  "sys.modules} & {'gaussianprocessnode_tpu_torch', 'jax'}))")
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "kin40k.serve.b262k", "--seed", "1", "--seconds", "1"],
                         cwd=mf.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    shutil.copy(mf.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(mf.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "kin40k.serve.b262k", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
