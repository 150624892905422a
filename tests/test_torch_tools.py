"""The port's measurement tool for the SE Gram kernel (scripts/se_gram_ab.py)
where there is no card: its diagnostic variants must match the kernel
sources it is meant for, or its store-only and compute-only readings would
silently time the full kernel."""

import importlib.util
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CU = ROOT / "gaussianprocessnode_tpu_torch" / "ops" / "csrc" / "se_gram.cu"


def _tool():
    spec = importlib.util.spec_from_file_location("se_gram_ab", ROOT / "scripts" / "se_gram_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _first_version():
    """The kernel as the serving slice first committed it, from git history
    (absent where the checkout has no history)."""
    try:
        return subprocess.run(["git", "show", "6f40e7f:gaussianprocessnode_tpu_torch/ops/csrc/se_gram.cu"],
                              cwd=ROOT, capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None


@pytest.mark.parametrize("which", ["committed", "first version"])
def test_variants_replace_the_epilogue_once(which):
    src = CU.read_text() if which == "committed" else _first_version()
    if src is None:
        pytest.skip("no git history in this checkout")
    v = _tool().variants("k", src)
    assert set(v) == {"k", "k:store-only", "k:compute-only"}
    for name in ("k:store-only", "k:compute-only"):
        assert v[name] != src and v[name].count("se_gram_f32(") == src.count("se_gram_f32(")
    assert "expf(" not in v["k:store-only"] and "ex2_approx(fmaxf" not in v["k:store-only"]


def test_unknown_epilogue_gets_no_variants():
    assert _tool().variants("k", "int se_gram_f32() { return 0; }") == {
        "k": "int se_gram_f32() { return 0; }"}


def test_refuses_to_run_without_card():
    mod = _tool()
    if mod.torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    assert mod.main([]) == 1
