"""On the card: each cell runs end to end for a short window and is correct,
and its control is not. Run there with
``python3 -m pytest -p no:cacheprovider -m gpu portbench/tests``."""

import pytest
import torch

from portbench import compare, manifest as mf
from portbench.run import run_cell
from portbench.trace import Tracer

CELLS = [w["name"] for w in mf.load_manifest()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    _card()
    r = run_cell(cell, 2**31 + 5, 1.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_control_is_not_correct(cell):
    _card()
    cfg, tr, spec = mf.cell_files(mf.load_manifest(), cell)
    s = mf.driver(spec["driver"]).Session(cfg, tr, spec, 2**31 + 6, "cuda", Tracer())
    assert not compare.passed(compare.judge(s.control(), spec["limits"]))
