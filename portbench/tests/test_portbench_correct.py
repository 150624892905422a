"""``correct`` at small sizes on the CPU: a sound run passes; every fault the
cell can have, planted in the port's timed path under a run that skips the
look for a card, fails it; and the control (the reference at TF32 in the
program's place) reads above the cell's limits."""

import pytest
import torch

import sys

from portbench import compare, manifest as mf
from portbench.run import run_cell
from portbench.trace import Tracer

from .small import CELLS, files

SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace=False):
    cfg, tr, spec = files(cell)
    return run_cell(cell, SEED, 0.3, trace, device="cpu", cfg=cfg, traffic=tr, spec=spec)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in
                                 mf.metrics(mf.load_manifest(), cell, "end_to_end")}


def _faults(cell):
    return mf.driver(mf.cell_spec(cell)["driver"]).FAULTS


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in _faults(c)])
def test_a_planted_fault_is_not_correct(cell, fault):
    with _faults(cell)[fault]():
        r = _run(cell)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    cfg, tr, spec = files(cell)
    s = mf.driver(spec["driver"]).Session(cfg, tr, spec, SEED, "cpu", Tracer())
    checks = compare.judge(s.control(), spec["limits"])
    assert not compare.passed(checks), checks


def _port_functions():
    return {(name, k): v for name, mod in list(sys.modules.items())
            if name.split(".")[0] == "gaussianprocessnode_tpu_torch"
            for k, v in vars(mod).items() if callable(v)}


@pytest.mark.parametrize("driver", mf.drivers())
def test_faults_leave_the_port_as_it_was(driver):
    faults = mf.driver(driver).FAULTS
    assert faults
    before = _port_functions()
    for plant in faults.values():
        with plant():
            assert _port_functions() != before
    assert _port_functions() == before
