"""The port's banana runner (experiments/banana.py), its data and the
faithful kin40k runner option, on the CPU at a small size; the full-size
runs are on the card (chip_smoke.py phase 7, and the runners' command
lines)."""

import json
import math

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gaussianprocessnode_tpu.utils import datasets as jdatasets
from gaussianprocessnode_tpu_torch.experiments import banana as runner
from gaussianprocessnode_tpu_torch.experiments import kin40k as kin40k_runner
from gaussianprocessnode_tpu_torch.utils import datasets


def test_synthetic_banana_shape_balance_and_seed():
    a = datasets.banana_synthetic(3)
    b = datasets.banana_synthetic(3)
    c = datasets.banana_synthetic(4)
    assert a.x_train.shape == (4000, 2) and a.y_train.shape == (4000,)
    assert a.x_test.shape == (1300, 2) and a.y_test.shape == (1300,)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a.x_train, c.x_train)
    for y in (a.y_train, a.y_test):
        assert set(np.unique(y)) == {0.0, 1.0}
        assert 0.45 <= y.mean() <= 0.55
    # standardised with the training points' moments
    np.testing.assert_allclose(a.x_train.mean(axis=0), 0.0, atol=1e-12)
    np.testing.assert_allclose(a.x_train.std(axis=0), 1.0, rtol=1e-12)


def test_synthetic_banana_classes_overlap():
    """No classifier is free of errors: the nearest other training point
    carries the other label for ≥ 5 % of the points, and the 15-nearest-
    neighbour vote, near the Bayes rule at this size, still errs on ≥ 5 %
    of the test points (the reference's banana: 9.6 %)."""
    d = datasets.banana_synthetic(1)
    tree = cKDTree(d.x_train)
    _, nn = tree.query(d.x_train, k=2)
    assert np.mean(d.y_train[nn[:, 1]] != d.y_train) >= 0.05
    _, nn = tree.query(d.x_test, k=15)
    vote = d.y_train[nn].mean(axis=1) > 0.5
    assert 0.05 <= np.mean(vote != d.y_test) <= 0.2


def test_banana_loader_is_the_jax_packages(tmp_path):
    """The port's copy reads the same file the same way (labels −1/1 →
    0/1); an absent file raises."""
    d = tmp_path / "data" / "banana"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = np.column_stack([rng.standard_normal((10, 2)), rng.choice([-1.0, 1.0], 10)])
    np.savetxt(d / "banana.csv", rows, delimiter=",", header="x,y,label", comments="")
    got = datasets.banana(str(tmp_path), n_train=6)
    want = jdatasets.banana(str(tmp_path), n_train=6)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    assert set(np.unique(got.y_train)) <= {0.0, 1.0}
    with pytest.raises(FileNotFoundError):
        datasets.banana(str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="synthetic"):
        runner.load_data("banana_small")


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "faithful"])
def test_runner_trains_and_classifies_on_cpu(fast, tmp_path):
    """A small configuration end to end on the CPU (no kernel launches
    there): the error rate falls below chance and below the untrained
    model's, the JSON line's keys, ``--json`` writes the same line."""
    kw = dict(m_inducing=40, batch_size=200, device="cpu", fast=fast)
    one = runner.run(epochs=1, **kw)
    more = runner.run(epochs=6, **kw)
    for r in (one, more):
        assert math.isfinite(r["value"]) and r["value"] > 0
        assert r["n_test"] == 1300 and r["errors"] == round(r["error_rate"] * 1300)
        assert r["gram_launches"] == 0 and r["device"] == {"name": "cpu"}
        assert r["trainer"] == ("fit_banana_fast" if fast else "fit_banana")
        assert r["w_mean"] > 0 and len(r["theta_softplus"]) == 3
    assert more["error_rate"] < 0.3 and more["error_rate"] <= one["error_rate"]
    assert json.loads(json.dumps(more)) == more


def test_runner_cli_writes_json(tmp_path, capsys, monkeypatch):
    run = runner.run

    def small_run(**kw):
        return run(m_inducing=16, batch_size=500, device="cpu", **kw)

    monkeypatch.setattr(runner, "run", small_run)
    path = tmp_path / "out.json"
    assert runner.main(["--epochs", "1", "--faithful", "--f64", f"--json={path}"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(path.read_text()) == json.loads(line)
    out = json.loads(line)
    assert out["trainer"] == "fit_banana" and out["dtype"] == "float64"


def test_banana_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        runner.run(epochs=1, m_inducing=8)


def test_kin40k_runner_faithful_trains_in_float64_on_cpu():
    """--faithful: fit_kin40k in float64 by default (the JAX runner's
    choice), the SMSE finite and below a zero predictor's; --f32 keeps it
    in float32."""
    kw = dict(m_inducing=32, batch_size=100, n_train=400, n_test=200, device="cpu",
              faithful=True)
    r = kin40k_runner.run(epochs=2, **kw)
    assert r["trainer"] == "fit_kin40k" and r["dtype"] == "float64"
    assert math.isfinite(r["smse"]) and r["smse"] < 1.0
    r32 = kin40k_runner.run(epochs=1, dtype=torch.float32, **kw)
    assert r32["dtype"] == "float32" and math.isfinite(r32["smse"])
