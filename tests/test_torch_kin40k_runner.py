"""The port's kin40k runner (experiments/kin40k.py) and its data, on the CPU
at a small size; the full-size run is on the card (chip_smoke.py phase 6,
and the runner's command line)."""

import json
import math

import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.utils import datasets as jdatasets
from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
from gaussianprocessnode_tpu_torch.utils import datasets


def test_synthetic_data_has_kin40k_shape_and_follows_the_seed():
    a = datasets.kin40k_synthetic(3, n_test=500)
    b = datasets.kin40k_synthetic(3, n_test=500)
    c = datasets.kin40k_synthetic(4, n_test=500)
    assert a.x_train.shape == (10_000, 8) and a.y_train.shape == (10_000,)
    assert a.x_test.shape == (500, 8) and a.y_test.shape == (500,)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a.y_train, c.y_train)
    # unit-variance latent function plus N(0, 1e-4) noise
    assert abs(np.std(a.y_train) - 1.0) < 1e-3
    assert np.all(np.isfinite(a.y_test))


def test_kin40k_loader_is_the_jax_packages(tmp_path):
    """The port's copy reads the same files the same way; absent files raise."""
    from scipy.io import savemat

    d = tmp_path / "data" / "kin40k"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, key, shape in (("xtrain", "xtrain", (6, 8)), ("ytrain", "ytrain", (6, 1)),
                             ("xtest", "xtest", (4, 8)), ("ytest", "ytest", (4, 1))):
        savemat(d / f"kin40k_{name}.mat", {key: rng.standard_normal(shape)})
    got, want = datasets.kin40k(str(tmp_path)), jdatasets.kin40k(str(tmp_path))
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    with pytest.raises(FileNotFoundError):
        datasets.kin40k(str(tmp_path / "absent"))


def test_load_data_never_switches_silently(monkeypatch, tmp_path):
    monkeypatch.setattr(datasets, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(runner, "kin40k", lambda: datasets.kin40k(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        runner.load_data("kin40k")
    with pytest.raises(ValueError, match="synthetic"):
        runner.load_data("kin40k_small")


def test_runner_trains_and_scores_on_cpu(capsys):
    """A small configuration end to end on the CPU (no kernel launches
    there): finite SMSE that falls with training, the JSON line's keys."""
    kw = dict(m_inducing=48, batch_size=100, n_train=800, n_test=400, device="cpu")
    one = runner.run(epochs=1, **kw)
    more = runner.run(epochs=8, **kw)
    for r in (one, more):
        assert math.isfinite(r["value"]) and r["value"] > 0
        assert math.isfinite(r["smse"])
        assert r["data"] == "synthetic" and r["gram_launches"] == 0
        assert r["device"] == {"name": "cpu"}
    assert more["smse"] < one["smse"]
    assert json.loads(json.dumps(more)) == more


def test_runner_defaults_to_the_card():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        runner.run(epochs=1, m_inducing=8, batch_size=50, n_train=100, n_test=10)


def test_faithful_runner_takes_the_budget(monkeypatch):
    """The faithful path hands ``ns_budget`` and the learning rate to
    ``fit_kin40k`` and trains its epochs through ``chunked_run`` in chunks
    of max(10, ⌊50·34/budget⌋) = 85 epochs at budget 20, as the JAX runner
    does: 2 epochs are one chunk, from no carry."""
    calls = []
    fit = runner.fit_kin40k

    def recording_fit(*args, **kwargs):
        calls.append((args[7], kwargs))
        return fit(*args, **kwargs)

    monkeypatch.setattr(runner, "fit_kin40k", recording_fit)
    kw = dict(m_inducing=16, batch_size=50, n_train=200, n_test=50, device="cpu",
              faithful=True)
    short = runner.run(epochs=2, ns_budget=20, **kw)
    assert calls == [(2, {"learning_rate": 0.001, "resume_state": None, "ns_budget": 20})]
    assert short["ns_budget"] == 20 and short["trainer"] == "fit_kin40k"
    assert math.isfinite(short["smse"])
