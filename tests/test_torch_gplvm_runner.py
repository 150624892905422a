"""The port's GPLVM runner (experiments/gplvm.py) and its data, on the CPU
at a small size; the full-size run is on the card (chip_smoke.py phase 13,
and the runner's command line).

The runner is held to the JAX runner (``experiments/gplvm.py::run``): its
``pca_2d`` and ``knn_accuracy`` to the JAX runner's own, exactly (the same
numpy operations); its inputs to those the JAX runner builds; and a run at
N = 32 rows (one 1-sweep gradient epoch or one Nelder–Mead iteration of
cold 1-sweep evaluations, then 2 final sweeps) to the same sequence of JAX
library calls on the same inputs (the JAX ``run`` itself reads the absent
3PhData files): θ, the FE trace and the final FE and latents to 1e-7
relative, as ``fit_gplvm_grad`` in ``tests/test_torch_gplvm.py`` (the
M-step's θ moves every later Laplace mode, so rounding is carried through
both; measured ≤ 2.1e-9, the latents), and the two 1-NN accuracies
exactly.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.gplvm import knn_accuracy as jax_knn_accuracy
from experiments.gplvm import pca_2d as jax_pca_2d
from gaussianprocessnode_tpu.infer import gplvm as jg
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.utils import datasets as jdatasets
from gaussianprocessnode_tpu.utils.optim import nelder_mead as jax_nelder_mead
from gaussianprocessnode_tpu_torch.experiments import gplvm as runner
from gaussianprocessnode_tpu_torch.utils import datasets

TINY_N, TINY_FINAL = 32, 2
RUN_RTOL = 1e-7

# the JAX runner's result keys (experiments/gplvm.py::run)
JAX_KEYS = {"fe", "fe_hyperopt", "knn_acc", "knn_acc_pca", "theta", "seconds",
            "device_hyperopt_seconds", "final_infer_seconds", "fe_trace", "latents", "labels"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_oil_flow_loader_is_the_jax_packages(tmp_path):
    """The port's copy reads the same files the same way; absent files raise."""
    d = tmp_path / "3PhData"
    d.mkdir()
    rng = np.random.default_rng(0)
    np.savetxt(d / "DataTrn.txt", rng.uniform(0.0, 1.5, (9, 12)))
    np.savetxt(d / "DataTrnLbls.txt", np.eye(3)[rng.integers(0, 3, 9)])
    for n in (9, 5):
        got, want = datasets.oil_flow(str(tmp_path), n), jdatasets.oil_flow(str(tmp_path), n)
        for u, v in zip(got, want):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    with pytest.raises(FileNotFoundError):
        datasets.oil_flow(str(tmp_path / "absent"))


def test_synthetic_oil_flow_has_3phdata_shape_and_follows_the_seed():
    a, la = datasets.oil_flow_synthetic(3)
    b, lb = datasets.oil_flow_synthetic(3)
    c, _ = datasets.oil_flow_synthetic(4)
    assert a.shape == (200, 12) and la.shape == (200,)
    assert np.array_equal(a, b) and np.array_equal(la, lb) and not np.array_equal(a, c)
    assert set(np.unique(la)) == {0, 1, 2} and np.bincount(la).min() >= 66
    # a longer draw continues the runner's rows: its rows past 200 are held out
    d, ld = datasets.oil_flow_synthetic(3, 240)
    assert np.array_equal(d[:200], a) and np.array_equal(ld[:200], la)
    assert np.bincount(ld[200:]).min() >= 13
    assert np.all(np.isfinite(a)) and np.abs(a).max() < 1.5
    # PCA mixes the classes: 1-NN accuracy in its projection well below 1
    assert 0.5 < runner.knn_accuracy(runner.pca_2d(a), la) < 0.95


def test_pca_and_knn():
    """The port's copies against the JAX runner's functions, exactly; on
    the runner test's 32-row synthetic draw and on a draw with two leading
    directions, whose projection keeps their variance."""
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((30, 5)) @ np.diag([3.0, 2.0, 0.1, 0.1, 0.1])
    Yc = Y - Y.mean(axis=0)
    Z = runner.pca_2d(Y)
    assert Z.shape == (30, 2)
    assert np.isclose((Z ** 2).sum(), (np.linalg.svd(Yc, compute_uv=False)[:2] ** 2).sum())
    Ys, ls = datasets.oil_flow_synthetic(0, TINY_N)
    labels = np.arange(30) % 3
    for A, lab in ((Y, labels), (Ys, ls), (*datasets.oil_flow_synthetic(0),)):
        Z, Zj = runner.pca_2d(A), jax_pca_2d(A)
        assert np.array_equal(Z, Zj)
        assert runner.knn_accuracy(Z, lab) == jax_knn_accuracy(Zj, lab)
        assert runner.knn_accuracy(A, lab) == jax_knn_accuracy(A, lab)
    pts = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0], [0.0, 0.2]])
    lab = np.array([0, 0, 1, 1, 1])
    assert runner.knn_accuracy(pts, lab) == jax_knn_accuracy(pts, lab) == 0.8


def _jax_inputs(Y_np):
    """The JAX runner's inputs (``experiments/gplvm.py:71-83``): prior
    means at the JAX ``pca_2d``, Xu the projections of 30 rows drawn by
    ``default_rng(86)``, θ0 = [1.0, 0.6, 0.5]."""
    mean_X = jax_pca_2d(Y_np)
    pos = np.random.default_rng(86).permutation(len(Y_np))[:30]
    return (jnp.asarray([1.0, 0.6, 0.5]), jnp.asarray(mean_X[pos]), jnp.asarray(Y_np),
            jnp.asarray(mean_X), mean_X)


def test_setup_builds_the_jax_runners_inputs():
    Y_np, _ = datasets.oil_flow_synthetic(0, TINY_N)
    kernel, theta0, Xu, Y, Xm, mean_X = runner.setup(Y_np, device="cpu")
    for got, want in zip((theta0, Xu, Y, Xm, mean_X), _jax_inputs(Y_np)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert Xu.dtype == Y.dtype == torch.float64 and Xu.shape == (30, 2)
    assert (kernel.kind, kernel.transform) == ("se", "softplus")


def test_load_data_never_switches_silently(monkeypatch, tmp_path):
    monkeypatch.setattr(runner, "oil_flow", lambda: datasets.oil_flow(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        runner.load_data("oil")
    with pytest.raises(ValueError, match="synthetic"):
        runner.load_data("oil_small")


@pytest.fixture
def tiny(monkeypatch):
    """The runner at N = 32 rows (M = 30, the runner's) and 2 final sweeps
    (30 in the runner)."""
    monkeypatch.setattr(runner, "oil_flow_synthetic",
                        lambda seed: datasets.oil_flow_synthetic(seed, TINY_N))
    monkeypatch.setattr(runner, "FINAL_SWEEPS", TINY_FINAL)


def _jax_run(grad):
    """The JAX runner's sequence of library calls at the tiny size: one
    1-sweep gradient epoch, or one Nelder–Mead iteration of cold 1-sweep
    evaluations; then the final sweeps, scored by the JAX 1-NN."""
    Y_np, labels = datasets.oil_flow_synthetic(0, TINY_N)
    theta0, Xu, Y, Xm, mean_X = _jax_inputs(Y_np)
    k = JKernel("se", transform="softplus")
    if grad:
        theta, _, fe_c = jg.fit_gplvm_grad(k, theta0, Xu, Y, Xm, epochs=1, n_iters=1)
        history = [float(f) for f in np.asarray(fe_c)]
    else:
        def fe_obj(th):
            return jg.gplvm_vmp(k, th, Xu, Y, Xm, n_iters=1)[1]

        theta, _, history = jax_nelder_mead(fe_obj, theta0, maxiter=1)
    state, fe = jg.gplvm_vmp(k, theta, Xu, Y, Xm, n_iters=TINY_FINAL)
    Z = np.asarray(state.x_means)
    return {"theta": np.asarray(theta), "fe_trace": history, "fe": float(fe), "latents": Z,
            "knn_acc": jax_knn_accuracy(Z, labels),
            "knn_acc_pca": jax_knn_accuracy(mean_X, labels)}


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "nm"])
def test_runner_keys_at_a_tiny_size(tiny, grad):
    """One gradient epoch (or one Nelder–Mead iteration) of 1-sweep E-steps:
    the JAX runner's keys, finite numbers, and the per-sweep counts; the
    numbers against the same JAX calls."""
    res = runner.run(nm_iters=1, n_iters=1, grad=grad, grad_epochs=1, verbose=False,
                     device="cpu")
    assert JAX_KEYS <= set(res)
    assert res["latents"].shape == (TINY_N, 2) and res["labels"].shape == (TINY_N,)
    assert all(math.isfinite(res[k]) for k in ("fe", "fe_hyperopt", "knn_acc", "knn_acc_pca"))
    assert len(res["theta"]) == 3 and res["device"] == {"name": "cpu"}
    assert res["estep_sweeps"] == len(res["fe_trace"]) and res["estep_sweeps"] >= 1
    per = res["per_sweep"]
    assert per["host_reads"] == per["linesearch_steps"] == res["host_reads"] / res["estep_sweeps"]
    assert (res["mstep"].get("host_reads", 0) > 0) == grad
    line = {k: v for k, v in res.items() if k not in ("latents", "labels")}
    assert json.loads(json.dumps(line)) == line
    want = _jax_run(grad)
    errs = {k: _rel(res[k], want[k]) for k in ("theta", "fe_trace", "fe", "latents")}
    assert len(res["fe_trace"]) == len(want["fe_trace"])
    assert max(errs.values()) <= RUN_RTOL, errs
    assert (res["knn_acc"], res["knn_acc_pca"]) == (want["knn_acc"], want["knn_acc_pca"])


def test_runner_defaults_to_the_card(tiny):
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        runner.run(grad_epochs=1, n_iters=1, verbose=False)
