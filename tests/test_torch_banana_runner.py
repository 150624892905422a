"""The port's banana runner (experiments/banana.py), its data and the
kin40k runner's faithful and ``--f64`` options, on the CPU at a small
size; the full-size runs are on the card (chip_smoke.py phase 7, and the
runners' command lines).

The banana runner's options are held to the JAX runner's body on the same
inputs: the JAX ``run`` reads the absent banana file, so the test rebuilds
it (``_jax_banana``): ``chunked_run`` over ``fit_banana_fast`` from
``init_banana_state`` or over ``fit_banana`` from None, then the 60
Newton–Schulz iterations, 4 refinement rounds and ``predict_probit``. In
float64 at M = 16 on 200 training rows in batches of 50, θ agrees within
1e-10 (the kin40k runner test's band) and the error count exactly; runs
that differ only in their chunks, or in a repeat, are bit-equal."""

import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.dists import gamma_mean as jgamma_mean
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.infer.batch_vmp import predict_probit as jpredict_probit
from gaussianprocessnode_tpu.ops import linalg as jla
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.kernels import invsoftplus as jinvsoftplus
from gaussianprocessnode_tpu.ops.kernels import softplus as jsoftplus
from gaussianprocessnode_tpu.utils import datasets as jdatasets
from gaussianprocessnode_tpu.utils import driver as jdriver
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


# --- the runner's chunks, inducing inputs and warm timing against JAX ---------------

SMALL = dict(m_inducing=16, batch_size=50, device="cpu", dtype=torch.float64)
N_TRAIN, N_TEST = 200, 200


def _small_data(data="synthetic", seed=1):
    return datasets.banana_synthetic(seed, n_train=N_TRAIN, n_test=N_TEST)


@pytest.fixture
def small(monkeypatch):
    """The runner on 200 training and 200 test rows of ``banana_synthetic``
    (from its seed, as the runner draws them), in float64 on the CPU."""
    monkeypatch.setattr(runner, "load_data", _small_data)
    return functools.partial(runner.run, **SMALL)


def _jax_banana(epochs, chunk, fast, xu=None):
    """The JAX runner's ``run`` body on the small data, float64: θ after
    softplus and the test error count."""
    ds = _small_data()
    f64 = jnp.float64
    if xu is None:
        xu = ds.x_train[np.random.default_rng(1).permutation(N_TRAIN)[:SMALL["m_inducing"]]]
    Xu = jnp.asarray(xu, f64)
    M = Xu.shape[0]
    b = SMALL["batch_size"]
    Xb = jnp.asarray(ds.x_train, f64).reshape(N_TRAIN // b, b, -1)
    yb = jnp.asarray(ds.y_train, f64).reshape(N_TRAIN // b, b)
    kernel = JKernel("se", transform="softplus")
    theta0 = jinvsoftplus(jnp.ones((3,), f64))
    prior_v = JNat(jnp.zeros(M, f64), jnp.eye(M, dtype=f64) / 50.0)
    prior_w = JGamma(jnp.asarray(1e-2, f64), jnp.asarray(1e-2, f64))
    trainer = jmb.fit_banana_fast if fast else jmb.fit_banana
    state = jmb.init_banana_state(kernel, theta0, Xu, prior_v, prior_w) if fast else None
    theta, nat, qw, _ = jdriver.chunked_run(
        lambda e, st: trainer(kernel, theta0, Xu, Xb, yb, prior_v, prior_w, e,
                              resume_state=st), epochs, chunk, state)
    prec = jla.sym(nat.prec)
    cov = jla.spd_inverse_ns(prec, iters=60)
    mu_v = jla.ir_solve(prec, nat.xi, cov, rounds=4)
    probs = jpredict_probit(kernel, theta, Xu, jnp.asarray(ds.x_test, f64), mu_v,
                            jgamma_mean(qw))
    errors = float(np.sum(np.abs((np.asarray(probs) >= 0.5) - ds.y_test)))
    return np.asarray(jsoftplus(theta)), errors


@pytest.mark.parametrize("given_xu", [False, True], ids=["drawn_xu", "given_xu"])
@pytest.mark.parametrize("fast", [True, False], ids=["fast", "faithful"])
def test_chunked_runner_matches_the_jax_runner(small, monkeypatch, tmp_path, fast, given_xu):
    """3 epochs in chunks of 2 (the runner's 100, cut), with M drawn from
    the training rows or 12 given rows read from a .npy file through the
    runner's reader (M is then 12)."""
    monkeypatch.setattr(runner, "CHUNK", 2)
    xu = None
    if given_xu:
        rows = np.random.default_rng(9).standard_normal((12, 2))
        np.save(tmp_path / "xu.npy", rows)
        xu = runner.load_xu(str(tmp_path / "xu.npy"))
        assert np.array_equal(xu, rows)
    out = small(epochs=3, fast=fast, xu=xu)
    theta, errors = _jax_banana(3, 2, fast, xu)
    assert out["m_inducing"] == (12 if given_xu else SMALL["m_inducing"])
    assert out["errors"] == errors
    assert np.abs(np.asarray(out["theta_softplus"]) - theta).max() <= 1e-10


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "faithful"])
def test_chunks_do_not_change_the_run(small, monkeypatch, fast):
    """The same 3 epochs in chunks of 2 and of 100: bit-equal θ, w̄ and
    error count."""
    monkeypatch.setattr(runner, "CHUNK", 2)
    two = small(epochs=3, fast=fast)
    monkeypatch.setattr(runner, "CHUNK", 100)
    whole = small(epochs=3, fast=fast)
    for key in ("theta_softplus", "w_mean", "errors"):
        assert two[key] == whole[key], key


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "faithful"])
def test_warm_timing_repeats_the_first_run(small, fast):
    """``warm_timing``: a second run from the same start, bit-equal to the
    first; both runs timed, and the same result as one run."""
    warm = small(epochs=2, fast=fast, warm_timing=True)
    cold = small(epochs=2, fast=fast)
    assert warm["warm_timing"] is True and warm["warm_equals_first"] is True
    assert warm["first_seconds"] > 0 and warm["seconds"] > 0
    assert warm["value"] == warm["seconds"]
    assert cold["warm_timing"] is False and cold["warm_equals_first"] is None
    assert cold["first_seconds"] == cold["seconds"]
    for key in ("theta_softplus", "w_mean", "errors"):
        assert warm[key] == cold[key], key


def test_runner_cli_warm_and_xu(small, monkeypatch, tmp_path, capsys):
    """``--warm --xu PATH --json=PATH``: the line carries the warm keys and
    the given M, and the file holds the printed line."""
    monkeypatch.setattr(runner, "run", lambda **kw: small(**kw))
    np.save(tmp_path / "xu.npy", datasets.banana_synthetic(5, 10, 1).x_train)
    path = tmp_path / "out.json"
    assert runner.main(["--epochs", "1", "--warm", "--xu", str(tmp_path / "xu.npy"),
                        f"--json={path}"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert json.loads(path.read_text()) == out
    assert out["warm_timing"] is True and out["warm_equals_first"] is True
    assert out["m_inducing"] == 10 and out["first_seconds"] > 0
    assert out["trainer"] == "fit_banana_fast"


@pytest.mark.parametrize("flags,dtype", [([], "float32"), (["--f64"], "float64")],
                         ids=["f32", "f64"])
def test_kin40k_cli_f64_flag(monkeypatch, capsys, flags, dtype):
    """kin40k's ``--f64`` trains the fast path in float64 (the JAX runner's
    flag); without it the fast path stays float32."""
    run = kin40k_runner.run

    def small_run(**kw):
        return run(m_inducing=16, batch_size=50, n_train=200, n_test=50, device="cpu", **kw)

    monkeypatch.setattr(kin40k_runner, "run", small_run)
    assert kin40k_runner.main(["--epochs", "1", *flags]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["trainer"] == "fit_kin40k_fast" and out["dtype"] == dtype
    assert math.isfinite(out["smse"])
