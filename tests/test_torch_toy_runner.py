"""The port's toy runners (experiments/toy_regression.py and
experiments/toy_classification.py) and their data, on the CPU.

- ``toy_sinc``, ``toy_classification`` and ``split2batch`` give the same
  bits as the JAX package's (numpy and scipy from the same seeds); the
  reference-draw loaders raise FileNotFoundError where the files are absent.
- A few epochs of each runner at its configuration (``--device cpu``)
  against the JAX package's ``fit_regression`` / ``fit_classification``
  and its prediction on the same data: θ to 1e-8 relative and the free
  energies to 1e-9 (the trainers' bounds, tests/test_torch_training.py),
  SMSE to 1e-8 relative, the same errors. The JAX runners themselves are not
  called: they write a compile cache into the repository.
- The command line prints one JSON line with the keys the documents read.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.dists import gamma_mean as jgamma_mean
from gaussianprocessnode_tpu.infer.batch_vmp import predict_out, predict_probit
from gaussianprocessnode_tpu.infer.training import fit_classification, fit_regression
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.kernels import invsoftplus as jinvsoftplus
from gaussianprocessnode_tpu.ops.kernels import softplus as jsoftplus
from gaussianprocessnode_tpu.utils import datasets as jds
from gaussianprocessnode_tpu.utils.metrics import num_error, smse
from gaussianprocessnode_tpu_torch.experiments import toy_classification as tcls
from gaussianprocessnode_tpu_torch.experiments import toy_regression as treg
from gaussianprocessnode_tpu_torch.utils import datasets as tds

JK = JKernel("se", transform="softplus")
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("name", ["toy_sinc", "toy_classification"])
def test_toy_data_are_the_jax_packages_bits(name):
    got, want = getattr(tds, name)(), getattr(jds, name)()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    got, want = getattr(tds, name)(seed=11), getattr(jds, name)(seed=11)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split2batch_matches_jax():
    d = tds.toy_sinc()
    for bs in (7, 10, 50):
        for g, w in zip(tds.split2batch(d.x_train, d.y_train, bs),
                        jds.split2batch(d.x_train, d.y_train, bs)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("loader", ["toy_sinc_reference", "toy_classification_reference"])
def test_reference_draw_loaders_raise_where_the_files_are_absent(loader, tmp_path):
    with pytest.raises(FileNotFoundError):
        getattr(tds, loader)(root=str(tmp_path))


def test_toy_regression_runner_matches_jax():
    out = treg.run(epochs=EPOCHS, device="cpu")
    d = jds.toy_sinc()
    X, y = jnp.asarray(d.x_train), jnp.asarray(d.y_train)
    Xu = jnp.linspace(-4.0, 4.0, 20)[:, None]
    theta, fe, res = fit_regression(JK, jinvsoftplus(jnp.asarray([1.0, 1.0])), Xu, X, y,
                                    JNat(jnp.zeros(20), jnp.eye(20) / 50.0),
                                    JGamma(jnp.asarray(1e-2), jnp.asarray(1e-2)), epochs=EPOCHS)
    mean, _ = predict_out(JK, theta, Xu, jnp.asarray(d.x_test), res.qv.mean,
                          jgamma_mean(res.qw))
    assert _rel(out["theta_softplus"], jsoftplus(theta)) <= 1e-8
    assert _rel(out["fe_first"], fe[0]) <= 1e-9
    assert _rel(out["fe_last"], fe[-1]) <= 1e-9
    assert _rel(out["smse"], smse(jnp.asarray(d.y_test), mean)) <= 1e-8
    assert out["epochs"] == EPOCHS and out["dtype"] == "float64"
    # one host read per linesearch iteration; at least one iteration per step
    assert out["host_reads_per_epoch"] == out["linesearch_steps_per_lbfgs_step"] * 60
    assert out["evaluations_per_lbfgs_step"] == out["linesearch_steps_per_lbfgs_step"] + 1
    assert out["linesearch_steps_per_lbfgs_step"] >= 1.0
    assert out["gram_launches"] == 0  # the CPU takes the plain Gram


def test_toy_classification_runner_matches_jax():
    out = tcls.run(epochs=EPOCHS, device="cpu")
    d = jds.toy_classification()
    X, y = jnp.asarray(d.x_train), jnp.asarray(d.y_train)
    Xu = jnp.linspace(-5.0, 5.0, 15)[:, None]
    g = JGamma(jnp.asarray(1e-2), jnp.asarray(1e-2))
    theta, fe, res = fit_classification(JK, jinvsoftplus(jnp.asarray([1.0, 1.0])), Xu, X, y,
                                        JNat(jnp.zeros(15), jnp.eye(15) / 50.0), g, g,
                                        epochs=EPOCHS)
    probs = predict_probit(JK, theta, Xu, jnp.asarray(d.x_test), res.qv.mean,
                           jgamma_mean(res.qw))
    pred = (np.asarray(probs) >= 0.5).astype(float)
    assert _rel(out["theta_softplus"], jsoftplus(theta)) <= 1e-8
    assert _rel(out["fe_first"], fe[0]) <= 1e-9
    assert _rel(out["fe_last"], fe[-1]) <= 1e-9
    assert out["errors"] == float(num_error(jnp.asarray(d.y_test), jnp.asarray(pred)))
    assert out["n_test"] == 400 and out["error_rate"] == out["errors"] / 400
    assert all(abs(p - 0.5) <= 1e-6 for _, p in out["near_half"])


def test_command_lines_print_one_json_line(tmp_path, capsys):
    path = Path(tmp_path) / "out.json"
    assert treg.main(["--epochs", "1", "--device", "cpu", "--json", str(path)]) == 0
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    out = json.loads(line[0])
    assert json.loads(path.read_text()) == out
    for key in ("smse", "theta_softplus", "fe_first", "fe_last", "seconds",
                "host_ms_per_epoch", "linesearch_steps_per_lbfgs_step",
                "host_reads_per_epoch", "gram_launches", "device"):
        assert key in out
    assert tcls.main(["--epochs", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["fe_first"] is None and out["errors"] >= 0
