"""Parity of the port's infer/fitc.py (SoR / DTC / FITC) with the JAX
package's, on the CPU.

Seeded problem: N = 48 points and M = 8 inducing inputs in 2-D (standard
normal), y = sin(x₁) + x₂/2 + N(0, 0.1²), θ = (0.3, −0.2, 0.1) under
softplus, σ² = 0.3; a second case takes the inducing inputs from the
rows of X, where FITC's k − q is 0 up to rounding.

Tolerances, relative to each compared result's largest entry: float64
1e-10 for evaluations (measured ≤ 4.5e-15: the same Grams, Cholesky
factors and solves, summed in other orders) and 1e-9 after 20 AdaMax
steps (measured ≤ 3.6e-15); float32 1e-4 for evaluations (float32
rounding carried through the solves against Kuu and B; measured ≤ 7.0e-6)
and 2e-4 after training (measured ≤ 8.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import fitc as jf
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.infer import fitc as tf
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as TKernel

JK = JKernel("se", transform="softplus")
TK = TKernel("se", transform="softplus", use_kernel=True)
N, M = 48, 8
METHODS = ["sor", "dtc", "fitc"]
RTOL = {np.float64: 1e-10, np.float32: 1e-4}
TRAIN_RTOL = {np.float64: 1e-9, np.float32: 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def close(got, want, rtol):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def _both(dtype=np.float64, xu_from_x=False):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, 2))
    Xu = X[::N // M][:M].copy() if xu_from_x else rng.standard_normal((M, 2))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.standard_normal(N)
    Xt = rng.standard_normal((20, 2))
    theta, log_noise = np.array([0.3, -0.2, 0.1]), np.array(np.log(0.3))
    arrs = [a.astype(dtype) for a in (X, Xu, y, Xt, theta, log_noise)]
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.as_tensor(a) for a in arrs]
    return (j[:4], jf.SparseGPParams(j[4], j[5])), (t[:4], tf.SparseGPParams(t[4], t[5]))


@pytest.mark.parametrize("xu_from_x", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", METHODS)
def test_nlml_and_gradient_match_jax(method, dtype, xu_from_x):
    ((jX, jXu, jy, _), jp), ((tX, tXu, ty, _), tp) = _both(dtype, xu_from_x)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jf.sparse_nlml(JK, p, jXu, jX, jy, method=method)))(jp)
    leaves = [p.clone().requires_grad_(True) for p in tp]
    tv = tf.sparse_nlml(TK, tf.SparseGPParams(*leaves), tXu, tX, ty, method=method)
    tg = torch.autograd.grad(tv, leaves)
    close(tv, jv, RTOL[dtype])
    for g, w in zip(tg, jg):
        close(g, w, RTOL[dtype])


def test_sor_and_dtc_share_the_training_criterion():
    _, ((tX, tXu, ty, _), tp) = _both()
    sor = tf.sparse_nlml(TK, tp, tXu, tX, ty, method="sor")
    assert torch.equal(sor, tf.sparse_nlml(TK, tp, tXu, tX, ty, method="dtc"))
    assert not torch.equal(sor, tf.sparse_nlml(TK, tp, tXu, tX, ty, method="fitc"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", METHODS)
def test_predict_matches_jax(method, dtype):
    ((jX, jXu, jy, jXt), jp), ((tX, tXu, ty, tXt), tp) = _both(dtype)
    jm, jv = jf.sparse_predict(JK, jp, jXu, jXt, jX, jy, method=method)
    tm, tv = tf.sparse_predict(TK, tp, tXu, tXt, tX, ty, method=method)
    close(tm, jm, RTOL[dtype])
    close(tv, jv, RTOL[dtype])


@pytest.mark.parametrize("dtype,method,learn_noise", [
    (np.float64, "fitc", True), (np.float64, "sor", False), (np.float32, "fitc", True)])
def test_fit_sparse_gp_twenty_steps_match_jax(dtype, method, learn_noise):
    """20 AdaMax(0.05) steps from the same parameters: parameters and the
    NLML trace; ``learn_noise=False`` leaves log σ² bit for bit."""
    ((jX, jXu, jy, _), jp), ((tX, tXu, ty, _), tp) = _both(dtype)
    kw = dict(method=method, steps=20, learning_rate=0.05, learn_noise=learn_noise)
    jout, jtr = jf.fit_sparse_gp(JK, jp, jXu, jX, jy, **kw)
    tout, ttr = tf.fit_sparse_gp(TK, tp, tXu, tX, ty, **kw)
    close(tout.theta, jout.theta, TRAIN_RTOL[dtype])
    close(tout.log_noise, jout.log_noise, TRAIN_RTOL[dtype])
    close(ttr, jtr, RTOL[dtype])
    assert float(ttr[-1]) < float(ttr[0])
    if not learn_noise:
        assert torch.equal(tout.log_noise, tp.log_noise)


def test_unknown_method_raises():
    _, ((tX, tXu, ty, tXt), tp) = _both()
    with pytest.raises(ValueError, match="method must be one of"):
        tf.sparse_nlml(TK, tp, tXu, tX, ty, method="vfe")
    with pytest.raises(ValueError, match="method must be one of"):
        tf.sparse_predict(TK, tp, tXu, tXt, tX, ty, method="vfe")
    with pytest.raises(ValueError, match="method must be one of"):
        tf.fit_sparse_gp(TK, tp, tXu, tX, ty, method="vfe", steps=1)


def test_init_and_params_converter_match_jax():
    jp = jf.init_sparse_gp(jnp.asarray([0.1, 0.2]), noise=0.5)
    tp = tf.init_sparse_gp(torch.tensor([0.1, 0.2], dtype=torch.float64), noise=0.5)
    for g, w in zip(tp, jp):
        close(g, w, 1e-15)
    cp = convert.sparse_gp_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert isinstance(cp, tf.SparseGPParams)
    for g, w in zip(cp, jp):
        close(g, w, 0.0)
