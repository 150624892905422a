"""The port's model front-end (``infer/model.py``) on the CPU: each class's
methods equal the direct calls they lower onto, bit for bit (the same
arithmetic on the same tensors), and each class's ``infer`` agrees with
the JAX package's class on the same numpy draw to 1e-9 relative to each
array's largest entry (the lowered programs' own parity tests hold them
to 1e-9–1e-11; measured ≤ 1e-12 here).

Small problems: the toy regression (20 points, M = 6) and classification
(40 points, M = 6) draws, the pendulum chain (T = 12, M = 12 on a 4×3
grid), and the synthetic oil-flow data (N = 24, M = 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import model as jmodel
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.experiments.gplvm import pca_2d
from gaussianprocessnode_tpu_torch.infer import batch_vmp, chain_smoother, gplvm, model, training
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.serve import GPSSMFilter, SGPClassifier, SGPRegressor
from gaussianprocessnode_tpu_torch.utils.datasets import (oil_flow_synthetic, pendulum,
                                                          toy_classification, toy_sinc)

RTOL = 1e-9
JK = JKernel("se", transform="softplus")
TK = Kernel("se", transform="softplus")
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _close(got, want):
    g = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= RTOL * max(np.abs(w).max(), 1e-300)


def _equal_trees(a, b):
    la = [x for x in jax.tree.leaves(a) if x is not None]
    lb = [x for x in jax.tree.leaves(b) if x is not None]
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def _theta(n):
    return np.log(np.expm1(np.ones(n)))


def test_sgp_regression():
    ds = toy_sinc(n_train=20, n_test=10)
    X, y, Xt = _t(ds.x_train), _t(ds.y_train), _t(ds.x_test)
    Xu_np = np.linspace(-1.0, 1.0, 6)[:, None] * np.abs(ds.x_train).max()
    th = _t(_theta(2))
    m = model.SGPRegression(kernel=TK, Xu=_t(Xu_np))
    res = m.infer(th, X, y, iterations=3)
    pv = MvGaussianNat(torch.zeros(6, dtype=F64), torch.eye(6, dtype=F64) / 50.0)
    pw = GammaShapeRate(torch.tensor(1e-2, dtype=F64), torch.tensor(1e-2, dtype=F64))
    _equal_trees(res, batch_vmp.regression_vmp(TK, th, _t(Xu_np), X, y, pv, pw, n_iters=3))
    jres = jmodel.SGPRegression(kernel=JK, Xu=jnp.asarray(Xu_np)).infer(
        jnp.asarray(_theta(2)), jnp.asarray(ds.x_train), jnp.asarray(ds.y_train), iterations=3)
    _close(res.qv.mean, jres.qv.mean)
    _close(res.free_energy, jres.free_energy)
    mean, var = m.predict(th, res, Xt)
    w = res.qw.shape / res.qw.rate
    dm, dv = batch_vmp.predict_out(TK, th, _t(Xu_np), Xt, res.qv.mean, w)
    assert torch.equal(mean, dm) and torch.equal(var, dv)
    jm, jv = jmodel.SGPRegression(kernel=JK, Xu=jnp.asarray(Xu_np)).predict(
        jnp.asarray(_theta(2)), jres, jnp.asarray(ds.x_test))
    _close(mean, jm)
    _close(var, jv)
    h = m.predictor(th, res)
    d = SGPRegressor.from_natural(TK, th, _t(Xu_np), res.qv_nat, w, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(h(Xt), d(Xt)))
    # a point-mass w, and one epoch of fit
    mf = model.SGPRegression(kernel=TK, Xu=_t(Xu_np), w_fixed=100.0)
    mean_f, var_f = mf.predict(th, mf.infer(th, X, y, iterations=2), Xt)
    assert torch.allclose(var_f, torch.full_like(var_f, 1e-2), rtol=0, atol=0)
    fit = m.fit(th, X, y, epochs=1, iterations=2)
    direct = training.fit_regression(TK, th, _t(Xu_np), X, y, pv, pw, epochs=1, n_iters=2)
    assert torch.equal(fit[0], direct[0]) and torch.equal(fit[1], direct[1])


def test_sgp_classification():
    ds = toy_classification(n_train=40, n_test=10)
    X, y, Xt = _t(ds.x_train), _t(ds.y_train), _t(ds.x_test)
    Xu_np = ds.x_train[:6]
    th = _t(_theta(1 + X.shape[1]))
    m = model.SGPClassification(kernel=TK, Xu=_t(Xu_np))
    res = m.infer(th, X, y, iterations=3)
    pv = MvGaussianNat(torch.zeros(6, dtype=F64), torch.eye(6, dtype=F64) / 50.0)
    g = GammaShapeRate(torch.tensor(1e-2, dtype=F64), torch.tensor(1e-2, dtype=F64))
    _equal_trees(res, batch_vmp.classification_vmp(TK, th, _t(Xu_np), X, y, pv, g, g,
                                                   n_iters=3))
    jres = jmodel.SGPClassification(kernel=JK, Xu=jnp.asarray(Xu_np)).infer(
        jnp.asarray(_theta(1 + X.shape[1])), jnp.asarray(ds.x_train),
        jnp.asarray(ds.y_train), iterations=3)
    _close(res.qv.mean, jres.qv.mean)
    _close(res.free_energy, jres.free_energy)
    p = m.predict_proba(th, res, Xt)
    assert torch.equal(p, batch_vmp.predict_probit(TK, th, _t(Xu_np), Xt, res.qv.mean,
                                                   res.qw.shape / res.qw.rate))
    h = m.predictor(th, res)
    d = SGPClassifier.from_natural(TK, th, _t(Xu_np), res.qv_nat, res.qw, device="cpu")
    assert torch.equal(h.probabilities(Xt), d.probabilities(Xt))


def _grid_xu():
    g1, g2 = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 3), indexing="ij")
    return np.stack([g1.ravel(), g2.ravel()], axis=1)


def test_gpssm():
    _, ys, _, P, _ = pendulum()
    y, yt = ys[:12], ys[12:18]
    Xu_np = _grid_xu()
    th = _t(_theta(3))
    kw = dict(obs_cov=_t(P), prior_x0_mean=_t([1.6, 0.0]), prior_x0_cov=_t(0.1 * np.eye(2)))
    m = model.GPSSM(kernel=TK, Xu=_t(Xu_np), **kw)
    state, fe = m.infer(th, _t(y), iterations=2)
    M = Xu_np.shape[0]
    pv = MvGaussianNat(torch.zeros(2 * M, dtype=F64), torch.eye(2 * M, dtype=F64) / 50.0)
    d_state, d_fe = chain_smoother.gpssm_vmp(
        TK, th, _t(Xu_np), _t(y), kw["obs_cov"], kw["prior_x0_mean"], kw["prior_x0_cov"], pv,
        100.0, torch.eye(2, dtype=F64), n_iters=2)
    _equal_trees(state, d_state)
    assert torch.equal(fe, d_fe)
    jm = jmodel.GPSSM(kernel=JK, Xu=jnp.asarray(Xu_np), obs_cov=jnp.asarray(P),
                      prior_x0_mean=jnp.asarray([1.6, 0.0]),
                      prior_x0_cov=jnp.asarray(0.1 * np.eye(2)))
    jstate, jfe = jm.infer(jnp.asarray(_theta(3)), jnp.asarray(y), iterations=2)
    _close(state.x_means, jstate.x_means)
    _close(fe, jfe)
    pm, pc = m.predict(th, state, _t(yt))
    dm, dc = chain_smoother.one_step_ahead(TK, th, _t(Xu_np), state, _t(yt), kw["obs_cov"])
    assert torch.equal(pm, dm) and torch.equal(pc, dc)
    h = m.predictor(th, state)
    d = GPSSMFilter.from_state(TK, th, _t(Xu_np), state, kw["obs_cov"])
    assert all(torch.equal(a, b) for a, b in zip(h(_t(yt))[:2], d(_t(yt))[:2]))


def test_gplvm():
    Y, _ = oil_flow_synthetic(2, 24)
    Xm = pca_2d(Y)
    Xu_np = Xm[np.random.default_rng(86).permutation(24)[:6]]
    th = np.array([1.0, 0.6, 0.5])
    m = model.GPLVM(kernel=TK, Xu=_t(Xu_np))
    state, fe = m.infer(_t(th), _t(Y), _t(Xm), iterations=1)
    d_state, d_fe = gplvm.gplvm_vmp(TK, _t(th), _t(Xu_np), _t(Y), _t(Xm), n_iters=1)
    _equal_trees(state, d_state)
    assert torch.equal(fe, d_fe)
    jstate, jfe = jmodel.GPLVM(kernel=JK, Xu=jnp.asarray(Xu_np)).infer(
        jnp.asarray(th), jnp.asarray(Y), jnp.asarray(Xm), iterations=1)
    _close(state.x_means, jstate.x_means)
    _close(fe, jfe)
