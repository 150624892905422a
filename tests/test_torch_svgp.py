"""Parity of the port's infer/svgp.py with the JAX package's, on the CPU.

Seeded problem: M = 8 inducing inputs and N = 64 points in 2-D (standard
normal), y = sin(x₁ + x₂) + N(0, 0.1²) and its signs as class labels,
θ = (0.2, 0.1, −0.3) under softplus, a random whitened mean and a random
lower-triangular factor (one raw diagonal entry negative, for
``raw_tril``), log σ² = log 0.05. The trainers run on B = 4 batches of 16.

Tolerances, relative to each compared result's largest entry:
- float64: 1e-10 for single evaluations (measured ≤ 3.2e-13: the Grams,
  Cholesky factors and triangular solves are the same arithmetic, summed
  in other orders) and 1e-9 after the trainers' 8 AdaMax steps (measured
  ≤ 8.4e-13). The Bernoulli ELBO's gradient is held to 1e-8: the
  derivatives of JAX's ``norm.logcdf`` and ``torch.special.log_ndtr``
  differ by up to 4.0e-9 relative for z in [−40, −20], which the centered
  parameterization reaches (|z| up to ~95 here; measured 1.5e-9);
- float32: 5e-4 for single evaluations, whose float32 rounding is carried
  through the solves against Kuu (κ(Kuu) ≈ 1.4e3, so κ·ε ≈ 1.6e-4; measured
  ≤ 8.7e-5, the JAX and torch values each as far from the float64 value),
  and 2e-4 after training (measured ≤ 2.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianprocessnode_tpu.infer import svgp as js
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.infer import svgp as ts
from gaussianprocessnode_tpu_torch.infer.minibatch import AdaMaxChain
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as TKernel

JK = JKernel("se", transform="softplus")
TK = TKernel("se", transform="softplus", use_kernel=True)
M, N, DIN, B = 8, 64, 2, 4
RTOL = {np.float64: 1e-10, np.float32: 5e-4}
LOG_NDTR_RTOL = 1e-8
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


def close_tree(got, want, rtol):
    for g, w in zip(got, want):
        close(g, w, rtol)


def _problem(dtype=np.float64):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, DIN))
    Xu = rng.standard_normal((M, DIN))
    y = np.sin(X.sum(1)) + 0.1 * rng.standard_normal(N)
    A = np.tril(rng.standard_normal((M, M)) * 0.2, -1) + np.diag(rng.uniform(0.3, 1.0, M))
    A[2, 2] = -0.6  # a negative raw diagonal entry (raw_tril keeps it)
    leaves = (np.array([0.2, 0.1, -0.3]), rng.standard_normal(M) * 0.5, A,
              np.array(np.log(0.05)))
    arrays = [a.astype(dtype) for a in (X, Xu, y, (y > 0).astype(float))]
    return arrays, [np.asarray(p, dtype) for p in leaves]


def _both(dtype=np.float64):
    (X, Xu, y, yc), leaves = _problem(dtype)
    j = [jnp.asarray(a) for a in (X, Xu, y, yc)]
    t = [torch.as_tensor(a) for a in (X, Xu, y, yc)]
    jp = js.SVGPParams(*(jnp.asarray(p) for p in leaves))
    tp = ts.SVGPParams(*(torch.as_tensor(p) for p in leaves))
    return j, t, jp, tp


def _torch_grad(fn, params):
    leaves = [p.detach().requires_grad_(True) for p in params]
    v = fn(ts.SVGPParams(*leaves))
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    return v, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("whitened", [True, False])
@pytest.mark.parametrize("raw_tril", [False, True])
def test_marginal_f_matches_jax(whitened, raw_tril):
    (jX, jXu, _, _), (tX, tXu, _, _), jp, tp = _both()
    jm, jv = js._marginal_f(JK, jp, jXu, jX, whitened, raw_tril=raw_tril)
    tm, tv = ts._marginal_f(TK, tp, tXu, tX, whitened, raw_tril=raw_tril)
    close(tm, jm, RTOL[np.float64])
    close(tv, jv, RTOL[np.float64])


@pytest.mark.parametrize("raw_tril", [False, True])
def test_kls_match_jax(raw_tril):
    (_, jXu, _, _), (_, tXu, _, _), jp, tp = _both()
    close(ts._kl_whitened(tp, raw_tril), js._kl_whitened(jp, raw_tril), RTOL[np.float64])
    close(ts._kl_centered(TK, tp, tXu, raw_tril=raw_tril),
          js._kl_centered(JK, jp, jXu, raw_tril=raw_tril), RTOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("likelihood", ["gaussian", "bernoulli"])
@pytest.mark.parametrize("whitened", [True, False])
def test_elbo_and_gradient_match_jax(dtype, likelihood, whitened):
    """Both ELBOs (scale 4, as a batch of 16 of 64 points) and their
    gradients in every parameter. The Bernoulli ELBO's GH nodes are in the
    default dtype (float64) in both packages, so its float32 value is a
    float64 sum."""
    (jX, jXu, jy, jyc), (tX, tXu, ty, tyc), jp, tp = _both(dtype)
    jy, ty = (jy, ty) if likelihood == "gaussian" else (jyc, tyc)
    jf = js.elbo_gaussian if likelihood == "gaussian" else js.elbo_bernoulli
    tf = ts.elbo_gaussian if likelihood == "gaussian" else ts.elbo_bernoulli
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jf(JK, p, jXu, jX, jy, scale=4.0, whitened=whitened)))(jp)
    tv, tg = _torch_grad(lambda p: tf(TK, p, tXu, tX, ty, scale=4.0, whitened=whitened), tp)
    assert tv.dtype == torch.as_tensor(np.array(jv)).dtype
    rtol = RTOL[dtype]
    if likelihood == "bernoulli" and dtype == np.float64:
        rtol = LOG_NDTR_RTOL
    close(tv, jv, rtol)
    close_tree(tg, jg, rtol)


def test_elbo_stays_finite_with_a_negative_raw_diagonal():
    (jX, jXu, jy, _), (tX, tXu, ty, _), jp, tp = _both()
    tv = ts.elbo_gaussian(TK, tp, tXu, tX, ty, raw_tril=True)
    assert torch.isfinite(tv)
    close(tv, js.elbo_gaussian(JK, jp, jXu, jX, jy, raw_tril=True), RTOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_collapsed_bound_gradient_and_prediction_match_jax(dtype):
    (jX, jXu, jy, _), (tX, tXu, ty, _), jp, tp = _both(dtype)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda th: js.collapsed_neg_elbo(JK, th, jXu, jX, jy, 0.01, jitter=1e-5)))(jp.theta)
    th = tp.theta.clone().requires_grad_(True)
    tv = ts.collapsed_neg_elbo(TK, th, tXu, tX, ty, 0.01, jitter=1e-5)
    (tg,) = torch.autograd.grad(tv, th)
    close(tv, jv, RTOL[dtype])
    close(tg, jg, RTOL[dtype])
    Xt = np.linspace(-2, 2, 10 * DIN).reshape(10, DIN).astype(dtype)
    close(ts.collapsed_predict(TK, tp.theta, tXu, torch.as_tensor(Xt), tX, ty, 0.01, 1e-5),
          js.collapsed_predict(JK, jp.theta, jXu, jnp.asarray(Xt), jX, jy, 0.01, 1e-5),
          RTOL[dtype])


@pytest.mark.parametrize("dtype,likelihood,learn_noise", [
    (np.float64, "gaussian", True), (np.float64, "gaussian", False),
    (np.float64, "bernoulli", True), (np.float32, "gaussian", False),
    (np.float32, "bernoulli", True)])
def test_fit_svgp_two_epochs_match_jax(dtype, likelihood, learn_noise):
    """2 epochs over 4 batches (8 AdaMax steps, lr 0.01) from the same
    parameters. With ``learn_noise=False`` log σ² stays bit for bit."""
    (jX, jXu, jy, jyc), (tX, tXu, ty, tyc), jp, tp = _both(dtype)
    jy, ty = (jy, ty) if likelihood == "gaussian" else (jyc, tyc)
    kw = dict(likelihood=likelihood, epochs=2, learning_rate=0.01, learn_noise=learn_noise)
    jout = js.fit_svgp(JK, jp, jXu, jX.reshape(B, N // B, DIN), jy.reshape(B, N // B), N, **kw)
    tout = ts.fit_svgp(TK, tp, tXu, tX.reshape(B, N // B, DIN), ty.reshape(B, N // B), N, **kw)
    close_tree(tout, jout, TRAIN_RTOL[dtype])
    assert not torch.equal(tout.theta, tp.theta)
    if not learn_noise:
        assert torch.equal(tout.log_noise, tp.log_noise)


def test_fit_svgp_centered_raw_tril_matches_jax():
    """The reference's own parameterization (centered, raw factor)."""
    (jX, jXu, jy, _), (tX, tXu, ty, _), jp, tp = _both()
    kw = dict(epochs=2, learning_rate=0.01, learn_noise=False, whitened=False,
              raw_tril=True, jitter=1e-5)
    jout = js.fit_svgp(JK, jp, jXu, jX.reshape(B, N // B, DIN), jy.reshape(B, N // B), N, **kw)
    tout = ts.fit_svgp(TK, tp, tXu, tX.reshape(B, N // B, DIN), ty.reshape(B, N // B), N, **kw)
    close_tree(tout, jout, TRAIN_RTOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_collapsed_chunk_resumes_from_a_jax_chunk(dtype):
    """A JAX chunk of 3 steps, its (θ, optax state) carried over by
    ``convert.adamax_state_from_jax``; then 4 more steps in both packages:
    θ, the state leaf for leaf, and the −ELBO trace agree."""
    (jX, jXu, jy, _), (tX, tXu, ty, _), jp, _ = _both(dtype)
    kw = dict(learning_rate=0.05, jitter=1e-5)
    th1, os1, _ = js.fit_svgp_collapsed_resumable(
        JK, jp.theta, js.collapsed_opt_init(jp.theta, 0.05), jXu, jX, jy, 0.01, steps=3, **kw)
    state = convert.adamax_state_from_jax(jax.tree.map(np.asarray, os1), device="cpu")
    assert set(state) == {"found_nan", "count", "mu", "nu"} and int(state["count"]) == 3
    th2, os2, tr2 = js.fit_svgp_collapsed_resumable(JK, th1, os1, jXu, jX, jy, 0.01, steps=4,
                                                    **kw)
    tth, tst, ttr = ts.fit_svgp_collapsed_resumable(
        TK, torch.as_tensor(np.asarray(th1)), state, tXu, tX, ty, 0.01, steps=4, **kw)
    close(tth, th2, TRAIN_RTOL[dtype])
    close(ttr, tr2, RTOL[dtype])
    z, (adam, _) = os2
    assert int(tst["count"]) == int(adam.count) == 7
    assert bool(tst["found_nan"]) == bool(z.found_nan)
    close(tst["mu"], adam.mu, TRAIN_RTOL[dtype])
    close(tst["nu"], adam.nu, TRAIN_RTOL[dtype])
    assert int(state["count"]) == 3  # the caller's state is not modified


def test_vsgp_optimizer_is_zero_nans_then_adamax_without_clipping():
    """A NaN and a gradient of norm 1e9 through the SVGPParams leaves:
    ``vsgp_optimizer`` matches ``optax.chain(zero_nans(), adamax)``, while
    the default AdaMaxChain (clip at 1e8) differs on the same gradient."""
    _, _, jp, tp = _both()
    g = [np.full(p.shape, 3e8) for p in jp]
    g[1][0] = np.nan
    jopt = optax.chain(optax.zero_nans(), optax.adamax(0.05))
    jstate = jopt.init(jp)
    jg = js.SVGPParams(*(jnp.asarray(a) for a in g))
    tg = ts.SVGPParams(*(torch.as_tensor(a) for a in g))
    opt = ts.vsgp_optimizer(0.05)
    tstate = opt.init(tp)
    for _ in range(2):
        ju, jstate = jopt.update(jg, jstate, jp)
        tu = opt.update_(tg, tstate)
    close_tree(tu, ju, 1e-15)
    assert [bool(f) for f in tstate["found_nan"]] == [False, True, False, False]
    clipped = AdaMaxChain(learning_rate=0.05)
    cstate = clipped.init(tp)
    clipped.update_(tg, cstate)
    assert not torch.allclose(cstate["mu"].theta, tstate["mu"].theta)
    # the JAX state, carried over, is the port's leaf for leaf
    cs = convert.adamax_state_from_jax(jax.tree.map(np.asarray, jstate), ts.SVGPParams,
                                       device="cpu")
    assert int(cs["count"]) == int(tstate["count"]) == 2
    assert isinstance(cs["found_nan"], ts.SVGPParams)
    assert [bool(f) for f in cs["found_nan"]] == [bool(f) for f in tstate["found_nan"]]
    for key in ("mu", "nu"):
        assert isinstance(cs[key], ts.SVGPParams)
        close_tree(cs[key], getattr(jstate[1][0], key), 0.0)
        close_tree(tstate[key], getattr(jstate[1][0], key), 1e-15)


def test_init_and_params_converter_match_jax():
    """The initial parameters agree to the last bit but for the raw
    diagonal log(expm1(1)), which Python's libm and XLA round one ulp
    apart."""
    for kw in ({}, {"noise": 0.01}, {"raw_tril": True}):
        jp = js.init_svgp(jnp.asarray([0.1, 0.2]), 5, **kw)
        tp = ts.init_svgp(torch.tensor([0.1, 0.2], dtype=torch.float64), 5, **kw)
        close_tree(tp, jp, 1e-15)
    tp = convert.svgp_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert isinstance(tp, ts.SVGPParams)
    close_tree(tp, jp, 0.0)
