"""The port's probit classification serving path against the JAX package,
on the CPU: ``predict_probit``, ``SGPClassifier`` built by
``convert.classifier_state_from_jax`` from the committed banana state
(benchmarks/banana_refxu_trained.npz: θ, ξ, Λ, w_shape, w_rate; κ(Λ) ≈
2e10), ``serve_fused`` on a classifier, and ``mv_nat_to_meancov``.

Tolerances follow the means: P = Φ(m/√(1+v)) moves by at most
φ(0)·|Δm|/√(1+v) ≤ 0.4·|Δm|, and |Δm| is held relative to |K|ᵀ|μ|, the
scale the means' rounding follows.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import dists as jdists
from gaussianprocessnode_tpu import serve as jserve
from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer.batch_vmp import predict_probit as j_predict_probit
from gaussianprocessnode_tpu.ops import pallas_gram as pg
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert, dists, serve
from gaussianprocessnode_tpu_torch.infer.batch_vmp import predict_probit
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

NPZ = Path(__file__).resolve().parent.parent / "benchmarks" / "banana_refxu_trained.npz"
M_BANANA = 500


@pytest.fixture(scope="module")
def state():
    z = np.load(NPZ, allow_pickle=False)
    return {k: z[k] for k in ("theta", "xi", "prec", "w_shape", "w_rate")}


def _interpret(fn):
    pg._INTERPRET = True
    jax.clear_caches()  # se_gram_pallas's jit trace depends on the flag
    try:
        return fn()
    finally:
        pg._INTERPRET = False
        jax.clear_caches()


def _scale(kernel, theta, Xu, X, mu):
    """|K(Xu, X)|ᵀ|μ| in float64."""
    t = lambda a: torch.as_tensor(a).double()  # noqa: E731
    return (kernel(t(theta), t(Xu), t(X)).abs().T @ t(mu).abs()).numpy()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_predict_probit_matches_jax(use_kernel):
    """f64, small shapes: 0.4·1e-12 of |K|ᵀ|μ| (the means' bound in
    test_torch_serve.py) plus 4ε."""
    rng = np.random.default_rng(0)
    Xu, X, mu = rng.standard_normal((12, 2)), rng.standard_normal((40, 2)), rng.standard_normal(12)
    theta = np.array([0.6, -0.2, 0.4])
    want = np.asarray(j_predict_probit(JKernel("se", "softplus", use_pallas=use_kernel),
                                       jnp.asarray(theta), jnp.asarray(Xu), jnp.asarray(X),
                                       jnp.asarray(mu), 3.0))
    kern = Kernel("se", "softplus", use_kernel=use_kernel)
    got = predict_probit(kern, torch.as_tensor(theta), torch.as_tensor(Xu), torch.as_tensor(X),
                         torch.as_tensor(mu), torch.tensor(3.0, dtype=torch.float64))
    assert got.dtype == torch.float64 and got.shape == (40,)
    tol = 0.4 * 1e-12 * _scale(kern, theta, Xu, X, mu) + 4 * np.finfo(np.float64).eps
    assert np.all(np.abs(got.numpy() - want) <= tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_classifier_matches_jax_handle(state, dtype):
    """classifier_state_from_jax → handle → probabilities and labels against
    the JAX SGPClassifier built from the same arrays (Kernel('se',
    'softplus', use_pallas=True); in f32 its Gram runs the Pallas kernel
    interpreted). Xu is drawn N(0, I₂): the npz holds none.

    θ, Xu and w̄ agree exactly. μ_v does not, in either package's sense:
    Λ has ‖Λ‖∞/λ_min ≈ 2.8e10, and 60 Newton–Schulz iterations leave
    ‖I − ΛΣ‖_F ≈ 4.8e3 in both, so the refined μ_v is determined only to
    the residual ‖Λμ − ξ‖/‖ξ‖ ≈ 3e-5 (measured 2.8e-5 JAX, 3.2e-5 port;
    held to 1e-4 each) and the two μ_v differ at O(1) in Λ's
    ill-conditioned directions. So the serving arithmetic is compared on
    JAX's μ_v: probabilities to 0.4·rtol of |K|ᵀ|μ| plus 4ε, rtol 1e-12 in
    f64 and 1e-5 in f32 (f32 Gram and mat-vec over 500 terms); labels equal
    away from P = ½."""
    rng = np.random.default_rng(12)
    Xu = rng.standard_normal((M_BANANA, 2))
    X = rng.standard_normal((256, 2)) * 0.5
    npd = np.float64 if dtype == torch.float64 else np.float32
    jh = jserve.SGPClassifier.from_natural(
        JKernel("se", "softplus", use_pallas=True), jnp.asarray(state["theta"]),
        jnp.asarray(Xu), JNat(jnp.asarray(state["xi"]), jnp.asarray(state["prec"])),
        JGamma(jnp.asarray(state["w_shape"]), jnp.asarray(state["w_rate"])), dtype=npd)

    def jrun():
        return np.asarray(jh.probabilities(X)), np.asarray(jh(X))

    jp, jlab = _interpret(jrun) if dtype == torch.float32 else jrun()
    th = convert.classifier_state_from_jax(state["theta"], Xu, state["xi"], state["prec"],
                                           state["w_shape"], state["w_rate"], dtype=dtype,
                                           device="cpu")
    assert th.kernel == Kernel("se", "softplus", use_kernel=True)
    assert th.theta.dtype == th.Xu.dtype == th.mu_v.dtype == dtype
    assert np.array_equal(th.theta.numpy(), np.asarray(jh.theta))
    assert np.array_equal(th.Xu.numpy(), np.asarray(jh.Xu))
    assert th.w_mean.dtype == torch.float64 and th.w_mean.shape == ()
    assert float(th.w_mean) == jh.w_mean
    P, xi = state["prec"], state["xi"]
    for mu in (th.mu_v.double().numpy(), np.asarray(jh.mu_v, np.float64)):
        if dtype == torch.float64:
            assert np.linalg.norm(P @ mu - xi) / np.linalg.norm(xi) <= 1e-4
    th = dataclasses.replace(th, mu_v=torch.as_tensor(np.array(jh.mu_v)))
    p = th.probabilities(X)
    assert p.dtype == dtype and p.shape == (256,)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    tol = 0.4 * rtol * _scale(th.kernel, th.theta, th.Xu, X, th.mu_v) + 4 * np.finfo(npd).eps
    assert np.all(np.abs(p.numpy() - jp) <= tol)
    lab = th(X)
    assert lab.dtype == dtype
    away = np.abs(jp - 0.5) > tol
    np.testing.assert_array_equal(lab.numpy()[away], jlab[away])
    assert 0.05 < float(lab.mean()) < 0.95  # both classes appear


def test_serve_fused_rows_equal_per_batch_probabilities(state):
    """serve_fused on a classifier: (R, B) probabilities, row i exactly
    ``probabilities(X_batches[i])``; the regressor path is unchanged."""
    th = convert.classifier_state_from_jax(
        state["theta"], np.random.default_rng(1).standard_normal((M_BANANA, 2)),
        state["xi"], state["prec"], state["w_shape"], state["w_rate"],
        dtype=torch.float32, device="cpu")
    X = np.random.default_rng(2).standard_normal((3, 70, 2))
    P = serve.serve_fused(th, X)
    assert isinstance(P, torch.Tensor) and tuple(P.shape) == (3, 70)
    for i in range(3):
        assert torch.equal(P[i], th.probabilities(X[i]))
    assert serve.throughput(th, X[0], iters=2) > 0
    assert serve.throughput_fused(th, X[0], n_batches=3, iters=2) > 0


def test_serve_fused_matches_jax_serve_fused_on_classifier():
    """f64 small model: the port's loop against the JAX scanned program with
    the Φ epilogue, to 0.4·1e-12 of |K|ᵀ|μ| plus 4ε."""
    rng = np.random.default_rng(3)
    Xu, X = rng.standard_normal((15, 2)), rng.standard_normal((4, 20, 2))
    A = rng.standard_normal((15, 15))
    prec, xi = A @ A.T + 15 * np.eye(15), rng.standard_normal(15)
    theta = np.array([0.5, 0.3, 0.8])
    jh = jserve.SGPClassifier.from_natural(
        JKernel("se", "softplus"), jnp.asarray(theta), jnp.asarray(Xu),
        JNat(jnp.asarray(xi), jnp.asarray(prec)), JGamma(jnp.asarray(6.0), jnp.asarray(2.0)))
    want = np.asarray(jserve.serve_fused(jh, X))
    th = serve.SGPClassifier.from_natural(Kernel("se", "softplus"), theta, Xu,
                                          dists.MvGaussianNat(xi, prec),
                                          dists.GammaShapeRate(6.0, 2.0), device="cpu")
    got = serve.serve_fused(th, X)
    assert float(th.w_mean) == 3.0
    for i in range(4):
        tol = 0.4 * 1e-12 * _scale(th.kernel, theta, Xu, X[i], th.mu_v) + 4e-16
        assert np.all(np.abs(got[i].numpy() - want[i]) <= tol)


def test_classifier_defaults_to_the_card(state):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        convert.classifier_state_from_jax(state["theta"], np.zeros((M_BANANA, 2)), state["xi"],
                                          state["prec"], state["w_shape"], state["w_rate"])


def test_mv_nat_to_meancov_matches_jax():
    """f64, κ(Λ) ≈ 1e3: Cholesky solves in both, to 1e-12 relative."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((20, 20))
    prec, xi = A @ A.T + 0.5 * np.eye(20), rng.standard_normal(20)
    want = jdists.mv_nat_to_meancov(JNat(jnp.asarray(xi), jnp.asarray(prec)))
    got = dists.mv_nat_to_meancov(dists.MvGaussianNat(torch.as_tensor(xi), torch.as_tensor(prec)))
    assert isinstance(got, dists.MvGaussian)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(want.cov)).max())
    assert torch.equal(got.cov, got.cov.T)
