"""Parity of the port's dense GP, t-process (infer/tprocess.py) and
full-covariance Bayesian-θ GP (infer/fullcov_gp.py) with the JAX
package's, on the CPU in float64.

- ``gp_exact_posterior`` / ``tp_exact_posterior`` to 1e-11 relative: one
  Cholesky factor and two triangular solves of a well-conditioned K + σ²I;
- ``fullcov_gp_vmp`` to 1e-6 relative in q(θ), q(γ), q(f) and the free
  energy (measured ≤ 4e-8 at N = 30 over 4 sweeps). The θ-tilt's GH-21 grid
  spans ℓ = e^{log 4 ± 11}: at its long-ℓ nodes K(ℓ) + 1e-8 I has κ up to
  ~1e10 and messages of −1e9 nats, where the two packages' Cholesky factors
  differ by κ·ε (measured up to 6 nats there, 1e-4 nats at the nodes that
  carry mass), so the matched q(θ) carries ~1e-8 of that rounding. A 1-ulp
  change of y moves JAX's own result by 1e-10–2e-9;
- ``fullcov_gp_predict`` from the JAX state carried by
  ``convert.fullcov_state_from_jax`` to 1e-10 (no iteration: the same
  9 batched factorisations);
- the batched Gram of ``ops/kernels.py::sqdist`` equals the per-lengthscale
  Grams to 1e-13 relative (a batched and a plain GEMM may round the cross
  term's D-term sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import fullcov_gp as jfc
from gaussianprocessnode_tpu.infer import tprocess as jtp
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.dists import gamma_mean
from gaussianprocessnode_tpu_torch.infer import fullcov_gp as tfc
from gaussianprocessnode_tpu_torch.infer import tprocess as ttp
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel, gram

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def sinc_draw(seed, n, outliers=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, n))
    y = np.sinc(x) + 0.1 * rng.normal(size=n)
    if outliers:
        y[n // 2:n // 2 + 2] += 2.0
    return x, y, np.linspace(-3.1, 3.1, 45)


@pytest.mark.parametrize("kind,transform,nu,outliers", [
    ("matern52", "identity", 100.0, True), ("matern52", "identity", 5.0, False),
    ("se", "softplus", 20.0, True)])
def test_gp_and_tp_posteriors(kind, transform, nu, outliers):
    x, y, xt = sinc_draw(4, 20, outliers)
    theta = np.array([1.0, np.log(2.0)])
    tk, jk = Kernel(kind, transform), JKernel(kind, transform)
    args = (t64(x[:, None]), t64(y), t64(xt[:, None]), 0.01)
    jargs = (jnp.asarray(x[:, None]), jnp.asarray(y), jnp.asarray(xt[:, None]), 0.01)
    gp = ttp.gp_exact_posterior(tk, t64(theta), *args)
    gj = jtp.gp_exact_posterior(jk, jnp.asarray(theta), *jargs)
    tp = ttp.tp_exact_posterior(tk, t64(theta), nu, *args)
    tj = jtp.tp_exact_posterior(jk, jnp.asarray(theta), nu, *jargs)
    for a, b in zip(gp, gj):
        assert rel(a, b) <= 1e-11
    for a, b in zip(tp, tj):
        assert rel(a, b) <= 1e-11
    assert torch.equal(gp.mean, tp.mean)


def test_batched_gram_equals_per_lengthscale():
    rng = np.random.default_rng(1)
    X = t64(rng.uniform(-3, 3, (17, 2)))
    Z = t64(rng.uniform(-3, 3, (9, 2)))
    ls = t64([0.3, 1.0, 4.0])
    batch = gram("matern52", X, Z, t64([1.0, 2.0, 0.5])[:, None, None], ls[:, None, None])
    for j in range(3):
        one = gram("matern52", X, Z, t64([1.0, 2.0, 0.5])[j], ls[j:j + 1])
        assert rel(batch[j], one.numpy()) <= 1e-13


@pytest.fixture(scope="module")
def fullcov_pair():
    x, y, xt = sinc_draw(0, 30)
    kern, jkern = Kernel("matern52"), JKernel("matern52")
    st = tfc.fullcov_gp_vmp(kern, t64(x[:, None]), t64(y), m_th0=float(np.log(4.0)), iters=4)
    sj = jfc.fullcov_gp_vmp(jkern, jnp.asarray(x[:, None]), jnp.asarray(y),
                            m_th0=float(np.log(4.0)), iters=4)
    return x, y, xt, st, jax.tree.map(np.asarray, sj)


def test_fullcov_vmp_matches_jax(fullcov_pair):
    _, _, _, st, sj = fullcov_pair
    assert rel(st.m_th, sj.m_th) <= 1e-6
    assert rel(st.v_th, sj.v_th) <= 1e-6
    assert rel(st.gamma.shape, sj.gamma.shape) <= 1e-12
    assert rel(st.gamma.rate, sj.gamma.rate) <= 1e-6
    assert rel(st.m_f, sj.m_f) <= 1e-6
    assert rel(st.V_f, sj.V_f) <= 1e-6
    assert rel(st.fe, sj.fe) <= 1e-6
    assert st.fe.shape == (4,)
    assert 5.0 < float(gamma_mean(st.gamma))


def test_fullcov_predict_from_jax_state(fullcov_pair):
    x, _, xt, _, sj = fullcov_pair
    state = convert.fullcov_state_from_jax(sj, device="cpu")
    mean, var = tfc.fullcov_gp_predict(Kernel("matern52"), state, t64(x[:, None]),
                                       t64(xt[:, None]))
    mj, vj = jfc.fullcov_gp_predict(JKernel("matern52"), jax.tree.map(jnp.asarray, sj),
                                    jnp.asarray(x[:, None]), jnp.asarray(xt[:, None]))
    assert rel(mean, mj) <= 1e-10
    assert rel(var, vj) <= 1e-10


def test_fullcov_without_fe():
    x, y, _ = sinc_draw(3, 12)
    st = tfc.fullcov_gp_vmp(Kernel("matern52"), t64(x[:, None]), t64(y), m_th0=0.0, iters=2,
                            compute_fe=False)
    assert torch.equal(st.fe, torch.zeros(2, dtype=F64))
    assert torch.isfinite(st.m_f).all()
