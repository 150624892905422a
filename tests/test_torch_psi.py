"""Parity of the port's ops/psi.py with the JAX package's, on the CPU.

Seeded inducing inputs and Gaussian inputs (M = 9; 1-D for the univariate
forms, 2-D for the multivariate ones), with every rule that feeds them: GH
(21 and 32 points), SR, UT and GenUT. The SE kernel is the softplus one of
the toy workloads, ARD in 2-D; the port's ``Kernel(use_kernel=True)`` takes
the plain Gram on the CPU, as the JAX kernel without Pallas does.

Tolerance: float64 Grams and contractions of at most a few hundred terms,
≤ 1e-12 relative to the largest entry (measured ~1e-15); float32, 64·ε of
it. A rule's weighted sums cancel from Σ|wₚ| times that entry, so the bound
is scaled by Σ|wₚ|: 1 for GH, SR and GenUT, ≈ 2e6 for the UT at its
default α = 1e-3, whose centre weighs −1e6 (in float32 that rule's Ψ's are
rounding noise in both packages). Gradients with respect to θ (through the
Gram's analytic VJP in the port, autodiff in JAX) to the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.ops import psi as jpsi
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch.ops import psi as tpsi
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as TKernel

JK = JKernel("se", transform="softplus")
TK = TKernel("se", transform="softplus", use_kernel=True)
RTOL = {np.float64: 1e-12, np.float32: 64 * float(np.finfo(np.float32).eps)}
DTYPES = [np.float64, np.float32]
M = 9

UNI = [jq.GaussHermite(21), jq.GaussHermite(32), jq.SphericalRadial(), jq.Unscented(),
       jq.GenUT()]
MULTI = [jq.SphericalRadial(), jq.Unscented(), jq.GenUT()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(method):
    return getattr(tq, type(method).__name__)(**vars(method))


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def close(got, want, rtol, cancel=1.0):
    """Held relative to the largest |entry| of the JAX result, times the
    rule's cancellation factor Σ|wₚ|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300) * max(cancel, 1.0)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def inputs(d, dtype, seed=0, n=6):
    rng = np.random.default_rng(seed)
    theta = np.concatenate([[0.4], rng.uniform(-0.5, 0.8, d)]).astype(dtype)
    Xu = rng.uniform(-3.0, 3.0, (M, d)).astype(dtype)
    means = rng.uniform(-2.0, 2.0, (n, d)).astype(dtype)
    A = rng.standard_normal((n, d, d)) * 0.4
    covs = (A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(d)).astype(dtype)
    return theta, Xu, means, covs


def pair(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_psi_match_jax(dtype):
    theta, Xu, X, _ = inputs(2, dtype)
    (jt, jXu, jX), (tt, tXu, tX) = pair(theta, Xu, X)
    close(tpsi.psi1_exact(TK, tt, tXu, tX[0]), jpsi.psi1_exact(JK, jt, jXu, jX[0]), RTOL[dtype])
    for g, w in zip(tpsi.psi_batch_exact(TK, tt, tXu, tX),
                    jpsi.psi_batch_exact(JK, jt, jXu, jX)):
        close(g, w, RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", UNI, ids=repr)
def test_expected_psi_uni_match_jax(method, dtype):
    theta, Xu, means, covs = inputs(1, dtype)
    (jt, jXu), (tt, tXu) = pair(theta, Xu)
    m, v = means[:, 0], covs[:, 0, 0]
    cancel = float(np.sum(np.abs(jq.points_weights_uni(method, 0.0, 1.0)[1])))
    for i in range(3):
        want = jpsi.psi_expected_uni(JK, jt, jXu, method, jnp.asarray(m[i]), jnp.asarray(v[i]))
        got = tpsi.psi_expected_uni(TK, tt, tXu, _port(method), torch.as_tensor(m[i]),
                                    torch.as_tensor(v[i]))
        for g, w in zip(got, want):
            close(g, w, RTOL[dtype], cancel)
    want = jpsi.psi_batch_expected_uni(JK, jt, jXu, method, jnp.asarray(m), jnp.asarray(v))
    got = tpsi.psi_batch_expected_uni(TK, tt, tXu, _port(method), torch.as_tensor(m),
                                      torch.as_tensor(v))
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], cancel)
    Kp, wq = got[2], got[3]
    c = torch.linspace(0.5, 1.5, m.shape[0], dtype=Kp.dtype)
    close(tpsi.sum_weighted_psi2(Kp, wq, c),
          jpsi.sum_weighted_psi2(want[2], want[3], jnp.asarray(c.numpy())), RTOL[dtype], cancel)
    close(tpsi.per_datum_psi2(Kp, wq), jpsi.per_datum_psi2(want[2], want[3]), RTOL[dtype],
          cancel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", MULTI, ids=repr)
def test_expected_psi_multi_match_jax(method, dtype):
    theta, Xu, means, covs = inputs(2, dtype, seed=1)
    (jt, jXu, jm, jV), (tt, tXu, tm, tV) = pair(theta, Xu, means, covs)
    cancel = float(jnp.sum(jnp.abs(jq.points_weights_multi(method, jm[0], jV[0])[1])))
    want = jpsi.psi_expected_multi(JK, jt, jXu, method, jm[0], jV[0])
    got = tpsi.psi_expected_multi(TK, tt, tXu, _port(method), tm[0], tV[0])
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], cancel)
    close(tpsi.psi1_expected_multi(TK, tt, tXu, _port(method), tm[1], tV[1]),
          jpsi.psi1_expected_multi(JK, jt, jXu, method, jm[1], jV[1]), RTOL[dtype], cancel)
    want = jpsi.psi_batch_expected_multi(JK, jt, jXu, method, jm, jV)
    got = tpsi.psi_batch_expected_multi(TK, tt, tXu, _port(method), tm, tV)
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], cancel)


@pytest.mark.parametrize("method", [jq.GaussHermite(21), jq.GenUT()], ids=repr)
def test_expected_psi_theta_gradient_matches_jax(method):
    """∇θ of a scalar of the batched expected Ψ's: the port's gradient runs
    through the SE Gram's analytic VJP."""
    theta, Xu, means, covs = inputs(1, np.float64, seed=2)
    m, v = means[:, 0], covs[:, 0, 0]

    def jf(t):
        p0, p1, Kp, w = jpsi.psi_batch_expected_uni(JK, t, jnp.asarray(Xu), method,
                                                    jnp.asarray(m), jnp.asarray(v))
        return jnp.sum(p0) + jnp.sum(p1**2) + jnp.sum(jpsi.per_datum_psi2(Kp, w))

    want = jax.grad(jf)(jnp.asarray(theta))
    t = torch.as_tensor(theta).requires_grad_(True)
    p0, p1, Kp, w = tpsi.psi_batch_expected_uni(TK, t, torch.as_tensor(Xu), _port(method),
                                                torch.as_tensor(m), torch.as_tensor(v))
    (g,) = torch.autograd.grad(torch.sum(p0) + torch.sum(p1**2)
                               + torch.sum(tpsi.per_datum_psi2(Kp, w)), t)
    close(g, want, 1e-12)
