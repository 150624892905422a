"""Parity of the port's infer/batch_vmp.py (regression_vmp,
classification_vmp, the prior energies) with the JAX package's, on the CPU.

Inputs: the toy workloads' own data and configurations (``toy_sinc``, N =
50, M = 20 on [−4, 4]; ``toy_classification``, N = 100, M = 15 on
[−5, 5]; prior N(0, 50·I) and Γ(1e-2, 1e-2)) at θ0 = softplus⁻¹(1) and at
a second θ, in float64, with the options the trainers and the kin40k
configuration use: ``w_fixed``, ``compute_fe=False`` and
``probit_product="gh32"``.

Tolerances. The free energy is a sum of terms of order 10–200 that cancel
to order 1–50, each from the Cholesky factor of Λ = I/50 + w·KuxKuxᵀ
(κ(Λ) up to 4.5e5 here), so its relative error is κ(Λ)·ε times that
cancellation: held to 1e-9 relative, the trainers' bound (measured up to
7.5e-11). μ_v, Σ_v, ξ, Λ and Uv agree to 20·κ(Λ)·ε = 2e-9 of their largest
entry (measured ≤ 4e-11); q(w) and q(f) to 1e-10 relative (measured
≤ 9e-13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import batch_vmp as jb
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.utils.datasets import toy_classification, toy_sinc
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import batch_vmp as tb
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

JK = JKernel("se", transform="softplus")
TK = Kernel("se", transform="softplus", use_kernel=True)
FE_RTOL = 1e-9
QV_RTOL = 2e-9
RTOL = 1e-10
THETAS = {"theta0": [0.5413248546129181, 0.5413248546129181], "theta1": [-1.2, 0.3]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def close(got, want, rtol):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def problem(kind):
    if kind == "regression":
        d, M, lim = toy_sinc(), 20, 4.0
    else:
        d, M, lim = toy_classification(), 15, 5.0
    Xu = np.linspace(-lim, lim, M)[:, None]
    arrays = dict(Xu=Xu, X=d.x_train, y=d.y_train, xi=np.zeros(M), prec=np.eye(M) / 50.0,
                  a=np.asarray(1e-2), b=np.asarray(1e-2))
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.as_tensor(np.array(v, np.float64)) for k, v in arrays.items()}
    return j, t


def held(got, want):
    close(got.free_energy, want.free_energy, FE_RTOL)
    for g, w in [(got.qv.mean, want.qv.mean), (got.qv.cov, want.qv.cov),
                 (got.qv_nat.xi, want.qv_nat.xi), (got.qv_nat.prec, want.qv_nat.prec),
                 (got.Uv, want.Uv)]:
        close(g, w, QV_RTOL)
    close(got.qw.shape, want.qw.shape, RTOL)
    close(got.qw.rate, want.qw.rate, RTOL)
    assert (got.qf is None) == (want.qf is None)
    if want.qf is not None:
        close(got.qf.mean, want.qf.mean, RTOL)
        close(got.qf.var, want.qf.var, RTOL)


@pytest.mark.parametrize("theta", list(THETAS), ids=list(THETAS))
@pytest.mark.parametrize("opts", [dict(), dict(n_iters=2), dict(compute_fe=False),
                                  dict(w_fixed=1e2), dict(w_fixed=1e2, compute_fe=False)],
                         ids=["default", "two_sweeps", "no_fe", "w_fixed", "w_fixed_no_fe"])
def test_regression_vmp_matches_jax(theta, opts):
    j, t = problem("regression")
    th = np.asarray(THETAS[theta])
    want = jb.regression_vmp(JK, jnp.asarray(th), j["Xu"], j["X"], j["y"],
                             JNat(j["xi"], j["prec"]), JGamma(j["a"], j["b"]), **opts)
    got = tb.regression_vmp(TK, torch.as_tensor(th), t["Xu"], t["X"], t["y"],
                            MvGaussianNat(t["xi"], t["prec"]), GammaShapeRate(t["a"], t["b"]),
                            **opts)
    held(got, want)
    if opts.get("compute_fe", True) is False:
        assert float(got.free_energy) == 0.0


@pytest.mark.parametrize("theta", list(THETAS), ids=list(THETAS))
@pytest.mark.parametrize("opts", [dict(), dict(n_iters=3), dict(compute_fe=False),
                                  dict(probit_product="gh32"),
                                  dict(probit_product="gh32", n_iters=3)],
                         ids=["exact", "three_sweeps", "no_fe", "gh32", "gh32_three_sweeps"])
def test_classification_vmp_matches_jax(theta, opts):
    j, t = problem("classification")
    th = np.asarray(THETAS[theta])
    want = jb.classification_vmp(JK, jnp.asarray(th), j["Xu"], j["X"], j["y"],
                                 JNat(j["xi"], j["prec"]), JGamma(j["a"], j["b"]),
                                 JGamma(j["a"], j["b"]), **opts)
    got = tb.classification_vmp(TK, torch.as_tensor(th), t["Xu"], t["X"], t["y"],
                                MvGaussianNat(t["xi"], t["prec"]),
                                GammaShapeRate(t["a"], t["b"]), GammaShapeRate(t["a"], t["b"]),
                                **opts)
    held(got, want)


def test_classification_vmp_rejects_an_unknown_product():
    _, t = problem("classification")
    with pytest.raises(ValueError):
        tb.classification_vmp(TK, torch.zeros(2, dtype=torch.float64), t["Xu"], t["X"], t["y"],
                              MvGaussianNat(t["xi"], t["prec"]), GammaShapeRate(t["a"], t["b"]),
                              GammaShapeRate(t["a"], t["b"]), probit_product="gh21")


def test_prior_energies_match_jax():
    rng = np.random.default_rng(4)
    A, B = rng.standard_normal((6, 6)), rng.standard_normal((6, 6))
    cq, cp = A @ A.T + np.eye(6), B @ B.T + 0.3 * np.eye(6)
    mq, mp = rng.standard_normal(6), rng.standard_normal(6)
    want = jb.prior_energy_mvn(*(jnp.asarray(a) for a in (mq, cq, mp, cp)))
    got = tb.prior_energy_mvn(*(torch.as_tensor(a) for a in (mq, cq, mp, cp)))
    close(got, want, 1e-12)
    for a0, b0, s, r in [(1e-2, 1e-2, 25.01, 0.3), (2.0, 3.0, 4.0, 0.5)]:
        want = jb.prior_energy_gamma(jnp.asarray(a0), jnp.asarray(b0),
                                     JGamma(jnp.asarray(s), jnp.asarray(r)))
        got = tb.prior_energy_gamma(torch.tensor(a0, dtype=torch.float64),
                                    torch.tensor(b0, dtype=torch.float64),
                                    GammaShapeRate(torch.tensor(s, dtype=torch.float64),
                                                   torch.tensor(r, dtype=torch.float64)))
        close(got, want, 1e-12)
