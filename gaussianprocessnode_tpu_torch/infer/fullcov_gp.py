"""Full-covariance GP regression with a Gaussian posterior over the kernel
hyperparameter: mean-field VMP over (f, γ, θ).

Counterpart of ``gaussianprocessnode_tpu/infer/fullcov_gp.py`` (the
reference's legacy CVI/UT notebook: a dense GP with θ = log ℓ ~ N(log ℓ₀,
2), γ ~ Gamma(0.01, 0.01) observation precision, q(f)q(γ)q(θ) over 50
sweeps):

    q(f): conjugate Gaussian with prior precision E_q(θ)[K(θ)⁻¹] (GH sigma
          points of q(θ)) and likelihood precision γ̄ I;
    q(γ): Gamma(a₀ + N/2, b₀ + ½ E‖y − f‖²);
    q(θ): GH-21 moments of p₀(θ)·exp(E_q(f)[log N(f; 0, K(e^θ))]),
          evaluated on q(θ)'s own grid through the importance tilt
          msg + log p₀ − log q (the notebook's CVI re-localisation).

Where the JAX package vmaps one Cholesky factorisation per θ-point, the
Grams of all points are built at once, (n, N, N), and factored by one
batched Cholesky: 9 points for E_q(θ)[K⁻¹] and log det, 21 for the tilt.
"""

import math
from typing import NamedTuple

import torch

from ..dists import GammaShapeRate, gamma_mean, gamma_mean_log
from ..ops.kernels import gram, softplus
from ..ops.linalg import chol_lower, chol_solve, logdet_from_chol
from ..ops.quadrature import gh_points_weights, moment_match_uni

__all__ = ["FullCovState", "fullcov_gp_vmp", "fullcov_gp_predict"]

_LOG2PI = math.log(2 * math.pi)


class FullCovState(NamedTuple):
    m_f: torch.Tensor  # (N,) q(f) mean
    V_f: torch.Tensor  # (N, N) q(f) covariance
    gamma: GammaShapeRate  # q(γ) observation precision
    m_th: torch.Tensor  # q(θ) mean (θ = log lengthscale)
    v_th: torch.Tensor  # q(θ) variance
    fe: torch.Tensor  # free-energy trace, one entry per sweep


def _params(kernel, th):
    """(σ², ℓ) of θ = [1, e^th] at each θ-point th (n,), after the
    kernel's transform, shaped to broadcast over (n, N, D) inputs."""
    theta = torch.stack([torch.ones_like(th), torch.exp(th)], -1)
    if kernel.transform == "softplus":
        theta = softplus(theta)
    return theta[:, 0, None, None], theta[:, 1:, None]


def _grams(kernel, th, X, Z):
    """K(X, Z) at every θ-point: (n, N, Nz)."""
    var, ls = _params(kernel, th)
    return gram(kernel.kind, torch.atleast_2d(X), torch.atleast_2d(Z), var, ls)


def _kuus(kernel, th, X, jitter):
    K = _grams(kernel, th, X, X)
    return K + jitter * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def _theta_stats(kernel, X, m_th, v_th, n_sigma, jitter):
    """E_q(θ)[K(e^θ)⁻¹] and E_q(θ)[log det K(e^θ)] over the n_sigma GH points
    of q(θ)."""
    pts, w = gh_points_weights(n_sigma, m_th, v_th)
    L = chol_lower(_kuus(kernel, pts, X, jitter))
    n = X.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
    Kinvs = chol_solve(L, eye)
    return torch.einsum("j,jab->ab", w, Kinvs), w @ logdet_from_chol(L)


def fullcov_gp_vmp(kernel, X, y, m_th0: float, v_th0: float = 2.0,
                   gamma_prior: tuple = (0.01, 0.01), iters: int = 50, n_sigma: int = 9,
                   n_gh: int = 21, jitter: float = 1e-8,
                   compute_fe: bool = True) -> FullCovState:
    """Mean-field VMP for the (f, γ, θ) full-covariance model on y's device
    and dtype (X: (N, D), y: (N,)). Returns the final state with the
    per-sweep free-energy trace (zeros with ``compute_fe=False``, which
    skips the second batched factorisation of each sweep)."""
    N = y.shape[0]
    dt, dev = y.dtype, y.device
    a0, b0 = (torch.as_tensor(v, dtype=dt, device=dev) for v in gamma_prior)
    m0 = torch.as_tensor(m_th0, dtype=dt, device=dev)
    v0 = torch.as_tensor(v_th0, dtype=dt, device=dev)
    eyeN = torch.eye(N, dtype=dt, device=dev)

    m_f, V_f, q_g, m_th, v_th = torch.zeros(N, dtype=dt, device=dev), eyeN, \
        GammaShapeRate(a0, b0), m0, v0
    fes = []
    for _ in range(iters):
        # q(f): conjugate Gaussian given E[K⁻¹] and γ̄
        Kinv_bar, _ = _theta_stats(kernel, X, m_th, v_th, n_sigma, jitter)
        gbar = gamma_mean(q_g)
        Lp = chol_lower(Kinv_bar + gbar * eyeN)
        V_f = chol_solve(Lp, eyeN)
        m_f = chol_solve(Lp, gbar * y)
        S = V_f + torch.outer(m_f, m_f)  # E[ffᵀ]
        # q(γ): conjugate Gamma
        resid2 = torch.sum((y - m_f) ** 2) + torch.trace(V_f)
        q_g = GammaShapeRate(a0 + 0.5 * N, b0 + 0.5 * resid2)
        gbar, glog = gamma_mean(q_g), gamma_mean_log(q_g)

        # q(θ): GH-21 tilted product on q(θ)'s own grid
        def log_tilt(th, m_th=m_th, v_th=v_th, S=S):
            L = chol_lower(_kuus(kernel, th, X, jitter))
            msg = (-0.5 * logdet_from_chol(L)
                   - 0.5 * torch.diagonal(chol_solve(L, S.expand(L.shape)), dim1=-2,
                                          dim2=-1).sum(-1))
            log_p0 = -((th - m0) ** 2) / (2.0 * v0)
            log_q = -((th - m_th) ** 2) / (2.0 * v_th)
            return msg + log_p0 - log_q

        m_th, v_th = moment_match_uni(log_tilt, m_th, v_th, n=n_gh)

        fe = torch.zeros((), dtype=dt, device=dev)
        if compute_fe:
            Kinv_bar, logdet_bar = _theta_stats(kernel, X, m_th, v_th, n_sigma, jitter)
            e_lik = 0.5 * (gbar * resid2 - N * glog + N * _LOG2PI)
            e_f = 0.5 * (logdet_bar + torch.sum(Kinv_bar * S) + N * _LOG2PI)
            e_g = (-a0 * torch.log(b0) + torch.special.gammaln(a0)
                   - (a0 - 1.0) * glog + b0 * gbar)
            e_th = 0.5 * (torch.log(2 * math.pi * v0) + (v_th + (m_th - m0) ** 2) / v0)
            h_f = 0.5 * (N * (1 + _LOG2PI)
                         - 2.0 * torch.sum(torch.log(torch.diagonal(Lp))))
            h_g = (q_g.shape - torch.log(q_g.rate) + torch.special.gammaln(q_g.shape)
                   + (1.0 - q_g.shape) * torch.special.digamma(q_g.shape))
            h_th = 0.5 * torch.log(2 * math.pi * math.e * v_th)
            fe = e_lik + e_f + e_g + e_th - h_f - h_g - h_th
        fes.append(fe)
    fe = torch.stack(fes) if fes else torch.zeros((0,), dtype=dt, device=dev)
    return FullCovState(m_f=m_f, V_f=V_f, gamma=q_g, m_th=m_th, v_th=v_th, fe=fe)


def fullcov_gp_predict(kernel, state: FullCovState, X, X_test, n_sigma: int = 9,
                       jitter: float = 1e-8):
    """Predictive (mean, var) of f*: the q(θ)-mixture of the Gaussian
    conditionals f* | q(f) at the sigma points, moment-matched. Per point
    θⱼ: f* | q(f) ~ N(A m, k** − q** + A V Aᵀ) with A = K*ₒKₒₒ⁻¹."""
    pts, w = gh_points_weights(n_sigma, state.m_th, state.v_th)
    L = chol_lower(_kuus(kernel, pts, X, jitter))
    Kot = _grams(kernel, pts, X, X_test)  # (n, N, Nt)
    KiKot = chol_solve(L, Kot)
    A = KiKot.mT  # (n, Nt, N)
    means = A @ state.m_f
    var_k, _ = _params(kernel, pts)
    ktt = var_k[:, :, 0].expand(-1, Kot.shape[-1])
    qtt = torch.sum(Kot * KiKot, dim=-2)
    vars_ = torch.clamp_min(ktt - qtt, 0.0) + torch.einsum("jta,ab,jtb->jt", A, state.V_f, A)
    mean = torch.einsum("j,jt->t", w, means)
    second = torch.einsum("j,jt->t", w, vars_ + means**2)
    return mean, second - mean**2
