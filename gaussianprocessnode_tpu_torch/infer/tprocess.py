"""Full-covariance exact GP and Student-t process regression.

Counterpart of ``gaussianprocessnode_tpu/infer/tprocess.py`` (the
reference's legacy t-process notebook): a dense GP posterior next to the
Student-t process posterior (Shah, Wilson & Ghahramani 2014) in the
standard multivariate-t shape-matrix parameterisation (Roth 2013):

    f* | y ~ MVT(ν + n, K_*o K̃⁻¹ y, (ν + β)/(ν + n) · Σ_GP),
    K̃ = K_oo + σ²I,  β = yᵀK̃⁻¹y,

so the t-process keeps the GP's mean and scales its covariance by the data
fit: outliers widen the posterior. Both are one Cholesky factor and two
triangular solves.
"""

import math
from typing import NamedTuple

import torch

from ..ops.linalg import chol_lower, tri_solve_lower

__all__ = ["GPPosterior", "TPPosterior", "gp_exact_posterior", "tp_exact_posterior"]


class GPPosterior(NamedTuple):
    mean: torch.Tensor  # (Nt,)
    var: torch.Tensor  # (Nt,) marginal posterior variances
    log_lik: torch.Tensor  # log marginal likelihood


class TPPosterior(NamedTuple):
    mean: torch.Tensor  # (Nt,), the GP mean
    var: torch.Tensor  # (Nt,) posterior covariance diagonal: ν̂/(ν̂−2) · scale
    scale_diag: torch.Tensor  # (Nt,) the MVT shape-matrix diagonal
    df: torch.Tensor  # posterior degrees of freedom ν + n
    fit_scale: torch.Tensor  # (ν + β)/(ν + n), the data-fit factor


def _shared(kernel, theta, X, y, X_test, obs_var, jitter):
    Koo = kernel.kuu(theta, X, jitter=jitter)
    n = X.shape[0]
    Kt = Koo + obs_var * torch.eye(n, dtype=Koo.dtype, device=Koo.device)
    L = chol_lower(Kt)
    alpha = tri_solve_lower(L, y)  # L⁻¹ y
    Kot = kernel(theta, X, X_test)  # (N, Nt)
    V = tri_solve_lower(L, Kot)  # L⁻¹ K_o*
    mean = V.T @ alpha
    ktt = kernel.diag(theta, X_test)
    var_gp = torch.clamp_min(ktt - torch.sum(V * V, dim=0), 0.0)
    beta = alpha @ alpha  # yᵀ K̃⁻¹ y
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return mean, var_gp, beta, logdet, n


def gp_exact_posterior(kernel, theta, X, y, X_test, obs_var, jitter: float = 0.0) -> GPPosterior:
    """Dense full-covariance GP regression (the notebook's ``gprocess``
    model) on X's device and dtype."""
    mean, var, beta, logdet, n = _shared(kernel, theta, X, y, X_test, obs_var, jitter)
    ll = -0.5 * (n * math.log(2.0 * math.pi) + logdet + beta)
    return GPPosterior(mean=mean, var=var, log_lik=ll)


def tp_exact_posterior(kernel, theta, nu, X, y, X_test, obs_var,
                       jitter: float = 0.0) -> TPPosterior:
    """Student-t process regression (the notebook's ``tprocess`` model, ν =
    100): the standard-MVT conditional."""
    mean, var_gp, beta, _, n = _shared(kernel, theta, X, y, X_test, obs_var, jitter)
    nu = torch.as_tensor(nu, dtype=mean.dtype, device=mean.device)
    fit = (nu + beta) / (nu + n)
    scale = fit * var_gp
    df = nu + n
    return TPPosterior(mean=mean, var=df / (df - 2.0) * scale, scale_diag=scale, df=df,
                       fit_scale=fit)
