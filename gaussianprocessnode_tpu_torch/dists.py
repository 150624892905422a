"""Exponential-family distributions as NamedTuples of tensors (L1 layer).

Counterpart of ``gaussianprocessnode_tpu/dists.py``: the Gaussian, Gamma
and Wishart families (Wishart by its scale or, as ReactiveMP's WishartFast,
by its inverse scale) and the point mass, their products, moments and
entropies. Digamma and log-gamma are ``torch.special``'s, in the
parameter's dtype.
"""

import math
from typing import NamedTuple

import torch

__all__ = ["Gaussian", "MvGaussian", "MvGaussianNat", "GammaShapeRate", "Wishart",
           "WishartFast", "PointMass", "gaussian_prod", "mv_nat_to_meancov",
           "mv_meancov_to_nat", "mv_gaussian_prod_nat", "gamma_mean", "gamma_mean_log",
           "wishart_mean", "wishart_mean_logdet", "gaussian_entropy", "mv_gaussian_entropy",
           "mv_gaussian_entropy_from_prec", "gamma_entropy", "wishart_entropy"]

_LOG2PI = math.log(2.0 * math.pi)


class Gaussian(NamedTuple):
    """Univariate Gaussian, mean/variance parameterization."""

    mean: torch.Tensor
    var: torch.Tensor

    @property
    def precision(self):
        return 1.0 / self.var


class MvGaussian(NamedTuple):
    """Multivariate Gaussian, mean/covariance (MvNormalMeanCovariance)."""

    mean: torch.Tensor
    cov: torch.Tensor


class MvGaussianNat(NamedTuple):
    """Multivariate Gaussian, weighted-mean/precision
    (MvNormalWeightedMeanPrecision): q(x) ∝ exp(ξᵀx − ½ xᵀΛx)."""

    xi: torch.Tensor
    prec: torch.Tensor


class GammaShapeRate(NamedTuple):
    shape: torch.Tensor
    rate: torch.Tensor


class Wishart(NamedTuple):
    """Wishart with scale matrix S: E[W] = df·S."""

    df: torch.Tensor
    scale: torch.Tensor


class WishartFast(NamedTuple):
    """Wishart by its *inverse* scale (ReactiveMP WishartFast):
    E[W] = df·inv(inv_scale)."""

    df: torch.Tensor
    inv_scale: torch.Tensor


class PointMass(NamedTuple):
    point: torch.Tensor


def gaussian_prod(a: Gaussian, b: Gaussian) -> Gaussian:
    """Product of two univariate Gaussians (normalized)."""
    pa, pb = 1.0 / a.var, 1.0 / b.var
    prec = pa + pb
    mean = (a.mean * pa + b.mean * pb) / prec
    return Gaussian(mean, 1.0 / prec)


def gamma_mean(q: GammaShapeRate):
    return q.shape / q.rate


def gamma_mean_log(q: GammaShapeRate):
    """E[log w] = ψ(a) − log b (used in average energies, UniSGPnode.jl:293)."""
    return torch.special.digamma(q.shape) - torch.log(q.rate)


def mv_nat_to_meancov(q: MvGaussianNat) -> MvGaussian:
    """(ξ, Λ) → (Λ⁻¹ξ, Λ⁻¹) through the Cholesky factor of sym(Λ) (NaN
    where Λ is not positive definite); the covariance comes back
    symmetrised."""
    from .ops.linalg import chol_lower, chol_solve, sym

    L = chol_lower(sym(q.prec))
    eye = torch.eye(q.prec.shape[-1], dtype=q.prec.dtype, device=q.prec.device)
    cov = chol_solve(L, eye)
    mean = chol_solve(L, q.xi)
    return MvGaussian(mean, sym(cov))


def mv_meancov_to_nat(q: MvGaussian) -> MvGaussianNat:
    """(μ, Σ) → (Σ⁻¹μ, Σ⁻¹) through the Cholesky factor of sym(Σ); the
    precision comes back symmetrised."""
    from .ops.linalg import chol_lower, chol_solve, sym

    L = chol_lower(sym(q.cov))
    eye = torch.eye(q.cov.shape[-1], dtype=q.cov.dtype, device=q.cov.device)
    prec = chol_solve(L, eye)
    return MvGaussianNat(chol_solve(L, q.mean), sym(prec))


def mv_gaussian_prod_nat(a: MvGaussianNat, b: MvGaussianNat) -> MvGaussianNat:
    return MvGaussianNat(a.xi + b.xi, a.prec + b.prec)


def wishart_mean(q):
    if isinstance(q, Wishart):
        return q.df * q.scale
    if isinstance(q, WishartFast):
        from .ops.linalg import cholinv, sym

        return q.df * cholinv(sym(q.inv_scale))
    raise TypeError(type(q))


def _mv_digamma_sum(df, d):
    """Σ_{i=1..d} ψ((df + 1 − i)/2), in df's dtype."""
    df = torch.as_tensor(df)
    i = torch.arange(1, d + 1, dtype=df.dtype, device=df.device)
    return torch.sum(torch.special.digamma((df + 1.0 - i) / 2.0))


def _wishart_logdet_scale(q):
    """(d, log det S) of a Wishart's scale, from either parameterization."""
    from .ops.linalg import chol_lower, logdet_from_chol, sym

    if isinstance(q, Wishart):
        return q.scale.shape[-1], logdet_from_chol(chol_lower(sym(q.scale)))
    if isinstance(q, WishartFast):
        return q.inv_scale.shape[-1], -logdet_from_chol(chol_lower(sym(q.inv_scale)))
    raise TypeError(type(q))


def wishart_mean_logdet(q):
    """E[log det W] = Σᵢ ψ((df + 1 − i)/2) + d log 2 + log det S (used in
    the MultiSGP energies, MultiSGPnode.jl:549)."""
    d, ld_S = _wishart_logdet_scale(q)
    df = torch.as_tensor(q.df, dtype=ld_S.dtype, device=ld_S.device)
    return _mv_digamma_sum(df, d) + d * math.log(2.0) + ld_S


def gaussian_entropy(q: Gaussian):
    return 0.5 * (_LOG2PI + 1.0 + torch.log(q.var))


def mv_gaussian_entropy(q: MvGaussian):
    from .ops.linalg import chol_lower, logdet_from_chol, sym

    d = q.mean.shape[-1]
    return 0.5 * (d * (_LOG2PI + 1.0) + logdet_from_chol(chol_lower(sym(q.cov))))


def mv_gaussian_entropy_from_prec(prec: torch.Tensor):
    """Entropy of N(·, Λ⁻¹) from the precision Λ: ½(d(1 + log 2π) −
    logdet Λ). Where Λ is the quantity held, this factors the exactly
    positive-definite matrix instead of an approximate inverse."""
    from .ops.linalg import chol_lower, logdet_from_chol, sym

    d = prec.shape[-1]
    return 0.5 * (d * (_LOG2PI + 1.0) - logdet_from_chol(chol_lower(sym(prec))))


def gamma_entropy(q: GammaShapeRate):
    a, b = q.shape, q.rate
    return a - torch.log(b) + torch.special.gammaln(a) + (1.0 - a) * torch.special.digamma(a)


def _mv_gammaln(a, d):
    """log Γ_d(a) = d(d−1)/4·log π + Σ_{i=1..d} log Γ(a + (1 − i)/2)."""
    a = torch.as_tensor(a)
    i = torch.arange(1, d + 1, dtype=a.dtype, device=a.device)
    return d * (d - 1) / 4.0 * math.log(math.pi) + torch.sum(
        torch.special.gammaln(a + (1.0 - i) / 2.0))


def wishart_entropy(q):
    """Entropy of a Wishart distribution, from either parameterization."""
    d, ld_S = _wishart_logdet_scale(q)
    df = torch.as_tensor(q.df, dtype=ld_S.dtype, device=ld_S.device)
    return ((d + 1.0) / 2.0 * ld_S
            + d * (d + 1.0) / 2.0 * math.log(2.0)
            + _mv_gammaln(df / 2.0, d)
            - (df - d - 1.0) / 2.0 * _mv_digamma_sum(df, d)
            + df * d / 2.0)
