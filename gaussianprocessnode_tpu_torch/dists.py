"""Exponential-family distributions as NamedTuples of tensors (L1 layer).

Counterpart of ``gaussianprocessnode_tpu/dists.py``: the Gaussian and Gamma
families that the sparse-GP regression and probit classification paths use,
their product, moments and entropies.
"""

import math
from typing import NamedTuple

import torch

__all__ = ["Gaussian", "MvGaussian", "MvGaussianNat", "GammaShapeRate", "gaussian_prod",
           "gamma_mean", "gamma_mean_log", "mv_nat_to_meancov", "gaussian_entropy",
           "gamma_entropy"]

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


def gaussian_entropy(q: Gaussian):
    return 0.5 * (_LOG2PI + 1.0 + torch.log(q.var))


def gamma_entropy(q: GammaShapeRate):
    a, b = q.shape, q.rate
    return a - torch.log(b) + torch.special.gammaln(a) + (1.0 - a) * torch.special.digamma(a)
