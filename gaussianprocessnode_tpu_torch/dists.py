"""Exponential-family distributions as NamedTuples of tensors (L1 layer).

Counterpart of ``gaussianprocessnode_tpu/dists.py``: the Gaussian and Gamma
families that the sparse-GP regression and probit classification paths use.
"""

from typing import NamedTuple

import torch

__all__ = ["Gaussian", "MvGaussian", "MvGaussianNat", "GammaShapeRate", "gamma_mean",
           "mv_nat_to_meancov"]


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


def gamma_mean(q: GammaShapeRate):
    return q.shape / q.rate


def _sym(A):
    return 0.5 * (A + A.mT)


def mv_nat_to_meancov(q: MvGaussianNat) -> MvGaussian:
    """(ξ, Λ) → (Λ⁻¹ξ, Λ⁻¹) through the Cholesky factor of sym(Λ); the
    covariance comes back symmetrised."""
    L = torch.linalg.cholesky(_sym(q.prec))
    eye = torch.eye(q.prec.shape[-1], dtype=q.prec.dtype, device=q.prec.device)
    cov = torch.cholesky_solve(eye, L)
    mean = torch.cholesky_solve(q.xi.unsqueeze(-1), L).squeeze(-1)
    return MvGaussian(mean, _sym(cov))
