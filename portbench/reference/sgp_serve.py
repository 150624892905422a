"""Plain reference of serving a sparse GP (the UniSGP :out rule at point
inputs, UniSGPnode.jl:96-104; the probit :out probability,
classification_banana.ipynb cell 13):

    μ_v = Λ⁻¹ξ,   mean = K(Xu, x*)ᵀμ_v,   var = 1/w̄,   P(y = 1) = Φ(mean/√(1 + var)).

μ_v is solved from the natural parameters in float64 through the Cholesky
factor of ½(Λ + Λᵀ). Rows are taken in blocks, so that a batch of any size
fits."""

import math

import torch

from .se import DTYPES, mm, se_gram

BLOCK = 65536


def mu_v(xi: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    f64 = torch.float64
    P = prec.to(f64)
    L = torch.linalg.cholesky(0.5 * (P + P.T))
    return torch.cholesky_solve(xi.to(f64)[:, None], L)[:, 0]


def predict(variance, lengthscales, Xu, X, mu, w_mean, precision: str = "float64"):
    """(mean, var, scale) at the rows of X, each float64; ``scale`` is
    |K(Xu, x*)|ᵀ|μ_v|, the size of the terms that the mean sums."""
    dt = DTYPES[precision]
    f64 = torch.float64
    var_, ls, Xu_, mu_ = (torch.as_tensor(variance).to(dt), torch.as_tensor(lengthscales).to(dt),
                          Xu.to(dt), mu.to(dt))
    means, scales = [], []
    for i in range(0, X.shape[0], BLOCK):
        K = se_gram(Xu_, X[i:i + BLOCK].to(dt), var_, ls, precision)
        means.append(mm(K.T, mu_, precision).to(f64))
        scales.append(K.to(f64).abs().T @ mu.to(f64).abs())
    mean = torch.cat(means)
    var = torch.full_like(mean, 1.0 / float(w_mean))
    return mean, var, torch.cat(scales)


def probabilities(mean, var):
    """Φ(mean/√(1 + var)) = ½·erfc(−z/√2)."""
    return 0.5 * torch.special.erfc(-(mean / torch.sqrt(1.0 + var)) / math.sqrt(2.0))
