"""Plain reference of serving the whitened SVGP baseline (ApproximateGPs.jl's
SVGP, Regression_VSGP.ipynb cells 15-19), its predictive q(f) written out
as the port's ``infer/svgp.py::_marginal_f`` writes it, whitened:

    Kuu = K(Xu, Xu) + jitter·I = Lu·Luᵀ,   y = Lu⁻¹K(Xu, x*),
    mean = yᵀm̃,   var = k(x*, x*) − ‖y‖² + ‖Ãᵀy‖², floored at 1e-12.

The served state is the optimal whitened q(u) for a Gaussian likelihood of
fixed variance σ²ₙ over the training rows, where the SVGP's ELBO converges
in q(u): with Φ = Lu⁻¹K(Xu, X), S = (I + ΦΦᵀ/σ²ₙ)⁻¹, m̃ = SΦy/σ²ₙ and Ã
the Cholesky factor of S. Everything is float64 with TF32 off, and rows are
taken in blocks, so that a batch of any size fits."""

import torch

from .se import DTYPES, mm, se_gram

BLOCK = 65536
F64 = torch.float64


def factor(variance, lengthscales, Xu, jitter: float) -> torch.Tensor:
    """Lu, the lower Cholesky factor of K(Xu, Xu) + jitter·I."""
    Xu = Xu.to(F64)
    eye = torch.eye(Xu.shape[0], dtype=F64, device=Xu.device)
    return torch.linalg.cholesky(se_gram(Xu, Xu, variance, lengthscales) + jitter * eye)


def optimal_qu(variance, lengthscales, Xu, X, y, noise: float, Lu):
    """(m̃, Ã) of the optimal whitened q(u) for the rows (X, y) at fixed
    likelihood variance ``noise``, Lu from :func:`factor`."""
    Phi = torch.linalg.solve_triangular(Lu, se_gram(Xu.to(F64), X.to(F64), variance,
                                                    lengthscales), upper=False)
    eye = torch.eye(Lu.shape[0], dtype=F64, device=Lu.device)
    S = torch.cholesky_inverse(torch.linalg.cholesky(eye + Phi @ Phi.T / noise))
    S = 0.5 * (S + S.T)
    return S @ (Phi @ y.to(F64)) / noise, torch.linalg.cholesky(S)


def predict(variance, lengthscales, Xu, X, Lu, m_white, A, precision: str = "float64"):
    """(mean, var, scale) at the rows of X, each float64. ``scale`` is
    |K(Xu, x*)|ᵀ|α| with α = Lu⁻ᵀm̃ (mean = Kᵀα), the size of the terms
    that the mean sums. At ``precision="tf32"`` (the control) the solve is
    Lu⁻¹, formed in float64, times the Gram, and it, the mean and the
    product with Ãᵀ go through TF32 products."""
    dt = DTYPES[precision]
    var_, ls = (torch.as_tensor(variance, dtype=F64).to(dt),
                torch.as_tensor(lengthscales, dtype=F64).to(dt))
    Lu = Lu.to(F64)
    alpha = torch.linalg.solve_triangular(Lu.T, m_white.to(F64)[:, None], upper=True)[:, 0]
    Linv = torch.linalg.solve_triangular(
        Lu, torch.eye(Lu.shape[0], dtype=F64, device=Lu.device), upper=False).to(dt)
    Xu_, m_, A_ = Xu.to(dt), m_white.to(dt), A.to(dt)
    means, vars_, scales = [], [], []
    for i in range(0, X.shape[0], BLOCK):
        K = se_gram(Xu_, X[i:i + BLOCK].to(dt), var_, ls, precision)
        if precision == "float64":
            Y = torch.linalg.solve_triangular(Lu, K, upper=False)
        else:
            Y = mm(Linv, K, precision)
        means.append(mm(Y.T, m_, precision).to(F64))
        Z = mm(A_.T, Y, precision)
        v = var_ - torch.sum(Y * Y, dim=0) + torch.sum(Z * Z, dim=0)
        vars_.append(torch.clamp_min(v, 1e-12).to(F64))
        scales.append(K.to(F64).abs().T @ alpha.abs())
    return torch.cat(means), torch.cat(vars_), torch.cat(scales)
