"""Plain reference of the collapsed VSGP training step: Titsias' (2009)
collapsed bound for a Gaussian likelihood with fixed noise σ²,

    −ELBO* = ½[log|B| + N log σ² + yᵀy/σ² − cᵀc + N log 2π + (Σ kxx − ‖A‖²_F)/σ²]

with Kuu = K(Xu, Xu) + jitter·I = L Lᵀ, A = L⁻¹K(Xu, X), B = I + AAᵀ/σ²,
c = L_B⁻¹Ay/σ², θ = softplus(θ_raw) = [σ_f², ℓ…]; its gradient by autograd
and AdaMax (Kingma & Ba 2015, §7.1: u ← max(|g| + ε, β₂u), θ ← θ − η·m̂/u,
a NaN gradient zeroed first)."""

import math

import torch

from .se import DTYPES, mm, se_gram, softplus

_LOG2PI = math.log(2.0 * math.pi)


def neg_elbo(theta_raw, Xu, X, y, noise: float, jitter: float,
             precision: str = "float64"):
    sp = softplus(theta_raw)
    var, ls = sp[0], sp[1:]
    N, M = X.shape[0], Xu.shape[0]
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    Kuu = se_gram(Xu, Xu, var, ls, precision) + jitter * eye
    Kux = se_gram(Xu, X, var, ls, precision)
    L, _ = torch.linalg.cholesky_ex(Kuu)
    A = torch.linalg.solve_triangular(L, Kux, upper=False)
    B = eye + mm(A, A.T, precision) / noise
    LB, _ = torch.linalg.cholesky_ex(B)
    c = torch.linalg.solve_triangular(LB, (mm(A, y, precision) / noise)[:, None],
                                      upper=False)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(LB))) + N * math.log(noise)
    quad = (y @ y) / noise - c @ c
    tr = (N * var - torch.sum(A * A)) / noise
    return 0.5 * (logdet + quad + N * _LOG2PI + tr)


def first_steps(theta0, Xu, X, y, cfg: dict, steps: int, precision: str = "float64"):
    """``steps`` AdaMax steps on the bound from θ0, at ``precision``.
    Returns {"losses": the bound at θ0…θ_{steps−1}, "grad": the gradient at
    θ0, "change": θ_steps − θ0}, each in float64."""
    dt = DTYPES[precision]
    opt = cfg["optimizer"]
    lr, b1, b2, eps = opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"]
    Xu, X, y = Xu.to(dt), X.to(dt), y.to(dt)
    theta = theta0.detach().to(dt).clone()
    mu = torch.zeros_like(theta)
    u = torch.zeros_like(theta)
    losses, grad0 = [], None
    for k in range(1, steps + 1):
        th = theta.clone().requires_grad_(True)
        v = neg_elbo(th, Xu, X, y, cfg["collapsed_noise"], cfg["jitter"], precision)
        (g,) = torch.autograd.grad(v, th)
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        if grad0 is None:
            grad0 = g
        losses.append(v.detach())
        with torch.no_grad():
            mu = (1 - b1) * g + b1 * mu
            u = torch.maximum(torch.abs(g) + eps, b2 * u)
            theta = theta - lr * (mu / (1 - b1 ** k)) / u
    f64 = torch.float64
    return {"losses": torch.stack(losses).to(f64), "grad": grad0.to(f64),
            "change": (theta - theta0.to(dt)).to(f64)}
