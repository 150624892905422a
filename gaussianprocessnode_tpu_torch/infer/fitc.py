"""FITC / SoR / DTC sparse-GP marginal-likelihood baselines.

Counterpart of ``gaussianprocessnode_tpu/infer/fitc.py`` (the reference's
legacy notebook Regression_FITC_SoR, GaussianProcesses.jl ``SoR`` /
``FITC`` on the negative log marginal likelihood). All three share one
O(N·M²) Woodbury evaluation, a Gram K(Xu, X), an M×M SYRK and Cholesky:

    Σ = Q_ff + D,  Q_ff = Vᵀ V,  V = Lu⁻¹ K_uf
    D_SoR = D_DTC = σ² I                (degenerate-prior likelihood)
    D_FITC = σ² I + diag(K_ff − Q_ff)   (exact per-point variances)

    −log p(y) = ½ [N log 2π + log|B| + Σᵢ log Dᵢ + βᵀβ − cᵀc],
    W = V D^{−1/2},  B = I + W Wᵀ,  β = D^{−1/2} y,  c = L_B⁻¹ W β.

At prediction SoR's variance is the degenerate K*u Λ⁻¹ K u*; DTC and FITC
add the prior marginal k** − q**. The trainer is an eager AdaMax loop
(``optax.chain(zero_nans(), adamax(lr))``, ``infer/svgp.py::vsgp_optimizer``)
that waits on the host nowhere.
"""

import math
from typing import NamedTuple

import torch

from ..config import JITTER_KUU
from ..ops.linalg import chol_lower, tri_solve_lower
from .svgp import _step_, vsgp_optimizer

__all__ = ["SparseGPParams", "init_sparse_gp", "sparse_nlml", "fit_sparse_gp",
           "sparse_predict"]

_METHODS = ("sor", "dtc", "fitc")
_LOG2PI = math.log(2.0 * math.pi)


class SparseGPParams(NamedTuple):
    theta: torch.Tensor  # kernel hyperparameters (softplus-transformed in kernel)
    log_noise: torch.Tensor  # log observation variance σ²


def init_sparse_gp(theta0, noise: float = 1.0) -> SparseGPParams:
    """The notebook's inits are ℓ = σf = 1, σ_noise = 1 (SE(0,0), logNoise = log 1)."""
    return SparseGPParams(theta=theta0, log_noise=torch.tensor(
        math.log(noise), dtype=theta0.dtype, device=theta0.device))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _whitened_stats(kernel, params: SparseGPParams, Xu, X, method: str, jitter: float):
    """Shared per-evaluation statistics: (Lu, V, D, W, chol(B)). FITC's
    k − q ≥ 0 holds exactly (a Schur complement); ``torch.maximum`` clamps
    its rounding tail and splits the gradient at a tie as ``jnp.maximum``
    does (Xu ⊂ X puts k − q at 0 up to rounding)."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    Lu = chol_lower(kernel.kuu(params.theta, Xu, jitter=jitter))
    Kux = kernel(params.theta, Xu, X)  # (M, N)
    V = tri_solve_lower(Lu, Kux)
    noise = torch.exp(params.log_noise)
    if method == "fitc":
        kxx = kernel.diag(params.theta, X)
        qxx = torch.sum(V * V, dim=0)
        D = noise + torch.maximum(kxx - qxx, _zero(qxx))
    else:
        D = noise.to(V.dtype).expand(X.shape[0])
    W = V / torch.sqrt(D)[None, :]
    B = torch.eye(Xu.shape[0], dtype=V.dtype, device=V.device) + W @ W.T
    return Lu, V, D, W, chol_lower(B)


def sparse_nlml(kernel, params: SparseGPParams, Xu, X, y, method: str = "fitc",
                jitter: float = JITTER_KUU):
    """Negative log marginal likelihood of y ~ N(0, VᵀV + D). SoR and DTC
    share this value exactly (they differ only in the test-time
    variance), as GaussianProcesses.jl's SoR/DTC mll coincide."""
    N = X.shape[0]
    _, _, D, W, LB = _whitened_stats(kernel, params, Xu, X, method, jitter)
    beta = y / torch.sqrt(D)
    c = tri_solve_lower(LB, W @ beta)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(LB))) + torch.sum(torch.log(D))
    quad = beta @ beta - c @ c
    return 0.5 * (N * _LOG2PI + logdet + quad)


def sparse_predict(kernel, params: SparseGPParams, Xu, X_test, X, y, method: str = "fitc",
                   jitter: float = JITTER_KUU):
    """Predictive (mean, var) of f* at X_test, in whitened coordinates:
    Λ⁻¹ = Lu⁻ᵀ B⁻¹ Lu⁻¹ since Λ = Kuu + K_uf D⁻¹ K_fu = Lu B Luᵀ."""
    Lu, _, D, W, LB = _whitened_stats(kernel, params, Xu, X, method, jitter)
    beta = y / torch.sqrt(D)
    c = tri_solve_lower(LB, W @ beta)  # (M,)
    Kut = kernel(params.theta, Xu, X_test)  # (M, Nt)
    At = tri_solve_lower(Lu, Kut)  # Lu⁻¹ K u*
    P = tri_solve_lower(LB, At)  # L_B⁻¹ Lu⁻¹ K u*
    mean = P.T @ c
    var_deg = torch.sum(P * P, dim=0)  # K*u Λ⁻¹ K u*
    if method == "sor":
        return mean, var_deg
    ktt = kernel.diag(params.theta, X_test)
    qtt = torch.sum(At * At, dim=0)
    return mean, torch.maximum(ktt - qtt, _zero(qtt)) + var_deg


def fit_sparse_gp(kernel, params0: SparseGPParams, Xu, X, y, method: str = "fitc",
                  steps: int = 300, learning_rate: float = 0.05, learn_noise: bool = True,
                  jitter: float = JITTER_KUU):
    """AdaMax on the full-batch NLML for ``steps`` steps (the notebook's
    CG/LBFGS under a wall-clock limit becomes a fixed-step first-order
    schedule). ``learn_noise=False`` detaches ``log_noise`` inside the
    loss. ``params0`` is not modified. Returns (params, NLML trace)."""
    optimizer = vsgp_optimizer(learning_rate)
    params = SparseGPParams(*(p.detach().clone() for p in params0))
    opt_state = optimizer.init(params)

    def loss(p):
        if not learn_noise:
            p = p._replace(log_noise=p.log_noise.detach())
        return sparse_nlml(kernel, p, Xu, X, y, method=method, jitter=jitter)

    trace = torch.empty(steps, dtype=params.theta.dtype, device=params.theta.device)
    for i in range(steps):
        trace[i] = _step_(loss, optimizer, params, opt_state)
    return params, trace
