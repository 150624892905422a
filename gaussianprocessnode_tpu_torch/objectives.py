"""Hyperparameter-learning objectives (L4 layer).

Counterpart of ``gaussianprocessnode_tpu/objectives.py``: the negative log
backward messages over θ (reference: helper_functions/derivative_helper.jl),
differentiated by ``torch.autograd``. The known-input loss comes in its
Cholesky form (``neg_log_backwardmess_fast``, the toy trainers') and its
factorization-free form (``neg_log_backwardmess_gram``, the kin40k fast
trainer's); the uncertain-input losses, univariate and multi-output (the
GPSSM M-step's), take expected Ψ's by quadrature.
Gradients flow through the SE Gram's analytic VJP (``ops/se_gram.py``),
the Cholesky and triangular solves, and the Newton–Schulz inverse's VJP
(``ops/linalg.py::spd_inverse``); every contraction is in full precision
(``config`` keeps TF32 off).
"""

import torch

from .config import JITTER_KUU, JITTER_KUU_SSM
from .ops.linalg import chol_lower, effective_jitter, spd_inverse, tri_solve_lower
from .ops.psi import psi_batch_expected_multi, psi_batch_expected_uni

__all__ = ["neg_log_backwardmess_fast", "neg_log_backwardmess_uncertain",
           "neg_log_backwardmess_multi", "neg_log_backwardmess_gram", "grad_fast",
           "grad_uncertain", "grad_multi"]


def neg_log_backwardmess_fast(theta, *, kernel, Xu, X, y, mu_v, Uv, w,
                              kuu_jitter: float = JITTER_KUU):
    """Batched known-input hyperparameter loss
    (reference: derivative_helper.jl:23-39):

        −Σᵢ [ −½w kxxᵢ + ½w‖Lu⁻¹kᵢ‖² − ½w‖Uv kᵢ‖² + w yᵢ⟨μ_v, kᵢ⟩ ]

    with kᵢ = K(Xu, xᵢ), X (N, Din), y (N,), Uv the upper Cholesky of Rv.
    Kuu carries the reference's +1e-8·I; where it is not positive definite
    (a linesearch excursion to a long lengthscale) the loss is NaN, as in
    the JAX package."""
    Kuu = kernel.kuu(theta, Xu, jitter=kuu_jitter)
    Lu = chol_lower(Kuu)
    kxx = kernel.diag(theta, X)
    Kux = kernel(theta, Xu, X)  # (M, N)
    alpha = tri_solve_lower(Lu, Kux)
    beta = Uv @ Kux
    llh = (
        -0.5 * w * torch.sum(kxx)
        + 0.5 * w * torch.sum(alpha * alpha)
        - 0.5 * w * torch.sum(beta * beta)
        + w * torch.dot(y, Kux.T @ mu_v)
    )
    return -llh


def neg_log_backwardmess_uncertain(theta, *, kernel, Xu, y, qx_means, qx_vars, mu_v, Uv, w,
                                   method):
    """Uncertain-input loss (reference: derivative_helper.jl:42-52):

        −Σᵢ [ w yᵢ⟨Ψ1ᵢ, μ_v⟩ − ½w (Ψ0ᵢ + tr(Ψ2ᵢ(UvᵀUv − Kuu⁻¹))) ]

    with the Kuu⁻¹ contraction as ‖Lu⁻¹kₚ‖² (triangular solves, not the
    explicit inverse, whose value and gradient are rounding noise at
    κ(Kuu) ~ 1/jitter)."""
    Lu = chol_lower(kernel.kuu(theta, Xu, jitter=JITTER_KUU_SSM))
    psi0, psi1, Kp, wq = psi_batch_expected_uni(kernel, theta, Xu, method, qx_means, qx_vars)
    M = Kp.shape[0]
    a = tri_solve_lower(Lu, Kp.reshape(M, -1)).reshape(Kp.shape)
    tr_kuu = torch.einsum("mnp,mnp,p->n", a, a, wq)
    UK = torch.einsum("qm,mnp->qnp", Uv, Kp)
    tr_rv = torch.einsum("qnp,qnp,p->n", UK, UK, wq)
    llh = torch.sum(w * y * torch.einsum("mn,m->n", psi1, mu_v)
                    - 0.5 * w * (psi0 + tr_rv - tr_kuu))
    return -llh


def neg_log_backwardmess_multi(theta, *, kernel, Xu, y_means, qx_means, qx_covs, sumRv_W,
                               mu_v, W, method):
    """Multi-output (C = I) hyperparameter loss (reference:
    derivative_helper.jl:92-106):

        −Σᵢ [ −½tr(W)(Ψ0ᵢ − ⟨Kuu⁻¹,Ψ2ᵢ⟩) + ⟨ΣdiagVᵢ, Ψ1ᵢ⟩ − ½⟨sumRv_W, Ψ2ᵢ⟩ ]

    with Vᵢ = μ_v yᵢᵀ W and sumRv_W = Σ_blocks Rv_blk ⊙ W precomputed;
    y_means (N, D), qx_means (N, Din), qx_covs (N, Din, Din), mu_v (M·D,).
    The Kuu⁻¹ contraction is Σ_p w_p ‖Lu⁻¹ kᵢₚ‖² (triangular solves). Kuu's
    jitter is ``JITTER_KUU_SSM`` in float64 and ``effective_jitter`` (300·ε,
    3.6e-5) in float32, where 1e-12 is below the resolution and the
    Cholesky of an ill-conditioned Kuu fails."""
    M = Xu.shape[0]
    D = y_means.shape[1]
    tr_W = torch.trace(W)
    dt_k = torch.promote_types(theta.dtype, Xu.dtype)
    jit = JITTER_KUU_SSM if dt_k == torch.float64 else effective_jitter(dt_k, JITTER_KUU_SSM)
    Lu = chol_lower(kernel.kuu(theta, Xu, jitter=jit))
    psi0, psi1, Kp, wq = psi_batch_expected_multi(kernel, theta, Xu, method, qx_means, qx_covs)
    # sumdiagVᵢ = Σ_d μ_v^(d) (yᵢᵀW)_d : (N, M)
    sumdiagV = (y_means @ W) @ mu_v.reshape(D, M)
    lin_terms = torch.einsum("nm,mn->n", sumdiagV, psi1)
    a = tri_solve_lower(Lu, Kp.reshape(M, -1)).reshape(Kp.shape)
    tr_kuu = torch.einsum("mnp,mnp,p->n", a, a, wq)
    AK = torch.einsum("mq,qnp->mnp", sumRv_W, Kp)
    tr_rv = torch.einsum("mnp,mnp,p->n", Kp, AK, wq)
    llh = torch.sum(-0.5 * tr_W * (psi0 - tr_kuu) + lin_terms - 0.5 * tr_rv)
    return -llh


def _grad(loss):
    def grad(theta, **kw):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(th, **kw), th)
        return g
    grad.__doc__ = f"∇θ of ``{loss.__name__}`` by ``torch.autograd.grad``."
    return grad


def neg_log_backwardmess_gram(theta, *, kernel, Xu, X, y, mu_v, Rv, w,
                              kuu_inv_warm=None, ns_iters: int = 30,
                              ns_tol: float | None = None,
                              kuu_jitter: float = JITTER_KUU):
    """Trace form of the batched known-input hyperparameter loss
    (reference: derivative_helper.jl:23-39):

        −Σᵢ llhᵢ = −[ −½w Σkxxᵢ + ½w·tr(Kuu⁻¹S) − ½w·tr(Rv·S) + w·yᵀKuxᵀμ_v ]

    with S = Kux·Kuxᵀ and Kuu⁻¹ by the warm-started Newton–Schulz inverse
    (λ_min = the jitter: Kuu = PSD Gram + jitter·I). Returns
    ``(loss, Kuu_inv)``; ``Kuu_inv`` is detached, the next call's warm
    start."""
    Kuu = kernel.kuu(theta, Xu, jitter=kuu_jitter)
    Kuu_inv = spd_inverse(Kuu, warm=kuu_inv_warm, iters=ns_iters, tol=ns_tol,
                          lambda_min=kuu_jitter)
    kxx = kernel.diag(theta, X)
    Kux = kernel(theta, Xu, X)
    S = torch.matmul(Kux, Kux.T)
    llh = (
        -0.5 * w * torch.sum(kxx)
        + 0.5 * w * torch.sum(Kuu_inv * S)
        - 0.5 * w * torch.sum(Rv * S)
        + w * torch.dot(y, torch.matmul(Kux.T, mu_v))
    )
    return -llh, Kuu_inv.detach()


grad_fast = _grad(neg_log_backwardmess_fast)
grad_uncertain = _grad(neg_log_backwardmess_uncertain)
grad_multi = _grad(neg_log_backwardmess_multi)
