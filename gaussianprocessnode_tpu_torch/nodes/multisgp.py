"""MultiSGP node: the D-output sparse-GP factor with identity
coregionalization.

Counterpart of ``gaussianprocessnode_tpu/nodes/multisgp.py`` (the
reference's GPnode/MultiSGPnode.jl). Model (MultiSGPnode.jl:47-49): one
scalar kernel shared by the outputs, C = I_D, v ∈ R^{M·D} stacked per
output (block d = v for output d), process-noise precision W (D×D, Wishart
or point mass).

Edges: out = x_t, in = x_{t-1}, v, w = W, θ.

As the reference keeps a dense ``Kuu_inverse`` in its meta
(gp_helperfunction.jl:55-73), ``MultiSGPArgs`` carries Kuu⁻¹ and the rules
contract against it. The in log-message comes back as a callable that
takes one point (Din,) or a batch of points (..., Din) at once, where the
JAX package returns a scalar closure; ``marginal_in`` hands the batch form
to the cubature. ``average_energy_batch`` is the energy of N nodes that
share q(v) and W, one Gram for all of them, where the GPSSM chain vmaps
``average_energy``.
"""

import math
from typing import Callable, NamedTuple

import torch

from ..config import JITTER_KUU_SSM
from ..dists import MvGaussian, MvGaussianNat, WishartFast
from ..ops import psi as psiops
from ..ops import quadrature as quad
from ..ops.linalg import block_trace_products, cholinv, sum_blocks_weighted, sym

__all__ = ["MultiSGPArgs", "out_message", "in_log_message", "marginal_in",
           "in_message_laplace", "v_message", "v_message_batch", "w_message",
           "theta_log_message", "average_energy", "average_energy_batch"]

_LOG2PI = math.log(2.0 * math.pi)


class MultiSGPArgs(NamedTuple):
    theta: torch.Tensor
    Xu: torch.Tensor  # (M, Din)
    Kuu_inv: torch.Tensor  # (M, M) dense inverse of Kuu + jitter·I


def _split_blocks(mu_v, M, D):
    """v stacked per output: block d = μ_v[d·M:(d+1)·M] (MultiSGPnode.jl:101)."""
    return mu_v.reshape(D, M)


def _sum_diag_V(mu_v, mu_y, W, M, D):
    """sumdiagV (M,) from V = μ_v (μ_yᵀW): Σ_d (Wμ_y)_d μ_v^(d)
    (reference: sum_diagonal_M(V, M), MultiSGPnode.jl:179)."""
    return (W @ mu_y) @ _split_blocks(mu_v, M, D)


def _eye(D, like):
    return torch.eye(D, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# out rule (MultiSGPnode.jl:90-120)
# ---------------------------------------------------------------------------


def out_message(kernel, method, args: MultiSGPArgs, q_in: MvGaussian, mu_v,
                W_mean) -> MvGaussian:
    """Forward message MvN(μ_y, W̄⁻¹) with μ_y[d] = Ψ1ᵀ μ_v^(d)."""
    M = args.Xu.shape[0]
    D = W_mean.shape[0]
    psi1 = psiops.psi1_expected_multi(kernel, args.theta, args.Xu, method, q_in.mean,
                                      q_in.cov)
    mu_y = _split_blocks(mu_v, M, D) @ psi1
    return MvGaussian(mu_y, cholinv(sym(W_mean)))


# ---------------------------------------------------------------------------
# in rule (MultiSGPnode.jl:162-236)
# ---------------------------------------------------------------------------


def in_log_message(kernel, args: MultiSGPArgs, mu_y, mu_v, Rv, W_mean) -> Callable:
    """Backward log-density over the input x (MultiSGPnode.jl:162-208):

        log ν(x) = −½tr(W)(Ψ0(x) − ⟨Kuu⁻¹,Ψ2(x)⟩) + ⟨ΣdiagV, Ψ1(x)⟩
                   − ½⟨Ψ2(x), ΣRv_blk·W⟩

    with Ψ1(x) = k = K(Xu, x) and Ψ2(x) = kkᵀ. The callable takes x of
    shape (..., Din) and returns log ν of shape (...): all points go
    through one Gram."""
    M = args.Xu.shape[0]
    D = mu_y.shape[0]
    tr_W = torch.trace(W_mean)
    sumdiagV = _sum_diag_V(mu_v, mu_y, W_mean, M, D)
    A = 0.5 * tr_W * args.Kuu_inv - 0.5 * sum_blocks_weighted(Rv, W_mean, D, M)

    def logpdf(x):
        xs = torch.as_tensor(x)
        pts = xs.reshape(-1, xs.shape[-1])
        K = kernel(args.theta, args.Xu, pts)  # (M, P)
        psi0 = kernel.diag(args.theta, pts)
        val = -0.5 * tr_W * psi0 + torch.sum(K * (A @ K), dim=0) + sumdiagV @ K
        return val.reshape(xs.shape[:-1])

    return logpdf


def marginal_in(kernel, args: MultiSGPArgs, mu_y, mu_v, Rv, W_mean, q_fwd: MvGaussian,
                method=quad.SphericalRadial()) -> MvGaussian:
    """Fused in-rule and cubature moment-matched product (reference:
    MultiSGPnode.jl:162-184, then the prod at :37-44)."""
    logpdf = in_log_message(kernel, args, mu_y, mu_v, Rv, W_mean)
    m, V = quad.moment_match_multi(logpdf, q_fwd.mean, q_fwd.cov, method=method)
    return MvGaussian(m, V)


def in_message_laplace(kernel, args: MultiSGPArgs, mu_y, mu_v, Rv, W_mean, q_in_mean,
                       lbfgs_steps: int = 20) -> MvGaussianNat:
    """Laplace-style in message (MultiSGPnode.jl:210-236): minimise −log ν
    by L-BFGS (``infer/training.py::lbfgs_solve``) from mean(q_in), then
    Λ = the Hessian at the minimiser → MvNormalWeightedMeanPrecision(Λm, Λ).

    The Hessian is reverse over reverse (``torch.autograd.functional.
    hessian``): the SE Gram's autograd Function (``ops/se_gram.py``) has an
    analytic VJP, which is differentiable again, and no forward-mode rule,
    as the JAX package's ``custom_vjp`` Gram has none."""
    from ..infer.training import lbfgs_solve

    logpdf = in_log_message(kernel, args, mu_y, mu_v, Rv, W_mean)

    def neg(x):
        return -logpdf(x)

    m_z, _ = lbfgs_solve(neg, q_in_mean, max_steps=lbfgs_steps)
    W_z = torch.autograd.functional.hessian(neg, m_z)
    return MvGaussianNat(W_z @ m_z, W_z)


# ---------------------------------------------------------------------------
# v rule (MultiSGPnode.jl:290-328)
# ---------------------------------------------------------------------------


def v_message(kernel, method, args: MultiSGPArgs, mu_y, q_in: MvGaussian,
              W_mean) -> MvGaussianNat:
    """ξ = vcat_d((Wμ_y)_d·Ψ1), Λ = W ⊗ Ψ2 (Kronecker precision)."""
    _, psi1, psi2 = psiops.psi_expected_multi(kernel, args.theta, args.Xu, method,
                                              q_in.mean, q_in.cov)
    yW = W_mean @ mu_y  # (D,)
    return MvGaussianNat((yW[:, None] * psi1[None, :]).reshape(-1), torch.kron(W_mean, psi2))


def v_message_batch(psi1, sum_psi2, sum_yW, W_mean) -> MvGaussianNat:
    """Σ_t v-messages sharing one W (the GPSSM chain and GPLVM case):
    ξ = vec_d(Σ_t (Wμ_y,t)_d Ψ1_t), Λ = W ⊗ Σ_t Ψ2_t. ``psi1`` (M, N),
    ``sum_psi2`` (M, M) = Σ_t Ψ2_t, ``sum_yW`` (N, D) rows (W μ_y,t)ᵀ. The
    contraction is in full precision (``config`` keeps TF32 off; the JAX
    package pins HIGHEST here)."""
    xi = torch.einsum("nd,mn->dm", sum_yW, psi1).reshape(-1)
    return MvGaussianNat(xi, torch.kron(W_mean, sum_psi2))


# ---------------------------------------------------------------------------
# w rule (MultiSGPnode.jl:367-444)
# ---------------------------------------------------------------------------


def w_message(kernel, method, args: MultiSGPArgs, mu_y, Sigma_y, q_in: MvGaussian,
              mu_v, Sigma_v) -> WishartFast:
    """WishartFast(D+2, I1 + I2) with
    I1 = (Ψ0 − tr(Kuu⁻¹Ψ2))·I_D,
    I2 = Ry − μ_y Eᵀ − E μ_yᵀ + Ψ4,  E[d] = Ψ1ᵀμ_v^(d),
    Ψ4[i,j] = ⟨Rv_blk[i,j], Ψ2ᵀ⟩.  Σ_y = 0 for a point-mass out."""
    M = args.Xu.shape[0]
    D = mu_y.shape[0]
    psi0, psi1, psi2 = psiops.psi_expected_multi(kernel, args.theta, args.Xu, method,
                                                 q_in.mean, q_in.cov)
    Rv = Sigma_v + torch.outer(mu_v, mu_v)
    I1 = (psi0 - torch.sum(args.Kuu_inv * psi2.T)) * _eye(D, mu_y)
    E = _split_blocks(mu_v, M, D) @ psi1
    psi4 = block_trace_products(Rv, psi2.T, D, M)
    Ry = Sigma_y + torch.outer(mu_y, mu_y)
    I2 = Ry - torch.outer(mu_y, E) - torch.outer(E, mu_y) + psi4
    df = torch.tensor(D + 2.0, dtype=mu_y.dtype, device=mu_y.device)
    return WishartFast(df, I1 + I2)


# ---------------------------------------------------------------------------
# θ rule (MultiSGPnode.jl:447-466)
# ---------------------------------------------------------------------------


def theta_log_message(kernel, method, Xu, q_in: MvGaussian, mu_y, mu_v, Rv, W_mean,
                      psi2_jitter: float = 1e-7) -> Callable:
    """log ν(θ) = −½tr(W̄ I1(θ)) + μ_yᵀW̄(I⊗Ψ1(θ))μ_v − ½tr((W̄⊗Ψ2(θ))Rv)
    with expected Ψ's per θ (+1e-7·I on Ψ2, MultiSGPnode.jl:459) and Kuu⁻¹
    jittered by ``JITTER_KUU_SSM`` (unjittered, a long-lengthscale θ probe
    makes the log-density and its gradient NaN)."""
    D = mu_y.shape[0]
    M = Xu.shape[0]

    def logpdf(theta):
        psi0, psi1, psi2 = psiops.psi_expected_multi(kernel, theta, Xu, method, q_in.mean,
                                                     q_in.cov)
        psi2 = psi2 + psi2_jitter * _eye(M, psi2)
        Kuu_inv = cholinv(kernel.kuu(theta, Xu), jitter=JITTER_KUU_SSM)
        tr_I1 = torch.trace(W_mean) * (psi0 - torch.trace(Kuu_inv @ psi2))
        lin = (W_mean @ mu_y) @ (_split_blocks(mu_v, M, D) @ psi1)
        # tr((W̄⊗Ψ2)Rv) = Σ_{ij} W̄_ij ⟨Ψ2, Rv_blk[j,i]⟩
        quad_term = torch.sum(sum_blocks_weighted(Rv, W_mean.T, D, M) * psi2)
        return -0.5 * tr_I1 + lin - 0.5 * quad_term

    return logpdf


# ---------------------------------------------------------------------------
# average energy (MultiSGPnode.jl:544-632)
# ---------------------------------------------------------------------------


def average_energy(kernel, method, args: MultiSGPArgs, mu_y, Sigma_y, q_in: MvGaussian,
                   mu_v, Sigma_v, W_mean, E_logdet_W):
    """U[q] = ½D log2π − ½E[logdet W] + ½tr(W̄ Ry)
             + ½tr(W̄)(Ψ0 − ⟨Kuu⁻¹,Ψ2⟩) − ⟨ΣdiagV,Ψ1⟩ + ½⟨Ψ2, ΣRv_blk·W̄⟩."""
    M = args.Xu.shape[0]
    D = mu_y.shape[0]
    psi0, psi1, psi2 = psiops.psi_expected_multi(kernel, args.theta, args.Xu, method,
                                                 q_in.mean, q_in.cov)
    Rv = Sigma_v + torch.outer(mu_v, mu_v)
    Ry = Sigma_y + torch.outer(mu_y, mu_y)
    sumdiagV = _sum_diag_V(mu_v, mu_y, W_mean, M, D)
    sumRv_W = sum_blocks_weighted(Rv, W_mean, D, M)
    return (0.5 * D * _LOG2PI
            - 0.5 * E_logdet_W
            + 0.5 * torch.trace(W_mean @ Ry)
            + 0.5 * torch.trace(W_mean) * (psi0 - torch.sum(args.Kuu_inv * psi2.T))
            - sumdiagV @ psi1
            + 0.5 * torch.sum(psi2 * sumRv_W))


def average_energy_batch(kernel, method, args: MultiSGPArgs, mu_y, Sigma_y, q_in: MvGaussian,
                         mu_v, Sigma_v, W_mean, E_logdet_W):
    """:func:`average_energy` of N nodes sharing q(v) and W (the GPSSM
    chain's transitions): mu_y (N, D), Sigma_y (N, D, D), q_in of means (N,
    Din) and covariances (N, Din, Din). The expected Ψ's of all N input
    marginals come from one Gram over their N·P cubature points; each
    node's terms are those of the single-node rule. Returns (N,)."""
    M = args.Xu.shape[0]
    D = mu_y.shape[-1]
    psi0, psi1, Kp, w = psiops.psi_batch_expected_multi(kernel, args.theta, args.Xu, method,
                                                         q_in.mean, q_in.cov)
    psi2 = psiops.per_datum_psi2(Kp, w)  # (N, M, M)
    Rv = Sigma_v + torch.outer(mu_v, mu_v)
    Ry = Sigma_y + mu_y.unsqueeze(-1) * mu_y.unsqueeze(-2)
    sumdiagV = (mu_y @ W_mean.T) @ _split_blocks(mu_v, M, D)  # (N, M)
    sumRv_W = sum_blocks_weighted(Rv, W_mean, D, M)
    return (0.5 * D * _LOG2PI
            - 0.5 * E_logdet_W
            + 0.5 * torch.einsum("de,ned->n", W_mean, Ry)
            + 0.5 * torch.trace(W_mean) * (psi0 - torch.einsum("mq,nqm->n", args.Kuu_inv, psi2))
            - torch.einsum("nm,mn->n", sumdiagV, psi1)
            + 0.5 * torch.einsum("nmq,mq->n", psi2, sumRv_W))
