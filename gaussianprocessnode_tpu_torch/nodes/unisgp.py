"""UniSGP node: univariate-output sparse-GP likelihood/transition factor.

Counterpart of ``gaussianprocessnode_tpu/nodes/unisgp.py``: the reference's
``@rule UniSGP(...)`` bodies and ``@average_energy`` implementations
(GPnode/UniSGPnode.jl). Node edges follow the reference
(UniSGPnode.jl:76-82):

    out : y (or x_t)          in : x (or x_{t-1})
    v   : transformed inducing outputs  v = Kuu⁻¹u   (length M)
    w   : process-noise precision       θ : kernel hyperparameters

``*_uncertain`` rules take a Gaussian input through quadrature, ``*_exact``
an observed input through exact kernel rows, ``*_batch_exact`` a whole batch
of observed inputs through one Gram. The log-density messages come back as
callables that take a batch of points at once (one value per point), where
the JAX package returns a scalar closure; ``marginal_in`` fuses the in
message with its Gaussian product by GH-21 moment matching.
"""

import math
from typing import Callable, NamedTuple

import torch

from ..config import CLAMP_HI, CLAMP_LO, JITTER_KUU, JITTER_PSI2, VAR_FLOOR
from ..dists import GammaShapeRate, Gaussian, MvGaussianNat
from ..ops import psi as psiops
from ..ops import quadrature as quad
from ..ops.linalg import cholinv, jdot, tri_solve_lower

_LOG2PI = math.log(2.0 * math.pi)


class UniSGPArgs(NamedTuple):
    """Per-node state (the reference's UniSGPMeta,
    gp_helperfunction.jl:33-52, minus its mutable buffers)."""

    theta: torch.Tensor  # kernel hyperparameters (PointMass q_θ mean)
    Xu: torch.Tensor  # inducing inputs (M, Din)
    KuuL: torch.Tensor  # lower Cholesky of K(Xu,Xu) + jitter
    Uv: torch.Tensor  # upper Cholesky of Rv = Σ_v + μ_v μ_vᵀ


def _clamp(x):
    return torch.clamp(x, CLAMP_LO, CLAMP_HI)


def _eye(M, like):
    return torch.eye(M, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# out rule  (UniSGPnode.jl:85-104)
# ---------------------------------------------------------------------------


def out_message_uncertain(kernel, method, args: UniSGPArgs, q_in: Gaussian, mu_v,
                          w_mean) -> Gaussian:
    """Forward message N(Ψ1ᵀμ_v, w̄⁻¹) with Ψ1 by cubature
    (reference: UniSGPnode.jl:85-93)."""
    _, psi1, _ = psiops.psi_expected_uni(kernel, args.theta, args.Xu, method, q_in.mean,
                                         q_in.var)
    return Gaussian(jdot(psi1, mu_v), 1.0 / w_mean)


def out_message_exact(kernel, args: UniSGPArgs, x, mu_v, w_mean) -> Gaussian:
    """Forward message with exact K(Xu, x̂) (reference: UniSGPnode.jl:96-104)."""
    psi1 = psiops.psi1_exact(kernel, args.theta, args.Xu, torch.atleast_1d(x))
    return Gaussian(jdot(psi1, mu_v), 1.0 / w_mean)


# ---------------------------------------------------------------------------
# in rule  (UniSGPnode.jl:107-122) + fused product
# ---------------------------------------------------------------------------


def in_log_message(kernel, args: UniSGPArgs, q_out: Gaussian, mu_v, w_mean) -> Callable:
    """Backward log-density message over a scalar input x
    (reference: UniSGPnode.jl:107-122):

        log ν(x) = −½ A(x) w̄ + w̄ μ_y B(x)ᵀ μ_v − ½ w̄ ‖Uv B(x)‖²
        A(x) = k(x,x) − ‖KuuL⁻¹ B(x)‖²,   B(x) = K(Xu, x)

    The returned callable takes a tensor of points of any shape and returns
    log ν at each, in that shape: all points go through one Gram."""
    mu_y = q_out.mean

    def logpdf(x):
        xs = torch.as_tensor(x)
        B = kernel(args.theta, args.Xu, xs.reshape(-1, 1))  # (M, P)
        alpha = tri_solve_lower(args.KuuL, B)
        A = kernel.kxx(args.theta, xs) - torch.sum(alpha * alpha, dim=0)
        beta = args.Uv @ B
        val = (-0.5 * A * w_mean + w_mean * mu_y * (B.T @ mu_v)
               - 0.5 * w_mean * torch.sum(beta * beta, dim=0))
        return val.reshape(xs.shape)

    return logpdf


def marginal_in(kernel, args: UniSGPArgs, q_out: Gaussian, mu_v, w_mean, q_fwd: Gaussian,
                n_gh: int = 21) -> Gaussian:
    """Fused in-rule and product: moment-match q_fwd·exp(log ν) with GH(n)
    (reference: rule UniSGPnode.jl:107-122 followed by prod at :39-46, with
    the +1e-6 variance floor and the fallback to q_fwd)."""
    logpdf = in_log_message(kernel, args, q_out, mu_v, w_mean)
    m, v = quad.moment_match_uni(logpdf, q_fwd.mean, q_fwd.var, n=n_gh, var_floor=VAR_FLOOR)
    return Gaussian(m, v)


# ---------------------------------------------------------------------------
# v rule  (UniSGPnode.jl:125-173)
# ---------------------------------------------------------------------------


def v_message_uncertain(kernel, method, args: UniSGPArgs, mu_y, q_in: Gaussian,
                        w_mean) -> MvGaussianNat:
    """Natural-parameter message to v with expected Ψ's (+1e-8·I on Ψ2)
    (reference: UniSGPnode.jl:125-140)."""
    _, psi1, psi2 = psiops.psi_expected_uni(kernel, args.theta, args.Xu, method, q_in.mean,
                                            q_in.var)
    psi2 = psi2 + JITTER_PSI2 * _eye(psi2.shape[0], psi2)
    return MvGaussianNat(w_mean * mu_y * psi1, w_mean * psi2)


def v_message_exact(kernel, args: UniSGPArgs, x, mu_y, w_mean) -> MvGaussianNat:
    """Exact-input v message: ξ = w μ_y Ψ1, Λ = w Ψ1Ψ1ᵀ (reference:
    UniSGPnode.jl:144-173)."""
    psi1 = psiops.psi1_exact(kernel, args.theta, args.Xu, torch.atleast_1d(x))
    return MvGaussianNat(w_mean * mu_y * psi1, w_mean * torch.outer(psi1, psi1))


def v_message_batch_exact(Kux, y_mean, w_mean) -> MvGaussianNat:
    """Σᵢ v-messages of a batch in two GEMMs (the order-free equivalent of
    N BufferUniSGP products, UniSGPnode.jl:62-73): ξ = w·Kux μ_y,
    Λ = w·Kux Kuxᵀ; ``Kux`` (M, N) from ``psi_batch_exact``."""
    return MvGaussianNat(w_mean * (Kux @ y_mean), w_mean * (Kux @ Kux.T))


# ---------------------------------------------------------------------------
# w rule  (UniSGPnode.jl:177-238)
# ---------------------------------------------------------------------------


def _w_terms_exact(kernel, args: UniSGPArgs, x, mu_y, v_y, mu_v):
    xv = torch.atleast_1d(x)
    psi1 = psiops.psi1_exact(kernel, args.theta, args.Xu, xv)
    alpha = tri_solve_lower(args.KuuL, psi1)
    I1 = kernel.kxx(args.theta, xv) - jdot(alpha, alpha)
    beta = args.Uv @ psi1
    I2 = mu_y**2 + v_y - 2.0 * mu_y * jdot(psi1, mu_v) + jdot(beta, beta)
    return I1, I2


def _shape_1p5(like):
    return torch.full((), 1.5, dtype=like.dtype, device=like.device)


def w_message_exact(kernel, args: UniSGPArgs, x, mu_y, v_y, mu_v) -> GammaShapeRate:
    """Γ(3/2, ½(I1+I2)) with exact kernel rows (reference:
    UniSGPnode.jl:196-238; v_y = 0 is the regression fast path)."""
    I1, I2 = _w_terms_exact(kernel, args, x, mu_y, v_y, mu_v)
    rate = 0.5 * (I1 + I2)
    return GammaShapeRate(_shape_1p5(rate), rate)


def _w_terms_uncertain(kernel, method, args: UniSGPArgs, q_out_mean, q_out_var,
                       q_in: Gaussian, mu_v):
    """Clamped uncertain-input (I1, I2), shared by the w message and the
    average energy (UniSGPnode.jl:177-192 and :290-313)."""
    psi0, psi1, psi2 = psiops.psi_expected_uni(kernel, args.theta, args.Xu, method,
                                               q_in.mean, q_in.var)
    psi2 = psi2 + JITTER_PSI2 * _eye(psi2.shape[0], psi2)
    s = tri_solve_lower(args.KuuL, psi2)
    s = tri_solve_lower(args.KuuL, s.T)  # KuuL⁻¹ (KuuL⁻¹ Ψ2)ᵀ; trace-equivalent
    I1 = _clamp(psi0 - torch.trace(s))
    # tr(UvᵀUv Ψ2) = Σᵢⱼ (Uv Ψ2)ᵢⱼ (Uv)ᵢⱼ
    tr_uvpsi2 = torch.sum((args.Uv @ psi2) * args.Uv)
    I2 = _clamp(q_out_mean**2 + q_out_var - 2.0 * q_out_mean * jdot(psi1, mu_v) + tr_uvpsi2)
    return I1, I2


def w_message_uncertain(kernel, method, args: UniSGPArgs, q_out_mean, q_out_var,
                        q_in: Gaussian, mu_v) -> GammaShapeRate:
    """Uncertain-input w message with clamped I1/I2
    (reference: UniSGPnode.jl:177-192)."""
    I1, I2 = _w_terms_uncertain(kernel, method, args, q_out_mean, q_out_var, q_in, mu_v)
    rate = 0.5 * (I1 + I2)
    return GammaShapeRate(_shape_1p5(rate), rate)


def _w_terms_batch_exact(args: UniSGPArgs, kxx, Kux, y_mean, y_var, mu_v):
    """Per-datum exact (I1, I2) vectors, shared by the batched w message
    and the batched average energy."""
    alpha = tri_solve_lower(args.KuuL, Kux)  # (M, N)
    I1 = kxx - torch.sum(alpha * alpha, dim=0)
    beta = args.Uv @ Kux
    I2 = (y_mean**2 + y_var - 2.0 * y_mean * (Kux.T @ mu_v)
          + torch.sum(beta * beta, dim=0))
    return I1, I2


def w_message_batch_exact(kernel, args: UniSGPArgs, kxx, Kux, y_mean, y_var, mu_v):
    """Batched exact w messages: (Σ shape increments, Σ rates), the
    product of N Γ(3/2, rateᵢ) messages: q(w) = Γ(a₀ + N/2, b₀ + Σᵢ rateᵢ)."""
    I1, I2 = _w_terms_batch_exact(args, kxx, Kux, y_mean, y_var, mu_v)
    rates = 0.5 * (I1 + I2)
    return 0.5 * kxx.shape[0], torch.sum(rates)


# ---------------------------------------------------------------------------
# θ rule  (UniSGPnode.jl:242-287): log-density over hyperparameters
# ---------------------------------------------------------------------------


def theta_log_message_exact(kernel, Xu, x, mu_y, mu_v, Rv, w_mean,
                            kuu_jitter: float = JITTER_KUU) -> Callable:
    """log ν(θ) = w μ_y Ψ1(θ)ᵀμ_v − ½w(Ψ0(θ) + Ψ1ᵀ(Rv − Kuu(θ)⁻¹)Ψ1) with
    exact Ψ's (reference: UniSGPnode.jl:242-272); Kuu jittered by the
    reference's +1e-8·I."""
    xv = torch.atleast_1d(x)

    def logpdf(theta):
        psi1 = psiops.psi1_exact(kernel, theta, Xu, xv)
        psi0 = kernel.kxx(theta, xv)
        Kuu_inv = cholinv(kernel.kuu(theta, Xu), jitter=kuu_jitter)
        quad_term = psi1 @ (Rv - Kuu_inv) @ psi1
        return w_mean * mu_y * jdot(psi1, mu_v) - 0.5 * w_mean * (psi0 + quad_term)

    return logpdf


def theta_log_message_uncertain(kernel, method, Xu, q_in: Gaussian, mu_y, mu_v, Rv, w_mean,
                                kuu_jitter: float = JITTER_KUU) -> Callable:
    """The same with expected Ψ's under q_in (reference:
    UniSGPnode.jl:274-287)."""

    def logpdf(theta):
        psi0, psi1, psi2 = psiops.psi_expected_uni(kernel, theta, Xu, method, q_in.mean,
                                                   q_in.var)
        Kuu_inv = cholinv(kernel.kuu(theta, Xu), jitter=kuu_jitter)
        tr_term = torch.sum(psi2 * (Rv - Kuu_inv).T)
        return w_mean * mu_y * jdot(psi1, mu_v) - 0.5 * w_mean * (psi0 + tr_term)

    return logpdf


# ---------------------------------------------------------------------------
# average energy  (UniSGPnode.jl:290-458)
# ---------------------------------------------------------------------------


def _energy(I1, I2, w_mean, E_logw):
    return 0.5 * (I1 * w_mean - E_logw + _LOG2PI + I2 * w_mean)


def average_energy_exact(kernel, args: UniSGPArgs, x, mu_y, v_y, mu_v, w_mean, E_logw):
    """U[q] for an observed input (reference: UniSGPnode.jl:337-387; the
    PointMass-w variants at :411-458 with E_logw = log w̄)."""
    I1, I2 = _w_terms_exact(kernel, args, x, mu_y, v_y, mu_v)
    return _energy(I1, I2, w_mean, E_logw)


def average_energy_exact_batch(kernel, args: UniSGPArgs, kxx, Kux, y_mean, y_var, mu_v,
                               w_mean, E_logw):
    """Σᵢ U[q] over a batch with exact kernel rows."""
    I1, I2 = _w_terms_batch_exact(args, kxx, Kux, y_mean, y_var, mu_v)
    return torch.sum(_energy(I1, I2, w_mean, E_logw))


def average_energy_uncertain(kernel, method, args: UniSGPArgs, q_out_mean, q_out_var,
                             q_in: Gaussian, mu_v, w_mean, E_logw):
    """U[q] with expected Ψ's and clamped I1/I2 (reference:
    UniSGPnode.jl:290-313)."""
    I1, I2 = _w_terms_uncertain(kernel, method, args, q_out_mean, q_out_var, q_in, mu_v)
    return _energy(I1, I2, w_mean, E_logw)
