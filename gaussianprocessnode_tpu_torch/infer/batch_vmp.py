"""Structured VMP inference programs for iid-data models (L5 layer).

Counterpart of ``gaussianprocessnode_tpu/infer/batch_vmp.py``. One sweep is
a handful of batched GEMMs, and the fixed number of sweeps is a Python
loop of that count (the JAX package's ``fori_loop``); nothing in it reads
the device, so a call queues its work without a host sync. Semantics
follow the reference schedule:

    per sweep: q(v) ← prior × Πᵢ v-messages      (order-free natural sum)
               Uv  ← chol(Σ_v + μ_v μ_vᵀ).U      (refresh once per sweep,
                                                  UniSGPnode.jl:62-73)
               q(w) ← prior × Πᵢ w-messages      (with the fresh Uv)

Free energy is the Bethe free energy of the mean-field factorization:
FE = Σ node energies + prior energies − Σ entropies.

Also ``predict_out`` and ``predict_probit``, the :out rules at PointMass
test inputs.
"""

import math
from typing import NamedTuple, Optional

import torch

from ..config import JITTER_KUU
from ..dists import (
    GammaShapeRate,
    Gaussian,
    MvGaussian,
    MvGaussianNat,
    gamma_entropy,
    gamma_mean,
    gamma_mean_log,
    gaussian_entropy,
    mv_nat_to_meancov,
)
from ..nodes import probit as probit_node
from ..nodes import unisgp
from ..nodes.unisgp import UniSGPArgs
from ..ops.linalg import chol_lower, chol_solve, chol_upper, logdet_from_chol, sym
from ..ops.psi import psi_batch_exact
from ..utils import tracing

__all__ = ["VMPResult", "prior_energy_mvn", "prior_energy_gamma", "regression_vmp",
           "classification_vmp", "predict_out", "predict_probit"]

_LOG2PI = math.log(2.0 * math.pi)


class VMPResult(NamedTuple):
    qv: MvGaussian
    qv_nat: MvGaussianNat
    qw: GammaShapeRate
    Uv: torch.Tensor
    free_energy: torch.Tensor
    qf: Optional[Gaussian] = None


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _qv_from_nat(nat: MvGaussianNat):
    """(μ_v, Σ_v, Uv, L) from the natural parameters; L = chol(sym(Λ))."""
    q = mv_nat_to_meancov(nat)
    L = chol_lower(sym(nat.prec))
    Uv = chol_upper(sym(q.cov + torch.outer(q.mean, q.mean)))
    return q.mean, q.cov, Uv, L


def prior_energy_mvn(mu_q, cov_q, mu_p, cov_p):
    """−E_q[log N(v; μ_p, Σ_p)] (the prior factor's part of the FE)."""
    M = mu_q.shape[0]
    Lp = chol_lower(sym(cov_p))
    d = mu_q - mu_p
    a = chol_solve(Lp, d)
    tr_term = torch.trace(chol_solve(Lp, cov_q))
    return 0.5 * (M * _LOG2PI + logdet_from_chol(Lp) + tr_term + d @ a)


def prior_energy_gamma(a0, b0, qw: GammaShapeRate):
    """−E_q[log Gamma(w; a0, b0)]."""
    return -(a0 * torch.log(b0) - torch.special.gammaln(a0)
             + (a0 - 1.0) * gamma_mean_log(qw) - b0 * gamma_mean(qw))


def _qv_entropy(mu_v, Lprec):
    """Entropy of q(v) from the Cholesky factor of its precision (the
    exactly-SPD matrix held; the JAX package's choice, DEVIATIONS #30)."""
    return 0.5 * (mu_v.shape[0] * (_LOG2PI + 1.0) - logdet_from_chol(Lprec))


# ---------------------------------------------------------------------------
# regression: y_i ~ UniSGP(x_i, v, w, θ), all data observed
# (reference model: GPT_regression.ipynb cell 6 / regression_kin40k.ipynb cell 7)
# ---------------------------------------------------------------------------


def regression_vmp(kernel, theta, Xu, X, y, prior_v: MvGaussianNat,
                   prior_w: GammaShapeRate, n_iters: int = 7, w_fixed=None,
                   compute_fe: bool = True) -> VMPResult:
    """VMP for the conjugate regression model (q(v)q(w) mean field).

    ``w_fixed``: if given, w is a PointMass (kin40k, w = 1e4) and the q(w)
    updates are skipped."""
    Kuu = kernel.kuu(theta, Xu, jitter=JITTER_KUU)
    KuuL = chol_lower(Kuu)
    kxx, Kux = psi_batch_exact(kernel, theta, Xu, X)
    a0, b0 = prior_w.shape, prior_w.rate
    w_pm = None if w_fixed is None else torch.as_tensor(w_fixed, dtype=y.dtype,
                                                        device=y.device)

    a_w, b_w = a0, b0
    for _ in range(n_iters):
        w_mean = (a_w / b_w) if w_pm is None else w_pm
        vmsg = unisgp.v_message_batch_exact(Kux, y, w_mean)
        nat = MvGaussianNat(prior_v.xi + vmsg.xi, prior_v.prec + vmsg.prec)
        mu_v, _, Uv, _ = _qv_from_nat(nat)
        if w_pm is None:
            args = UniSGPArgs(theta, Xu, KuuL, Uv)
            dshape, rates = unisgp.w_message_batch_exact(kernel, args, kxx, Kux, y, 0.0, mu_v)
            a_w = a0 + dshape
            b_w = b0 + rates

    # final marginals, recomputed once outside the loop
    w_mean = (a_w / b_w) if w_pm is None else w_pm
    vmsg = unisgp.v_message_batch_exact(Kux, y, w_mean)
    nat = MvGaussianNat(prior_v.xi + vmsg.xi, prior_v.prec + vmsg.prec)
    mu_v, cov_v, Uv, Lprec = _qv_from_nat(nat)
    qw = GammaShapeRate(a_w, b_w)

    fe = torch.zeros((), dtype=y.dtype, device=y.device)
    if compute_fe:
        E_logw = torch.log(w_mean) if w_pm is not None else gamma_mean_log(qw)
        args = UniSGPArgs(theta, Xu, KuuL, Uv)
        node_e = unisgp.average_energy_exact_batch(kernel, args, kxx, Kux, y, 0.0, mu_v,
                                                   w_mean, E_logw)
        qp = mv_nat_to_meancov(prior_v)
        fe = (node_e + prior_energy_mvn(mu_v, cov_v, qp.mean, qp.cov)
              - _qv_entropy(mu_v, Lprec))
        if w_pm is None:
            fe = fe + prior_energy_gamma(a0, b0, qw) - gamma_entropy(qw)

    return VMPResult(MvGaussian(mu_v, cov_v), nat, qw, Uv, fe)


# ---------------------------------------------------------------------------
# classification: f_i ~ UniSGP(x_i, v, w, θ); y_i ~ Probit(f_i)
# (reference model: classification_banana.ipynb cell 7)
# ---------------------------------------------------------------------------


def classification_vmp(kernel, theta, Xu, X, y, prior_v: MvGaussianNat,
                       prior_w: GammaShapeRate, init_w: GammaShapeRate, n_iters: int = 30,
                       compute_fe: bool = True, probit_product: str = "exact") -> VMPResult:
    """VMP for probit classification with latent f (q(f)q(v)q(w) mean field).

    Per sweep:
        forward fᵢ ~ N(Ψ1ᵢᵀμ_v, w̄⁻¹)   → tilted q(fᵢ) with the probit
        v-messages with μ_y = E[fᵢ]      → q(v), refresh Uv
        w-messages with (E[fᵢ], V[fᵢ])   → q(w)

    ``probit_product``: "exact", the closed-form tilted moments; "gh32", the
    reference's ProbitMeta(32) Gauss–Hermite moment matching."""
    if probit_product == "exact":
        tilted = probit_node.tilted_marginal_batch
    elif probit_product == "gh32":
        def tilted(m, v, yy):
            return probit_node.tilted_marginal_gh_batch(m, v, yy, n_gh=32)
    else:
        raise ValueError(f"probit_product must be 'exact' or 'gh32', not {probit_product!r}")
    Kuu = kernel.kuu(theta, Xu, jitter=JITTER_KUU)
    KuuL = chol_lower(Kuu)
    kxx, Kux = psi_batch_exact(kernel, theta, Xu, X)
    N = y.shape[0]
    a0, b0 = prior_w.shape, prior_w.rate

    # q(v) starts at its prior, q(f) at N(0, 1)
    mu_v, _, _, _ = _qv_from_nat(prior_v)
    a_w, b_w = init_w.shape, init_w.rate
    f_mean = torch.zeros((N,), dtype=Xu.dtype, device=Xu.device)
    f_var = torch.ones((N,), dtype=Xu.dtype, device=Xu.device)
    for _ in range(n_iters):
        w_mean = a_w / b_w
        f_fwd_mean = Kux.T @ mu_v
        f_fwd_var = (1.0 / w_mean).expand(N).to(f_fwd_mean.dtype)
        qf = tilted(f_fwd_mean, f_fwd_var, y)
        vmsg = unisgp.v_message_batch_exact(Kux, qf.mean, w_mean)
        nat = MvGaussianNat(prior_v.xi + vmsg.xi, prior_v.prec + vmsg.prec)
        mu_v, _, Uv, _ = _qv_from_nat(nat)
        args = UniSGPArgs(theta, Xu, KuuL, Uv)
        dshape, rates = unisgp.w_message_batch_exact(kernel, args, kxx, Kux, qf.mean,
                                                     qf.var, mu_v)
        a_w, b_w, f_mean, f_var = a0 + dshape, b0 + rates, qf.mean, qf.var

    w_mean = a_w / b_w
    vmsg = unisgp.v_message_batch_exact(Kux, f_mean, w_mean)
    nat = MvGaussianNat(prior_v.xi + vmsg.xi, prior_v.prec + vmsg.prec)
    mu_v, cov_v, Uv, Lprec = _qv_from_nat(nat)
    qw = GammaShapeRate(a_w, b_w)
    qf = Gaussian(f_mean, f_var)

    fe = torch.zeros((), dtype=Xu.dtype, device=Xu.device)
    if compute_fe:
        E_logw = gamma_mean_log(qw)
        args = UniSGPArgs(theta, Xu, KuuL, Uv)
        node_e = unisgp.average_energy_exact_batch(kernel, args, kxx, Kux, f_mean, f_var,
                                                   mu_v, w_mean, E_logw)
        probit_e = probit_node.average_energy_batch(f_mean, f_var, y)
        qp = mv_nat_to_meancov(prior_v)
        fe = (node_e + probit_e + prior_energy_mvn(mu_v, cov_v, qp.mean, qp.cov)
              + prior_energy_gamma(a0, b0, qw) - _qv_entropy(mu_v, Lprec)
              - gamma_entropy(qw) - torch.sum(gaussian_entropy(qf)))

    return VMPResult(MvGaussian(mu_v, cov_v), nat, qw, Uv, fe, qf)


# ---------------------------------------------------------------------------
# prediction (reference: predict_new / @call_rule UniSGP(:out))
# ---------------------------------------------------------------------------


def predict_out(kernel, theta, Xu, X_test, mu_v, w_mean):
    """Batched UniSGP :out rule at PointMass test inputs:
    N(K(Xu,x*)ᵀ μ_v, w̄⁻¹) (reference: UniSGPnode.jl:96-104).

    ``w_mean`` is a tensor (0-dim, any float dtype) on the inputs' device,
    so neither the mean nor the variance waits on the host."""
    Kut = kernel(theta, Xu, X_test)
    with tracing.span("serve.matvec"):
        mean = Kut.T @ mu_v
    with tracing.span("serve.fill"):
        var = torch.empty_like(mean).copy_((1.0 / w_mean).expand(mean.shape))
    return mean, var


def predict_probit(kernel, theta, Xu, X_test, mu_v, w_mean):
    """Class probability P(y=1|x*) = Φ(m/√(1+v)) through the Probit out rule
    (reference: classification_banana.ipynb cell 13)."""
    mean, var = predict_out(kernel, theta, Xu, X_test, mu_v, w_mean)
    with tracing.span("probit.phi"):
        return probit_node.out_probability(Gaussian(mean, var))
