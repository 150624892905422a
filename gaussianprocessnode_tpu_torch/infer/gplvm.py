"""GPLVM inference: latent-input VMP through the MultiSGP node.

Counterpart of ``gaussianprocessnode_tpu/infer/gplvm.py`` (reference
workload GPLVM.ipynb). Model:

    v ~ MvNWMP(0, I_D ⊗ Kuu(θ))        (whitened prior: precision = Kuu)
    x_i ~ MvN(x̄_i^PCA, 100·I_2)
    y_i ~ MultiSGP(x_i, v, W=1e2·I_D, θ)    W PointMass, D=12 outputs

Mean-field q(x)q(v). Per VMP sweep:
  1. q(v): natural sum of v-messages with expected Ψ's under the current
     q(x) (one Gram over all N·2·Din cubature points);
  2. every q(x_i): Laplace in-message (MultiSGPnode.jl:210-236, L-BFGS on
     −log ν, Hessian precision) × the MvN prior, in closed form.

Where the JAX package vmaps a per-row x-update, :func:`make_x_update`
returns an update of all N rows at once: −log ν is row-separable (row i
depends on x_i alone, through the shared A_in, θ and Xu), so one
``training.lbfgs_solve_batched`` runs every row's L-BFGS with one objective
evaluation per linesearch iteration, and Din reverse-over-reverse passes of
the summed gradient give every row's Hessian (``jax.hessian`` per row in
JAX; they agree to rounding). The whole Laplace path runs in float64, and
the q(v) naturals are always float64, whatever the model dtype; in a
float32 state the Ψ-statistics and the node energies stay float32, through
the SE kernel on the card with ``Kernel(use_kernel=True)``.

FE (the NelderMead objective in the reference) = Σ node energies + prior
energies − entropies. ``counts`` (a dict, optional) collects the batched
L-BFGS's ``evaluations``, ``linesearch_steps`` and ``host_reads``.
"""

import math
from typing import NamedTuple

import torch

from ..config import JITTER_KUU_SSM
from ..dists import MvGaussian, MvGaussianNat, mv_gaussian_entropy, mv_nat_to_meancov
from ..nodes.multisgp import MultiSGPArgs, _split_blocks, average_energy_batch
from ..ops import psi as psiops
from ..ops import quadrature as quad
from ..ops.linalg import (chol_lower, chol_solve, cholinv, effective_jitter, logdet_from_chol,
                          sym)
from .training import lbfgs_solve, lbfgs_solve_batched

__all__ = ["GPLVMState", "make_x_update", "laplace_precision_guard", "gplvm_free_energy",
           "gplvm_fe_theta_terms", "gplvm_fe_const_terms", "gplvm_init_state", "gplvm_vmp",
           "fit_gplvm_grad", "gplvm_embed"]

_LOG2PI = math.log(2.0 * math.pi)
_F64 = torch.float64


class GPLVMState(NamedTuple):
    x_means: torch.Tensor  # (N, Din)
    x_covs: torch.Tensor  # (N, Din, Din)
    xi_v: torch.Tensor  # (M·D,) float64
    prec_v: torch.Tensor  # (M·D, M·D) float64


def _eye(n, dtype, device):
    return torch.eye(n, dtype=dtype, device=device)


def _qv_stats(xi, prec):
    """(ξ, Λ) → (μ, Σ) through ``dists.mv_nat_to_meancov``, factored in f64
    whatever the state dtype (κ(Λ_v) ≈ 1e10 for the converged q(v)),
    moments cast back."""
    dt = xi.dtype
    q = mv_nat_to_meancov(MvGaussianNat(xi.to(_F64), prec.to(_F64)))
    return q.mean.to(dt), q.cov.to(dt)


def _qv_stats_kron(xi, prec, M, D):
    """q(v) moments through the family's exact Kronecker structure: every
    producer of the precision (:func:`gplvm_vmp`, :func:`gplvm_init_state`)
    builds Λ_v = I_D ⊗ B with B = Kuu + w·ΣΨ2 (C = I, W = w·I), so one M×M
    Cholesky gives μ_d = B⁻¹ξ_d, Σ_v = I_D ⊗ B⁻¹ and logdet Λ_v = D·logdet
    B. Returns ``(mu_v, Binv, Lb)``: ``Lb`` the f64 Cholesky factor of B,
    μ and B⁻¹ cast to the state's dtype. The factorization is always f64
    (κ(B) ≈ 1e10 at convergence)."""
    dt = xi.dtype
    B = sym(prec[:M, :M]).to(_F64)
    Lb = chol_lower(B)
    Binv = sym(chol_solve(Lb, _eye(M, _F64, B.device)))
    mu = chol_solve(Lb, xi.to(_F64).reshape(D, M).T).T.reshape(-1)
    return mu.to(dt), Binv.to(dt), Lb


def _kuu_ssm(kernel, theta, Xu):
    """Kuu at the SSM jitter, by dtype: 1e-12 in f64, 300·ε in f32 (the
    reference's 1e-12 is below f32 resolution; without the larger jitter
    the f32 Gram's noise leaves Kuu indefinite)."""
    dt = torch.promote_types(theta.dtype, Xu.dtype)
    jit = JITTER_KUU_SSM if dt == _F64 else effective_jitter(dt, JITTER_KUU_SSM)
    return kernel.kuu(theta, Xu, jitter=jit)


def _row_hessians(f, X):
    """Hessians (N, d, d) of every row of a row-separable f: (N, d) → (N,),
    by d reverse passes over the summed gradient (column j of every row's
    Hessian is the gradient of Σᵢ ∂fᵢ/∂x_ij)."""
    with torch.enable_grad():
        x = X.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(x).sum(), x, create_graph=True)
        cols = [torch.autograd.grad(g[:, j].sum(), x, retain_graph=True)[0]
                for j in range(X.shape[-1])]
    return torch.stack(cols, dim=-1).detach()


def laplace_precision_guard(W_z):
    """Branchless PSD guard for Laplace-message precisions (…, d, d): the
    symmetrized Hessian where it is finite and its smallest eigenvalue
    positive, else zeros (a flat message: the marginal falls back to its
    prior). A positive diagonal does not imply PSD ([[1,2],[2,1]]), and a
    later cholinv of an indefinite precision returns NaN."""
    W_sym = 0.5 * (W_z + W_z.mT)
    finite = torch.isfinite(W_z).all(dim=-1).all(dim=-1)
    # eigvalsh of the finite matrices only (LAPACK rejects NaN input)
    safe = torch.where(finite[..., None, None], W_sym, torch.zeros_like(W_sym))
    ok = (torch.linalg.eigvalsh(safe).amin(dim=-1) > 0) & finite
    return torch.where(ok[..., None, None], W_sym, torch.zeros_like(W_z))


def make_x_update(kernel, theta, Xu, xi_v, prec_v, W, x_prior_prec, laplace_steps,
                  counts=None):
    """The GPLVM latent update at frozen v-statistics, shared by
    :func:`gplvm_vmp` (fresh q(v) each sweep) and :func:`gplvm_embed`
    (trained q(v)): Laplace in-message (L-BFGS minimizer + Hessian
    precision) × the per-point MvN prior, in natural parameters.

    Returns ``update_x(Y, m_init, xi_p) -> (means, covs)`` over all rows:
    ``m_init`` (N, Din) seeds the L-BFGS (the objective is multimodal, so
    the start selects the mode), ``xi_p`` (N, Din) is the prior's natural
    mean. The whole path runs in f64: A_in is a large cancellation of
    tr(W)·Kuu⁻¹ against ΣRv·W, with Kuu⁻¹ at the 1e-12 jitter beyond f32.
    (The JAX function also takes a Kuu⁻¹ that it does not use.)"""
    dt = x_prior_prec.dtype  # model dtype (xi_v/prec_v are always f64)
    M = Xu.shape[0]
    D = W.shape[0]
    theta64, Xu64, W64 = theta.to(_F64), Xu.to(_F64), W.to(_F64)
    tr_W = torch.trace(W64)
    # Kuu⁻¹ from the f64 cast of the model-dtype Gram at the reference jitter
    Kuu_inv64 = cholinv(_kuu_ssm(kernel, theta, Xu).to(_F64))
    # Λ_v = I_D ⊗ B: ΣᵢⱼWᵢⱼRv[i,j] = tr(W)·B⁻¹ + Σᵢⱼ Wᵢⱼ μᵢμⱼᵀ
    mu_v, Binv, _ = _qv_stats_kron(xi_v.to(_F64), prec_v.to(_F64), M, D)
    mu_blocks = _split_blocks(mu_v, M, D)
    sumRv_W = tr_W * Binv + torch.einsum("ij,im,jn->mn", W64, mu_blocks, mu_blocks)
    A_in = 0.5 * tr_W * Kuu_inv64 - 0.5 * sumRv_W
    x_prior_prec64 = x_prior_prec.to(_F64)

    def update_x(Y, m_init, xi_p):
        sumdiagV = (Y.to(_F64) @ W64.T) @ mu_blocks  # (N, M)

        def neg_log(X):
            K = kernel(theta64, Xu64, X)  # (M, N)
            psi0 = kernel.diag(theta64, X)
            return -(-0.5 * tr_W * psi0 + torch.sum(K * (A_in @ K), dim=0)
                     + torch.sum(sumdiagV.T * K, dim=0))

        m_z, _ = lbfgs_solve_batched(neg_log, m_init.to(_F64), laplace_steps, counts)
        W_z = laplace_precision_guard(_row_hessians(neg_log, m_z))
        # product with the prior (natural parameters)
        cov = cholinv(sym(x_prior_prec64 + W_z))
        nat = xi_p.to(_F64) + (W_z @ m_z.unsqueeze(-1)).squeeze(-1)
        mean = (cov @ nat.unsqueeze(-1)).squeeze(-1)
        return mean.to(dt), sym(cov).to(dt)

    return update_x


def _kron_moments(state, M, D, dt):
    """The frozen q(v)'s moments for the θ-terms: (μ_v, Σ_v = I_D ⊗ B⁻¹,
    Σ_d R_dd = D·B⁻¹ + Σ_d μ_dμ_dᵀ) in ``dt``, and B's f64 factor."""
    mu_v, Binv, Lb = _qv_stats_kron(state.xi_v, state.prec_v, M, D)
    mu_v, Binv = mu_v.to(dt), Binv.to(dt).contiguous()  # (torch.kron takes no strides)
    cov_v = torch.kron(_eye(D, dt, Binv.device), Binv)
    mub = _split_blocks(mu_v, M, D)
    R_diag_sum = D * Binv + torch.einsum("dm,dn->mn", mub, mub)
    return mu_v, cov_v, R_diag_sum, Lb


def gplvm_free_energy(kernel, theta, Xu, Y, state: GPLVMState, x_prior_means,
                      x_prior_cov_scale: float = 100.0, W_val: float = 100.0):
    """Bethe free energy FE(θ; q) at a frozen variational state, the
    gradient-hyperopt M-step objective (differentiable in θ through the
    cubature Ψ-statistics and the whitened v-prior I_D ⊗ Kuu(θ)): the
    θ-terms (:func:`gplvm_fe_theta_terms`) plus the θ-constant terms
    (:func:`gplvm_fe_const_terms`)."""
    M = Xu.shape[0]
    mu_v, cov_v, R_diag_sum, Lb = _kron_moments(state, M, Y.shape[1], Y.dtype)
    return gplvm_fe_theta_terms(
        kernel, theta, Xu, Y, state.x_means, state.x_covs, mu_v, cov_v, R_diag_sum, W_val,
    ) + gplvm_fe_const_terms(state, x_prior_means, Lb, x_prior_cov_scale)


def gplvm_fe_theta_terms(kernel, theta, Xu, Y, x_means, x_covs, mu_v, cov_v, R_diag_sum,
                         W_val: float = 100.0):
    """The θ-dependent half of the FE at frozen q: the N node energies
    (``average_energy_batch``, one Gram over all cubature points) plus the
    v-prior energy in Kronecker form, logdet(I⊗Kuu) = D·logdet Kuu and
    tr((I⊗Kuu)R_v) = tr(Kuu·Σ_d R_dd)."""
    D = Y.shape[1]
    M = Xu.shape[0]
    dt, dev = Y.dtype, Y.device
    Kuu = _kuu_ssm(kernel, theta, Xu)
    # factored in f64 whatever the model dtype: the inverse of the
    # ill-conditioned Kuu is condition-critical, the Gram is not
    Kuu_inv = cholinv(Kuu.to(_F64)).to(Kuu.dtype)
    args = MultiSGPArgs(theta, Xu, Kuu_inv)
    W = W_val * _eye(D, dt, dev)
    logdetW = D * torch.log(torch.full((), W_val, dtype=dt, device=dev))
    U_nodes = torch.sum(average_energy_batch(
        kernel, quad.SphericalRadial(), args, Y, torch.zeros((D, D), dtype=dt, device=dev),
        MvGaussian(x_means, x_covs), mu_v, cov_v, W, logdetW))
    Lk = chol_lower(sym(Kuu).to(_F64))  # f64 logdet (an FE term)
    tr_prior = torch.einsum("mn,nm->", Kuu, R_diag_sum)
    U_v = 0.5 * (M * D * _LOG2PI - D * logdet_from_chol(Lk) + tr_prior)
    return U_nodes + U_v


def gplvm_fe_const_terms(state: GPLVMState, x_prior_means, Lb,
                         x_prior_cov_scale: float = 100.0):
    """The θ-independent half of the FE at frozen q: the latent prior
    energies minus the entropies H_x + H_v, with H_v = (MD/2)(1 + log2π) −
    (D/2)·logdet B from B's f64 factor ``Lb``."""
    Din = state.x_means.shape[-1]
    M = Lb.shape[0]
    D = state.xi_v.shape[0] // M
    # −E_q[log N(x_i; x̄_i, s·I)] of every latent (batch_vmp.prior_energy_mvn
    # at an isotropic prior covariance)
    d = state.x_means - x_prior_means
    tr = torch.diagonal(state.x_covs, dim1=-2, dim2=-1).sum(-1)
    U_x = torch.sum(0.5 * (Din * _LOG2PI + Din * math.log(x_prior_cov_scale)
                           + (tr + torch.sum(d * d, dim=-1)) / x_prior_cov_scale))
    H_x = torch.sum(mv_gaussian_entropy(MvGaussian(state.x_means, state.x_covs)))
    H_v = 0.5 * M * D * (1.0 + _LOG2PI) - 0.5 * D * logdet_from_chol(Lb)
    return U_x - H_x - H_v


def gplvm_init_state(kernel, theta, Xu, Y, x_prior_means) -> GPLVMState:
    """The cold-start mean-field state: latents at their prior means with
    unit covariance, q(v) at the whitened prior (ξ = 0, Λ = I_D ⊗ Kuu(θ)),
    exactly what :func:`gplvm_vmp` and :func:`fit_gplvm_grad` build when
    ``init_state`` is omitted. The q(v) naturals are f64 in every mode
    (κ(Λ_v) ≈ 1e10 puts B's small eigenvalues below f32's resolution)."""
    return _cold_state(_kuu_ssm(kernel, theta, Xu).to(_F64), Y, x_prior_means)


def _cold_state(Kuu64, Y, x_prior_means) -> GPLVMState:
    """:func:`gplvm_init_state` from the f64 Kuu(θ) already at hand."""
    N, D = Y.shape
    Din = x_prior_means.shape[1]
    return GPLVMState(
        x_prior_means,
        _eye(Din, Y.dtype, Y.device).expand(N, Din, Din).clone(),
        torch.zeros(Kuu64.shape[0] * D, dtype=_F64, device=Y.device),
        torch.kron(_eye(D, _F64, Y.device), Kuu64),
    )


def gplvm_vmp(kernel, theta, Xu, Y, x_prior_means, x_prior_cov_scale: float = 100.0,
              W_val: float = 100.0, n_iters: int = 6, laplace_steps: int = 20,
              compute_fe: bool = True, init_state: GPLVMState | None = None, counts=None):
    """``n_iters`` VMP sweeps from ``init_state`` (default: the cold start
    of :func:`gplvm_init_state`). Returns (state, FE), FE 0 in the model
    dtype when ``compute_fe`` is off.

    Each sweep updates q(v) first, from the current latent marginals (at
    the cold start q(v) sits at its whitened prior, where the in-message is
    exactly flat; updating x first would collapse q(x) onto its prior),
    then every q(x_i) by :func:`make_x_update`, the L-BFGS started at the
    current mean."""
    N, D = Y.shape
    Din = x_prior_means.shape[1]
    dt, dev = Y.dtype, Y.device
    sr = quad.SphericalRadial()
    with torch.no_grad():
        cold = _cold_state(_kuu_ssm(kernel, theta, Xu).to(_F64), Y, x_prior_means)
        prior_xi_v, prior_prec_v = cold.xi_v, cold.prec_v
        W = W_val * _eye(D, dt, dev)
        x_prior_prec = _eye(Din, dt, dev) / x_prior_cov_scale
        x_prior_xi = x_prior_means / x_prior_cov_scale
        ones = torch.ones(N, dtype=dt, device=dev)

        state = cold if init_state is None else init_state
        for _ in range(n_iters):
            # 1. q(v) from the current latent marginals; the data sums in
            # the model dtype, the accumulated naturals in f64
            _, psi1_b, Kp, wq = psiops.psi_batch_expected_multi(
                kernel, theta, Xu, sr, state.x_means, state.x_covs)
            sum_psi2 = psiops.sum_weighted_psi2(Kp, wq, ones)
            yW = Y @ W.T
            xi_v = prior_xi_v + torch.einsum("nd,mn->dm", yW, psi1_b).reshape(-1).to(_F64)
            prec_v = prior_prec_v + torch.kron(W, sum_psi2).to(_F64)
            # 2. every q(x_i): the shared Laplace-×-prior update
            update_x = make_x_update(kernel, theta, Xu, xi_v, prec_v, W, x_prior_prec,
                                     laplace_steps, counts)
            new_means, new_covs = update_x(Y, state.x_means, x_prior_xi)
            state = GPLVMState(new_means, new_covs, xi_v, prec_v)

        fe = torch.zeros((), dtype=dt, device=dev)
        if compute_fe:
            fe = gplvm_free_energy(kernel, theta, Xu, Y, state, x_prior_means,
                                   x_prior_cov_scale, W_val)
    return state, fe


def fit_gplvm_grad(kernel, theta0, Xu, Y, x_prior_means, epochs: int = 25, n_iters: int = 6,
                   laplace_steps: int = 20, lbfgs_steps: int = 8,
                   x_prior_cov_scale: float = 100.0, W_val: float = 100.0,
                   init_state: GPLVMState | None = None, counts=None, mstep_counts=None):
    """Gradient GPLVM hyperparameter optimization (generalized EM in place
    of the reference's NelderMead, GPLVM.ipynb cells 16-17). Each epoch:

    - E-step: ``n_iters`` VMP sweeps at the current θ, warm-started from
      the last epoch's state;
    - M-step: ``lbfgs_steps`` steps of ``training.lbfgs_solve`` on the
      θ-terms of the FE with q frozen (q(v) factored once per epoch); the
      θ-constant terms are added back for the reported FE.

    ``init_state`` warm-starts the mean-field state. ``counts`` collects
    the E-step's L-BFGS counts, ``mstep_counts`` the M-step's. Returns (θ,
    state, fe_trace) with fe_trace[e] the FE after epoch e's M-step at that
    epoch's E-step state."""
    dt = Y.dtype
    M = Xu.shape[0]
    D = Y.shape[1]
    theta = theta0
    state = init_state
    if state is None:
        state = gplvm_init_state(kernel, theta0, Xu, Y, x_prior_means)
    fes = []
    for _ in range(epochs):
        state, _ = gplvm_vmp(kernel, theta, Xu, Y, x_prior_means, x_prior_cov_scale, W_val,
                             n_iters=n_iters, laplace_steps=laplace_steps, compute_fe=False,
                             init_state=state, counts=counts)
        with torch.no_grad():
            mu_v, cov_v, R_diag_sum, Lb = _kron_moments(state, M, D, dt)
            const = gplvm_fe_const_terms(state, x_prior_means, Lb, x_prior_cov_scale)

        def obj(th, state=state, mu_v=mu_v, cov_v=cov_v, R_diag_sum=R_diag_sum):
            return gplvm_fe_theta_terms(kernel, th, Xu, Y, state.x_means, state.x_covs,
                                        mu_v, cov_v, R_diag_sum, W_val)

        theta, _ = lbfgs_solve(obj, theta, max_steps=lbfgs_steps, counts=mstep_counts)
        with torch.no_grad():
            fes.append(obj(theta) + const)
    if fes:
        fe_trace = torch.stack(fes)
    else:
        fe_trace = torch.zeros((0,), dtype=_F64, device=Y.device)
    return theta, state, fe_trace


def gplvm_embed(kernel, theta, Xu, Y_new, state: GPLVMState, x_prior_means,
                x_prior_cov_scale: float = 100.0, W_val: float = 100.0, n_iters: int = 3,
                laplace_steps: int = 20, x_start=None):
    """Out-of-sample embedding: q(x*) for new observations ``Y_new`` under
    the trained model, the x-update of :func:`gplvm_vmp` iterated with the
    trained q(v) frozen. ``x_prior_means`` are the per-point prior centres
    (the PCA projections, as for the training latents); ``x_start`` seeds
    the first L-BFGS (default: the prior means); the first ``n_iters`` − 1
    passes polish the starting point. Returns (means (N*, Din), covs (N*,
    Din, Din))."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be ≥ 1 (got {n_iters}): the final pass is the "
                         "embedding; n_iters-1 are polish iterations")
    Din = x_prior_means.shape[1]
    D = Y_new.shape[1]
    dt, dev = Y_new.dtype, Y_new.device
    W = W_val * _eye(D, dt, dev)
    x_prior_prec = _eye(Din, dt, dev) / x_prior_cov_scale
    x_prior_xi = x_prior_means / x_prior_cov_scale
    means = x_prior_means if x_start is None else x_start
    with torch.no_grad():
        # the same x-update map as gplvm_vmp's sweeps, at the trained q(v):
        # trained latents are its fixed points by construction
        update_x = make_x_update(kernel, theta, Xu, state.xi_v, state.prec_v, W,
                                 x_prior_prec, laplace_steps)
        for _ in range(n_iters - 1):
            means = update_x(Y_new, means, x_prior_xi)[0]
        return update_x(Y_new, means, x_prior_xi)
