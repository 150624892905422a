"""GPSSM chain smoother: mean-field VMP over a MultiSGP transition chain.

Counterpart of ``gaussianprocessnode_tpu/infer/chain_smoother.py`` (the
reference's reactive chain inference, Pendulum_Wishart_2d.ipynb cells
12-16). Model:

    v ~ MvN(0, 50·I_{MD});  W ~ Wishart(ν₀, S₀);  x₀ ~ MvN(m₀, V₀)
    x_t ~ MultiSGP(x_{t-1}, v, W, θ);  y_t ~ MvN(x_t, P)      t = 1..T

Mean-field q(x₀)∏q(x_t)·q(v)·q(W). One Jacobi sweep updates every q(x_t)
from the previous sweep's marginals (the out-message of node t, the
observation, and the in-message of node t+1 moment-matched by
spherical-radial cubature), then q(v) (Λ = Λ₀ + W̄ ⊗ ΣΨ2_t) and q(W)
(df = ν₀ + T, rate = S₀⁻¹ + Σ_t (I1_t + I2_t)). A Gauss–Seidel sweep
updates q(x_t) in order t = 0..T, each from the fresh q(x_{t-1}).

Where the JAX package vmaps a closure over t, the port batches: the
in-message refinement of all T input marginals (x_prev batched in with the
others) is one moment match of T rows with one Gram 48 × T·4 at the
pendulum's width (``quadrature.moment_match_multi_batch``), and the node
energies of the free energy are ``multisgp.average_energy_batch``. Gram
launches per call, with ``Kernel(use_kernel=True)``, float32 tensors on the
card: ``gpssm_vmp`` 1 (Kuu) + 3 per sweep (in-message Ψ, refinement,
q(v)/q(W) Ψ) + 2 for the free energy (Kuu, node Ψ);
``gpssm_vmp_sequential`` 1 + (2T + 1) per sweep + 2; one per filtered
step.

Precision: the q(v) factorisation (κ(Λ_v) ≳ 1e6) and Kuu⁻¹ are in float64
whatever the state's dtype, cast back (``_qv_stats``, ``_kuu_inv_f64``);
everything else runs in the state's dtype. The JAX package's TPU-only lift
of Λ_v before that factorisation is not ported: it applies only on its TPU
backend, and float64 GEMMs on the card are IEEE.
"""

import math
from typing import NamedTuple

import torch

from ..config import JITTER_KUU_SSM
from ..dists import (
    MvGaussian,
    MvGaussianNat,
    WishartFast,
    _mv_gammaln,
    mv_gaussian_entropy,
    mv_gaussian_entropy_from_prec,
    mv_nat_to_meancov,
    wishart_entropy,
    wishart_mean,
    wishart_mean_logdet,
)
from ..nodes.multisgp import MultiSGPArgs, _split_blocks, average_energy_batch
from ..ops import psi as psiops
from ..ops import quadrature as quad
from ..ops.linalg import (
    chol_lower,
    chol_solve,
    cholinv,
    effective_jitter,
    logdet_from_chol,
    sum_blocks_weighted,
    sym,
)
from .batch_vmp import prior_energy_mvn

__all__ = ["GPSSMState", "chain_qv_qw_updates", "chain_fe_terms", "gpssm_vmp",
           "gpssm_free_energy", "gpssm_vmp_sequential", "GPSSMFilterFrozen",
           "filter_frozen", "CTRL_EPS", "augment_control", "filter_stream",
           "one_step_ahead"]

_LOG2PI = math.log(2.0 * math.pi)
_SR = quad.SphericalRadial()


class GPSSMState(NamedTuple):
    x_means: torch.Tensor  # (T+1, D), index 0 = x_prev
    x_covs: torch.Tensor  # (T+1, D, D)
    xi_v: torch.Tensor  # (M·D,)
    prec_v: torch.Tensor  # (M·D, M·D)
    W_df: torch.Tensor
    W_rate: torch.Tensor  # (D, D) rate matrix (inverse scale)


def _spd_guard_f64(prec):
    """Λ symmetrised in float64, ready to factor (the JAX package's guard
    without its TPU-only lift)."""
    return sym(prec.to(torch.float64))


def _qv_stats(xi, prec):
    """(ξ, Λ) → (μ, Σ) by ``dists.mv_nat_to_meancov``, factored in float64
    whatever the state's dtype, the moments cast back to it: the chain's one
    condition-critical solve (κ(Λ_v) grows to ~1e6 and beyond as ΣΨ2
    accumulates). A no-op cast for float64 states."""
    dt = xi.dtype
    q = mv_nat_to_meancov(MvGaussianNat(xi.to(torch.float64), _spd_guard_f64(prec)))
    return q.mean.to(dt), q.cov.to(dt)


def _identity(x):
    return x


def _kuu_inv_f64(kernel, theta, Xu, dt):
    """Kuu⁻¹ at the state-space jitter, factored in float64 and cast to
    ``dt``. Kuu comes from the kernel in its own dtype; a float32 Gram
    carries ~ε entrywise noise on the pendulum's near-singular grid, so its
    jitter is ``effective_jitter(float32, JITTER_KUU_SSM)`` = 300·ε."""
    K = kernel.kuu(theta, Xu)
    jit = (JITTER_KUU_SSM if K.dtype == torch.float64
           else effective_jitter(K.dtype, JITTER_KUU_SSM))
    return cholinv(K.to(torch.float64), jitter=jit).to(dt)


def chain_qv_qw_updates(kernel, theta, Xu, sr, Kuu_inv, prior_v, S0_inv,
                        prior_W_df, T_global, in_means, in_covs, out_means,
                        out_covs, W_mean, dt, reduce=_identity):
    """The global q(v) and q(W) updates of one chain sweep, shared by the
    Jacobi, Gauss–Seidel, parallel-in-time and controlled engines.
    ``reduce`` folds the per-shard sums over t (the identity on one device;
    a sequence-parallel engine puts its all-reduce there).

    q(v): ξ = ξ₀ + Σ_t (W̄ μ_{x_t}) ⊗ Ψ1_t,  Λ = Λ₀ + W̄ ⊗ ΣΨ2_t
    (MultiSGPnode.jl:290-308); q(W): WishartFast(ν₀+T, S₀⁻¹+ΣI1_t+ΣI2_t)
    (MultiSGPnode.jl:367-405). One Gram over the T·P cubature points of the
    input marginals. Returns (xi_v, prec_v, W_df, W_rate)."""
    M = Xu.shape[0]
    D = W_mean.shape[0]
    T_loc = in_means.shape[0]
    dev = in_means.device
    psi0_in, psi1_in, Kp_in, wq = psiops.psi_batch_expected_multi(
        kernel, theta, Xu, sr, in_means, in_covs)
    sum_psi2 = reduce(psiops.sum_weighted_psi2(Kp_in, wq, torch.ones((T_loc,), dtype=dt,
                                                                     device=dev)))
    yW = out_means @ W_mean.T  # (T_loc, D)
    xi_v = prior_v.xi + reduce(torch.einsum("td,mt->dm", yW, psi1_in).reshape(-1))
    prec_v = prior_v.prec + torch.kron(W_mean.contiguous(), sum_psi2.contiguous())
    mu_v, cov_v = _qv_stats(xi_v, prec_v)
    Rv = cov_v + torch.outer(mu_v, mu_v)
    mu_blocks = _split_blocks(mu_v, M, D)

    KinvK = (Kuu_inv @ Kp_in.reshape(M, -1)).reshape(Kp_in.shape)
    tr_t = torch.sum(Kp_in * KinvK, dim=0) @ wq  # (T_loc,)
    I1_sum = reduce(torch.sum(psi0_in - tr_t)) * torch.eye(D, dtype=dt, device=dev)
    E_t = (mu_blocks @ psi1_in).T  # (T_loc, D)
    Ry_sum = reduce(out_means.T @ out_means + torch.sum(out_covs, 0))
    cross = reduce(out_means.T @ E_t)
    # Σ_t Ψ4_t[i,j] = Σ_{t,p} w_p k_tpᵀ Rv_blk[i,j] k_tp, point by point: in
    # float32, contracting Rv with the summed Ψ2 instead loses ~20× more to
    # the cancellation in I2 (Rv's entries are large against the result)
    Kf = Kp_in.reshape(M, -1)
    RvK = (Rv.reshape(D * M * D, M) @ (Kf * wq.repeat(T_loc))).reshape(D, M, D, -1)
    psi4_sum = reduce(torch.einsum("imjk,mk->ij", RvK, Kf))
    I2_sum = Ry_sum - cross - cross.T + psi4_sum
    W_df = torch.full((), prior_W_df + T_global, dtype=dt, device=dev)
    W_rate = sym(S0_inv + I1_sum + I2_sum)
    return xi_v, prec_v, W_df, W_rate


def chain_fe_terms(kernel, theta, Xu, Kuu_inv, ys_loc, Pobs, prior_x0_mean,
                   prior_x0_cov, prior_v, prior_W_df, prior_W_scale,
                   x0_m, x0_V, means_loc, covs_loc, in_means, in_covs,
                   xi_v, prec_v, W_df, W_rate, sr, reduce=_identity):
    """Bethe free energy of the chain: the node and observation energies
    and the marginal entropies are sums over t (folded by ``reduce``); the
    prior terms (x0, v, W) are whole. The node energies take one Gram."""
    D = ys_loc.shape[1]
    T_loc = ys_loc.shape[0]
    dt = ys_loc.dtype
    args = MultiSGPArgs(theta, Xu, Kuu_inv)
    mu_v, cov_v = _qv_stats(xi_v, prec_v)
    qW = WishartFast(W_df, W_rate)
    W_mean = wishart_mean(qW)
    E_logdet_W = wishart_mean_logdet(qW)

    U_nodes = reduce(torch.sum(average_energy_batch(
        kernel, sr, args, means_loc, covs_loc, MvGaussian(in_means, in_covs),
        mu_v, cov_v, W_mean, E_logdet_W)))
    Lp = chol_lower(sym(Pobs))
    P_inv = cholinv(sym(Pobs))
    d_res = ys_loc - means_loc
    U_obs = reduce(0.5 * (
        T_loc * (D * _LOG2PI + logdet_from_chol(Lp))
        + torch.einsum("td,de,te->", d_res, P_inv, d_res)
        + torch.einsum("de,ted->", P_inv, covs_loc)
    ))
    H_x = (reduce(torch.sum(mv_gaussian_entropy(MvGaussian(means_loc, covs_loc))))
           + mv_gaussian_entropy(MvGaussian(x0_m, x0_V)))

    U_x0 = prior_energy_mvn(x0_m, x0_V, prior_x0_mean, prior_x0_cov)
    mu_p, cov_p = _qv_stats(prior_v.xi, prior_v.prec)
    U_v = prior_energy_mvn(mu_v, cov_v, mu_p, cov_p)
    S0_inv = cholinv(sym(prior_W_scale))
    ld_S0 = logdet_from_chol(chol_lower(sym(prior_W_scale)))
    nu0 = torch.full((), prior_W_df, dtype=dt, device=ys_loc.device)
    U_W = -(
        (nu0 - D - 1.0) / 2.0 * E_logdet_W
        - 0.5 * torch.sum(S0_inv * W_mean.T)
        - nu0 * D / 2.0 * math.log(2.0)
        - nu0 / 2.0 * ld_S0
        - _mv_gammaln(nu0 / 2.0, D)
    )
    # q(v)'s entropy from the held precision Λ_v, factored in float64: the
    # exactly positive-definite matrix, not its approximate inverse
    H_v = mv_gaussian_entropy_from_prec(_spd_guard_f64(prec_v)).to(dt)
    H_W = wishart_entropy(qW)
    return U_nodes + U_obs + U_x0 + U_v + U_W - H_x - H_v - H_W


class _ChainConsts(NamedTuple):
    """What one ``gpssm_vmp`` call computes once for all its sweeps."""

    Kuu_inv: torch.Tensor
    P_inv: torch.Tensor
    obs_xi: torch.Tensor  # (T, D)
    S0_inv: torch.Tensor
    x0_mean: torch.Tensor  # the prior of x_prev, as mean and covariance
    x0_cov: torch.Tensor


def _chain_consts(Kuu_inv, ys, P, prior_x0_mean, prior_x0_cov, prior_W_scale):
    P_inv = cholinv(sym(P))
    prior_x0_prec = cholinv(sym(prior_x0_cov))
    prior_x0_xi = prior_x0_prec @ prior_x0_mean
    return _ChainConsts(
        Kuu_inv, P_inv, ys @ P_inv.T,
        cholinv(sym(prior_W_scale)),
        chol_solve(chol_lower(sym(prior_x0_prec)), prior_x0_xi),
        cholinv(sym(prior_x0_prec)))


def _cold_state(ys, prior_x0_mean, prior_x0_cov, prior_v, prior_W_df, S0_inv,
                init_x_cov_scale):
    """The reference's initialisation (gp_initialization): q(x_t) = MvN(0,
    50·I), q(v) its prior, q(W) = Wishart(ν₀, S₀)."""
    T, D = ys.shape
    dt, dev = ys.dtype, ys.device
    x_means = torch.cat([prior_x0_mean[None, :], torch.zeros((T, D), dtype=dt, device=dev)], 0)
    eye = torch.eye(D, dtype=dt, device=dev)
    x_covs = torch.cat([prior_x0_cov[None], (init_x_cov_scale * eye).expand(T, D, D)], 0)
    return GPSSMState(x_means, x_covs, prior_v.xi, prior_v.prec,
                      torch.full((), prior_W_df, dtype=dt, device=dev), S0_inv)


class _SweepStats(NamedTuple):
    """The state's q(v) and q(W) as a sweep reads them."""

    W_mean: torch.Tensor
    tr_W: torch.Tensor
    A_in: torch.Tensor  # ½tr(W̄)Kuu⁻¹ − ½ΣRv_blk·W̄: the in-message's Ψ2 contraction
    mu_blocks: torch.Tensor  # (D, M)


def _sweep_stats(state: GPSSMState, Kuu_inv, M, D):
    mu_v, cov_v = _qv_stats(state.xi_v, state.prec_v)
    Rv = cov_v + torch.outer(mu_v, mu_v)
    W_mean = state.W_df * cholinv(sym(state.W_rate))
    tr_W = torch.trace(W_mean)
    A_in = 0.5 * tr_W * Kuu_inv - 0.5 * sum_blocks_weighted(Rv, W_mean, D, M)
    return _SweepStats(W_mean, tr_W, A_in, _split_blocks(mu_v, M, D))


def _in_logpdf(kernel, theta, Xu, st: _SweepStats, sdV, u_next=None):
    """log ν(x) of the in-message from each row's successor node,
    −½tr(W̄)k(x,x) + kᵀA_in k + sdVᵀk with k = K(Xu, x), for the (B, P, D)
    points of B rows (sdV (B, M)), one Gram for all of them. ``u_next``
    (B, Dc): the successor step's known control, appended to every point."""

    def logpdf(x):
        if u_next is not None:
            x = torch.cat([x, u_next.unsqueeze(-2).expand(x.shape[:-1] + u_next.shape[-1:])], -1)
        B, P, Din = x.shape
        pts = x.reshape(B * P, Din)
        K = kernel(theta, Xu, pts).T.reshape(B, P, -1)  # (B, P, M)
        psi0 = kernel.diag(theta, pts).reshape(B, P)
        kAk = torch.sum((K @ st.A_in) * K, dim=-1)
        return -0.5 * st.tr_W * psi0 + kAk + torch.einsum("bpm,bm->bp", K, sdV)

    return logpdf


def _gauss_part(st: _SweepStats, c: _ChainConsts, psi1_in):
    """The Gaussian part of every q(x_t): the out-message N(μ_y, W̄⁻¹) of
    node t times the observation. Returns (means (T, D), the shared cov)."""
    D = st.W_mean.shape[0]
    eye = torch.eye(D, dtype=st.W_mean.dtype, device=st.W_mean.device)
    out_means = (st.mu_blocks @ psi1_in).T  # (T, D): Ψ1_tᵀ μ_v^(d)
    xi_g = out_means @ st.W_mean.T + c.obs_xi
    cov_g = sym(chol_solve(chol_lower(sym(st.W_mean + c.P_inv)), eye))
    return xi_g @ cov_g.T, cov_g


def _jacobi_sweep(kernel, theta, Xu, c: _ChainConsts, prior_v, prior_W_df,
                  state: GPSSMState) -> GPSSMState:
    """One Jacobi sweep: every q(x_t) from the previous sweep's marginals,
    then q(v) and q(W). Three Grams."""
    T, D = c.obs_xi.shape
    M = Xu.shape[0]
    dt = c.obs_xi.dtype
    st = _sweep_stats(state, c.Kuu_inv, M, D)
    _, psi1_in, _, _ = psiops.psi_batch_expected_multi(
        kernel, theta, Xu, _SR, state.x_means[:-1], state.x_covs[:-1])
    mean_g, cov_g = _gauss_part(st, c, psi1_in)
    # in-message from node t+1 to x_t, t = 0..T-1 (x_prev and x_1..x_{T-1});
    # its μ_y is the mean of q(x_{t+1})
    sumdiagV = state.x_means[1:] @ st.W_mean.T @ st.mu_blocks  # (T, M)
    m_f = torch.cat([c.x0_mean[None], mean_g[:-1]], 0)
    V_f = torch.cat([c.x0_cov[None], cov_g.expand(T - 1, D, D)], 0)
    m_r, V_r = quad.moment_match_multi_batch(
        _in_logpdf(kernel, theta, Xu, st, sumdiagV), m_f, V_f, _SR)
    # x_T: Gaussian part only
    new_means = torch.cat([m_r, mean_g[-1:]], 0)
    new_covs = torch.cat([V_r, cov_g[None]], 0)
    xi_v, prec_v, W_df, W_rate = chain_qv_qw_updates(
        kernel, theta, Xu, _SR, c.Kuu_inv, prior_v, c.S0_inv, prior_W_df, T,
        new_means[:-1], new_covs[:-1], new_means[1:], new_covs[1:], st.W_mean, dt)
    return GPSSMState(new_means, new_covs, xi_v, prec_v, W_df, W_rate)


def gpssm_vmp(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
              prior_v: MvGaussianNat, prior_W_df, prior_W_scale,
              init_x_cov_scale: float = 50.0, n_iters: int = 10,
              compute_fe: bool = True, init_state: GPSSMState | None = None):
    """Run ``n_iters`` Jacobi mean-field VMP sweeps; returns (GPSSMState,
    free energy), the free energy 0 when ``compute_fe`` is off.
    ``init_state`` warm-starts the sweeps (e.g. from the previous
    hyperparameter epoch) instead of the reference's fresh initialisation.
    No host sync."""
    c = _chain_consts(_kuu_inv_f64(kernel, theta, Xu, ys.dtype), ys, P, prior_x0_mean,
                      prior_x0_cov, prior_W_scale)
    state = init_state
    if state is None:
        state = _cold_state(ys, prior_x0_mean, prior_x0_cov, prior_v, prior_W_df, c.S0_inv,
                            init_x_cov_scale)
    for _ in range(n_iters):
        state = _jacobi_sweep(kernel, theta, Xu, c, prior_v, prior_W_df, state)
    fe = torch.zeros((), dtype=ys.dtype, device=ys.device)
    if compute_fe:
        fe = gpssm_free_energy(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                               prior_v, prior_W_df, prior_W_scale, state)
    return state, fe


def gpssm_free_energy(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                      prior_v: MvGaussianNat, prior_W_df, prior_W_scale,
                      state: GPSSMState):
    """Bethe free energy of the chain under the mean-field q (the dense,
    identity-reduce view of :func:`chain_fe_terms`). Two Grams."""
    Kuu_inv = _kuu_inv_f64(kernel, theta, Xu, ys.dtype)
    return chain_fe_terms(
        kernel, theta, Xu, Kuu_inv, ys, P, prior_x0_mean, prior_x0_cov,
        prior_v, prior_W_df, prior_W_scale,
        state.x_means[0], state.x_covs[0], state.x_means[1:], state.x_covs[1:],
        state.x_means[:-1], state.x_covs[:-1],
        state.xi_v, state.prec_v, state.W_df, state.W_rate, _SR)


# ---------------------------------------------------------------------------
# 1-step-ahead filtering on test data (Pendulum cells 3, 36)
# ---------------------------------------------------------------------------


class GPSSMFilterFrozen(NamedTuple):
    """The filter's constants, recovered from a trained GPSSMState once
    (the q(v) solve is an (M·D)² Cholesky)."""

    mu_blocks: torch.Tensor  # (D, M) posterior mean of v, per output
    pred_cov: torch.Tensor  # (D, D) = W̄⁻¹, the :out rule's predictive cov
    pred_prec: torch.Tensor  # (D, D) its inverse
    P_inv: torch.Tensor  # (D, D) observation precision


def filter_frozen(state: GPSSMState, P) -> GPSSMFilterFrozen:
    """Freeze a trained smoother state into the filter's constants."""
    D = P.shape[0]
    mu_v, _ = _qv_stats(state.xi_v, state.prec_v)
    M = mu_v.shape[0] // D
    W_mean = wishart_mean(WishartFast(state.W_df, state.W_rate))
    W_mean_inv = cholinv(sym(W_mean))
    return GPSSMFilterFrozen(_split_blocks(mu_v, M, D), W_mean_inv,
                             cholinv(sym(W_mean_inv)), cholinv(sym(P)))


CTRL_EPS = 1e-30  # ε variance on known-control input dims (gpssm_control)


def augment_control(m, V, u, eps: float = CTRL_EPS):
    """[m; u] means and blkdiag(V, ε·I) covariances, for one input marginal
    (m (D,), V (D, D), u (Dc,)) or a batch of them along the leading axes:
    the known-control augmentation (``infer/gpssm_control.py``). ε is far
    below round-off, so the σ-point spread on control dims is √ε."""
    D, Dc = m.shape[-1], u.shape[-1]
    m_a = torch.cat([m, u], -1)
    V_a = torch.zeros(V.shape[:-2] + (D + Dc, D + Dc), dtype=m.dtype, device=m.device)
    V_a[..., :D, :D] = V
    V_a[..., D:, D:] = eps * torch.eye(Dc, dtype=m.dtype, device=m.device)
    return m_a, V_a


def filter_stream(kernel, theta, Xu, frozen: GPSSMFilterFrozen, ys, carry, us=None):
    """One filtering window, chainable: predict and update each observation
    from ``carry`` = the previous filtered marginal (mean, cov), and return
    the final carry, so that filter_stream(ys[:k]) then filter_stream(ys[k:],
    carry) equals filter_stream(ys). ``us``: optional (T, Dc) known controls;
    the prediction then evaluates Ψ1 at the control-augmented marginal (Xu
    in D+Dc dims). One Gram (Xu × the 2·Din cubature points) per step, no
    host sync. Returns (pred_means (T, D), pred_covs (T, D, D), carry)."""
    # the update's covariance is the same at every step
    cov = cholinv(sym(frozen.pred_prec + frozen.P_inv))
    m, V = carry
    pred_means = []
    for t in range(ys.shape[0]):
        m_in, V_in = (m, V) if us is None else augment_control(m, V, us[t])
        # PredictState: the MultiSGP :out rule from the previous marginal
        psi1 = psiops.psi1_expected_multi(kernel, theta, Xu, _SR, m_in, V_in)
        pred_mean = frozen.mu_blocks @ psi1
        # UpdateState: the product with the observation message N(y, P)
        m = cov @ (frozen.pred_prec @ pred_mean + frozen.P_inv @ ys[t])
        V = cov
        pred_means.append(pred_mean)
    T, D = ys.shape
    if T == 0:
        return (ys.new_zeros((0, D)), ys.new_zeros((0, D, D)), (m, V))
    return (torch.stack(pred_means), frozen.pred_cov.expand(T, D, D).clone(), (m, V))


def one_step_ahead(kernel, theta, Xu, state: GPSSMState, ys_test, P):
    """Predict/update over one test window from the smoother's last
    marginal (Pendulum cells 3, 36): a view of :func:`filter_stream` (use
    it, or ``serve.GPSSMFilter``, to chain windows). Returns (pred_means,
    pred_covs)."""
    frozen = filter_frozen(state, P)
    pred_means, pred_covs, _ = filter_stream(
        kernel, theta, Xu, frozen, ys_test, (state.x_means[-1], state.x_covs[-1]))
    return pred_means, pred_covs


# ---------------------------------------------------------------------------
# Gauss–Seidel engine
# ---------------------------------------------------------------------------


def _sequential_sweep(kernel, theta, Xu, c: _ChainConsts, ys, prior_v, prior_W_df,
                      state: GPSSMState) -> GPSSMState:
    """One Gauss–Seidel sweep: q(x_0), then q(x_t) for t = 1..T in order,
    each from the fresh q(x_{t-1}); then q(v) and q(W). Two Grams per t
    (the out-message's Ψ1 and the in-message's moment match; q(x_T) has no
    successor, so one there, where the JAX scan computes the match and
    discards it), one for x_prev and one for q(v)/q(W)."""
    T, D = ys.shape
    M = Xu.shape[0]
    dt = ys.dtype
    st = _sweep_stats(state, c.Kuu_inv, M, D)

    def refine(mean, cov, succ_mean):
        sdV = ((st.W_mean @ succ_mean) @ st.mu_blocks)[None]
        logpdf = _in_logpdf(kernel, theta, Xu, st, sdV)
        return quad.moment_match_multi(lambda x: logpdf(x[None])[0], mean, cov, method=_SR)

    # x_prev: prior × in-message from node 1 (μ_y = the current q(x_1))
    m, V = refine(c.x0_mean, c.x0_cov, state.x_means[1])
    means, covs = [m], [V]
    cov_g = cholinv(sym(st.W_mean + c.P_inv))
    for t in range(T):
        # out-message through node t+1 from the fresh predecessor marginal
        psi1 = psiops.psi1_expected_multi(kernel, theta, Xu, _SR, m, V)
        mean_g = cov_g @ (st.W_mean @ (st.mu_blocks @ psi1) + c.P_inv @ ys[t])
        # in-message from the successor node, which q(x_T) has not
        m, V = (mean_g, cov_g) if t == T - 1 else refine(mean_g, cov_g, state.x_means[t + 2])
        means.append(m)
        covs.append(V)
    new_means, new_covs = torch.stack(means), torch.stack(covs)
    xi_v, prec_v, W_df, W_rate = chain_qv_qw_updates(
        kernel, theta, Xu, _SR, c.Kuu_inv, prior_v, c.S0_inv, prior_W_df, T,
        new_means[:-1], new_covs[:-1], new_means[1:], new_covs[1:], st.W_mean, dt)
    return GPSSMState(new_means, new_covs, xi_v, prec_v, W_df, W_rate)


def gpssm_vmp_sequential(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                         prior_v: MvGaussianNat, prior_W_df, prior_W_scale,
                         init_x_cov_scale: float = 50.0, n_iters: int = 10,
                         compute_fe: bool = True, init_state: GPSSMState | None = None):
    """Gauss–Seidel variant of :func:`gpssm_vmp`: per sweep, q(x_t) updates
    in order t = 0..T, each from the freshly updated q(x_{t-1}), the
    convergence behaviour of the reference's reactive schedule (one sweep ≈
    several Jacobi sweeps). Serial in t, as the JAX scan is. Returns
    (GPSSMState, free energy)."""
    c = _chain_consts(_kuu_inv_f64(kernel, theta, Xu, ys.dtype), ys, P, prior_x0_mean,
                      prior_x0_cov, prior_W_scale)
    state = init_state
    if state is None:
        state = _cold_state(ys, prior_x0_mean, prior_x0_cov, prior_v, prior_W_df, c.S0_inv,
                            init_x_cov_scale)
    for _ in range(n_iters):
        state = _sequential_sweep(kernel, theta, Xu, c, ys, prior_v, prior_W_df, state)
    fe = torch.zeros((), dtype=ys.dtype, device=ys.device)
    if compute_fe:
        fe = gpssm_free_energy(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                               prior_v, prior_W_df, prior_W_scale, state)
    return state, fe
