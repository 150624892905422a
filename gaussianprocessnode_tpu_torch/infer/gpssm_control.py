"""Controlled GPSSM: chain smoothing and filtering when the GP transition
takes a known control input, x_t ~ GP([x_{t-1}; u_t]) + noise.

Counterpart of ``gaussianprocessnode_tpu/infer/gpssm_control.py`` (the
reference's legacy ``GPTransitionControl`` node, GPSSM_realdata-checkpoint
cells 11-21). The control enters as an augmentation of the input marginal
of step t: mean [m_{x_{t-1}}; u_t], covariance blkdiag(V_{x_{t-1}}, ε·I)
with ε = 1e-30, so the chain's Ψ-statistics and its q(v)/q(W) and
free-energy cores run unchanged on the augmented arrays, with the inducing
inputs in D+Dc dimensions. The in-message refinement moment-matches over
the state dimensions only, with the successor step's control pinned inside
the log-density. Gram launches per call, as ``gpssm_vmp``'s: 1 (Kuu) + 3
per sweep (48 × T·4 × (D+Dc) each at the pendulum's width) + 2 for the
free energy. Unlike the uncontrolled chain, Kuu⁻¹ is factored in the
model's dtype at the state-space jitter, as in the JAX package.
"""

import torch

from ..config import JITTER_KUU_SSM
from ..dists import MvGaussianNat
from ..ops import psi as psiops
from ..ops import quadrature as quad
from ..ops.linalg import cholinv
from .chain_smoother import (
    GPSSMState,
    _chain_consts,
    _cold_state,
    _gauss_part,
    _in_logpdf,
    _sweep_stats,
    augment_control,
    chain_fe_terms,
    chain_qv_qw_updates,
    filter_frozen,
    filter_stream,
)

__all__ = ["gpssm_control_vmp", "gpssm_control_free_energy", "one_step_ahead_control"]

_SR = quad.SphericalRadial()


def _kuu_inv(kernel, theta, Xu):
    return cholinv(kernel.kuu(theta, Xu), jitter=JITTER_KUU_SSM)


def _control_sweep(kernel, theta, Xu, c, us, prior_v, prior_W_df,
                   state: GPSSMState) -> GPSSMState:
    """One Jacobi sweep of the controlled chain. Three Grams."""
    T, D = c.obs_xi.shape
    M = Xu.shape[0]
    st = _sweep_stats(state, c.Kuu_inv, M, D)
    in_m, in_V = augment_control(state.x_means[:-1], state.x_covs[:-1], us)
    _, psi1_in, _, _ = psiops.psi_batch_expected_multi(kernel, theta, Xu, _SR, in_m, in_V)
    mean_g, cov_g = _gauss_part(st, c, psi1_in)
    sumdiagV = state.x_means[1:] @ st.W_mean.T @ st.mu_blocks  # (T, M)
    # x_prev: prior × in-message from node 1 (control u_1 = us[0]);
    # x_1..x_{T-1}: Gaussian part × in-message from node t+1 (control us[t])
    m_f = torch.cat([c.x0_mean[None], mean_g[:-1]], 0)
    V_f = torch.cat([c.x0_cov[None], cov_g.expand(T - 1, D, D)], 0)
    m_r, V_r = quad.moment_match_multi_batch(
        _in_logpdf(kernel, theta, Xu, st, sumdiagV, u_next=us), m_f, V_f, _SR)
    new_means = torch.cat([m_r, mean_g[-1:]], 0)
    new_covs = torch.cat([V_r, cov_g[None]], 0)
    in_m2, in_V2 = augment_control(new_means[:-1], new_covs[:-1], us)
    xi_v, prec_v, W_df, W_rate = chain_qv_qw_updates(
        kernel, theta, Xu, _SR, c.Kuu_inv, prior_v, c.S0_inv, prior_W_df, T,
        in_m2, in_V2, new_means[1:], new_covs[1:], st.W_mean, c.obs_xi.dtype)
    return GPSSMState(new_means, new_covs, xi_v, prec_v, W_df, W_rate)


def gpssm_control_vmp(kernel, theta, Xu, ys, us, P, prior_x0_mean, prior_x0_cov,
                      prior_v: MvGaussianNat, prior_W_df, prior_W_scale,
                      init_x_cov_scale: float = 50.0, n_iters: int = 10,
                      compute_fe: bool = True, init_state: GPSSMState | None = None):
    """Jacobi mean-field VMP of the controlled chain: Xu (M, D+Dc) inducing
    inputs over state ⊕ control, ys (T, D), us (T, Dc) the control driving
    each transition x_{t-1} → x_t. Returns (GPSSMState, free energy)."""
    c = _chain_consts(_kuu_inv(kernel, theta, Xu), ys, P, prior_x0_mean, prior_x0_cov,
                      prior_W_scale)
    state = init_state
    if state is None:
        state = _cold_state(ys, prior_x0_mean, prior_x0_cov, prior_v, prior_W_df, c.S0_inv,
                            init_x_cov_scale)
    for _ in range(n_iters):
        state = _control_sweep(kernel, theta, Xu, c, us, prior_v, prior_W_df, state)
    fe = torch.zeros((), dtype=ys.dtype, device=ys.device)
    if compute_fe:
        fe = gpssm_control_free_energy(kernel, theta, Xu, ys, us, P, prior_x0_mean,
                                       prior_x0_cov, prior_v, prior_W_df, prior_W_scale, state)
    return state, fe


def gpssm_control_free_energy(kernel, theta, Xu, ys, us, P, prior_x0_mean, prior_x0_cov,
                              prior_v, prior_W_df, prior_W_scale, state: GPSSMState):
    """Bethe free energy of the controlled chain: ``chain_fe_terms`` on the
    control-augmented input marginals (the state entropies are unchanged:
    the ε-variance control dims belong to no q factor). Two Grams."""
    in_m, in_V = augment_control(state.x_means[:-1], state.x_covs[:-1], us)
    return chain_fe_terms(
        kernel, theta, Xu, _kuu_inv(kernel, theta, Xu), ys, P, prior_x0_mean, prior_x0_cov,
        prior_v, prior_W_df, prior_W_scale,
        state.x_means[0], state.x_covs[0], state.x_means[1:], state.x_covs[1:],
        in_m, in_V, state.xi_v, state.prec_v, state.W_df, state.W_rate, _SR)


def one_step_ahead_control(kernel, theta, Xu, state: GPSSMState, ys_test, us_test, P):
    """Predict/update over a test window with known controls: the MultiSGP
    :out rule at [m_prev; u_t], then the Gaussian observation update (a
    view of ``chain_smoother.filter_stream`` with ``us``). Returns
    (pred_means, pred_covs)."""
    frozen = filter_frozen(state, P)
    pred_means, pred_covs, _ = filter_stream(
        kernel, theta, Xu, frozen, ys_test, (state.x_means[-1], state.x_covs[-1]), us=us_test)
    return pred_means, pred_covs
