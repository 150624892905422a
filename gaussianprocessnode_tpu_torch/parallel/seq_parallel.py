"""Sequence-parallel GPSSM smoothing over ranks (time-axis sharding).

Counterpart of ``gaussianprocessnode_tpu/parallel/seq_parallel.py``. The
Jacobi smoother (``infer/chain_smoother.py::gpssm_vmp``) updates every
q(x_t) from the previous sweep's neighbours, so the time axis shards:

- each rank owns a contiguous block of T/P steps (the marginals q(x_t),
  the observations y_t and their cubature Ψ-statistics);
- the only dependencies across t are nearest-neighbour: node t reads the
  mean and covariance of x_{t−1} (its input edge) and the mean of x_{t+1}
  (the in-message from its successor), one (mean, cov) halo from the left
  neighbour and one mean halo from the right per sweep
  (``comm.halo_from_left`` / ``halo_from_right``; rank 0 and the last
  rank receive zeros and post nothing on their open side);
- the q(v) and q(W) updates and the free energy's data terms are sums over
  t, all-reduced through the ``reduce`` hooks of
  ``chain_smoother.chain_qv_qw_updates`` and ``chain_fe_terms``, then
  solved on every rank.

x_prev (index 0 of the state) is replicated. Its refinement reads the old
mean of x_1, which rank 0 owns, so rank 0 refines it in the batch of its
own rows (the refinement is ``quadrature.moment_match_multi_batch``, as in
the single-device sweep) and a masked all-reduce hands the result to every
rank, which keeps x_prev bit-equal across ranks. At world size 1 a sweep
is the single-device Jacobi sweep, op for op.
"""

import torch

from ..infer.chain_smoother import (_SR, GPSSMState, _chain_consts, _gauss_part, _in_logpdf,
                                    _kuu_inv_f64, _sweep_stats, chain_fe_terms,
                                    chain_qv_qw_updates)
from ..ops import psi as psiops
from ..ops import quadrature as quad
from .comm import (all_gather_rows, all_reduce_sum, halo_from_left, halo_from_right, rank,
                   rank_slice, world_size)

__all__ = ["gpssm_vmp_sp", "shard_chain_data", "gather_sp_state"]


def shard_chain_data(ys, group=None):
    """This rank's contiguous block of the observation sequence (T, D)
    along time; T must divide evenly over the group's ranks."""
    return rank_slice(ys, 0, group,
                      "chain length T={size} is not divisible by the {n} ranks; pad or trim "
                      "the sequence (e.g. 296 instead of 300 on 8 ranks)")


def _input_edges(x0_m, x0_V, means_loc, covs_loc, group):
    """The marginals of each local node's input edge x_{t−1}: the left
    neighbour's last marginal (x_prev on rank 0), then the block shifted
    by one. One exchange carries the mean and the covariance."""
    D = means_loc.shape[1]
    h = halo_from_left(torch.cat([means_loc[-1], covs_loc[-1].reshape(-1)]), group)
    pm, pV = (x0_m, x0_V) if rank(group) == 0 else (h[:D], h[D:].reshape(D, D))
    return (torch.cat([pm[None], means_loc[:-1]], 0),
            torch.cat([pV[None], covs_loc[:-1]], 0))


def gpssm_vmp_sp(kernel, theta, Xu, ys, Pobs, prior_x0_mean, prior_x0_cov, prior_v,
                 prior_W_df, prior_W_scale, group=None, init_x_cov_scale: float = 50.0,
                 n_iters: int = 10, compute_fe: bool = True,
                 init_state: GPSSMState | None = None):
    """Sequence-parallel ``gpssm_vmp``: ``ys`` is this rank's block of the
    observations (:func:`shard_chain_data`); ``init_state`` a whole
    single-device state (T+1 rows, index 0 = x_prev; e.g. from
    ``convert.gpssm_state_from_jax``), of which each rank takes its rows.
    Returns ``(GPSSMState, free energy)`` in the single-device layout,
    gathered on every rank (the chain state is small; only the work per
    sweep is sharded). Gram launches: 1 (Kuu) + 3 per sweep + 1 for the
    free energy."""
    T_loc, D = ys.shape
    P, r = world_size(group), rank(group)
    T = T_loc * P
    M = Xu.shape[0]
    dt, dev = ys.dtype, ys.device
    is_first, is_last = r == 0, r == P - 1

    def reduce(v):
        return all_reduce_sum(v, group)

    Kuu_inv = _kuu_inv_f64(kernel, theta, Xu, dt)
    c = _chain_consts(Kuu_inv, ys, Pobs, prior_x0_mean, prior_x0_cov, prior_W_scale)
    if init_state is None:
        x0_m, x0_V = prior_x0_mean, prior_x0_cov
        means = torch.zeros((T_loc, D), dtype=dt, device=dev)
        covs = (init_x_cov_scale * torch.eye(D, dtype=dt, device=dev)).expand(T_loc, D, D)
        xi_v, prec_v = prior_v.xi, prior_v.prec
        W_df = torch.full((), prior_W_df, dtype=dt, device=dev)
        W_rate = c.S0_inv
    else:
        x0_m, x0_V = init_state.x_means[0], init_state.x_covs[0]
        rows = slice(1 + r * T_loc, 1 + (r + 1) * T_loc)
        means, covs = init_state.x_means[rows], init_state.x_covs[rows]
        xi_v, prec_v = init_state.xi_v, init_state.prec_v
        W_df, W_rate = init_state.W_df, init_state.W_rate
    # rows of this block whose in-message is refined: all but the global x_T
    n_ref = T_loc - 1 if is_last else T_loc

    for _ in range(n_iters):
        st = _sweep_stats(GPSSMState(None, None, xi_v, prec_v, W_df, W_rate), Kuu_inv, M, D)
        in_means, in_covs = _input_edges(x0_m, x0_V, means, covs, group)
        _, psi1_in, _, _ = psiops.psi_batch_expected_multi(kernel, theta, Xu, _SR, in_means,
                                                           in_covs)
        mean_g, cov_g = _gauss_part(st, c, psi1_in)
        # successor means for the in-messages: the block shifted by one and
        # the right neighbour's first (zeros on the last rank, whose last
        # row, x_T, has no successor and is not refined)
        succ = torch.cat([means[1:], halo_from_right(means[0], group)[None]], 0)
        m_f, V_f = mean_g[:n_ref], cov_g.expand(n_ref, D, D)
        if is_first:
            # x_prev: prior × in-message from node 1, whose μ_y is the old
            # mean of x_1, refined first in rank 0's batch
            succ = torch.cat([means[:1], succ], 0)
            m_f = torch.cat([c.x0_mean[None], m_f], 0)
            V_f = torch.cat([c.x0_cov[None], V_f], 0)
        sdV = succ[:m_f.shape[0]] @ st.W_mean.T @ st.mu_blocks  # (rows, M)
        m_r, V_r = quad.moment_match_multi_batch(
            _in_logpdf(kernel, theta, Xu, st, sdV), m_f, V_f, _SR)
        if is_first:
            x0_new, m_r, V_r = torch.cat([m_r[0], V_r[0].reshape(-1)]), m_r[1:], V_r[1:]
        else:
            x0_new = torch.zeros(D + D * D, dtype=dt, device=dev)
        x0_new = reduce(x0_new)  # masked: only rank 0 contributes
        x0_m, x0_V = x0_new[:D], x0_new[D:].reshape(D, D)
        if is_last:
            means = torch.cat([m_r, mean_g[-1:]], 0)
            covs = torch.cat([V_r, cov_g[None]], 0)
        else:
            means, covs = m_r, V_r
        in_means, in_covs = _input_edges(x0_m, x0_V, means, covs, group)
        xi_v, prec_v, W_df, W_rate = chain_qv_qw_updates(
            kernel, theta, Xu, _SR, Kuu_inv, prior_v, c.S0_inv, prior_W_df, T, in_means,
            in_covs, means, covs, st.W_mean, dt, reduce=reduce)

    fe = torch.zeros((), dtype=dt, device=dev)
    if compute_fe:
        in_means, in_covs = _input_edges(x0_m, x0_V, means, covs, group)
        fe = chain_fe_terms(kernel, theta, Xu, Kuu_inv, ys, Pobs, prior_x0_mean, prior_x0_cov,
                            prior_v, prior_W_df, prior_W_scale, x0_m, x0_V, means, covs,
                            in_means, in_covs, xi_v, prec_v, W_df, W_rate, _SR,
                            reduce=reduce)
    state = gather_sp_state(x0_m, x0_V, means, covs, xi_v, prec_v, W_df, W_rate, group)
    return state, fe


def gather_sp_state(x0_m, x0_V, means_loc, covs_loc, xi_v, prec_v, W_df, W_rate,
                    group=None) -> GPSSMState:
    """The single-device GPSSMState layout (T+1 rows, index 0 = x_prev) from
    the ranks' blocks, gathered on every rank."""
    return GPSSMState(
        torch.cat([x0_m[None], all_gather_rows(means_loc, group)], 0),
        torch.cat([x0_V[None], all_gather_rows(covs_loc, group)], 0),
        xi_v, prec_v, W_df, W_rate)
