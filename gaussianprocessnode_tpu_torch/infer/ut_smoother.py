"""UT smoother baseline: VMP with a known nonlinear transition.

Counterpart of ``gaussianprocessnode_tpu/infer/ut_smoother.py`` (the
reference's ``VMPsmoothing`` model, Pendulum_Wishart_2d.ipynb cells 26-27):
x_t ~ MvN(g(x_{t-1}), W⁻¹) with the transition g handled by the unscented
transform, y_t ~ MvN(x_t, P), W ~ Wishart, mean-field q(x)∏q(x_t)q(W).

Messages through g use statistical linearisation: propagate q(x_{t-1})
through g with UT sigma points (α = 1, β = 0, κ = 1, not the ``Unscented``
defaults), linearise g(x) ≈ A x + b with A = C_xzᵀ V_x⁻¹, and run the
resulting linear-Gaussian updates. Every t of a sweep is one batched op;
``g`` takes points (..., D) and returns (..., D). The solve for A is
``torch.linalg.solve_ex`` (no error check, so no host sync; a singular V
gives non-finite values, as ``jnp.linalg.solve`` does).
"""

from typing import NamedTuple

import torch

from ..ops.linalg import cholinv, sym
from ..ops.quadrature import ut_points_weights

__all__ = ["UTSmootherState", "ut_smoother_vmp", "ut_one_step_ahead"]


class UTSmootherState(NamedTuple):
    x_means: torch.Tensor  # (T+1, D); index 0 = x_prev
    x_covs: torch.Tensor
    W_df: torch.Tensor
    W_rate: torch.Tensor


def _ut_propagate(g, m, V, alpha=1.0, beta=0.0, kappa=1.0):
    """UT statistics of z = g(x), x ~ N(m, V), for one marginal or a batch
    (m (..., D), V (..., D, D)): returns (m_z, V_z, C_xz)."""
    pts, wm, wc = ut_points_weights(m, V, alpha, beta, kappa)  # pts (..., P, D)
    zs = g(pts)
    mz = torch.einsum("p,...pi->...i", wm, zs)
    dz = zs - mz.unsqueeze(-2)
    dx = pts - m.unsqueeze(-2)
    Vz = torch.einsum("p,...pi,...pj->...ij", wc, dz, dz)
    Cxz = torch.einsum("p,...pi,...pj->...ij", wc, dx, dz)
    return mz, Vz, Cxz


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def ut_smoother_vmp(g, ys, P, prior_x0_mean, prior_x0_cov, prior_W_df, prior_W_scale,
                    init_x_cov_scale: float = 50.0, n_iters: int = 30) -> UTSmootherState:
    """Mean-field VMP smoothing with known dynamics g (UT-linearised), for
    ``n_iters`` Jacobi sweeps from the reference's initialisation."""
    T, D = ys.shape
    dt, dev = ys.dtype, ys.device
    P_inv = cholinv(sym(P))
    obs_xi = ys @ P_inv.T
    S0_inv = cholinv(sym(prior_W_scale))
    prior_x0_prec = cholinv(sym(prior_x0_cov))
    prior_x0_xi = prior_x0_prec @ prior_x0_mean
    eye = torch.eye(D, dtype=dt, device=dev)

    x_means = torch.cat([prior_x0_mean[None], torch.zeros((T, D), dtype=dt, device=dev)], 0)
    x_covs = torch.cat([prior_x0_cov[None], (init_x_cov_scale * eye).expand(T, D, D)], 0)
    state = UTSmootherState(x_means, x_covs, torch.full((), prior_W_df, dtype=dt, device=dev),
                            S0_inv)

    for _ in range(n_iters):
        W_mean = state.W_df * cholinv(sym(state.W_rate))
        # statistical linearisation of g about each q(x_{t-1}): g(x) ≈ A x + b
        m_in, V_in = state.x_means[:-1], state.x_covs[:-1]
        mz, Vz, Cxz = _ut_propagate(g, m_in, V_in)
        A = torch.linalg.solve_ex(sym(V_in), Cxz).result.mT  # C_xzᵀ V⁻¹
        b = mz - _mv(A, m_in)
        # residual covariance of the linearisation (added process spread)
        R = sym(Vz - A @ V_in @ A.mT)

        # forward message to x_t: N(g-propagated mean, Vz + W̄⁻¹)
        W_inv = cholinv(sym(W_mean))
        fwd_prec = cholinv(sym(Vz + W_inv))
        fwd_xi = _mv(fwd_prec, mz)

        # backward message to x_{t-1} from node t (linearised):
        # x_t ≈ N(A x + b, W̄⁻¹ + R) ⇒ prec = Aᵀ S A, ξ = Aᵀ S (μ_t − b)
        S = cholinv(sym(W_inv + R))
        bwd_prec = A.mT @ S @ A
        bwd_xi = _mv(A.mT @ S, state.x_means[1:] - b)

        # q(x_t), t = 1..T-1: forward + observation + backward from node t+1;
        # x_T: forward + observation; x_prev: prior + backward from node 1
        xi = torch.cat([(prior_x0_xi + bwd_xi[0])[None],
                        fwd_xi[:-1] + obs_xi[:-1] + bwd_xi[1:],
                        (fwd_xi[-1] + obs_xi[-1])[None]], 0)
        prec = torch.cat([(prior_x0_prec + bwd_prec[0])[None],
                          fwd_prec[:-1] + P_inv + bwd_prec[1:],
                          (fwd_prec[-1] + P_inv)[None]], 0)
        covs = sym(cholinv(sym(prec)))
        means = _mv(covs, xi)

        # q(W): Wishart update with E[(x_t − g(x_{t-1}))(·)ᵀ] via the linearisation
        d = means[1:] - (_mv(A, means[:-1]) + b)
        E_rr = torch.sum(d.unsqueeze(-1) * d.unsqueeze(-2) + covs[1:]
                         + A @ covs[:-1] @ A.mT + R, dim=0)
        state = UTSmootherState(means, covs,
                                torch.full((), prior_W_df + T, dtype=dt, device=dev),
                                sym(S0_inv + E_rr))
    return state


def ut_one_step_ahead(g, state: UTSmootherState, ys_test, P):
    """Sequential UT predict/update over the test window (reference:
    Pendulum cells 3/36, predict_UT). Returns (pred_means, pred_covs)."""
    W_mean = state.W_df * cholinv(sym(state.W_rate))
    W_inv = cholinv(sym(W_mean))
    P_inv = cholinv(sym(P))
    m, V = state.x_means[-1], state.x_covs[-1]
    pred_means, pred_covs = [], []
    for t in range(ys_test.shape[0]):
        mz, Vz, _ = _ut_propagate(g, m, V)
        pred_cov = sym(Vz + W_inv)
        prec = cholinv(pred_cov) + P_inv
        V = cholinv(sym(prec))
        m = V @ (cholinv(pred_cov) @ mz + P_inv @ ys_test[t])
        pred_means.append(mz)
        pred_covs.append(pred_cov)
    return torch.stack(pred_means), torch.stack(pred_covs)
