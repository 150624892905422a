"""Parallel-in-time GPSSM smoothing: SLR and associative-scan LGSSM sweeps.

Counterpart of ``gaussianprocessnode_tpu/infer/pit_gpssm.py``. The Jacobi
engine (``chain_smoother.gpssm_vmp``) is parallel within a sweep, but
information travels about one chain step per sweep, so a cold start needs
O(correlation length) sweeps. This engine replaces that propagation with
global smoothing sweeps:

  1. statistically linearise the GP transition at the current marginals
     (the Jacobi sweep's spherical-radial points: one Gram over all T·P of
     them): x_t ≈ A_t x_{t-1} + b_t + ε_t, ε_t ~ N(0, Ω_t + W̄⁻¹);
  2. one parallel Kalman filter and RTS smoother of that linear-Gaussian
     chain by two associative scans (Särkkä & García-Fernández 2021;
     ``ops/scan.py::associative_scan``, O(log T) rounds of batched D×D
     ops), so every observation reaches every state in one sweep;
  3. q(v) and q(W) from the smoothed marginals
     (``chain_smoother.chain_qv_qw_updates``, one Gram).

After ``n_pit`` such sweeps the state goes to ``n_polish`` exact Jacobi
sweeps (``gpssm_vmp`` with ``init_state``): the result is a fixed point of
the same mean-field map. Gram launches: 1 (Kuu) + 2 per PIT sweep, then
``gpssm_vmp``'s. No host sync.
"""

import torch

from ..dists import MvGaussianNat
from ..nodes.multisgp import _split_blocks
from ..ops import quadrature as quad
from ..ops.linalg import cholinv, spd_clamp, sym
from ..ops.scan import associative_scan
from .chain_smoother import (
    GPSSMState,
    _cold_state,
    _kuu_inv_f64,
    _qv_stats,
    chain_qv_qw_updates,
    gpssm_free_energy,
    gpssm_vmp,
)
from .sde_gp import _inv33

__all__ = ["gpssm_vmp_pit", "slr_transition", "parallel_lgssm_smooth"]

_SR = quad.SphericalRadial()


def _inv_batched(m):
    """Batched small-D inverse: the closed forms (adjugate over determinant)
    for D ≤ 3, as the JAX package computes them; ``torch.linalg.inv_ex``
    (no error check, no host sync) beyond. Every matrix inverted here is an
    SPD predictive or innovation covariance or I + (cov)·(information)."""
    D = m.shape[-1]
    if D == 1:
        return 1.0 / m
    if D == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, d = m[..., 1, 0], m[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    if D == 3:
        return _inv33(m)
    return torch.linalg.inv_ex(m).inverse


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def slr_transition(kernel, theta, Xu, method, mu_blocks, means, covs,
                   jitter_frac: float = 1e-9):
    """Statistical linear regression of the GP posterior-mean transition
    m(x) = mu_blocks·K(Xu, x) under each q(x_{t-1}) = N(m_t, V_t).

    Returns (A, b, Omega): per-t gain (T, D, D), offset (T, D) and the SLR
    residual Var_q[m] − A V Aᵀ (T, D, D), floored by a relative jitter so
    the filter's innovation stays SPD. One Gram over all T·P points."""
    T, D = means.shape
    pts, w = quad.points_weights_multi(method, means, covs)
    if w.dim() > 1:
        w = w[0]  # identical across t for SR and UT
    P = pts.shape[1]
    K = kernel(theta, Xu, pts.reshape(T * P, D))  # (M, T·P)
    Kp = K.reshape(-1, T, P)
    f = torch.einsum("dm,mtp->tpd", mu_blocks, Kp)  # the transition at each point
    mu_f = torch.einsum("tpd,p->td", f, w)
    dx = pts - means.unsqueeze(1)
    df = f - mu_f.unsqueeze(1)
    C = torch.einsum("tpa,tpb,p->tab", dx, df, w)  # Cov[x, m(x)]
    S_f = torch.einsum("tpa,tpb,p->tab", df, df, w)  # Var[m(x)]
    A = (_inv_batched(sym(covs)) @ C).mT  # Cᵀ V⁻¹
    b = mu_f - _mv(A, means)
    resid = sym(S_f - A @ C)
    tr = torch.diagonal(resid, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(D, dtype=means.dtype, device=means.device)
    omega = resid + jitter_frac * torch.clamp_min(tr, 1.0) * eye
    return A, b, omega


def parallel_lgssm_smooth(A, b, Q, m0, V0, ys, R_obs):
    """Parallel-in-time Kalman filter and RTS smoother of the time-varying
    linear-Gaussian chain with H = I observations at every step:

        x_0 ~ N(m0, V0);  x_t = A_t x_{t-1} + b_t + N(0, Q_t);
        y_t = x_t + N(0, R)                                   t = 1..T

    by two associative scans (Särkkä & García-Fernández 2021, eqs. (10) and
    (21)). A, b, Q are (T, D, D), (T, D), (T, D, D); ``R_obs`` is (D, D).
    Returns the smoothed (means (T+1, D), covs (T+1, D, D)) including the
    t = 0 prior state."""
    T, D = ys.shape
    dt, dev = ys.dtype, ys.device
    I = torch.eye(D, dtype=dt, device=dev)

    # filter elements, k = 1..T (observed, H = I)
    S = Q + R_obs  # innovation covariance given a point-mass predecessor
    Sinv = _inv_batched(S)
    K = Q @ Sinv
    ImK = I - K
    a_el = ImK @ A
    resid0 = ys - b
    b_el = b + _mv(K, resid0)
    C_el = sym(ImK @ Q)
    At = A.mT
    eta_el = _mv(At, _mv(Sinv, resid0))
    J_el = At @ Sinv @ A
    # k = 0: the prior N(m0, V0) (x_prev carries no observation)
    zDD = torch.zeros((1, D, D), dtype=dt, device=dev)
    a_el = torch.cat([zDD, a_el])
    b_el = torch.cat([m0[None], b_el])
    C_el = torch.cat([V0[None], C_el])
    eta_el = torch.cat([torch.zeros((1, D), dtype=dt, device=dev), eta_el])
    J_el = torch.cat([zDD, J_el])

    def fcomb(e1, e2):
        a1, b1, c1, h1, j1 = e1
        a2, b2, c2, h2, j2 = e2
        a2d = a2 @ _inv_batched(I + c1 @ j2)
        ninv = _inv_batched(I + j2 @ c1)
        a12 = a2d @ a1
        b12 = _mv(a2d, b1 + _mv(c1, h2)) + b2
        c12 = a2d @ c1 @ a2.mT + c2
        rhs = h2 - _mv(j2, b1)
        t1 = _mv(ninv, rhs)
        h12 = _mv(a1.mT, t1) + h1
        j12 = (a1.mT @ (ninv @ j2)) @ a1 + j1
        return a12, b12, c12, h12, j12

    _, fm, fP, _, _ = associative_scan(fcomb, (a_el, b_el, C_el, eta_el, J_el))

    # one-step predictives for k = 1..T (from the filtered k-1 state)
    mp = _mv(A, fm[:-1]) + b
    Pp = A @ fP[:-1] @ At + Q

    # smoother elements (eq. (21)): a suffix associative scan
    G = (_inv_batched(sym(Pp)) @ (A @ fP[:-1])).mT
    E = torch.cat([G, zDD])
    g = torch.cat([fm[:-1] - _mv(G, mp), fm[-1][None]])
    L = torch.cat([fP[:-1] - G @ Pp @ G.mT, fP[-1][None]])

    def scomb(later, earlier):
        E1, g1, L1 = later
        E2, g2, L2 = earlier
        return E2 @ E1, _mv(E2, g1) + g2, E2 @ L1 @ E2.mT + L2

    _, sm, sP = associative_scan(scomb, (E, g, L), reverse=True)
    return sm, sym(sP)


def _pit_sweep(kernel, theta, Xu, Kuu_inv, S0_inv, ys, P, prior_x0_mean, prior_x0_cov,
               prior_v, prior_W_df, state: GPSSMState) -> GPSSMState:
    """One SLR + parallel-smooth sweep, then q(v) and q(W). Two Grams."""
    T, D = ys.shape
    M = Xu.shape[0]
    mu_v, _ = _qv_stats(state.xi_v, state.prec_v)
    W_mean = state.W_df * cholinv(sym(state.W_rate))
    W_inv = cholinv(sym(W_mean))
    A, b, omega = slr_transition(kernel, theta, Xu, _SR, _split_blocks(mu_v, M, D),
                                 state.x_means[:-1], state.x_covs[:-1])
    # transition noise: the VMP out-message's W̄⁻¹ plus the SLR residual
    sm, sP = parallel_lgssm_smooth(A, b, omega + W_inv, prior_x0_mean, prior_x0_cov, ys, P)
    # guard the smoothed covariances (the gain's fP − G·Pp·Gᵀ cancellation
    # can leave negative eigenvalues): an eigenvalue clamp at
    # λ ≥ 1e-9·max(tr, 1e-6), far inside the fixed point's tolerance
    trP = torch.diagonal(sP, dim1=-2, dim2=-1).sum(-1)
    sP = spd_clamp(sP, 1e-9 * torch.clamp_min(trP, 1e-6))
    xi_v, prec_v, W_df, W_rate = chain_qv_qw_updates(
        kernel, theta, Xu, _SR, Kuu_inv, prior_v, S0_inv, prior_W_df, T,
        sm[:-1], sP[:-1], sm[1:], sP[1:], W_mean, ys.dtype)
    return GPSSMState(sm, sP, xi_v, prec_v, W_df, W_rate)


def _pit_sweeps(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov, prior_v,
                prior_W_df, prior_W_scale, state0, n_pit):
    """``n_pit`` SLR + parallel-smooth sweeps (the accelerator half)."""
    Kuu_inv = _kuu_inv_f64(kernel, theta, Xu, ys.dtype)
    S0_inv = cholinv(sym(prior_W_scale))
    state = state0
    for _ in range(n_pit):
        state = _pit_sweep(kernel, theta, Xu, Kuu_inv, S0_inv, ys, P, prior_x0_mean,
                           prior_x0_cov, prior_v, prior_W_df, state)
    return state


def gpssm_vmp_pit(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                  prior_v: MvGaussianNat, prior_W_df, prior_W_scale,
                  init_x_cov_scale: float = 50.0, n_pit: int = 4, n_polish: int = 20,
                  compute_fe: bool = True, init_state: GPSSMState | None = None):
    """Parallel-in-time GPSSM inference: ``n_pit`` SLR/parallel-smooth
    sweeps, then ``n_polish`` exact Jacobi sweeps of the mean-field map, so
    the returned state is a fixed point of the same map as ``gpssm_vmp``.
    Returns (GPSSMState, free energy)."""
    if init_state is None:
        init_state = _cold_state(ys, prior_x0_mean, prior_x0_cov, prior_v, prior_W_df,
                                 cholinv(sym(prior_W_scale)), init_x_cov_scale)
    state = _pit_sweeps(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov, prior_v,
                        prior_W_df, prior_W_scale, init_state, n_pit)
    if n_polish > 0:
        return gpssm_vmp(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov, prior_v,
                         prior_W_df, prior_W_scale, n_iters=n_polish,
                         compute_fe=compute_fe, init_state=state)
    fe = torch.zeros((), dtype=ys.dtype, device=ys.device)
    if compute_fe:
        fe = gpssm_free_energy(kernel, theta, Xu, ys, P, prior_x0_mean, prior_x0_cov,
                               prior_v, prior_W_df, prior_W_scale, state)
    return state, fe
