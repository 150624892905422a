"""State-space (SDE) GP regression: Matérn-5/2 Kalman filtering and RTS
smoothing over a 1-D timeline.

Counterpart of ``gaussianprocessnode_tpu/infer/sde_gp.py`` (Hartikainen &
Särkkä 2010). The Matérn-5/2 prior is exactly the stationary distribution
of the 3-state linear SDE

    df = F f dt + L dβ,   F = [[0,1,0],[0,0,1],[−λ³,−3λ²,−3λ]],
    λ = √5/ℓ,  H = [1,0,0],
    P∞ = σ² [[1, 0, −λ²/3], [0, λ²/3, 0], [−λ²/3, 0, λ⁴]],

so 1-D GP regression is an O(T) forward-backward sweep whose smoothed
marginals and prediction-error log-likelihood equal the dense Matérn-5/2
GP's to float64 round-off. Observations may cover a subset of the
timeline: updates are gated by ``torch.where`` on the mask, as the JAX
package gates them.

The sequential form is the JAX package's two ``lax.scan`` passes as Python
loops over time: per step a handful of batched 3×3 tensor ops, none of which
reads the device from the host. The parts that do not depend on the carry
are taken out of the loops and done once for all steps: the RTS gains
G_k = P_k A_kᵀ (P⁻_{k+1})⁻¹ (one batched Cholesky solve of the T−1 predictive
covariances; the JAX package solves them one by one inside its backward
scan, with the same arithmetic per matrix) and the log-likelihood terms
(from the stacked predictions after the forward loop). The parallel form
(``parallel=True``) runs both passes as associative scans
(``ops/scan.py``), O(log T) rounds of batched 3×3 ops.

Every function takes an optional leading batch shape: θ (..., 2), y, the
mask and a per-point obs_var (..., T) broadcast together against the shared
timeline t (T,), so a bank of chains (the GP-PAD mixtures, the GH nodes of
a lengthscale posterior) runs as one chain of batched steps. The unbatched
call computes what the JAX function computes.
"""

import math
from typing import NamedTuple

import torch

from ..ops.linalg import solve_psd
from ..ops.scan import associative_scan

__all__ = ["matern52_ssm", "sde_gp_smooth", "sde_gp_nlml", "SDEGPResult"]

_TWO_PI = 2.0 * math.pi


class SDEGPResult(NamedTuple):
    mean: torch.Tensor  # (..., T) smoothed posterior mean of f
    var: torch.Tensor  # (..., T) smoothed posterior variance of f
    log_lik: torch.Tensor  # (...) marginal log-likelihood of the observations


def matern52_ssm(theta):
    """(F, P∞, H) of the Matérn-5/2 SDE for θ = [σ², ℓ] (..., 2), the
    parameterisation of ``Kernel("matern52")``: k(τ) = σ²(1 + λτ +
    λ²τ²/3)e^{−λτ}."""
    var, ell = theta[..., 0], theta[..., 1]
    lam = math.sqrt(5.0) / ell
    z = torch.zeros_like(var)
    one = torch.ones_like(var)
    F = torch.stack([
        torch.stack([z, one, z], -1),
        torch.stack([z, z, one], -1),
        torch.stack([-lam**3, -3.0 * lam**2, -3.0 * lam], -1),
    ], -2)
    k2 = var * lam**2 / 3.0
    Pinf = torch.stack([
        torch.stack([var, z, -k2], -1),
        torch.stack([z, k2, z], -1),
        torch.stack([-k2, z, var * lam**4], -1),
    ], -2)
    H = torch.stack([one, z, z], -1)
    return F, Pinf, H


def _discretize(F, Pinf, dts):
    """Per-step transitions A_k = expm(F Δt_k) (..., T−1, 3, 3) and process
    noises Q_k = P∞ − A_k P∞ A_kᵀ (stationarity).

    The exponential is closed form: the companion matrix has the triple
    eigenvalue −λ, so (F + λI)³ = 0 and expm(FΔ) = e^{−λΔ}(I + NΔ +
    N²Δ²/2) with N = F + λI, exact to round-off (the JAX package's form;
    no ``torch.linalg.matrix_exp``)."""
    lam = -F[..., 2, 2] / 3.0
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    N = F + lam[..., None, None] * eye
    N2 = N @ N
    d = dts[..., None, None]
    A = (torch.exp(-lam[..., None, None, None] * d)
         * (eye + N[..., None, :, :] * d + N2[..., None, :, :] * (0.5 * d * d)))
    P = Pinf[..., None, :, :]
    Q = P - A @ P @ A.mT
    return A, Q


def _inputs(theta, t, y, obs_mask, obs_var):
    """θ, the timeline and the observations as tensors on t's device and in
    its dtype, broadcast to one batch shape: y, mask and R (..., T)."""
    dt, dev = t.dtype, t.device
    theta = torch.as_tensor(theta, dtype=dt, device=dev)
    y = torch.as_tensor(y, dtype=dt, device=dev)
    mask = torch.as_tensor(obs_mask, device=dev).to(dt)
    R = torch.as_tensor(obs_var, dtype=dt, device=dev)
    T = t.shape[-1]
    bshape = torch.broadcast_shapes(theta.shape[:-1], y.shape[:-1], mask.shape[:-1],
                                    R.shape[:-1] if R.dim() else ())
    full = bshape + (T,)
    return (theta, y.expand(full), mask.expand(full),
            (R[..., None] if R.dim() == 0 else R).expand(full))


def sde_gp_smooth(theta, t, y, obs_mask, obs_var, parallel: bool = False) -> SDEGPResult:
    """Exact GP regression on a 1-D timeline by Kalman + RTS smoothing.

    ``t``: (T,) increasing timeline (a tensor: its device and dtype are the
    computation's); ``y``: (..., T) observations (entries where ``obs_mask``
    is False are ignored); ``obs_var``: the Gaussian noise variance, a
    scalar or one per point. Returns the smoothed (mean, var) of f at every
    timeline point and the marginal log-likelihood Σ_obs log N(y_k; Hm⁻_k,
    HP⁻_kHᵀ + R_k). ``parallel=True`` runs the associative-scan form (the
    same results to round-off). Both forms are differentiable by autograd.
    """
    theta, y, mask, R = _inputs(theta, t, y, obs_mask, obs_var)
    F, Pinf, _ = matern52_ssm(theta)
    A, Q = _discretize(F, Pinf, torch.diff(t))
    if parallel:
        return _smooth_parallel(A, Q, Pinf, y, mask, R)
    return _smooth_sequential(A, Q, Pinf, y, mask, R)


def _smooth_sequential(A, Q, Pinf, y, mask, R) -> SDEGPResult:
    bshape = y.shape[:-1]
    T = y.shape[-1]
    obs = (mask > 0).unbind(-1)
    ys, Rs = y.unbind(-1), R.unbind(-1)
    As, Qs = A.unbind(-3), Q.unbind(-3)
    m_pred = torch.zeros(bshape + (3,), dtype=y.dtype, device=y.device)
    P_pred = Pinf.expand(bshape + (3, 3))
    mps, Pps, ms, Ps = [m_pred], [P_pred], [], []
    for k in range(T):
        if k:
            Ak = As[k - 1]
            m_pred = (Ak @ ms[-1][..., None])[..., 0]
            P_pred = Ak @ Ps[-1] @ Ak.mT + Qs[k - 1]
            mps.append(m_pred)
            Pps.append(P_pred)
        # update with y_k: H = [1,0,0] makes HPHᵀ, PHᵀ and Hm slices
        s = P_pred[..., 0, 0] + Rs[k]
        gain = P_pred[..., :, 0] / s[..., None]
        resid = ys[k] - m_pred[..., 0]
        m_upd = m_pred + gain * resid[..., None]
        P_upd = P_pred - gain[..., :, None] * gain[..., None, :] * s[..., None, None]
        ok = obs[k]
        ms.append(torch.where(ok[..., None], m_upd, m_pred))
        Ps.append(torch.where(ok[..., None, None], P_upd, P_pred))
    mp, Pp = torch.stack(mps, -2), torch.stack(Pps, -3)
    # Σ_k mask_k·log N(y_k; Hm⁻_k, HP⁻_kHᵀ + R_k), from the stacked
    # predictions (the same s and residuals as the loop's updates)
    s_all = Pp[..., 0, 0] + R
    r_all = y - mp[..., 0]
    ll = torch.sum(mask * (-0.5 * (torch.log(_TWO_PI * s_all) + r_all**2 / s_all)), -1)
    if T == 1:
        return SDEGPResult(ms[0][..., 0], Ps[0][..., 0, 0], ll)
    # RTS gains G_k = P_k A_kᵀ (P⁻_{k+1})⁻¹ for k < T−1, all at once
    Pf = torch.stack(Ps[:-1], -3)
    G = solve_psd(Pp[..., 1:, :, :], A @ Pf).mT
    Gs = G.unbind(-3)
    m_s, P_s = ms[-1], Ps[-1]
    sm, sP = [m_s], [P_s]
    for k in range(T - 2, -1, -1):
        Gk = Gs[k]
        m_s = ms[k] + (Gk @ (m_s - mps[k + 1])[..., None])[..., 0]
        P_s = Ps[k] + Gk @ (P_s - Pps[k + 1]) @ Gk.mT
        sm.append(m_s)
        sP.append(P_s)
    sm.reverse()
    sP.reverse()
    mean = torch.stack([m[..., 0] for m in sm], -1)
    var = torch.stack([P[..., 0, 0] for P in sP], -1)
    return SDEGPResult(mean=mean, var=var, log_lik=ll)


def _inv33(m):
    """Batched closed-form 3×3 inverse (adjugate over determinant), as the
    JAX package computes it. Every matrix inverted here is I + (covariance)·
    (information) or an SPD predictive covariance, well conditioned at the
    smoother's scales."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = e * i - f * h
    c01 = f * g - d * i
    c02 = d * h - e * g
    c10 = c * h - b * i
    c11 = a * i - c * g
    c12 = b * g - a * h
    c20 = b * f - c * e
    c21 = c * d - a * f
    c22 = a * e - b * d
    det = a * c00 + b * c01 + c * c02
    inv = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return inv / det[..., None, None]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _smooth_parallel(A, Q, Pinf, y, mask, R) -> SDEGPResult:
    """Parallel-in-time Kalman filter and RTS smoother by associative scans
    (Särkkä & García-Fernández 2021), the JAX package's ``_smooth_parallel``.

    Filter elements per step k ≥ 1, observed: a_k = (I−K_kH)A_k,
    b_k = K_k y_k, C_k = (I−K_kH)Q_k, η_k = A_kᵀHᵀy_k/S_k,
    J_k = A_kᵀHᵀHA_k/S_k with S_k = HQ_kHᵀ + R_k; masked: (A_k, 0, Q_k, 0,
    0). The k = 0 element folds the stationary prior. The scans run over the
    leading axis, so the time axis is moved to the front and back."""
    dt, dev = y.dtype, y.device
    bshape = y.shape[:-1]
    I3 = torch.eye(3, dtype=dt, device=dev)
    A, Q = A.expand(bshape + A.shape[-3:]), Q.expand(bshape + Q.shape[-3:])
    A, Q = A.movedim(-3, 0), Q.movedim(-3, 0)
    y, mask, R = y.movedim(-1, 0), mask.movedim(-1, 0), R.movedim(-1, 0)
    Pinf = Pinf.expand(bshape + (3, 3))

    S = Q[..., 0, 0] + R[1:]
    K = Q[..., :, 0] / S[..., None]
    HA = A[..., 0, :]
    a_obs = A - K[..., :, None] * HA[..., None, :]
    b_obs = K * y[1:, ..., None]
    C_obs = Q - K[..., :, None] * Q[..., None, 0, :]
    eta_obs = HA * (y[1:] / S)[..., None]
    J_obs = HA[..., :, None] * HA[..., None, :] / S[..., None, None]
    mk = mask[1:] > 0
    zero = torch.zeros((), dtype=dt, device=dev)
    a_el = torch.where(mk[..., None, None], a_obs, A)
    b_el = torch.where(mk[..., None], b_obs, zero)
    C_el = torch.where(mk[..., None, None], C_obs, Q)
    eta_el = torch.where(mk[..., None], eta_obs, zero)
    J_el = torch.where(mk[..., None, None], J_obs, zero)
    S0 = Pinf[..., 0, 0] + R[0]
    K0 = Pinf[..., :, 0] / S0[..., None]
    ok0 = mask[0] > 0
    b0 = torch.where(ok0[..., None], K0 * y[0][..., None], zero)
    C0 = torch.where(ok0[..., None, None],
                     Pinf - K0[..., :, None] * K0[..., None, :] * S0[..., None, None], Pinf)
    z33 = torch.zeros((1,) + bshape + (3, 3), dtype=dt, device=dev)
    z3 = torch.zeros((1,) + bshape + (3,), dtype=dt, device=dev)
    a_el = torch.cat([z33, a_el])
    b_el = torch.cat([b0[None], b_el])
    C_el = torch.cat([C0[None], C_el])
    eta_el = torch.cat([z3, eta_el])
    J_el = torch.cat([z33, J_el])

    def fcomb(e1, e2):
        a1, b1, c1, h1, j1 = e1
        a2, b2, c2, h2, j2 = e2
        a2d = a2 @ _inv33(I3 + c1 @ j2)
        ninv = _inv33(I3 + j2 @ c1)
        a12 = a2d @ a1
        b12 = _mv(a2d, b1 + _mv(c1, h2)) + b2
        c12 = a2d @ c1 @ a2.mT + c2
        t1 = _mv(ninv, h2 - _mv(j2, b1))
        h12 = _mv(a1.mT, t1) + h1
        j12 = (a1.mT @ (ninv @ j2)) @ a1 + j1
        return a12, b12, c12, h12, j12

    _, fm, fP, _, _ = associative_scan(fcomb, (a_el, b_el, C_el, eta_el, J_el))

    # the marginal log-likelihood from the one-step predictives
    mp = torch.cat([z3, _mv(A, fm[:-1])])
    Pp = torch.cat([Pinf[None], A @ fP[:-1] @ A.mT + Q])
    s_pred = Pp[..., 0, 0] + R
    resid = y - mp[..., 0]
    ll = torch.sum(mask * (-0.5) * (torch.log(_TWO_PI * s_pred)
                                    + resid * resid / s_pred), 0)

    # smoother elements (the paper's eq. (21)) and their suffix scan
    G = (_inv33(Pp[1:]) @ (A @ fP[:-1])).mT
    E = torch.cat([G, z33])
    g = torch.cat([fm[:-1] - _mv(G, mp[1:]), fm[-1:]])
    L = torch.cat([fP[:-1] - G @ Pp[1:] @ G.mT, fP[-1:]])

    def scomb(later, earlier):
        # the reverse scan hands the accumulated later suffix first; the
        # smoothing composition is earlier ∘ later
        E1, g1, L1 = later
        E2, g2, L2 = earlier
        return E2 @ E1, _mv(E2, g1) + g2, E2 @ L1 @ E2.mT + L2

    _, sm, sP = associative_scan(scomb, (E, g, L), reverse=True)
    return SDEGPResult(mean=sm[..., 0].movedim(0, -1), var=sP[..., 0, 0].movedim(0, -1),
                       log_lik=ll)


def sde_gp_nlml(theta, t, y, obs_mask, obs_var, parallel: bool = False):
    """Differentiable −log p(y | θ) by the prediction-error decomposition."""
    return -sde_gp_smooth(theta, t, y, obs_mask, obs_var, parallel=parallel).log_lik
