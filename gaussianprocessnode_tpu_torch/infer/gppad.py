"""GP probabilistic amplitude demodulation (GP-PAD): recover a slow
log-amplitude GP envelope from an amplitude-modulated signal.

Counterpart of ``gaussianprocessnode_tpu/infer/gppad.py`` (the reference's
legacy PAD notebooks). The model is

    f ~ Matérn-5/2 GP (the state-space chain of ``infer/sde_gp.py``),
    y_t = c_t · exp(f_t),  carrier c_t ~ N(0, σ_c²),

so p(y_t | f_t) = N(y_t; 0, σ_c² e^{2 f_t}). Inference is parallel EP over
the chain: Gaussian sites (λ₁ₜ, λ₂ₜ) stand in for the likelihoods; one
iteration is a Kalman/RTS sweep with the sites as heteroscedastic
pseudo-observations, a GH tilt of every cavity against the exact likelihood
(``moment_match_uni`` on all T sites at once, each with its own
stabilising max and fallback, where the JAX package vmaps the single-site
rule) and a damped site update. The update is branchless: a site without a
valid cavity, a non-finite tilt or a precision outside (0, 1e12) keeps its
previous value, and the tilted variance is floored at 1e-13 so that the
rejected branch puts no NaN into a gradient.

The colored-carrier variant (:func:`gppad_colored_infer`) makes the carrier
a Matérn-5/2 GP too, y_t = c_t·e^{f_t} + σ_y ε, and alternates an exact
carrier chain sweep with the f-site EP update under the re-localised
:func:`two_stage_tilt`.

θ may carry a leading batch shape (..., 2), with y (..., T) and a carrier
variance (...) broadcast against it: a bank of models runs as one batched
chain.
"""

import math
from typing import NamedTuple

import torch

from ..ops.quadrature import moment_match_uni
from .sde_gp import SDEGPResult, sde_gp_smooth

__all__ = ["PADState", "gppad_infer", "pad_loglik", "ColoredPADState", "gppad_colored_infer",
           "colored_pad_loglik", "colored_pad_sweep", "two_stage_tilt"]

_TWO_PI = 2.0 * math.pi


class PADState(NamedTuple):
    mean: torch.Tensor  # (..., T) smoothed posterior mean of the log-envelope f
    var: torch.Tensor  # (..., T) smoothed posterior variance of f
    lam1: torch.Tensor  # (..., T) site natural mean parameters
    lam2: torch.Tensor  # (..., T) site precisions
    envelope: torch.Tensor  # (..., T) E[e^f] = exp(mean + var/2)
    site_delta: torch.Tensor  # (..., iters) max |Δλ₂| per iteration


def pad_loglik(y, f, carrier_var):
    """Exact log p(y | f) = log N(y; 0, σ_c² e^{2f}), elementwise."""
    v = carrier_var * torch.exp(2.0 * f)
    return -0.5 * (torch.log(_TWO_PI * v) + y * y / v)


def _pseudo_obs(lam1, lam2, lam2_floor):
    """The sites as heteroscedastic pseudo-observations: (z, R, active)."""
    r = 1.0 / torch.clamp_min(lam2, lam2_floor)
    return lam1 * r, r, lam2 > lam2_floor


def _ep_update(m, v, lam1, lam2, tilt, damping):
    """One damped parallel-EP site update from the smoothed marginals (m,
    v): delete each site, tilt every cavity (``tilt(m_cav, v_cav)``), and
    accept the candidate sites where they are valid."""
    # a site whose precision reached the marginal's has no valid cavity:
    # clamping alone would inflate m_cav by ~1e12, so it is frozen
    raw_prec_cav = 1.0 / v - lam2
    cav_ok = raw_prec_cav > 1e-12
    prec_cav = torch.clamp_min(raw_prec_cav, 1e-12)
    v_cav = 1.0 / prec_cav
    m_cav = (m / v - lam1) * v_cav
    m_t, v_t = tilt(m_cav, v_cav)
    # derivative-safe floor: the reciprocal of a smaller variance would be
    # rejected by the ceiling anyway, but its unbounded derivative would
    # reach the rejection's VJP as 0·inf
    v_t = torch.clamp_min(v_t, 1e-13)
    lam2_new = 1.0 / v_t - prec_cav
    lam1_new = m_t / v_t - m_cav * prec_cav
    # the 1e12 ceiling mirrors the reference's clamp(·, 1e-12, 1e12)
    ok = (cav_ok & torch.isfinite(lam1_new) & torch.isfinite(lam2_new)
          & (lam2_new > 0) & (lam2_new < 1e12))
    lam1_new = torch.where(ok, lam1_new, lam1)
    lam2_new = torch.where(ok, lam2_new, lam2)
    return ((1.0 - damping) * lam1 + damping * lam1_new,
            (1.0 - damping) * lam2 + damping * lam2_new)


def _sites(sites0, shape, dt, dev):
    if sites0 is None:
        z = torch.zeros(shape, dtype=dt, device=dev)
        return z, z.clone()
    return (torch.as_tensor(sites0[0], dtype=dt, device=dev).expand(shape),
            torch.as_tensor(sites0[1], dtype=dt, device=dev).expand(shape))


def gppad_infer(theta, t, y, carrier_var=1.0, iters: int = 20, damping: float = 0.5,
                n_gh: int = 61, lam2_floor: float = 1e-10, sites0=None,
                parallel: bool = False) -> PADState:
    """Parallel-EP GP-PAD on t's device and dtype. θ = [σ², ℓ] of the
    Matérn-5/2 log-envelope prior; ``carrier_var`` σ_c²; ``sites0`` an
    optional (λ₁, λ₂) warm start. Returns the smoothed log-envelope
    posterior and the per-iteration site movement."""
    dt, dev = t.dtype, t.device
    theta = torch.as_tensor(theta, dtype=dt, device=dev)
    y = torch.as_tensor(y, dtype=dt, device=dev)
    cv = torch.as_tensor(carrier_var, dtype=dt, device=dev)
    shape = torch.broadcast_shapes(theta.shape[:-1], y.shape[:-1], cv.shape) + (y.shape[-1],)
    y = y.expand(shape)
    yp, cvp = y[..., None], cv[..., None, None]

    def tilt(m_cav, v_cav):
        return moment_match_uni(lambda f: pad_loglik(yp, f, cvp), m_cav, v_cav, n=n_gh)

    lam1, lam2 = _sites(sites0, shape, dt, dev)
    deltas = []
    for _ in range(iters):
        z, r, mask = _pseudo_obs(lam1, lam2, lam2_floor)
        res = sde_gp_smooth(theta, t, z, mask, r, parallel=parallel)
        lam1, lam2_new = _ep_update(res.mean, res.var, lam1, lam2, tilt, damping)
        deltas.append(torch.amax(torch.abs(lam2_new - lam2), dim=-1))
        lam2 = lam2_new
    z, r, mask = _pseudo_obs(lam1, lam2, lam2_floor)
    res = sde_gp_smooth(theta, t, z, mask, r, parallel=parallel)
    delta = (torch.stack(deltas, -1) if deltas
             else torch.zeros(shape[:-1] + (0,), dtype=dt, device=dev))
    return PADState(mean=res.mean, var=res.var, lam1=lam1, lam2=lam2,
                    envelope=torch.exp(res.mean + 0.5 * res.var), site_delta=delta)


class ColoredPADState(NamedTuple):
    f_mean: torch.Tensor  # (..., T) smoothed log-envelope posterior mean
    f_var: torch.Tensor  # (..., T)
    c_mean: torch.Tensor  # (..., T) smoothed carrier posterior mean
    c_var: torch.Tensor  # (..., T)
    envelope: torch.Tensor  # (..., T) E[e^f]
    site_delta: torch.Tensor  # (..., iters) max |Δλ₂| on the f-sites
    lam1: torch.Tensor  # (..., T) f-site natural mean parameters
    lam2: torch.Tensor  # (..., T) f-site precisions


def colored_pad_loglik(y, f, mc, vc, obs_var):
    """E_q(c)[log N(y; c·e^f, σ_y²)] up to f-constants, the carrier
    marginalised under its Gaussian posterior q(c_t) = N(mc, vc)."""
    g = torch.exp(f)
    return (y * mc * g - 0.5 * (mc * mc + vc) * g * g) / obs_var


def two_stage_tilt(ll, m, v, n: int = 61):
    """Moment-match N(m, v)·exp(ll) with a re-localised second pass, for a
    batch of products (m, v of any shape; ``ll`` takes the (..., n) points
    of all of them). Pass 1 estimates the tilted moments; pass 2 evaluates
    the same product on a grid centred there through the importance
    identity q₁·exp(ll + log N_cav − log N_q₁) ∝ N_cav·exp(ll). The pass-1
    variance is floored at 1e-12: a near-delta likelihood can collapse the
    product onto one GH node, and pass 2's (f−m₁)²/(2v₁) would then put
    under- or overflow into every gradient through the tilt."""
    m1, v1 = moment_match_uni(ll, m, v, n=n)
    v1 = torch.clamp_min(v1, 1e-12)
    mb, vb, m1b, v1b = m[..., None], v[..., None], m1[..., None], v1[..., None]

    def ll2(f):
        return ll(f) - (f - mb) ** 2 / (2.0 * vb) + (f - m1b) ** 2 / (2.0 * v1b)

    return moment_match_uni(ll2, m1, v1, n=n)


class _Carrier(NamedTuple):
    eg: torch.Tensor  # (..., T) E[g] = e^{m+v/2}
    eg2: torch.Tensor  # (..., T) E[g²] = e^{2m+2v}
    z: torch.Tensor  # (..., T) pseudo-observations y·E[g]/E[g²]
    r: torch.Tensor  # (..., T) their variances σ_y²/E[g²]
    mask: torch.Tensor  # (T,) every site observed
    res: SDEGPResult  # the q(c) chain smoothed


def _carrier_pass(theta_c, t, y, m, v, obs_var, parallel) -> _Carrier:
    """The exact q(c) chain given the envelope moments (m, v): the carrier
    pseudo-observations and the chain smoothed under them."""
    eg = torch.exp(m + 0.5 * v)
    eg2 = torch.exp(2.0 * m + 2.0 * v)
    z, r = y * eg / eg2, obs_var / eg2
    mask = torch.ones(y.shape[-1], dtype=torch.bool, device=y.device)
    return _Carrier(eg, eg2, z, r, mask,
                    sde_gp_smooth(theta_c, t, z, mask, r, parallel=parallel))


def colored_pad_sweep(theta_f, theta_c, t, y, sites, obs_var=1e-3, damping: float = 0.5,
                      n_gh: int = 61, lam2_floor: float = 1e-10, parallel: bool = False):
    """One outer iteration of the colored-carrier mean-field loop:
    f-moments at the current sites → exact q(c) chain sweep → one damped
    parallel-EP f-site update. ``sites`` is the (λ₁, λ₂) pair; returns the
    updated pair (the map whose fixed point ``pad_learn`` differentiates)."""
    lam1, lam2 = sites
    z, r, mask = _pseudo_obs(lam1, lam2, lam2_floor)
    resf = sde_gp_smooth(theta_f, t, z, mask, r, parallel=parallel)
    m, v = resf.mean, resf.var
    resc = _carrier_pass(theta_c, t, y, m, v, obs_var, parallel).res
    yp, mcp, vcp = y[..., None], resc.mean[..., None], resc.var[..., None]

    def tilt(m_cav, v_cav):
        return two_stage_tilt(lambda f: colored_pad_loglik(yp, f, mcp, vcp, obs_var),
                              m_cav, v_cav, n=n_gh)

    return _ep_update(m, v, lam1, lam2, tilt, damping)


def gppad_colored_infer(theta_f, theta_c, t, y, obs_var: float = 1e-3, iters: int = 40,
                        damping: float = 0.5, n_gh: int = 61, lam2_floor: float = 1e-10,
                        sites0=None, parallel: bool = False) -> ColoredPADState:
    """Colored-carrier GP-PAD: y_t = c_t·exp(f_t) + σ_y·ε with the
    log-envelope f and the carrier c both Matérn-5/2 GPs; mean-field
    q(f-chain) ⊗ q(c-chain), alternating two O(T) passes per iteration
    (q(c) first, from the f prior while the sites are empty), on t's device
    and dtype."""
    dt, dev = t.dtype, t.device
    theta_f = torch.as_tensor(theta_f, dtype=dt, device=dev)
    theta_c = torch.as_tensor(theta_c, dtype=dt, device=dev)
    y = torch.as_tensor(y, dtype=dt, device=dev)
    shape = torch.broadcast_shapes(theta_f.shape[:-1], theta_c.shape[:-1],
                                   y.shape[:-1]) + (y.shape[-1],)
    y = y.expand(shape)
    lam1, lam2 = _sites(sites0, shape, dt, dev)
    deltas = []
    for _ in range(iters):
        lam1, lam2_new = colored_pad_sweep(theta_f, theta_c, t, y, (lam1, lam2),
                                           obs_var=obs_var, damping=damping, n_gh=n_gh,
                                           lam2_floor=lam2_floor, parallel=parallel)
        deltas.append(torch.amax(torch.abs(lam2_new - lam2), dim=-1))
        lam2 = lam2_new
    z, r, mask = _pseudo_obs(lam1, lam2, lam2_floor)
    resf = sde_gp_smooth(theta_f, t, z, mask, r, parallel=parallel)
    # the final q(c) at the final f moments (the loop's is one sweep stale)
    car = _carrier_pass(theta_c, t, y, resf.mean, resf.var, obs_var, parallel)
    delta = (torch.stack(deltas, -1) if deltas
             else torch.zeros(shape[:-1] + (0,), dtype=dt, device=dev))
    return ColoredPADState(f_mean=resf.mean, f_var=resf.var, c_mean=car.res.mean,
                           c_var=car.res.var, envelope=car.eg, site_delta=delta, lam1=lam1,
                           lam2=lam2)
