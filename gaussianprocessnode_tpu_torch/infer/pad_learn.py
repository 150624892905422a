"""Hyperparameter learning and model selection for the state-space GP and
GP-PAD families: EP model evidence, mean-field ELBOs, Bayesian lengthscale
posteriors, EP-EM point learning and evidence-weighted mixtures.

Counterpart of ``gaussianprocessnode_tpu/infer/pad_learn.py`` (the
reference's LearnParamsGPSDE, LearnParams_PAD2 and GPPAD_mixture
notebooks).

Evidence. A converged EP chain holds Gaussian sites s_k(f) =
C_k·exp(λ₁ₖ f − λ₂ₖ f²/2) for the true likelihoods ℓ_k(f). With z = λ₁/λ₂,
R = 1/λ₂,

    log Z_EP = log Z_chain(z, R) + Σ_k [log C_k + ½log(2πR_k) + z_k²/(2R_k)],

log C_k = log Z_tilt,k − log G_k matching each site's mass to the true
likelihood against its cavity (Z_tilt by GH, G_k in closed form).

Mean-field ELBO. q(f) and q(c) are exact chain posteriors under their own
pseudo-observations, so KL(q ‖ p) = Σ_k E_q[log N(z_k; x_k, R_k)] −
log Z_chain, and the expected log-likelihood is closed form in the chain
marginals.

Learning. :func:`fit_gppad_theta` alternates warm-started EP with an Adam
step on the site-frozen evidence; :func:`fit_gppad_colored_theta` steps on
the colored ELBO with the E-step's fixed point differentiated implicitly
(:class:`_FixedPoint`, an autograd Function: forward iterations without a
graph, backward a Neumann series of sweep VJPs). The Bayesian lengthscale
posteriors and the mixtures run their GH nodes and their K models as one
batched chain (a leading batch dimension on θ), where the JAX package
vmaps them.
"""

import math
from typing import NamedTuple

import torch

from ..ops.quadrature import moment_match_uni, moment_match_uni_logz
from ..utils.optim import Adam
from .gppad import (_TWO_PI, PADState, _carrier_pass, _pseudo_obs, colored_pad_sweep,
                    gppad_colored_infer, gppad_infer, pad_loglik)
from .sde_gp import sde_gp_smooth

__all__ = [
    "ep_chain_evidence", "pad_evidence", "pad_elbo", "colored_pad_elbo",
    "sde_gp_bayes_lengthscale", "gppad_bayes_lengthscale", "BayesThetaResult",
    "fit_gppad_theta", "fit_gppad_colored_theta", "PADFitResult",
    "gppad_mixture", "gppad_colored_mixture", "MixturePADResult",
]

# ---------------------------------------------------------------------------
# EP evidence and mean-field ELBOs
# ---------------------------------------------------------------------------

def _cavities(m, v, lam1, lam2, active):
    """Delete each active site from its smoothed marginal (a site without a
    valid cavity is clamped; its tilt falls back)."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    raw = 1.0 / v - torch.where(active, lam2, zero)
    prec = torch.clamp_min(raw, 1e-12)
    v_cav = 1.0 / prec
    m_cav = (m / v - torch.where(active, lam1, zero)) * v_cav
    return m_cav, v_cav, prec


def ep_chain_evidence(theta, t, lam1, lam2, loglik, args=(), n_gh: int = 61,
                      lam2_floor: float = 1e-10, parallel: bool = False):
    """EP approximation of log p(y | θ) for a Matérn-5/2 chain with sites
    (λ₁, λ₂) (..., T) standing in for the likelihoods exp(loglik(f, *a_k)).
    ``loglik`` takes the (..., T, n) GH points of every site and the
    per-point data ``args`` (each (..., T)) as (..., T, 1). Sites below
    ``lam2_floor`` are inactive: they add their cavity-tilt mass log Z_tilt
    directly and are masked out of the Kalman pass."""
    dt, dev = t.dtype, t.device
    lam1 = torch.as_tensor(lam1, dtype=dt, device=dev)
    lam2 = torch.as_tensor(lam2, dtype=dt, device=dev)
    z, r, active = _pseudo_obs(lam1, lam2, lam2_floor)
    res = sde_gp_smooth(theta, t, z, active, r, parallel=parallel)
    m_cav, v_cav, prec_cav = _cavities(res.mean, res.var, lam1, lam2, active)
    cols = [a[..., None] for a in args]
    _, _, log_zt = moment_match_uni_logz(lambda f: loglik(f, *cols), m_cav, v_cav, n=n_gh)
    # log G_k = log ∫ cav·e^{λ₁f − λ₂f²/2} df: combined precision p, linear h
    p = prec_cav + lam2
    h = m_cav * prec_cav + lam1
    log_g = 0.5 * (torch.log(prec_cav) - torch.log(p) + h * h / p
                   - m_cav * m_cav * prec_cav)
    corr = torch.where(
        active, log_zt - log_g + 0.5 * torch.log(_TWO_PI * r) + 0.5 * z * z / r, log_zt)
    return res.log_lik + torch.sum(corr, -1)


def _per_model(carrier_var, t, extra_dims):
    """A carrier variance (a scalar or one per model, (...)) shaped to
    broadcast over ``extra_dims`` trailing axes."""
    cv = torch.as_tensor(carrier_var, dtype=t.dtype, device=t.device)
    return cv.reshape(cv.shape + (1,) * extra_dims)


def pad_evidence(theta, t, y, lam1, lam2, carrier_var=1.0, n_gh: int = 61,
                 lam2_floor: float = 1e-10, parallel: bool = False):
    """EP marginal likelihood of the white-carrier PAD model y_t =
    c_t·e^{f_t}, c_t ~ N(0, σ_c²), at the given sites."""
    y = torch.as_tensor(y, dtype=t.dtype, device=t.device)
    cv = _per_model(carrier_var, t, 2)
    return ep_chain_evidence(theta, t, lam1, lam2, lambda f, yk: pad_loglik(yk, f, cv), (y,),
                             n_gh=n_gh, lam2_floor=lam2_floor, parallel=parallel)


def _site_cross_terms(z, r, m, v, active):
    """Σ_active E_q[log N(z_k; x_k, R_k)], the closed-form piece of
    KL(q‖p) for an exact chain posterior under pseudo-observations."""
    e = -0.5 * (torch.log(_TWO_PI * r) + ((z - m) ** 2 + v) / r)
    return torch.sum(torch.where(active, e, torch.zeros_like(e)), -1)


def pad_elbo(theta, t, y, state: PADState, carrier_var=1.0, lam2_floor: float = 1e-10,
             parallel: bool = False):
    """Mean-field ELBO of the white-carrier PAD model at the state's q(f):
    Σ_t E_q[log N(y_t; 0, σ_c² e^{2f_t})] − KL(q(f)‖p(f)), closed form."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    lam2 = torch.as_tensor(state.lam2, dtype=dt, device=dev)
    lam1 = torch.as_tensor(state.lam1, dtype=dt, device=dev)
    cv = _per_model(carrier_var, t, 1)
    z, r, active = _pseudo_obs(lam1, lam2, lam2_floor)
    res = sde_gp_smooth(theta, t, z, active, r, parallel=parallel)
    m, v = res.mean, res.var
    e_lik = torch.sum(-0.5 * torch.log(_TWO_PI * cv) - m
                      - y * y * torch.exp(-2.0 * m + 2.0 * v) / (2.0 * cv), -1)
    kl = _site_cross_terms(z, r, m, v, active) - res.log_lik
    return e_lik - kl


def colored_pad_elbo(theta_f, theta_c, t, y, lam1, lam2, obs_var=1e-3,
                     lam2_floor: float = 1e-10, parallel: bool = False):
    """Mean-field ELBO of the colored-carrier PAD model at the f-sites:
    Σ_t E_q(f)q(c)[log N(y_t; c_t e^{f_t}, σ_y²)] − KL(q(f)‖p(f)) −
    KL(q(c)‖p(c)), q(c) the exact carrier chain built from the f-moments."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    lam1 = torch.as_tensor(lam1, dtype=dt, device=dev)
    lam2 = torch.as_tensor(lam2, dtype=dt, device=dev)
    zf, rf, active = _pseudo_obs(lam1, lam2, lam2_floor)
    resf = sde_gp_smooth(theta_f, t, zf, active, rf, parallel=parallel)
    m, v = resf.mean, resf.var
    car = _carrier_pass(theta_c, t, y, m, v, obs_var, parallel)
    mc, vc = car.res.mean, car.res.var
    e_lik = torch.sum(-0.5 * math.log(_TWO_PI * obs_var)
                      - (y * y - 2.0 * y * mc * car.eg + (mc * mc + vc) * car.eg2)
                      / (2.0 * obs_var), -1)
    kl_f = _site_cross_terms(zf, rf, m, v, active) - resf.log_lik
    kl_c = _site_cross_terms(car.z, car.r, mc, vc, car.mask) - car.res.log_lik
    return e_lik - kl_f - kl_c


# ---------------------------------------------------------------------------
# Bayesian lengthscale posteriors (LearnParamsGPSDE)
# ---------------------------------------------------------------------------

class BayesThetaResult(NamedTuple):
    m_s: torch.Tensor  # posterior mean of s = log ℓ
    v_s: torch.Tensor  # posterior variance of s
    trace: torch.Tensor  # (iters, 2) per-iteration (m_s, v_s)


def _bayes_lengthscale(log_evidence, m0, v0, iters, n_gh, t):
    """The re-localised GH tilt loop: q(s) ← moments of
    p₀(s)·exp(log_evidence(s)) on q's own grid, through the importance tilt
    log_ev + log p₀ − log q. ``log_evidence`` takes the (n,) GH nodes at
    once. Non-finite evidence is −inf (zero mass) before the product, and
    the variance shrinks at most 4× per sweep (the JAX package's trust
    region: the first prior-wide product puts its mass on one node)."""
    m0 = torch.as_tensor(m0, dtype=t.dtype, device=t.device)
    v0 = torch.as_tensor(v0, dtype=t.dtype, device=t.device)
    m_s, v_s = m0, v0
    trace = []
    for _ in range(iters):
        def log_tilt(s, m_s=m_s, v_s=v_s):
            le = log_evidence(s)
            le = torch.where(torch.isfinite(le), le, torch.full_like(le, -float("inf")))
            return le - (s - m0) ** 2 / (2.0 * v0) + (s - m_s) ** 2 / (2.0 * v_s)

        m_new, v_new = moment_match_uni(log_tilt, m_s, v_s, n=n_gh)
        v_s = torch.maximum(v_new, 0.25 * v_s)
        m_s = m_new
        trace.append(torch.stack([m_s, v_s]))
    return BayesThetaResult(m_s=m_s, v_s=v_s, trace=torch.stack(trace))


def _thetas(s2, s):
    """θ = [σ², e^s] at each lengthscale node s (n,): (n, 2)."""
    return torch.stack([s2.expand(s.shape), torch.exp(s)], -1)


def sde_gp_bayes_lengthscale(t, y, obs_mask, obs_var, m0=0.0, v0=10.0, sigma2=1.0,
                             iters: int = 8, n_gh: int = 21) -> BayesThetaResult:
    """Gaussian posterior q(s), s = log ℓ, for Matérn-5/2 SDE GP regression:
    the tilt is the exact O(T) Kalman evidence at every GH node (one
    batched chain of n_gh models)."""
    y = torch.as_tensor(y, dtype=t.dtype, device=t.device)
    s2 = torch.as_tensor(sigma2, dtype=t.dtype, device=t.device)

    def log_ev(s):
        return sde_gp_smooth(_thetas(s2, s), t, y, obs_mask, obs_var).log_lik

    return _bayes_lengthscale(log_ev, m0, v0, iters, n_gh, t)


def gppad_bayes_lengthscale(t, y, carrier_var=1.0, m0=0.0, v0=10.0, sigma2=1.0,
                            iters: int = 6, ep_iters: int = 15, n_gh: int = 61,
                            n_gh_theta: int = 21) -> BayesThetaResult:
    """Gaussian posterior q(s), s = log ℓ, over the PAD log-envelope prior's
    lengthscale: each GH node runs its own parallel-EP inference and is
    scored by its EP evidence (the n_gh_theta chains batched)."""
    y = torch.as_tensor(y, dtype=t.dtype, device=t.device)
    s2 = torch.as_tensor(sigma2, dtype=t.dtype, device=t.device)

    def log_ev(s):
        theta = _thetas(s2, s)
        st = gppad_infer(theta, t, y, carrier_var=carrier_var, iters=ep_iters, n_gh=n_gh)
        return pad_evidence(theta, t, y, st.lam1, st.lam2, carrier_var=carrier_var, n_gh=n_gh)

    return _bayes_lengthscale(log_ev, m0, v0, iters, n_gh_theta, t)


# ---------------------------------------------------------------------------
# Implicit differentiation of an E-step fixed point
# ---------------------------------------------------------------------------

class _FixedPoint(torch.autograd.Function):
    """x* ≈ step(θ, ·) iterated ``n_fwd`` times from x0, with the
    implicit-function VJP: u = ḡ + (∂step/∂x)ᵀu by ``n_bwd`` Neumann
    iterations at x*, then θ̄ = (∂step/∂θ)ᵀu. No gradient flows to x0 (a
    fixed point forgets its start). θ and x are tuples of tensors, passed
    flat: ``apply(step, n_fwd, n_bwd, n_theta, *theta, *x0)``.

    Back-propagating through a warm-started truncated sweep stack instead
    was measured in the JAX package to lose most of the site response on
    the colored ELBO (ℓ_f driven the wrong way)."""

    @staticmethod
    def forward(ctx, step, n_fwd, n_bwd, n_theta, *flat):
        theta, x = tuple(flat[:n_theta]), tuple(flat[n_theta:])
        with torch.no_grad():
            for _ in range(n_fwd):
                x = tuple(step(theta, x))
        ctx.step, ctx.n_bwd, ctx.n_theta = step, n_bwd, n_theta
        ctx.save_for_backward(*theta, *x)
        return tuple(xi.clone() for xi in x)

    @staticmethod
    def backward(ctx, *gbar):
        saved = ctx.saved_tensors
        theta = tuple(th.detach().requires_grad_() for th in saved[:ctx.n_theta])
        x = tuple(xi.detach().requires_grad_() for xi in saved[ctx.n_theta:])
        gbar = tuple(torch.zeros_like(xi) if g is None else g for g, xi in zip(gbar, x))
        with torch.enable_grad():
            out = tuple(ctx.step(theta, x))
        u = gbar
        for _ in range(ctx.n_bwd):
            mu = torch.autograd.grad(out, x, u, retain_graph=True, allow_unused=True)
            u = tuple(g + (torch.zeros_like(g) if m is None else m) for g, m in zip(gbar, mu))
        th_bar = torch.autograd.grad(out, theta, u, allow_unused=True)
        th_bar = tuple(torch.zeros_like(th) if g is None else g
                       for g, th in zip(th_bar, theta))
        return (None, None, None, None) + th_bar + (None,) * len(x)


def _fixed_point(step, theta, x0, n_fwd: int, n_bwd: int):
    """The fixed point of ``step(θ, x)`` from x0 (tuples of tensors), with
    the implicit VJP of :class:`_FixedPoint`."""
    theta, x0 = tuple(theta), tuple(x0)
    return _FixedPoint.apply(step, n_fwd, n_bwd, len(theta), *theta,
                             *(xi.detach() for xi in x0))


# ---------------------------------------------------------------------------
# EP-EM point learning (LearnParams_PAD2)
# ---------------------------------------------------------------------------

class PADFitResult(NamedTuple):
    theta: torch.Tensor  # learned θ (white: [σ², ℓ]; colored: [ℓ_f, ℓ_c])
    evidence: torch.Tensor  # (epochs,) objective trace
    theta_trace: torch.Tensor  # (epochs, d)
    sites: tuple  # final (lam1, lam2) f-sites


def fit_gppad_theta(t, y, theta0, carrier_var=1.0, epochs: int = 30, ep_iters: int = 10,
                    learning_rate: float = 0.08, n_gh: int = 61,
                    learn_var: bool = True) -> PADFitResult:
    """EP-EM for the white-carrier PAD prior θ = [σ², ℓ]: per epoch, an
    E-step of ``ep_iters`` warm-started parallel-EP sweeps at the current θ,
    then one Adam step on −:func:`pad_evidence` in log θ with the sites
    frozen. A last E-step at the learned θ gives the returned sites."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    T = y.shape[-1]
    log_th0 = torch.log(torch.as_tensor(theta0, dtype=dt, device=dev))
    opt = Adam(learning_rate)

    def full(log_th):
        th = torch.exp(log_th)
        return th if learn_var else torch.stack([torch.exp(log_th0[0]), th[1]])

    log_th = log_th0.clone()
    state = opt.init(log_th)
    lam1 = lam2 = torch.zeros(T, dtype=dt, device=dev)
    evs, ths = [], []
    for _ in range(epochs):
        with torch.no_grad():
            st = gppad_infer(torch.exp(log_th), t, y, carrier_var=carrier_var, iters=ep_iters,
                             n_gh=n_gh, sites0=(lam1, lam2))
        lam1, lam2 = st.lam1, st.lam2
        lt = log_th.detach().requires_grad_()
        neg = -pad_evidence(full(lt), t, y, lam1, lam2, carrier_var=carrier_var, n_gh=n_gh)
        (g,) = torch.autograd.grad(neg, lt)
        log_th = log_th + opt.update_(g, state)
        evs.append(-neg.detach())
        ths.append(torch.exp(log_th))
    theta = full(log_th)
    with torch.no_grad():
        st = gppad_infer(theta, t, y, carrier_var=carrier_var, iters=ep_iters, n_gh=n_gh,
                         sites0=(lam1, lam2))
    return PADFitResult(theta=theta, evidence=torch.stack(evs), theta_trace=torch.stack(ths),
                        sites=(st.lam1, st.lam2))


def fit_gppad_colored_theta(t, y, ell0, var_f=1.0, var_c=0.5, obs_var=1e-3,
                            epochs: int = 25, ep_iters: int = 150, adjoint_iters: int = 60,
                            learning_rate: float = 0.08, damping: float = 0.8,
                            n_gh: int = 61) -> PADFitResult:
    """Variational EM for the colored-carrier PAD lengthscales ℓ = [ℓ_f,
    ℓ_c] (the variances fixed): per epoch a warm-started ``ep_iters``-sweep
    E-step, then one Adam step on −:func:`colored_pad_elbo` with the
    E-step's fixed point differentiated implicitly (``adjoint_iters``
    sweep VJPs). The mean-field ELBO is not stationary in the parallel-EP
    sites, so their response dq*/dθ carries most of the ℓ_f signal."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    T = y.shape[-1]
    vf = torch.as_tensor(var_f, dtype=dt, device=dev)
    vc = torch.as_tensor(var_c, dtype=dt, device=dev)
    opt = Adam(learning_rate)

    def estep(th_pair, sites):
        return colored_pad_sweep(th_pair[0], th_pair[1], t, y, sites, obs_var=obs_var,
                                 n_gh=n_gh, damping=damping)

    log_l = torch.log(torch.as_tensor(ell0, dtype=dt, device=dev))
    state = opt.init(log_l)
    lam1 = lam2 = torch.zeros(T, dtype=dt, device=dev)
    evs, ls = [], []
    for _ in range(epochs):
        ll = log_l.detach().requires_grad_()
        th_f = torch.stack([vf, torch.exp(ll[0])])
        th_c = torch.stack([vc, torch.exp(ll[1])])
        lam1, lam2 = _fixed_point(estep, (th_f, th_c), (lam1, lam2), ep_iters, adjoint_iters)
        neg = -colored_pad_elbo(th_f, th_c, t, y, lam1, lam2, obs_var=obs_var)
        (g,) = torch.autograd.grad(neg, ll)
        lam1, lam2 = lam1.detach(), lam2.detach()
        log_l = log_l + opt.update_(g, state)
        evs.append(-neg.detach())
        ls.append(torch.exp(log_l))
    return PADFitResult(theta=torch.exp(log_l), evidence=torch.stack(evs),
                        theta_trace=torch.stack(ls), sites=(lam1, lam2))


# ---------------------------------------------------------------------------
# Mixture PAD (GPPAD_mixture)
# ---------------------------------------------------------------------------

class MixturePADResult(NamedTuple):
    log_evidence: torch.Tensor  # (K,) per-model EP evidence (white) / ELBO
    elbo: torch.Tensor  # (K,) per-model mean-field ELBO
    resp: torch.Tensor  # (K,) posterior model responsibilities
    envelopes: torch.Tensor  # (K, T) per-model E[e^f]
    envelope: torch.Tensor  # (T,) responsibility-weighted envelope


def _responsibilities(scores, log_prior):
    lp = scores if log_prior is None else scores + log_prior
    return torch.softmax(lp, -1)


def gppad_mixture(thetas, t, y, carrier_vars=None, log_prior=None, iters: int = 25,
                  n_gh: int = 61) -> MixturePADResult:
    """K-model white-carrier PAD bank: the K EP chains run batched, each
    model scored by its EP evidence (responsibilities = softmax(evidence +
    log-prior)), its mean-field ELBO beside it as a ranking cross-check.
    ``thetas``: (K, 2) rows [σ², ℓ]; ``carrier_vars``: (K,) or None (= 1)."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    thetas = torch.as_tensor(thetas, dtype=dt, device=dev)
    K = thetas.shape[0]
    cvars = (torch.ones(K, dtype=dt, device=dev) if carrier_vars is None
             else torch.as_tensor(carrier_vars, dtype=dt, device=dev))
    st = gppad_infer(thetas, t, y, carrier_var=cvars, iters=iters, n_gh=n_gh)
    evs = pad_evidence(thetas, t, y, st.lam1, st.lam2, carrier_var=cvars, n_gh=n_gh)
    els = pad_elbo(thetas, t, y, st, carrier_var=cvars)
    resp = _responsibilities(evs, log_prior)
    return MixturePADResult(log_evidence=evs, elbo=els, resp=resp, envelopes=st.envelope,
                            envelope=resp @ st.envelope)


def gppad_colored_mixture(thetas_f, thetas_c, t, y, obs_var=1e-3, log_prior=None,
                          iters: int = 30, n_gh: int = 61) -> MixturePADResult:
    """K-model colored PAD bank (per-component (θ_amplitude, θ_carrier)
    pairs), batched, scored by the mean-field ELBO :func:`colored_pad_elbo`."""
    dt, dev = t.dtype, t.device
    y = torch.as_tensor(y, dtype=dt, device=dev)
    thetas_f = torch.as_tensor(thetas_f, dtype=dt, device=dev)
    thetas_c = torch.as_tensor(thetas_c, dtype=dt, device=dev)
    st = gppad_colored_infer(thetas_f, thetas_c, t, y, obs_var=obs_var, iters=iters, n_gh=n_gh)
    els = colored_pad_elbo(thetas_f, thetas_c, t, y, st.lam1, st.lam2, obs_var=obs_var)
    resp = _responsibilities(els, log_prior)
    return MixturePADResult(log_evidence=els, elbo=els, resp=resp, envelopes=st.envelope,
                            envelope=resp @ st.envelope)
