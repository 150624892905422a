"""Parity of the port's learning layer for the SDE-GP / GP-PAD families
(infer/pad_learn.py) and its hand-written Adam (utils/optim.py) with the
JAX package's and optax's, on the CPU in float64.

- ``pad_evidence``, ``ep_chain_evidence`` (active and inactive sites),
  ``pad_elbo`` and ``colored_pad_elbo`` at shared sites: 1e-11 relative
  (one smoother and one batched tilt; no iteration);
- the Bayesian lengthscale posteriors (``sde_gp_bayes_lengthscale``,
  ``gppad_bayes_lengthscale``; GH nodes batched as one chain bank where JAX
  vmaps them): the (m, v) trace to 1e-11 (the tilt exponentiates evidences
  of hundreds of nats, relative rounding ~1e-14 of them; measured 8e-15);
- ``_fixed_point``'s implicit gradient against JAX's ``custom_vjp``, on a
  contraction (1e-12) and on the colored-PAD ELBO through the colored sweep
  (1e-9: the forward's EP sweeps carry rounding into the point where the
  adjoint is taken; measured 1.2e-11), and finite there;
- ``Adam`` against ``optax.adam`` over 60 steps of noisy gradients, state
  and parameters step for step (1e-15 relative: the same operations);
- ``fit_gppad_theta`` (learn_var on and off) and
  ``fit_gppad_colored_theta`` for 2 epochs at small depth: θ trace,
  evidence / ELBO trace and the final sites (1e-10; measured ≤ 1.7e-13);
- ``gppad_mixture`` and ``gppad_colored_mixture`` (K = 3, batched) against
  JAX's vmapped banks (1e-9; measured ≤ 2.3e-11, the colored bank's
  envelopes after its EP loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianprocessnode_tpu.infer import gppad as jg
from gaussianprocessnode_tpu.infer import pad_learn as jl
from gaussianprocessnode_tpu_torch.infer import gppad as tg
from gaussianprocessnode_tpu_torch.infer import pad_learn as tl
from gaussianprocessnode_tpu_torch.utils.optim import Adam
from test_torch_gppad import colored_draw, pad_draw, rel, t64

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pad_sites():
    """White-carrier sites after 6 EP sweeps (JAX), a quarter switched off."""
    t, y = pad_draw(7, T=64)
    theta = np.array([1.0, 0.8])
    st = jg.gppad_infer(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), carrier_var=0.04,
                        iters=6)
    lam1, lam2 = np.array(st.lam1), np.array(st.lam2)
    lam2[::4] = 0.0
    return t, y, theta, lam1, lam2, st


def test_evidence_and_elbo(pad_sites):
    t, y, theta, lam1, lam2, st = pad_sites
    ev = tl.pad_evidence(t64(theta), t64(t), t64(y), t64(lam1), t64(lam2), carrier_var=0.04)
    evj = jl.pad_evidence(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), lam1, lam2,
                          carrier_var=0.04)
    assert rel(ev, evj) <= 1e-11
    # a Gaussian likelihood through the generic evidence
    ll = tl.ep_chain_evidence(t64(theta), t64(t), t64(lam1), t64(lam2),
                              lambda f, yk: -0.5 * (f - yk) ** 2 / 0.3, (t64(y),))
    llj = jl.ep_chain_evidence(jnp.asarray(theta), jnp.asarray(t), lam1, lam2,
                               lambda f, yk: -0.5 * (f - yk) ** 2 / 0.3, (jnp.asarray(y),))
    assert rel(ll, llj) <= 1e-11
    el = tl.pad_elbo(t64(theta), t64(t), t64(y), tg.PADState(*(t64(np.asarray(a)) for a in st)),
                     carrier_var=0.04)
    elj = jl.pad_elbo(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), st, carrier_var=0.04)
    assert rel(el, elj) <= 1e-11


def test_colored_elbo():
    t, y = colored_draw(8, T=64)
    thf, thc = np.array([0.4, 0.8]), np.array([1.0, 0.1])
    sj = jg.gppad_colored_infer(jnp.asarray(thf), jnp.asarray(thc), jnp.asarray(t),
                                jnp.asarray(y), obs_var=1e-3, iters=5)
    el = tl.colored_pad_elbo(t64(thf), t64(thc), t64(t), t64(y), t64(np.array(sj.lam1)),
                             t64(np.array(sj.lam2)), obs_var=1e-3)
    elj = jl.colored_pad_elbo(jnp.asarray(thf), jnp.asarray(thc), jnp.asarray(t),
                              jnp.asarray(y), sj.lam1, sj.lam2, obs_var=1e-3)
    assert rel(el, elj) <= 1e-11


def test_sde_bayes_lengthscale():
    rng = np.random.default_rng(2)
    T = 80
    t = np.linspace(0.0, 4.0, T)
    y = np.sin(2.0 * t) + 0.2 * rng.normal(size=T)
    mask = rng.uniform(size=T) < 0.7
    res = tl.sde_gp_bayes_lengthscale(t64(t), t64(y), torch.as_tensor(mask), 0.04, iters=5)
    ref = jl.sde_gp_bayes_lengthscale(jnp.asarray(t), jnp.asarray(y), jnp.asarray(mask), 0.04,
                                      iters=5)
    assert rel(res.trace, ref.trace) <= 1e-11
    assert res.trace.shape == (5, 2)


def test_gppad_bayes_lengthscale():
    t, y = pad_draw(9, T=48)
    res = tl.gppad_bayes_lengthscale(t64(t), t64(y), carrier_var=0.04, iters=2, ep_iters=4)
    ref = jl.gppad_bayes_lengthscale(jnp.asarray(t), jnp.asarray(y), carrier_var=0.04, iters=2,
                                     ep_iters=4)
    assert rel(res.trace, ref.trace) <= 1e-11


def _contraction(lib):
    def step(theta, x):
        a, b = theta
        x1, x2 = x
        return (0.5 * lib.tanh(a * x2 + b), 0.3 * lib.sin(x1) * a + 0.1 * b)
    return step


def test_fixed_point_gradient_on_a_contraction():
    a, b = np.array([0.7, -0.2, 1.1]), np.array([0.4, 0.9, -0.5])
    w = np.array([1.0, -2.0, 0.5])

    def jloss(a_, b_):
        x = jl._fixed_point(_contraction(jnp), (a_, b_), (jnp.zeros(3), jnp.zeros(3)), 30, 25)
        return jnp.sum(w * x[0]) + jnp.sum(x[1] ** 2)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = t64(a).requires_grad_(), t64(b).requires_grad_()
    x = tl._fixed_point(_contraction(torch), (ta, tb), (torch.zeros(3, dtype=F64),) * 2, 30, 25)
    loss = torch.sum(t64(w) * x[0]) + torch.sum(x[1] ** 2)
    tga, tgb = torch.autograd.grad(loss, (ta, tb))
    assert rel(tga, ga) <= 1e-12
    assert rel(tgb, gb) <= 1e-12


def test_fixed_point_gradient_on_the_colored_elbo():
    t, y = colored_draw(10, T=48)
    vf, vc = 0.4, 1.0

    def jobj(log_l):
        th_f = jnp.stack([jnp.asarray(vf), jnp.exp(log_l[0])])
        th_c = jnp.stack([jnp.asarray(vc), jnp.exp(log_l[1])])

        def estep(th, s):
            return jg.colored_pad_sweep(th[0], th[1], jnp.asarray(t), jnp.asarray(y), s,
                                        obs_var=1e-3, damping=0.8)

        z = jnp.zeros(48)
        s = jl._fixed_point(estep, (th_f, th_c), (z, z), 8, 4)
        return -jl.colored_pad_elbo(th_f, th_c, jnp.asarray(t), jnp.asarray(y), s[0], s[1],
                                    obs_var=1e-3)

    log_l = np.log([0.3, 0.1])
    vj, gj = jax.jit(jax.value_and_grad(jobj))(jnp.asarray(log_l))

    ll = t64(log_l).requires_grad_()
    th_f = torch.stack([t64(vf), torch.exp(ll[0])])
    th_c = torch.stack([t64(vc), torch.exp(ll[1])])

    def estep(th, s):
        return tg.colored_pad_sweep(th[0], th[1], t64(t), t64(y), s, obs_var=1e-3, damping=0.8)

    z = torch.zeros(48, dtype=F64)
    s = tl._fixed_point(estep, (th_f, th_c), (z, z), 8, 4)
    neg = -tl.colored_pad_elbo(th_f, th_c, t64(t), t64(y), s[0], s[1], obs_var=1e-3)
    (g,) = torch.autograd.grad(neg, ll)
    assert torch.isfinite(g).all()
    assert rel(neg, vj) <= 1e-10
    assert rel(g, gj) <= 1e-9


@pytest.mark.parametrize("lr", [0.08, 1e-3])
def test_adam_matches_optax(lr):
    rng = np.random.default_rng(11)
    p0 = rng.normal(size=4)
    opt, topt = optax.adam(lr), Adam(lr)
    pj, sj = jnp.asarray(p0), optax.adam(lr).init(jnp.asarray(p0))
    pt = t64(p0)
    st = topt.init(pt)
    for _ in range(60):
        g = rng.normal(size=4) * 10.0 ** rng.uniform(-6, 2)
        upd, sj = opt.update(jnp.asarray(g), sj)
        pj = optax.apply_updates(pj, upd)
        pt = pt + topt.update_(t64(g), st)
        adam_state = sj[0]
        assert int(st["count"]) == int(adam_state.count)
        assert rel(st["mu"], adam_state.mu) <= 1e-15
        assert rel(st["nu"], adam_state.nu) <= 1e-15
        assert rel(pt, pj) <= 1e-15


@pytest.mark.parametrize("learn_var", [True, False])
def test_fit_gppad_theta(learn_var):
    t, y = pad_draw(12, T=48)
    res = tl.fit_gppad_theta(t64(t), t64(y), t64([0.5, 0.35]), carrier_var=0.04, epochs=2,
                             ep_iters=3, learn_var=learn_var)
    ref = jl.fit_gppad_theta(jnp.asarray(t), jnp.asarray(y), jnp.asarray([0.5, 0.35]),
                             carrier_var=0.04, epochs=2, ep_iters=3, learn_var=learn_var)
    assert rel(res.theta, ref.theta) <= 1e-10
    assert rel(res.theta_trace, ref.theta_trace) <= 1e-10
    assert rel(res.evidence, ref.evidence) <= 1e-10
    assert rel(res.sites[1], ref.sites[1]) <= 1e-10
    if not learn_var:
        assert float(res.theta[0]) == pytest.approx(0.5, rel=1e-15)


def test_fit_gppad_colored_theta():
    t, y = colored_draw(13, T=48)
    kw = dict(var_f=0.4, var_c=1.0, epochs=2, ep_iters=10, adjoint_iters=5)
    res = tl.fit_gppad_colored_theta(t64(t), t64(y), t64([0.3, 0.1]), **kw)
    ref = jl.fit_gppad_colored_theta(jnp.asarray(t), jnp.asarray(y), jnp.asarray([0.3, 0.1]),
                                     **kw)
    assert rel(res.theta_trace, ref.theta_trace) <= 1e-10
    assert rel(res.evidence, ref.evidence) <= 1e-10
    assert rel(res.sites[1], ref.sites[1]) <= 1e-10
    assert torch.isfinite(res.evidence).all()


def test_mixtures():
    t, y = pad_draw(14, T=48)
    ths = np.array([[1.0, 0.9], [1.0, 0.15], [1.0, 4.0]])
    cvs = np.array([0.04, 0.04, 0.09])
    res = tl.gppad_mixture(t64(ths), t64(t), t64(y), carrier_vars=t64(cvs), iters=4)
    ref = jl.gppad_mixture(jnp.asarray(ths), jnp.asarray(t), jnp.asarray(y),
                           carrier_vars=jnp.asarray(cvs), iters=4)
    for a, b in zip(res, ref):
        assert rel(a, b) <= 1e-9
    t2, y2 = colored_draw(15, T=40)
    thf = np.array([[0.4, 0.8], [0.4, 0.2], [0.4, 2.0]])
    thc = np.array([[1.0, 0.1], [1.0, 0.1], [1.0, 0.05]])
    res = tl.gppad_colored_mixture(t64(thf), t64(thc), t64(t2), t64(y2), iters=3,
                                   log_prior=t64(np.log([0.5, 0.25, 0.25])))
    ref = jl.gppad_colored_mixture(jnp.asarray(thf), jnp.asarray(thc), jnp.asarray(t2),
                                   jnp.asarray(y2), iters=3,
                                   log_prior=jnp.log(jnp.asarray([0.5, 0.25, 0.25])))
    for a, b in zip(res, ref):
        assert rel(a, b) <= 1e-9
