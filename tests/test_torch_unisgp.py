"""Parity of the port's nodes/unisgp.py, and of the linear algebra and
distributions under it (ops/linalg.py's Cholesky family, dists.py's
product, moments and entropies), with the JAX package's, on the CPU.

Seeded node state: M = 8 inducing inputs on [−3, 3], θ = (0.3, −0.2) under
softplus, a random SPD Rv = Σ_v + μ_vμ_vᵀ and its upper factor Uv, w̄ = 7.5,
E[log w] from Γ(4, 0.5). Every rule and energy is evaluated at a few
observed inputs, at uncertain inputs under GH-21, SR, UT(α = 0.5) and
GenUT, and in batch form; the θ log-messages and the in log-message also
with their gradients.

Tolerance: float64 throughout, ≤ 1e-12 relative to the result's largest
entry (measured ~1e-14; the triangular solves and Grams are the same
arithmetic in both packages, summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import dists as jd
from gaussianprocessnode_tpu.nodes import unisgp as ju
from gaussianprocessnode_tpu.ops import linalg as jl
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import dists as td
from gaussianprocessnode_tpu_torch.nodes import unisgp as tu
from gaussianprocessnode_tpu_torch.ops import linalg as tl
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as TKernel

JK = JKernel("se", transform="softplus")
TK = TKernel("se", transform="softplus", use_kernel=True)
RTOL = 1e-12
M = 8
METHODS = [jq.GaussHermite(21), jq.SphericalRadial(), jq.Unscented(alpha=0.5, kappa=1.0),
           jq.GenUT()]
X_OBS = [-2.3, 0.1, 1.7]
Q_IN = [(0.4, 0.3), (-1.5, 0.05)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(method):
    return getattr(tq, type(method).__name__)(**vars(method))


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def close(got, want, rtol=RTOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def close_tuple(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, rtol)


def T(a):
    return torch.as_tensor(np.array(a, np.float64))


def J(a):
    return jnp.asarray(np.array(a, np.float64))


@pytest.fixture(scope="module")
def node():
    rng = np.random.default_rng(0)
    theta = np.array([0.3, -0.2])
    Xu = np.linspace(-3.0, 3.0, M)[:, None]
    mu_v = rng.standard_normal(M)
    A = rng.standard_normal((M, M)) * 0.3
    Sigma = A @ A.T + 0.1 * np.eye(M)
    Rv = Sigma + np.outer(mu_v, mu_v)
    Uv = np.linalg.cholesky(Rv).T
    KuuL = np.asarray(jl.chol_lower(JK.kuu(J(theta), J(Xu), jitter=1e-8)))
    jargs = ju.UniSGPArgs(J(theta), J(Xu), J(KuuL), J(Uv))
    targs = tu.UniSGPArgs(T(theta), T(Xu), T(KuuL), T(Uv))
    return dict(theta=theta, Xu=Xu, mu_v=mu_v, Rv=Rv, Sigma=Sigma, Uv=Uv, jargs=jargs,
                targs=targs, w=7.5, Elogw=float(jd.gamma_mean_log(jd.GammaShapeRate(4.0, 0.5))))


def test_cholesky_family_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 6))
    S = A @ A.T + 0.5 * np.eye(6)
    B = rng.standard_normal((6, 3))
    b = rng.standard_normal(6)
    close(tl.jittered(T(S), 1e-3), jl.jittered(J(S), 1e-3))
    close(tl.chol_lower(T(S), 1e-6), jl.chol_lower(J(S), 1e-6))
    close(tl.chol_upper(T(S)), jl.chol_upper(J(S)))
    L, jL = tl.chol_lower(T(S)), jl.chol_lower(J(S))
    for rhs in (B, b):
        close(tl.tri_solve_lower(L, T(rhs)), jl.tri_solve_lower(jL, J(rhs)))
        close(tl.tri_solve_upper(L.mT, T(rhs)), jl.tri_solve_upper(jL.T, J(rhs)))
        close(tl.chol_solve(L, T(rhs)), jl.chol_solve(jL, J(rhs)))
    close(tl.cholinv(T(S), 1e-8), jl.cholinv(J(S), 1e-8))
    close(tl.logdet_from_chol(L), jl.logdet_from_chol(jL))
    close(tl.jdot(T(B), T(B)), jl.jdot(J(B), J(B)))
    close(tl.rv_chol_upper(T(b), T(S)), jl.rv_chol_upper(J(b), J(S)))


def lower_nan(L):
    r, c = torch.tril_indices(L.shape[-1], L.shape[-1])
    return bool(torch.all(torch.isnan(L[..., r, c])))


def test_cholesky_of_a_matrix_that_is_not_positive_definite_is_nan_as_in_jax():
    """torch.linalg.cholesky would raise (a host sync on the card); the port's
    factor is NaN, as jnp.linalg.cholesky's, and so is everything built on
    it, a batch element at a time. The SE Kuu of two coincident inducing
    inputs without jitter is such a matrix."""
    K = np.array([[1.0, 2.0], [2.0, 1.0]])  # eigenvalues 3 and −1
    L = tl.chol_lower(T(K))
    # NaN on and below the diagonal, zero above it: JAX's pattern
    np.testing.assert_array_equal(_np(L), np.asarray(jl.chol_lower(J(K))))
    assert lower_nan(L)
    assert torch.all(torch.isnan(tl.cholinv(T(K))))
    assert torch.isnan(tl.logdet_from_chol(L))
    batch = T(np.stack([K, np.eye(2) * 2.0]))
    Lb = tl.chol_lower(batch)
    assert lower_nan(Lb[0])
    close(Lb[1], np.sqrt(2.0) * np.eye(2))
    Kuu = TK.kuu(T([0.0, 0.0]), T([[0.5], [0.5], [1.0]]))
    assert lower_nan(tl.chol_lower(Kuu))
    # the gradient through a NaN factor is NaN too, not an error
    th = T([0.0, 0.0]).requires_grad_(True)
    (g,) = torch.autograd.grad(tl.logdet_from_chol(tl.chol_lower(TK.kuu(
        th, T([[0.5], [0.5], [1.0]])))), th)
    assert not torch.all(torch.isfinite(g))


def test_dists_match_jax():
    a, b = jd.Gaussian(J(0.3), J(2.0)), jd.Gaussian(J(-1.1), J(0.4))
    close_tuple(td.gaussian_prod(td.Gaussian(T(0.3), T(2.0)), td.Gaussian(T(-1.1), T(0.4))),
                jd.gaussian_prod(a, b))
    for shape, rate in [(4.0, 0.5), (0.01, 0.01), (51.0, 3.7)]:
        jq_, tq_ = jd.GammaShapeRate(J(shape), J(rate)), td.GammaShapeRate(T(shape), T(rate))
        close(td.gamma_mean_log(tq_), jd.gamma_mean_log(jq_))
        close(td.gamma_entropy(tq_), jd.gamma_entropy(jq_))
    v = np.array([0.1, 1.0, 7.0])
    close(td.gaussian_entropy(td.Gaussian(T(v), T(v))), jd.gaussian_entropy(jd.Gaussian(J(v), J(v))))
    rng = np.random.default_rng(2)
    A = rng.standard_normal((5, 5))
    P = A @ A.T + np.eye(5)
    xi = rng.standard_normal(5)
    close_tuple(td.mv_nat_to_meancov(td.MvGaussianNat(T(xi), T(P))),
                jd.mv_nat_to_meancov(jd.MvGaussianNat(J(xi), J(P))))


def test_out_and_v_messages_match_jax(node):
    ja, ta, mu, w = node["jargs"], node["targs"], node["mu_v"], node["w"]
    for x in X_OBS:
        close_tuple(tu.out_message_exact(TK, ta, T(x), T(mu), T(w)),
                    ju.out_message_exact(JK, ja, J(x), J(mu), J(w)))
        close_tuple(tu.v_message_exact(TK, ta, T(x), T(0.7), T(w)),
                    ju.v_message_exact(JK, ja, J(x), J(0.7), J(w)))
    for method in METHODS:
        for m, v in Q_IN:
            close_tuple(tu.out_message_uncertain(TK, _port(method), ta,
                                                 td.Gaussian(T(m), T(v)), T(mu), T(w)),
                        ju.out_message_uncertain(JK, method, ja, jd.Gaussian(J(m), J(v)),
                                                 J(mu), J(w)))
            close_tuple(tu.v_message_uncertain(TK, _port(method), ta, T(0.7),
                                               td.Gaussian(T(m), T(v)), T(w)),
                        ju.v_message_uncertain(JK, method, ja, J(0.7), jd.Gaussian(J(m), J(v)),
                                               J(w)))
    Kux = np.asarray(JK(J(node["theta"]), J(node["Xu"]), J(np.array(X_OBS)[:, None])))
    y = np.array([0.2, -0.4, 1.1])
    close_tuple(tu.v_message_batch_exact(T(Kux), T(y), T(w)),
                ju.v_message_batch_exact(J(Kux), J(y), J(w)))


def test_in_log_message_and_marginal_match_jax(node):
    """The port's log-message takes all points at once (one Gram); JAX's is a
    scalar closure, vmapped here. Its gradient in x is held to JAX's too."""
    ja, ta, mu, w = node["jargs"], node["targs"], node["mu_v"], node["w"]
    q_out = (0.6, 0.2)
    jlp = ju.in_log_message(JK, ja, jd.Gaussian(J(q_out[0]), J(q_out[1])), J(mu), J(w))
    tlp = tu.in_log_message(TK, ta, td.Gaussian(T(q_out[0]), T(q_out[1])), T(mu), T(w))
    xs = np.linspace(-3.5, 3.5, 17)
    close(tlp(T(xs)), jax.vmap(jlp)(J(xs)))
    close(tlp(T(0.25)), jlp(J(0.25)))
    xt = T(xs).requires_grad_(True)
    (gx,) = torch.autograd.grad(torch.sum(tlp(xt)), xt)
    close(gx, jax.vmap(jax.grad(jlp))(J(xs)))
    for m, v in Q_IN + [(0.0, 4.0)]:
        close_tuple(tu.marginal_in(TK, ta, td.Gaussian(T(q_out[0]), T(q_out[1])), T(mu), T(w),
                                   td.Gaussian(T(m), T(v))),
                    ju.marginal_in(JK, ja, jd.Gaussian(J(q_out[0]), J(q_out[1])), J(mu), J(w),
                                   jd.Gaussian(J(m), J(v))))


def test_w_messages_and_energies_match_jax(node):
    ja, ta, mu, w, El = node["jargs"], node["targs"], node["mu_v"], node["w"], node["Elogw"]
    for x in X_OBS:
        for vy in (0.0, 0.3):
            close_tuple(tu.w_message_exact(TK, ta, T(x), T(0.5), T(vy), T(mu)),
                        ju.w_message_exact(JK, ja, J(x), J(0.5), J(vy), J(mu)))
            close(tu.average_energy_exact(TK, ta, T(x), T(0.5), T(vy), T(mu), T(w), T(El)),
                  ju.average_energy_exact(JK, ja, J(x), J(0.5), J(vy), J(mu), J(w), J(El)))
    for method in METHODS:
        for m, v in Q_IN:
            tin, jin = td.Gaussian(T(m), T(v)), jd.Gaussian(J(m), J(v))
            close_tuple(tu.w_message_uncertain(TK, _port(method), ta, T(0.5), T(0.1), tin,
                                               T(mu)),
                        ju.w_message_uncertain(JK, method, ja, J(0.5), J(0.1), jin, J(mu)))
            close(tu.average_energy_uncertain(TK, _port(method), ta, T(0.5), T(0.1), tin,
                                              T(mu), T(w), T(El)),
                  ju.average_energy_uncertain(JK, method, ja, J(0.5), J(0.1), jin, J(mu),
                                              J(w), J(El)))
    X = np.array(X_OBS)[:, None]
    kxx = np.asarray(JK.diag(J(node["theta"]), J(X)))
    Kux = np.asarray(JK(J(node["theta"]), J(node["Xu"]), J(X)))
    ym, yv = np.array([0.2, -0.4, 1.1]), np.array([0.0, 0.3, 0.05])
    got = tu.w_message_batch_exact(TK, ta, T(kxx), T(Kux), T(ym), T(yv), T(mu))
    want = ju.w_message_batch_exact(JK, ja, J(kxx), J(Kux), J(ym), J(yv), J(mu))
    assert float(got[0]) == float(want[0])
    close(got[1], want[1])
    close(tu.average_energy_exact_batch(TK, ta, T(kxx), T(Kux), T(ym), T(yv), T(mu), T(w),
                                        T(El)),
          ju.average_energy_exact_batch(JK, ja, J(kxx), J(Kux), J(ym), J(yv), J(mu), J(w),
                                        J(El)))


def test_clamps_bound_the_uncertain_terms_as_in_jax(node):
    """A Uv of zeros and q_out = 0 make I2 = 0 and a Kuu⁻¹ far from the Gram
    makes I1 negative; both clamp to 1e-12 in both packages."""
    ja, ta, mu = node["jargs"], node["targs"], node["mu_v"]
    z = np.zeros((M, M))
    ja0, ta0 = ja._replace(Uv=J(z), KuuL=ja.KuuL * 0.2), ta._replace(Uv=T(z), KuuL=ta.KuuL * 0.2)
    got = tu._w_terms_uncertain(TK, tq.GenUT(), ta0, T(0.0), T(0.0), td.Gaussian(T(0.1), T(0.2)),
                                T(mu))
    want = ju._w_terms_uncertain(JK, jq.GenUT(), ja0, J(0.0), J(0.0), jd.Gaussian(J(0.1), J(0.2)),
                                 J(mu))
    assert float(got[0]) == float(want[0]) == 1e-12
    assert float(got[1]) == float(want[1]) == 1e-12


@pytest.mark.parametrize("method", [None] + METHODS, ids=repr)
def test_theta_log_messages_and_gradients_match_jax(node, method):
    mu, Rv, w, Xu = node["mu_v"], node["Rv"], node["w"], node["Xu"]
    th0 = np.array([0.1, 0.4])
    if method is None:
        jlp = ju.theta_log_message_exact(JK, J(Xu), J(0.8), J(0.3), J(mu), J(Rv), J(w))
        tlp = tu.theta_log_message_exact(TK, T(Xu), T(0.8), T(0.3), T(mu), T(Rv), T(w))
    else:
        jlp = ju.theta_log_message_uncertain(JK, method, J(Xu), jd.Gaussian(J(0.8), J(0.2)),
                                             J(0.3), J(mu), J(Rv), J(w))
        tlp = tu.theta_log_message_uncertain(TK, _port(method), T(Xu),
                                             td.Gaussian(T(0.8), T(0.2)), T(0.3), T(mu), T(Rv),
                                             T(w))
    t = T(th0).requires_grad_(True)
    val = tlp(t)
    (g,) = torch.autograd.grad(val, t)
    close(val, jlp(J(th0)))
    close(g, jax.grad(jlp)(J(th0)))


def test_float32_node_rules_match_jax_to_float32_rounding(node):
    """The same node state in float32 in both packages: exact and uncertain
    (GH-21) rules and the batched energy. Each passes the Gram through a
    triangular solve with KuuL, so the bound is 64·ε·κ(Kuu) of the result's
    largest entry (κ(Kuu) ≈ 4.8 here)."""
    f32 = np.float32
    th, Xu, mu = (np.asarray(node[k], f32) for k in ("theta", "Xu", "mu_v"))
    KuuL = np.asarray(jl.chol_lower(JK.kuu(jnp.asarray(th), jnp.asarray(Xu), jitter=1e-8)))
    Uv = np.asarray(node["Uv"], f32)
    kuu = np.asarray(JK.kuu(jnp.asarray(th), jnp.asarray(Xu)), np.float64)
    rtol = 64 * float(np.finfo(f32).eps) * np.linalg.cond(kuu)
    ja = ju.UniSGPArgs(*(jnp.asarray(a) for a in (th, Xu, KuuL, Uv)))
    ta = tu.UniSGPArgs(*(torch.as_tensor(np.array(a)) for a in (th, Xu, KuuL, Uv)))

    def j32(a):
        return jnp.asarray(np.asarray(a, f32))

    def t32(a):
        return torch.as_tensor(np.asarray(a, f32))

    for x in X_OBS:
        close_tuple(tu.out_message_exact(TK, ta, t32(x), t32(mu), t32(7.5)),
                    ju.out_message_exact(JK, ja, j32(x), j32(mu), j32(7.5)), rtol)
        close_tuple(tu.w_message_exact(TK, ta, t32(x), t32(0.5), t32(0.1), t32(mu)),
                    ju.w_message_exact(JK, ja, j32(x), j32(0.5), j32(0.1), j32(mu)), rtol)
    close_tuple(tu.w_message_uncertain(TK, tq.GaussHermite(21), ta, t32(0.5), t32(0.1),
                                       td.Gaussian(t32(0.4), t32(0.3)), t32(mu)),
                ju.w_message_uncertain(JK, jq.GaussHermite(21), ja, j32(0.5), j32(0.1),
                                       jd.Gaussian(j32(0.4), j32(0.3)), j32(mu)), rtol)
    X = np.asarray(X_OBS, f32)[:, None]
    kxx = np.asarray(JK.diag(jnp.asarray(th), jnp.asarray(X)))
    Kux = np.asarray(JK(jnp.asarray(th), jnp.asarray(Xu), jnp.asarray(X)))
    ym, yv = np.asarray([0.2, -0.4, 1.1], f32), np.asarray([0.0, 0.3, 0.05], f32)
    close(tu.average_energy_exact_batch(TK, ta, t32(kxx), t32(Kux), t32(ym), t32(yv), t32(mu),
                                        t32(7.5), t32(0.3)),
          ju.average_energy_exact_batch(JK, ja, j32(kxx), j32(Kux), j32(ym), j32(yv), j32(mu),
                                        j32(7.5), j32(0.3)), rtol)
