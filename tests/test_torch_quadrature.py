"""Parity of the port's ops/quadrature.py with the JAX package's, on the CPU.

Every rule (GH, SR, UT, GenUT; univariate and multivariate at d = 1, 2, 3,
so both closed-form Cholesky branches and the general one run), both GenUT
statistics, the joint forms, the expectations and the three moment
matchers, on the same seeded inputs. The port's callables take all points
at once; the JAX ones are vmapped scalar functions of the same formula.

Tolerances. In float64 both packages evaluate the same formulas and differ
only by the order of their few-term sums and by libm: ≤ 1e-12 relative
(measured ≤ 1e-15 on the rules). Values that can cancel to ~0 (central
moments of a symmetric rule, cross-covariances) are held to 1e-12 of the
scale they cancel from. In float32 the same bound is 64·ε of that scale:
each result is a few dozen float32 operations deep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu_torch.ops import quadrature as tq

RTOL = {np.float64: 1e-12, np.float32: 64 * float(np.finfo(np.float32).eps)}
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def close(got, want, rtol, scale=None):
    """|got − want| ≤ rtol·max(|want|, scale) elementwise."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    s = np.abs(w) if scale is None else np.maximum(np.abs(w), scale)
    err = np.abs(g - w)
    assert np.all(err <= rtol * s), f"max excess {np.max(err / (rtol * s))}"


def spd(d, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    return (A @ A.T + 0.5 * np.eye(d)).astype(dtype)


def both(x, dtype=np.float64):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.as_tensor(x)


UNI_METHODS = [jq.GaussHermite(21), jq.GaussHermite(32), jq.SphericalRadial(),
               jq.Unscented(), jq.Unscented(alpha=0.5, beta=2.0, kappa=1.0), jq.GenUT()]


def _port(method):
    """The port's marker of the same rule and parameters."""
    return getattr(tq, type(method).__name__)(**vars(method))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", UNI_METHODS, ids=repr)
def test_univariate_points_and_weights_match_jax(method, dtype):
    for m, v in [(0.3, 1.7), (-2.0, 0.04), (0.0, 1.0)]:
        jm, tm = both(m, dtype)
        jv, tv = both(v, dtype)
        jp, jw = jq.points_weights_uni(method, jm, jv)
        tp, tw = tq.points_weights_uni(_port(method), tm, tv)
        close(tp, jp, RTOL[dtype], scale=abs(m) + np.sqrt(v))
        close(tw, jw, RTOL[dtype], scale=1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_univariate_rules_batch_as_jax_vmaps_them(dtype):
    """A batch of (m, v) gives one row of points each, as jax.vmap of the
    scalar rule does."""
    rng = np.random.default_rng(3)
    m, v = rng.standard_normal(9), rng.uniform(0.1, 3.0, 9)
    for method in UNI_METHODS:
        jp, jw = jax.vmap(lambda a, b: jq.points_weights_uni(method, a, b))(*both(m, dtype)[:1],
                                                                          both(v, dtype)[0])
        tp, tw = tq.points_weights_uni(_port(method), both(m, dtype)[1], both(v, dtype)[1])
        close(tp, jp, RTOL[dtype], scale=np.abs(m)[:, None] + np.sqrt(v)[:, None])
        close(tw if tw.dim() == 2 else tw.expand(jw.shape), jw, RTOL[dtype], scale=1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_multivariate_rules_match_jax(d, dtype):
    m = np.random.default_rng(d).standard_normal(d)
    V = spd(d, d, dtype)
    jm, tm = both(m, dtype)
    jV, tV = both(V, dtype)
    scale = np.abs(m).max() + np.sqrt(np.diag(V)).max() * np.sqrt(2 * d + 1)
    jp, jw = jq.sr_points_weights(jm, jV)
    tp, tw = tq.sr_points_weights(tm, tV)
    close(tp, jp, RTOL[dtype], scale=scale)
    close(tw, jw, RTOL[dtype])
    for a, b, k in [(1e-3, 2.0, 0.0), (0.7, 2.0, 1.0)]:
        jp, jwm, jwc = jq.ut_points_weights(jm, jV, a, b, k)
        tp, twm, twc = tq.ut_points_weights(tm, tV, a, b, k)
        close(tp, jp, RTOL[dtype], scale=scale)
        close(twm, jwm, RTOL[dtype])
        close(twc, jwc, RTOL[dtype])
    jp, jw = jq.genut_points_weights_multi(jm, jV)
    tp, tw = tq.genut_points_weights_multi(tm, tV)
    close(tp, jp, RTOL[dtype], scale=scale)
    close(tw, jw, RTOL[dtype], scale=1.0)
    S = np.linspace(-0.3, 0.4, d)
    K = 3.5 * np.sqrt(np.diag(V)) ** 4
    jp, jw = jq.genut_points_weights_multi(jm, jV, both(S, dtype)[0], both(K, dtype)[0])
    tp, tw = tq.genut_points_weights_multi(tm, tV, both(S, dtype)[1], both(K, dtype)[1])
    close(tp, jp, RTOL[dtype], scale=scale)
    close(tw, jw, RTOL[dtype], scale=1.0)
    for method in [jq.SphericalRadial(), jq.Unscented(), jq.GenUT()]:
        for jf, tf in [(jq.points_weights_multi, tq.points_weights_multi),
                       (jq.points_weights_cov_multi, tq.points_weights_cov_multi)]:
            for a, b in zip(jf(method, jm, jV), tf(_port(method), tm, tV)):
                close(b, a, RTOL[dtype], scale=max(scale, 1.0))


def test_multivariate_rules_batch_as_jax_vmaps_them():
    rng = np.random.default_rng(11)
    means = rng.standard_normal((5, 2))
    covs = np.stack([spd(2, s) for s in range(5)])
    for method in [jq.SphericalRadial(), jq.Unscented(), jq.GenUT()]:
        jp, jw = jax.vmap(lambda a, b: jq.points_weights_multi(method, a, b))(
            jnp.asarray(means), jnp.asarray(covs))
        tp, tw = tq.points_weights_multi(_port(method), torch.as_tensor(means),
                                         torch.as_tensor(covs))
        close(tp, jp, 1e-12, scale=5.0)
        close(tw if tw.dim() == 2 else tw.expand(jw.shape), jw, 1e-12, scale=1.0)


def test_skewed_univariate_genut_matches_jax():
    jp, jw = jq.genut_points_weights_uni(jnp.asarray(0.4), jnp.asarray(2.0), jnp.asarray(0.9),
                                         jnp.asarray(14.0))
    tp, tw = tq.genut_points_weights_uni(torch.tensor(0.4, dtype=torch.float64),
                                         torch.tensor(2.0, dtype=torch.float64),
                                         torch.tensor(0.9, dtype=torch.float64),
                                         torch.tensor(14.0, dtype=torch.float64))
    close(tp, jp, 1e-12)
    close(tw, jw, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_expectations_match_jax(dtype):
    def jf(x):
        return jnp.stack([jnp.sin(x), x**3, jnp.exp(-x * x)])

    def tf(x):  # all points at once: (P,) → (P, 3)
        return torch.stack([torch.sin(x), x**3, torch.exp(-x * x)], dim=-1)

    # the UT at α = 1e-3 weighs its centre by ≈ −1e6: its sums cancel, so
    # each expectation is held to its cancellation scale Σ|wᵢ|·|f|max
    for method in UNI_METHODS:
        want = jq.expect_uni(method, jf, *both(0.3, dtype)[:1], both(1.2, dtype)[0])
        got = tq.expect_uni(_port(method), tf, both(0.3, dtype)[1], both(1.2, dtype)[1])
        pts, w = jq.points_weights_uni(method, 0.3, 1.2)
        close(got, want, RTOL[dtype], scale=float(jnp.sum(jnp.abs(w))) * 30.0)
    m, V = np.array([0.2, -0.5, 1.0]), spd(3, 4)

    def jg(x):
        return jnp.stack([jnp.sum(jnp.sin(x)), x[0] * x[1] * x[2]])

    def tg(x):
        return torch.stack([torch.sum(torch.sin(x), -1), x[:, 0] * x[:, 1] * x[:, 2]], -1)

    for method in [jq.SphericalRadial(), jq.Unscented(), jq.GenUT()]:
        want = jq.expect_multi(method, jg, *both(m, dtype)[:1], both(V, dtype)[0])
        got = tq.expect_multi(_port(method), tg, both(m, dtype)[1], both(V, dtype)[1])
        _, w = jq.points_weights_multi(method, jnp.asarray(m), jnp.asarray(V))
        close(got, want, RTOL[dtype], scale=float(jnp.sum(jnp.abs(w))) * 30.0)


def _jlog(x):
    return -0.5 * (x - 1.3) ** 2 / 0.25 + jnp.log1p(0.3 * jnp.sin(x))


def _tlog(x):
    return -0.5 * (x - 1.3) ** 2 / 0.25 + torch.log1p(0.3 * torch.sin(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,var_floor", [(21, 0.0), (21, 1e-6), (32, 0.0)])
def test_moment_match_uni_matches_jax(n, var_floor, dtype):
    jm, tm = both(0.4, dtype)
    jv, tv = both(0.8, dtype)
    want = jq.moment_match_uni(_jlog, jm, jv, n=n, var_floor=var_floor)
    got = tq.moment_match_uni(_tlog, tm, tv, n=n, var_floor=var_floor)
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype])
    want = jq.moment_match_uni_logz(_jlog, jm, jv, n=n)
    got = tq.moment_match_uni_logz(_tlog, tm, tv, n=n)
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype])


def test_moment_match_gradients_match_jax():
    """d(m_t, v_t, log Z)/d(m, v) through the GH rule and the stabilised
    exponentials (the EP-EM trainers differentiate through these)."""
    def jout(mv):
        a, b, c = jq.moment_match_uni_logz(_jlog, mv[0], mv[1], n=21)
        return jnp.stack([a, b, c])

    want = jax.jacfwd(jout)(jnp.asarray([0.4, 0.8]))
    mv = torch.tensor([0.4, 0.8], dtype=torch.float64)
    got = torch.autograd.functional.jacobian(
        lambda t: torch.stack(tq.moment_match_uni_logz(_tlog, t[0], t[1], n=21)), mv)
    close(got, want, 1e-12, scale=1.0)


def _zero_mass_logf_torch(x):
    # −inf at every GH point of N(0, 1): the product has zero quadrature mass
    return torch.where(x > 100.0, -(x - 100.0) ** 2, torch.full_like(x, -float("inf")))


def _zero_mass_logf_jax(x):
    return jnp.where(x > 100.0, -(x - 100.0) ** 2, -jnp.inf)


@pytest.mark.parametrize("fn", ["moment_match_uni", "moment_match_uni_logz"])
def test_zero_mass_product_falls_back_with_a_clean_gradient(fn):
    """With zero quadrature mass the matchers return the Gaussian factor
    (and log Z = −inf), and the gradient of the result with respect to
    (m, v) is the fallback's identity, not NaN: the double where on Z keeps
    the Σ/Z branch's NaN derivative out. JAX gives the same."""
    jfn, tfn = getattr(jq, fn), getattr(tq, fn)
    mv = torch.tensor([0.0, 1.0], dtype=torch.float64, requires_grad=True)
    out = tfn(_zero_mass_logf_torch, mv[0], mv[1], n=21)
    assert float(out[0].detach()) == 0.0 and float(out[1].detach()) == 1.0
    if fn == "moment_match_uni_logz":
        assert float(out[2].detach()) == -np.inf
    (g,) = torch.autograd.grad(out[0] + 2.0 * out[1], mv)
    want = jax.grad(lambda p: (lambda r: r[0] + 2.0 * r[1])(
        jfn(_zero_mass_logf_jax, p[0], p[1], n=21)))(jnp.asarray([0.0, 1.0]))
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g.numpy(), [1.0, 2.0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", [jq.SphericalRadial(), jq.Unscented(), jq.GenUT()],
                         ids=repr)
def test_moment_match_multi_matches_jax(method, dtype):
    m, V = np.array([0.3, -0.2]), spd(2, 7) * 0.3
    prec = np.linalg.inv(spd(2, 8))

    def jlog(x):
        d = x - jnp.asarray([1.0, 0.5])
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlog(x):  # (P, 2) → (P,)
        d = x - torch.tensor([1.0, 0.5], dtype=x.dtype)
        return -0.5 * torch.einsum("pi,ij,pj->p", d, torch.as_tensor(prec, dtype=x.dtype), d)

    want = jq.moment_match_multi(jlog, *both(m, dtype)[:1], both(V, dtype)[0], method)
    got = tq.moment_match_multi(tlog, both(m, dtype)[1], both(V, dtype)[1], _port(method))
    # held to the cancellation scale of the weighted sums (Σ|wᵢ| ≈ 2e6 for
    # the UT at α = 1e-3, 1 for the others)
    _, w, wc = jq.points_weights_cov_multi(method, jnp.asarray(m), jnp.asarray(V))
    scale = float(jnp.sum(jnp.abs(w)) + jnp.sum(jnp.abs(wc)))
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], scale=scale)


def test_moment_match_multi_falls_back_where_the_matched_covariance_is_indefinite():
    """The UT at α = 1e-3 on a log-density that keeps only its centre and
    one +x point: the centre's covariance weight (≈ −1e6) makes the matched
    covariance indefinite, its Cholesky factor is NaN (no error, no host
    sync), and both packages fall back to (m, V)."""
    m, V = np.zeros(2), np.eye(2)

    def tlog(x):
        keep = (x[:, 0] >= 0) & (x[:, 1] == 0)
        return torch.where(keep, torch.zeros_like(x[:, 0]), torch.full_like(x[:, 0], -1e4))

    def jlog(x):
        return jnp.where((x[0] >= 0) & (x[1] == 0), 0.0, -1e4)

    want = jq.moment_match_multi(jlog, jnp.asarray(m), jnp.asarray(V), jq.Unscented())
    got = tq.moment_match_multi(tlog, torch.as_tensor(m), torch.as_tensor(V), tq.Unscented())
    for g, w, fallback in zip(got, want, (m, V)):
        np.testing.assert_array_equal(_np(g), fallback)
        np.testing.assert_array_equal(_np(w), fallback)


@pytest.mark.parametrize("dtype", DTYPES)
def test_genut_statistics_match_jax(dtype):
    jm, tm = both(0.3, dtype)
    jv, tv = both(0.7, dtype)
    want = jq.genut_statistics_uni(lambda x: jnp.sin(x) + 0.1 * x**2, jm, jv)
    got = tq.genut_statistics_uni(lambda x: torch.sin(x) + 0.1 * x**2, tm, tv)
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], scale=1.0)
    want = jq.genut_expectation_uni(lambda x: jnp.cos(x), jm, jv, both(0.2, dtype)[0],
                                    both(1.6, dtype)[0])
    got = tq.genut_expectation_uni(lambda x: torch.cos(x), tm, tv, both(0.2, dtype)[1],
                                   both(1.6, dtype)[1])
    close(got, want, RTOL[dtype], scale=1.0)
    m, V = np.array([0.2, -0.4, 0.9]), spd(3, 5, dtype) * 0.2

    def jg(x):
        return jnp.stack([jnp.sin(x[0]) * x[1], x[2] ** 2])

    def tg(x):
        return torch.stack([torch.sin(x[:, 0]) * x[:, 1], x[:, 2] ** 2], -1)

    want = jq.genut_statistics_multi(jg, *both(m, dtype)[:1], both(V, dtype)[0])
    got = tq.genut_statistics_multi(tg, both(m, dtype)[1], both(V, dtype)[1])
    for g, w in zip(got, want):
        close(g, w, RTOL[dtype], scale=1.0)
    want = jq.genut_statistics_multi(jg, jnp.asarray(m), jnp.asarray(V), compute_cross=False)
    got = tq.genut_statistics_multi(tg, torch.as_tensor(m), torch.as_tensor(V),
                                    compute_cross=False)
    assert got[4] is None and want[4] is None


def test_genut_joint_forms_match_jax():
    """A scalar marginal, a correlated 2-D one and a 1-D one given with its
    own skew and kurtosis: the joint points, the expectation and the
    statistics (with and without the cross-covariance)."""
    V2 = spd(2, 9) * 0.4
    jmarg = [(jnp.asarray(0.3), jnp.asarray(0.5)),
             (jnp.asarray([1.0, -0.5]), jnp.asarray(V2)),
             (jnp.asarray([0.2]), jnp.asarray([[0.7]]), jnp.asarray([0.3]), jnp.asarray([1.9]))]
    tmarg = [tuple(torch.as_tensor(np.array(a)) for a in q) for q in jmarg]

    def jg(a, b, c):
        return jnp.stack([a * b[0] + jnp.sin(b[1]), c[0] ** 2 + a])

    def tg(a, b, c):  # a (P,), b (P, 2), c (P, 1)
        return torch.stack([a * b[:, 0] + torch.sin(b[:, 1]), c[:, 0] ** 2 + a], -1)

    want = jq.genut_expectation_joint(jg, *jmarg)
    got = tq.genut_expectation_joint(tg, *tmarg)
    close(got, want, 1e-12, scale=1.0)
    for cross in (True, False):
        want = jq.genut_statistics_joint(jg, *jmarg, compute_cross=cross)
        got = tq.genut_statistics_joint(tg, *tmarg, compute_cross=cross)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                close(g, w, 1e-12, scale=1.0)
    # a scalar-valued g comes back as one output
    want = jq.genut_statistics_joint(lambda a, b, c: a * b[1], *jmarg)
    got = tq.genut_statistics_joint(lambda a, b, c: a * b[:, 1], *tmarg)
    for g, w in zip(got, want):
        close(g, w, 1e-12, scale=1.0)
    with pytest.raises(ValueError):
        tq.genut_expectation_joint(tg, (tmarg[0][0], tmarg[0][1], None))
