"""The port's probit node (nodes/probit.py), its Gauss–Hermite rule
(ops/quadrature.py) and the classification metrics against the JAX
package's, on the CPU, in float32 and float64.

The grid: 2,000 seeded (m, v, y) with v ∈ [0.01, 3], y ∈ {0, 1} and
z = s·m/√(1+v) uniform on [−40, 40]. The two packages compute the same
formulas from primitives that round differently:

- log Φ: ``torch.special.log_ndtr`` and JAX's ``log_ndtr`` agree to
  4ε·max(1, |log Φ|), except JAX's float64 asymptotic series below z = −20,
  which is 2e-11 relative from the exact value (measured; held to 1e-10);
- Φ: the port's ``ndtr`` is ½·erfc(−x/√2), JAX's the same in the tails
  and ½(1 + erf(x/√2)) near 0; they agree to 512ε relative where Φ is a
  normal number (erfc's implementations differ by up to ~260ε deep in the
  float64 tail) and to finfo.tiny absolute in the subnormal range.

Each composite is held to the first-order propagation of those gaps
through its formula, plus a few ε of its own rounding; the bounds are
written beside each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import Gaussian as JGaussian
from gaussianprocessnode_tpu.nodes import probit as jp
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.utils import metrics as jmetrics
from gaussianprocessnode_tpu_torch.dists import Gaussian
from gaussianprocessnode_tpu_torch.nodes import probit as tp
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.utils import metrics

DTYPES = [np.float32, np.float64]
N_GRID = 2000


def grid(dtype):
    rng = np.random.default_rng(0)
    v = rng.uniform(0.01, 3.0, N_GRID)
    z = rng.uniform(-40.0, 40.0, N_GRID)
    y = rng.integers(0, 2, N_GRID).astype(np.float64)
    m = z * np.sqrt(1.0 + v) / (2.0 * y - 1.0)
    return m.astype(dtype), v.astype(dtype), y.astype(dtype)


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def logcdf_gap_bound(z, dtype):
    """The stated bound on |log Φ_torch(z) − log Φ_jax(z)|."""
    eps = float(np.finfo(dtype).eps)
    lc = np.abs(_np(torch.special.log_ndtr(torch.as_tensor(z))))
    bound = 4.0 * eps * np.maximum(1.0, lc)
    if dtype == np.float64:
        bound = np.where(_np(z) < -20.0, np.maximum(bound, 1e-10 * lc), bound)
    return bound


@pytest.mark.parametrize("dtype", DTYPES)
def test_primitives_match_jax(dtype):
    z = np.random.default_rng(1).uniform(-40.0, 40.0, 20000).astype(dtype)
    eps, tiny = float(np.finfo(dtype).eps), float(np.finfo(dtype).tiny)
    jl = _np(jax.scipy.stats.norm.logcdf(jnp.asarray(z)))
    tl = _np(torch.special.log_ndtr(torch.as_tensor(z)))
    assert np.all(np.abs(tl - jl) <= logcdf_gap_bound(z, dtype))
    jc = _np(jax.scipy.stats.norm.cdf(jnp.asarray(z)))
    tc = _np(tp.ndtr(torch.as_tensor(z)))
    assert np.all(np.abs(tc - jc) <= 512 * eps * jc + tiny)
    jd = _np(jax.scipy.stats.norm.logpdf(jnp.asarray(z)))
    td = _np(tp._norm_logpdf(torch.as_tensor(z)))
    np.testing.assert_allclose(td, jd, rtol=4 * eps, atol=0)


def test_ndtr_keeps_the_lower_tail():
    """Φ(−10) in float32 and Φ(−30) in float64 are normal numbers; the
    port's ndtr returns them (torch.special.ndtr gives 0 there)."""
    from scipy.special import ndtr as sp_ndtr

    for x, dt in ((-10.0, torch.float32), (-30.0, torch.float64)):
        got = float(tp.ndtr(torch.tensor(x, dtype=dt)))
        assert got == pytest.approx(float(sp_ndtr(x)), rel=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_out_probability_matches_jax(dtype):
    """Φ ∈ [0, 1]: 4ε absolute (measured 0.5ε)."""
    m, v, _ = grid(dtype)
    want = _np(jp.out_probability(JGaussian(jnp.asarray(m), jnp.asarray(v))))
    got = tp.out_probability(Gaussian(torch.as_tensor(m), torch.as_tensor(v)))
    assert got.dtype == torch.from_numpy(m).dtype
    assert np.max(np.abs(_np(got) - want)) <= 4 * np.finfo(dtype).eps


@pytest.mark.parametrize("dtype", DTYPES)
def test_tilted_marginal_matches_jax(dtype):
    """Closed form. With r = φ(z)/Φ(z) and δ the log-cdf gap bound, r moves
    by r·δ relative, so m_t by v·r·δ/√(1+v) and v_t by
    v²/(1+v)·r·(|z|+2r)·δ (the derivative of r(z+r)); z+r cancels at large
    |z|, which is why v_t's gap grows like |z|³ (measured up to 1.1e6·ε·v
    in float32 at |z| = 40). Held to 4× that plus 64ε of each output's
    scale. The Gaussian-in form agrees bit for bit with the batch form."""
    m, v, y = grid(dtype)
    eps = float(np.finfo(dtype).eps)
    M, V, Y = (torch.as_tensor(a) for a in (m, v, y))
    jm, jv = jp.tilted_marginal_batch(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y))
    tm, tv = tp.tilted_marginal_batch(M, V, Y)
    assert tm.dtype == tv.dtype == M.dtype
    s = 2.0 * y.astype(np.float64) - 1.0
    den = np.sqrt(1.0 + v.astype(np.float64))
    z = (s * m / den).astype(dtype)
    zz = _np(z)
    zt = torch.as_tensor(z)
    r = np.exp(_np(tp._norm_logpdf(zt) - torch.special.log_ndtr(zt)))
    d = logcdf_gap_bound(z, dtype) + 4 * eps
    vv = _np(V)
    tol_m = 4 * vv * r * d / den + 64 * eps * (np.abs(_np(jm)) + np.sqrt(vv))
    tol_v = 4 * vv**2 / (1 + vv) * r * (np.abs(zz) + 2 * r) * d + 64 * eps * vv
    assert np.all(np.abs(_np(tm) - _np(jm)) <= tol_m)
    assert np.all(np.abs(_np(tv) - _np(jv)) <= tol_v)
    q = tp.tilted_marginal(Gaussian(M, V), Y)
    assert torch.equal(q.mean, tm) and torch.equal(q.var, tv)
    assert bool(torch.all(tv >= 1e-12)) and bool(torch.all(torch.isfinite(tm)))


def _gh_sums(m, v, y, ndtr):
    """Σ w·Φ(s·pts) per row, with the given Φ (float64 arithmetic)."""
    z, w = jq._gh_nodes_np(32)
    pts = m[:, None] + np.sqrt(v)[:, None] * z
    return np.sum(w * ndtr((2.0 * y - 1.0)[:, None] * pts), axis=1), pts


@pytest.mark.parametrize("dtype", DTYPES)
def test_tilted_marginal_gh_matches_jax(dtype):
    """GH-32 moments. Each Φ term differs by at most ρ = 512ε relative plus
    finfo.tiny absolute (subnormal), so Zsum by ρ·Z + tiny and m_t, v_t by
    (ρ + 32·tiny/Z) times the spread of the points (max |pts| for m_t,
    max (pts − m)² for v_t), doubled for the ratio and held with a factor
    4; where either package's Zsum underflows to 0 the two cannot be
    compared, and each must then return its forward marginal exactly (the
    guard)."""
    m, v, y = grid(dtype)
    eps, tiny = float(np.finfo(dtype).eps), float(np.finfo(dtype).tiny)
    jg = jp.tilted_marginal_gh_batch(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y))
    tg = tp.tilted_marginal_gh_batch(*(torch.as_tensor(a) for a in (m, v, y)))
    assert tg.mean.dtype == torch.from_numpy(m).dtype
    j_ndtr = lambda x: _np(jax.scipy.special.ndtr(jnp.asarray(x.astype(dtype))))  # noqa: E731
    t_ndtr = lambda x: _np(tp.ndtr(torch.as_tensor(x.astype(dtype))))  # noqa: E731
    m64, v64, y64 = _np(m), _np(v), _np(y)
    zj, pts = _gh_sums(m64, v64, y64, j_ndtr)
    zt, _ = _gh_sums(m64, v64, y64, t_ndtr)
    zmin = np.minimum(zj, zt)
    ok = zmin > 0
    rho = 512 * eps
    rel = 2 * (rho + 32 * tiny / np.where(ok, zmin, 1.0)) + 64 * eps
    tol_m = 4 * rel * np.max(np.abs(pts), axis=1)
    tol_v = 4 * rel * np.max((pts - m64[:, None]) ** 2, axis=1) + 64 * eps * v64
    dm, dv = np.abs(_np(tg.mean) - _np(jg.mean)), np.abs(_np(tg.var) - _np(jg.var))
    assert np.all(dm[ok] <= tol_m[ok]) and np.all(dv[ok] <= tol_v[ok])
    assert 0.2 < ok.mean() < 0.95  # the grid reaches both regimes
    for zs, q in ((zj, jg), (zt, tg)):
        under = zs == 0
        assert np.array_equal(_np(q.mean)[under], m64[under])
        assert np.array_equal(_np(q.var)[under], v64[under])
    # the scalar call is the batch call's row
    i = int(np.argmax(ok))
    q1 = tp.tilted_marginal_gh(torch.as_tensor(m[i]), torch.as_tensor(v[i]), float(y[i]))
    assert float(q1.mean) == float(tg.mean[i]) and float(q1.var) == float(tg.var[i])


def test_gh_underflow_falls_back_to_forward_marginal():
    """The JAX package's pinned case (tests/test_probit_svgp.py): in float32
    all 32 GH values underflow at m = −20, y = 1, so the guard returns the
    forward marginal N(−20, 0.5), not N(0, 1e-12); JAX does the same."""
    m, v, y = np.float32(-20.0), np.float32(0.5), np.float32(1.0)
    q = tp.tilted_marginal_gh(torch.tensor(m), torch.tensor(v), torch.tensor(y))
    jq_ = jp.tilted_marginal_gh(jnp.float32(m), jnp.float32(v), jnp.float32(y))
    assert q.mean.dtype == torch.float32
    assert float(q.mean) == float(jq_.mean) == -20.0
    assert float(q.var) == float(jq_.var) == 0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_average_energy_matches_jax(dtype):
    """U = −Σ w log Φ(s·pts): each term moves by the log-cdf gap bound at
    its point, so |ΔU| ≤ Σ w·δ(s·pts), held with a factor 2 plus 64ε·|U|;
    the batch form is the sum of the per-point values."""
    m, v, y = grid(dtype)
    eps = float(np.finfo(dtype).eps)
    want = _np(jax.vmap(lambda a, b, c: jp.average_energy(JGaussian(a, b), c))(
        jnp.asarray(m), jnp.asarray(v), jnp.asarray(y)))
    M, V, Y = (torch.as_tensor(a) for a in (m, v, y))
    got = tp.average_energy(Gaussian(M, V), Y)
    assert got.shape == (N_GRID,) and got.dtype == M.dtype
    pts, w = tq.gh_points_weights(32, M, V)
    arg = ((2.0 * Y - 1.0).unsqueeze(-1) * pts).numpy()
    tol = 2 * np.sum(_np(w) * logcdf_gap_bound(arg, dtype), axis=1) + 64 * eps * np.abs(want)
    assert np.all(np.abs(_np(got) - want) <= tol)
    jb = float(jp.average_energy_batch(jnp.asarray(m), jnp.asarray(v), jnp.asarray(y)))
    tb = float(tp.average_energy_batch(M, V, Y))
    assert tb == pytest.approx(jb, rel=N_GRID * eps, abs=float(np.sum(tol)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5, 32])
def test_gh_points_weights_match_jax(n, dtype):
    """The nodes and weights are the same float64 numbers rounded to the
    dtype (bit for bit); the points m + √v·z to 2ε of |m| + √v·|z|."""
    zj, wj = jq.gh_nodes(n)
    zt, wt = tq.gh_nodes(n)
    assert np.array_equal(zt.numpy(), np.asarray(zj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    assert float(torch.sum(wt)) == pytest.approx(1.0, abs=1e-14)
    m, v = dtype(0.7), dtype(1.9)
    pj, wj = jq.gh_points_weights(n, jnp.asarray(m), jnp.asarray(v))
    pt, wt = tq.gh_points_weights(n, torch.tensor(m), torch.tensor(v))
    assert pt.dtype == wt.dtype == torch.from_numpy(np.asarray(m)).dtype
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    eps = float(np.finfo(dtype).eps)
    tol = 2 * eps * (abs(float(m)) + np.sqrt(float(v)) * np.abs(_np(zt)))
    assert np.all(np.abs(_np(pt) - _np(pj)) <= tol)
    # a batch gives one row of points per (m, v)
    pb, _ = tq.gh_points_weights(n, torch.tensor([m, m]), torch.tensor([v, v]))
    assert pb.shape == (2, n) and torch.equal(pb[1], pt)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 1300).astype(np.float64)
    pred = np.where(rng.random(1300) < 0.1, 1.0 - y, y)
    ne = metrics.num_error(y, pred)
    assert float(ne) == float(jmetrics.num_error(y, pred)) == float(np.sum(y != pred))
    assert float(metrics.error_rate(y, pred)) == float(jmetrics.error_rate(y, pred))
    assert float(metrics.error_rate(torch.as_tensor(y), torch.as_tensor(y))) == 0.0
