"""Parity of the port's GP-PAD (infer/gppad.py) and its batched univariate
moment matching (ops/quadrature.py) with the JAX package's, on the CPU in
float64.

- ``moment_match_uni`` / ``moment_match_uni_logz`` on a batch of products,
  row by row against the same functions called on each row alone (1e-14
  relative: the same sums along the GH axis) and against JAX's single-site
  functions (1e-13), on rows whose
  log-densities differ by thousands of nats (a shared max would underflow
  every row but one), a row with zero quadrature mass (−inf everywhere), a
  NaN row and a row with a non-positive matched variance: each keeps its own
  max and its own fallback;
- ``two_stage_tilt`` on a batch of sites against ``jax.vmap`` of JAX's
  (1e-12);
- ``gppad_infer`` (sequential and parallel chain sweeps, cold and warm
  from a JAX state through ``convert.pad_state_from_jax``) and
  ``colored_pad_sweep`` / ``gppad_colored_infer`` against JAX's at T = 64–96:
  the smoothed moments to 1e-11 relative to their largest entry and the
  sites to 1e-9 (an EP loop carries each sweep's rounding into the next
  tilt; measured ≤ 3.3e-13 in the moments and ≤ 1.1e-11 in the sites, the
  colored loop's parallel form);
- a bank of K models (θ (K, 2), per-model carrier variances) row by row
  against the unbatched calls (1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import gppad as jg
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.infer import gppad as tg
from gaussianprocessnode_tpu_torch.ops import quadrature as tq

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    scale = np.max(np.abs(b[np.isfinite(b)])) if np.isfinite(b).any() else 1.0
    same_inf = np.array_equal(np.isfinite(a), np.isfinite(b)) and np.array_equal(
        a[~np.isfinite(a)], b[~np.isfinite(b)])
    assert same_inf, (a, b)
    fin = np.isfinite(b)
    return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0) / max(scale, 1e-300))


def pad_draw(seed, T=64):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4.0, T)
    f = 0.8 * np.sin(2.0 * np.pi * t / 4.0)
    return t, 0.2 * rng.normal(size=T) * np.exp(f)


def colored_draw(seed, T=64):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0, T)
    f = 0.6 * np.sin(2.0 * np.pi * t / 2.0)
    c = np.sin(2.0 * np.pi * 6.0 * t + rng.uniform(0, 6))
    return t, c * np.exp(f) + 0.03 * rng.normal(size=T)


# rows: ordinary; log-densities 3,000 nats below the others; zero mass;
# NaN; a likelihood so sharp that the matched variance rounds to ≤ 0
ROWS_M = np.array([0.3, -1.0, 0.5, 0.1, 2.0])
ROWS_V = np.array([0.5, 2.0, 0.3, 1.0, 1e-3])
ROWS_SHIFT = np.array([0.0, -3000.0, 0.0, 0.0, 0.0])
ROWS_SHARP = np.array([1.0, 1.0, 1.0, 1.0, 1e18])


def _row_logf(f, k, lib):
    """log f_k: a Gaussian-ish likelihood per row, with the rows' special
    cases (``lib`` is torch or jnp)."""
    base = -0.5 * ROWS_SHARP[k] * (f - 0.7) ** 2 + ROWS_SHIFT[k]
    if k == 2:
        return base - lib.inf
    if k == 3:
        return base * lib.nan
    return base


def _batch_logf(f):
    rows = [_row_logf(f[k], k, torch) for k in range(len(ROWS_M))]
    return torch.stack(rows)


@pytest.mark.parametrize("n", [21, 61])
def test_moment_match_batch_row_by_row(n):
    m, v = t64(ROWS_M), t64(ROWS_V)
    mb, vb = tq.moment_match_uni(_batch_logf, m, v, n=n)
    mz, vz, lz = tq.moment_match_uni_logz(_batch_logf, m, v, n=n)
    for k in range(len(ROWS_M)):
        ms, vs = tq.moment_match_uni(lambda f: _row_logf(f, k, torch), m[k], v[k], n=n)
        mzs, vzs, lzs = tq.moment_match_uni_logz(lambda f: _row_logf(f, k, torch), m[k], v[k],
                                                 n=n)
        for a, b in ((mb[k], ms), (vb[k], vs), (mz[k], mzs), (vz[k], vzs), (lz[k], lzs)):
            assert rel(a, b.numpy()) <= 1e-14
        mj, vj = jq.moment_match_uni(lambda f: _row_logf(f, k, jnp), ROWS_M[k], ROWS_V[k], n=n)
        mzj, vzj, lzj = jq.moment_match_uni_logz(lambda f: _row_logf(f, k, jnp), ROWS_M[k],
                                                 ROWS_V[k], n=n)
        for a, b in ((mb[k], mj), (vb[k], vj), (mz[k], mzj), (vz[k], vzj), (lz[k], lzj)):
            assert rel(a, b) <= 1e-13
    # the fallbacks: zero mass and NaN keep (m, v) and score −inf
    for k in (2, 3):
        assert float(mb[k]) == ROWS_M[k] and float(vb[k]) == ROWS_V[k]
        assert float(lz[k]) == -np.inf
    # the far row is matched, not dropped by another row's max
    assert float(vb[1]) != ROWS_V[1] and np.isfinite(float(lz[1]))


def test_moment_match_batch_gradient_through_a_dead_row():
    """The double where keeps a zero-mass row's NaN out of the gradient, as
    in JAX: d(Σ m̃ + ṽ)/dm against ``jax.grad`` of the vmapped rule."""
    dead = np.array([0.0, -np.inf])

    def tlogf(f):
        return -0.5 * (f - 0.7) ** 2 + t64(dead)[:, None]

    m = t64(ROWS_M[:2]).requires_grad_()
    mb, vb = tq.moment_match_uni(tlogf, m, t64(ROWS_V[:2]), n=21)
    (g,) = torch.autograd.grad((mb + vb).sum(), m)

    def jrow(mk, vk, dk):
        mt, vt = jq.moment_match_uni(lambda f: -0.5 * (f - 0.7) ** 2 + dk, mk, vk, n=21)
        return mt + vt

    gj = jax.grad(lambda mm: jnp.sum(jax.vmap(jrow)(mm, jnp.asarray(ROWS_V[:2]),
                                                    jnp.asarray(dead))))(
        jnp.asarray(ROWS_M[:2]))
    assert torch.isfinite(g).all()
    assert rel(g, gj) <= 1e-13


def test_two_stage_tilt_batch():
    rng = np.random.default_rng(3)
    T = 40
    m, v = rng.normal(size=T), rng.uniform(0.05, 1.5, T)
    y, mc, vc = rng.normal(size=T), rng.normal(size=T), rng.uniform(0.01, 0.3, T)
    obs = 1e-3

    def tll(f):
        return tg.colored_pad_loglik(t64(y)[:, None], f, t64(mc)[:, None], t64(vc)[:, None],
                                     obs)

    mt, vt = tg.two_stage_tilt(tll, t64(m), t64(v), n=61)

    def one(mk, vk, yk, mck, vck):
        return jg.two_stage_tilt(lambda f: jg.colored_pad_loglik(yk, f, mck, vck, obs), mk, vk,
                                 n=61)

    mj, vj = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (m, v, y, mc, vc)))
    assert rel(mt, mj) <= 1e-12
    assert rel(vt, vj) <= 1e-12


@pytest.mark.parametrize("parallel", [False, True])
def test_gppad_infer_matches_jax(parallel):
    t, y = pad_draw(1, T=96)
    theta = np.array([1.0, 0.9])
    st = tg.gppad_infer(t64(theta), t64(t), t64(y), carrier_var=0.04, iters=8,
                        parallel=parallel)
    sj = jg.gppad_infer(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), carrier_var=0.04,
                        iters=8, parallel=parallel)
    for name in ("mean", "var", "envelope"):
        assert rel(getattr(st, name), getattr(sj, name)) <= 1e-11, name
    for name in ("lam1", "lam2", "site_delta"):
        assert rel(getattr(st, name), getattr(sj, name)) <= 1e-9, name
    # warm start from the JAX state
    warm = convert.pad_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    st2 = tg.gppad_infer(t64(theta), t64(t), t64(y), carrier_var=0.04, iters=3,
                         sites0=(warm.lam1, warm.lam2), parallel=parallel)
    sj2 = jg.gppad_infer(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), carrier_var=0.04,
                         iters=3, sites0=(sj.lam1, sj.lam2), parallel=parallel)
    assert rel(st2.mean, sj2.mean) <= 1e-11
    assert rel(st2.lam2, sj2.lam2) <= 1e-9


def test_gppad_bank_rows_equal_unbatched():
    t, y = pad_draw(2, T=48)
    thetas = np.array([[1.0, 0.9], [0.5, 0.2], [2.0, 3.0]])
    cvs = np.array([0.04, 0.09, 0.01])
    bank = tg.gppad_infer(t64(thetas), t64(t), t64(y), carrier_var=t64(cvs), iters=5)
    for k in range(3):
        one = tg.gppad_infer(t64(thetas[k]), t64(t), t64(y), carrier_var=float(cvs[k]), iters=5)
        for a, b in zip(bank, one):
            assert rel(a[k], b.numpy()) <= 1e-12


def test_colored_sweep_matches_jax():
    t, y = colored_draw(4)
    rng = np.random.default_rng(5)
    lam2 = np.where(rng.uniform(size=64) < 0.8, rng.uniform(0.5, 20.0, 64), 0.0)
    lam1 = lam2 * rng.normal(size=64) * 0.3
    thf, thc = np.array([0.4, 0.8]), np.array([1.0, 0.1])
    out = tg.colored_pad_sweep(t64(thf), t64(thc), t64(t), t64(y), (t64(lam1), t64(lam2)),
                               obs_var=1e-3, damping=0.8)
    ref = jax.jit(lambda a, b, s: jg.colored_pad_sweep(a, b, jnp.asarray(t), jnp.asarray(y), s,
                                                       obs_var=1e-3, damping=0.8))(
        jnp.asarray(thf), jnp.asarray(thc), (jnp.asarray(lam1), jnp.asarray(lam2)))
    assert rel(out[0], ref[0]) <= 1e-11
    assert rel(out[1], ref[1]) <= 1e-11


@pytest.mark.parametrize("parallel", [False, True])
def test_colored_infer_matches_jax(parallel):
    t, y = colored_draw(6)
    thf, thc = np.array([0.4, 0.8]), np.array([1.0, 0.1])
    st = tg.gppad_colored_infer(t64(thf), t64(thc), t64(t), t64(y), obs_var=1e-3, iters=6,
                                parallel=parallel)
    sj = jg.gppad_colored_infer(jnp.asarray(thf), jnp.asarray(thc), jnp.asarray(t),
                                jnp.asarray(y), obs_var=1e-3, iters=6, parallel=parallel)
    for name in ("f_mean", "f_var", "c_mean", "c_var", "envelope"):
        assert rel(getattr(st, name), getattr(sj, name)) <= 1e-11, name
    for name in ("lam1", "lam2", "site_delta"):
        assert rel(getattr(st, name), getattr(sj, name)) <= 1e-9, name
    warm = convert.pad_state_from_jax(jax.tree.map(np.asarray, sj), device="cpu")
    assert isinstance(warm, tg.ColoredPADState)
    assert torch.equal(warm.lam2, torch.as_tensor(np.array(sj.lam2)))
