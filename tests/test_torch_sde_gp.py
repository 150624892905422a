"""Parity of the port's state-space GP (infer/sde_gp.py) with the JAX
package's, on the CPU in float64.

- ``matern52_ssm`` and ``_discretize`` to 1e-14 relative (the same closed
  forms; only the order of the 3×3 products' sums can differ);
- the sequential smoother on masked, heteroscedastic and irregular
  timelines against JAX's (mean, var 1e-12 relative to the largest entry,
  log-likelihood 1e-12: both run the same recursion, one rounding per
  operation; the log-likelihood is summed in another order) and against
  the dense GP posterior at the JAX tests' own limits
  (tests/test_sde_gp.py::TestDenseEquivalence: mean rtol 1e-8 / atol
  1e-10, var rtol 1e-7, log-likelihood rtol 1e-10);
- the parallel form against the sequential at the JAX tests' limits
  (TestParallelSmoother: mean rtol 1e-9 / atol 1e-11, var rtol 1e-8 / atol
  1e-11, log-likelihood rtol 1e-10) and against JAX's parallel form
  (1e-12: the same associative-scan order, ``ops/scan.py``);
- the reverse associative scan hands the later element first, held against
  a sequential right fold of the smoother's composition;
- the NLML's gradient by autograd through either form against ``jax.grad``
  (rtol 1e-9: the backward passes of two recursions of ~T·20 operations);
- a leading batch dimension: every row equals the unbatched call (1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import sde_gp as jsde
from gaussianprocessnode_tpu_torch.infer import pit_gpssm
from gaussianprocessnode_tpu_torch.infer import sde_gp as tsde
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.scan import associative_scan

F64 = torch.float64
_jsmooth = jax.jit(jsde.sde_gp_smooth, static_argnames=("parallel",))
_jgrad = jax.jit(jax.grad(jsde.sde_gp_nlml))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def workload(seed, T=96, irregular=True, hetero=True, frac=0.5):
    """A timeline, observations, a mask and the noise variances."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 4.0, T)) if irregular else np.linspace(0.0, 5.0, T)
    y = np.sin(t) + 0.3 * rng.normal(size=T)
    mask = rng.uniform(size=T) < frac
    R = rng.uniform(0.02, 0.8, T) if hetero else 0.2
    return t, y, mask, R


def close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def close_scaled(a, b, rel):
    """max |a − b| ≤ rel · max |b| (entries near zero carry the scale's
    rounding, not their own)."""
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert np.max(np.abs(a - b)) <= rel * np.max(np.abs(b)), np.max(np.abs(a - b))


def port(theta, t, y, mask, R, parallel=False):
    return tsde.sde_gp_smooth(t64(theta), t64(t), t64(y), torch.as_tensor(mask), t64(R),
                              parallel=parallel)


def jaxs(theta, t, y, mask, R, parallel=False):
    return _jsmooth(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), jnp.asarray(mask),
                    jnp.asarray(R), parallel=parallel)


def dense_posterior(theta, t, y, mask, R):
    """The dense Matérn-5/2 GP posterior at every timeline point (numpy)."""
    K = Kernel("matern52")(t64(theta), t64(t[:, None]), t64(t[:, None])).numpy()
    Rv = np.broadcast_to(R, t.shape)
    Koo = K[np.ix_(mask, mask)] + np.diag(Rv[mask])
    Kto = K[:, mask]
    sol = np.linalg.solve(Koo, np.c_[y[mask], Kto.T])
    mean = Kto @ sol[:, 0]
    var = np.diag(K) - np.sum(Kto * sol[:, 1:].T, axis=1)
    sign, logdet = np.linalg.slogdet(2 * np.pi * Koo)
    ll = -0.5 * (logdet + y[mask] @ sol[:, 0])
    return mean, var, ll


@pytest.mark.parametrize("theta", [[1.3, 0.9], [0.4, 0.15], [2.0, 3.0]])
def test_ssm_and_discretization(theta):
    F, P, H = tsde.matern52_ssm(t64(theta))
    Fj, Pj, Hj = jsde.matern52_ssm(jnp.asarray(theta))
    for a, b in ((F, Fj), (P, Pj), (H, Hj)):
        close(a, b, 1e-14)
    dts = np.diff(np.sort(np.random.default_rng(0).uniform(0, 3, 20)))
    A, Q = tsde._discretize(F, P, t64(dts))
    Aj, Qj = jsde._discretize(Fj, Pj, jnp.asarray(dts))
    close_scaled(A, Aj, 1e-14)
    close_scaled(Q, Qj, 1e-13)


@pytest.mark.parametrize("irregular,hetero,frac", [
    (False, False, 0.4), (True, True, 0.5), (True, False, 1.0), (False, True, 0.1)])
def test_sequential_matches_jax_and_dense(irregular, hetero, frac):
    t, y, mask, R = workload(1, irregular=irregular, hetero=hetero, frac=frac)
    theta = [0.8, 0.5]
    res, ref = port(theta, t, y, mask, R), jaxs(theta, t, y, mask, R)
    close_scaled(res.mean, ref.mean, 1e-12)
    close_scaled(res.var, ref.var, 1e-12)
    close(res.log_lik, ref.log_lik, 1e-12)
    mean, var, ll = dense_posterior(theta, t, y, mask, R)
    close(res.mean, mean, 1e-8, 1e-10)
    close(res.var, var, 1e-7, 1e-10)
    close(res.log_lik, ll, 1e-10)


@pytest.mark.parametrize("irregular,hetero,frac", [
    (False, False, 0.4), (True, True, 0.6), (True, True, 1.0)])
def test_parallel_matches_sequential_and_jax(irregular, hetero, frac):
    t, y, mask, R = workload(2, T=83, irregular=irregular, hetero=hetero, frac=frac)
    theta = [2.0, 1.0]
    seq, par = port(theta, t, y, mask, R), port(theta, t, y, mask, R, parallel=True)
    close(par.mean, seq.mean, 1e-9, 1e-11)
    close(par.var, seq.var, 1e-8, 1e-11)
    close(par.log_lik, seq.log_lik, 1e-10)
    ref = jaxs(theta, t, y, mask, R, parallel=True)
    close_scaled(par.mean, ref.mean, 1e-12)
    close_scaled(par.var, ref.var, 1e-12)
    close(par.log_lik, ref.log_lik, 1e-12)


def test_reverse_scan_hands_the_later_element_first():
    """The smoother's composition, scanned in reverse, against the right
    fold acc_t = earlier_t ∘ acc_{t+1} that the RTS recursion is."""
    rng = np.random.default_rng(5)
    n = 37
    E = 0.5 * rng.standard_normal((n, 3, 3))
    g = rng.standard_normal((n, 3))
    L = rng.standard_normal((n, 3, 3))
    L = L @ np.swapaxes(L, 1, 2)

    def scomb(later, earlier):
        E1, g1, L1 = later
        E2, g2, L2 = earlier
        return (E2 @ E1, (E2 @ g1[..., None])[..., 0] + g2,
                E2 @ L1 @ np.swapaxes(E2, -1, -2) + L2)

    def tcomb(later, earlier):
        E1, g1, L1 = later
        E2, g2, L2 = earlier
        return E2 @ E1, (E2 @ g1[..., None])[..., 0] + g2, E2 @ L1 @ E2.mT + L2

    out = associative_scan(tcomb, (t64(E), t64(g), t64(L)), reverse=True)
    acc = (E[-1], g[-1], L[-1])
    fold = [acc]
    for k in range(n - 2, -1, -1):
        acc = scomb(acc, (E[k], g[k], L[k]))
        fold.append(acc)
    fold = fold[::-1]
    for i in range(3):
        close(out[i], np.stack([f[i] for f in fold]), 1e-11, 1e-12)


@pytest.mark.parametrize("parallel", [False, True])
def test_nlml_gradient_matches_jax(parallel):
    t, y, mask, R = workload(3, T=64)
    theta = np.array([0.9, 0.6])
    th = t64(theta).requires_grad_()
    nl = tsde.sde_gp_nlml(th, t64(t), t64(y), torch.as_tensor(mask), t64(R), parallel=parallel)
    (g,) = torch.autograd.grad(nl, th)
    gj = _jgrad(jnp.asarray(theta), jnp.asarray(t), jnp.asarray(y), jnp.asarray(mask),
                jnp.asarray(R))
    close(g, gj, 1e-9)


@pytest.mark.parametrize("parallel", [False, True])
def test_batch_rows_equal_unbatched(parallel):
    t, y, mask, R = workload(4, T=48)
    thetas = np.array([[0.8, 0.5], [1.5, 0.2], [0.3, 2.0]])
    ys = np.stack([y, -y, 2 * y])
    res = tsde.sde_gp_smooth(t64(thetas), t64(t), t64(ys), torch.as_tensor(mask), t64(R),
                             parallel=parallel)
    for k in range(3):
        one = port(thetas[k], t, ys[k], mask, R, parallel)
        close_scaled(res.mean[k], one.mean.numpy(), 1e-13)
        close_scaled(res.var[k], one.var.numpy(), 1e-13)
        close(res.log_lik[k], one.log_lik, 1e-13)


def test_scalar_obs_var_equals_per_point():
    t, y, mask, _ = workload(6, T=40)
    a = port([1.0, 0.7], t, y, mask, 0.3)
    b = port([1.0, 0.7], t, y, mask, np.full(40, 0.3))
    for x, z in zip(a, b):
        close(x, z, 0.0)


def test_inv33_is_shared_and_exact():
    assert pit_gpssm._inv33 is tsde._inv33
    rng = np.random.default_rng(8)
    m = rng.standard_normal((10, 3, 3)) + 3 * np.eye(3)
    close(tsde._inv33(t64(m)), np.linalg.inv(m), 1e-12, 1e-14)
    close(tsde._inv33(t64(m)), jsde._inv33(jnp.asarray(m)), 1e-14, 1e-15)
