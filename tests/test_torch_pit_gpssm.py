"""Parity of the port's parallel-in-time GPSSM engine (infer/pit_gpssm.py),
its associative scan (ops/scan.py) and the eigenvalue clamp
(ops/linalg.py::spd_clamp) with the JAX package's, on the CPU.

- ``associative_scan`` against ``jax.lax.associative_scan`` and a
  sequential fold, forward and reverse, at lengths 1, 2, 7, 40 and 301 (301
  is the pendulum chain's T + 1, not a power of two), on a non-commutative
  operator (3×3 products with an affine part): it follows JAX's odd/even
  recursion, so the combinations and their rounding are JAX's; held to
  1e-13 relative (measured ~1e-16) against JAX and to 1e-11 against the
  fold, whose order differs;
- ``_inv_batched`` for D = 1–4 against JAX's (1e-12) and numpy's inverse;
- ``slr_transition`` and ``parallel_lgssm_smooth`` (D = 2 and 3) against
  JAX's (1e-11) and a sequential Kalman filter and RTS smoother in numpy
  (1e-9, JAX's own limit in tests/test_pit_gpssm.py);
- ``gpssm_vmp_pit`` on the chain of tests/test_torch_chain_smoother.py
  (T = 30, M = 12 on a regular grid), f64: 3 PIT sweeps with and without 2
  polishing Jacobi sweeps, every state field and the free energy to 1e-11
  (measured ≤ 2.3e-14); f32: 2e-3 (the chain test's f32 limit and
  reason);
- ``spd_clamp`` for D = 2 (closed form) and D = 3 (eigh), on indefinite,
  isotropic and positive-definite inputs, against JAX's (1e-12 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import pit_gpssm as jp
from gaussianprocessnode_tpu.nodes.multisgp import _split_blocks
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.linalg import spd_clamp as jclamp
from gaussianprocessnode_tpu_torch.infer import pit_gpssm as tp
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.linalg import spd_clamp
from gaussianprocessnode_tpu_torch.ops.scan import associative_scan
from test_torch_chain_smoother import DTYPES, JK, TK, chain_args, close, close_state

RTOL = 1e-11
# the JAX references jitted (eager JAX dispatches each op: several times slower)
_jsmooth = jax.jit(jp.parallel_lgssm_smooth)
_jpit = jax.jit(jp.gpssm_vmp_pit, static_argnums=0, static_argnames=("n_pit", "n_polish"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _affine(a, b):
    """(A1, c1) then (A2, c2): x ↦ A2(A1 x + c1) + c2, as (A2A1, A2c1 + c2)."""
    return (b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1])


@pytest.mark.parametrize("n", [1, 2, 7, 40, 301])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan(n, reverse):
    rng = np.random.default_rng(n)
    A = 0.6 * rng.standard_normal((n, 3, 3))
    c = rng.standard_normal((n, 3))
    if reverse:
        def t_fn(later, earlier):
            return _affine(later, earlier)
    else:
        t_fn = _affine
    jr = jax.jit(lambda e: jax.lax.associative_scan(t_fn, e, reverse=reverse))(
        (jnp.asarray(A), jnp.asarray(c)))
    tr = associative_scan(t_fn, (torch.as_tensor(A), torch.as_tensor(c)), reverse=reverse)
    fold = []
    acc = None
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        acc = (A[k], c[k]) if acc is None else t_fn(acc, (A[k], c[k]))
        fold.append(acc)
    if reverse:
        fold = fold[::-1]
    for i in range(2):
        close(tr[i], jr[i], 1e-13)
        close(tr[i], np.stack([f[i] for f in fold]), 1e-11)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_inv_batched(D):
    rng = np.random.default_rng(D)
    B = rng.standard_normal((6, D, D))
    m = B @ np.swapaxes(B, 1, 2) + np.eye(D)
    ti = tp._inv_batched(torch.as_tensor(m))
    close(ti, jp._inv_batched(jnp.asarray(m)), 1e-12)
    close(ti, np.linalg.inv(m), 1e-12)


def _random_lgssm(T=40, D=2, seed=0):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.stack([np.linalg.qr(rng.standard_normal((D, D)))[0] for _ in range(T)])
    b = 0.3 * rng.standard_normal((T, D))
    Q = np.stack([np.diag(rng.uniform(0.05, 0.3, D)) for _ in range(T)])
    m0 = rng.standard_normal(D)
    V0 = 0.5 * np.eye(D)
    R = 0.2 * np.eye(D)
    x = m0 + np.linalg.cholesky(V0) @ rng.standard_normal(D)
    ys = []
    for t in range(T):
        x = A[t] @ x + b[t] + np.linalg.cholesky(Q[t]) @ rng.standard_normal(D)
        ys.append(x + np.linalg.cholesky(R) @ rng.standard_normal(D))
    return A, b, Q, m0, V0, R, np.asarray(ys)


def _sequential_kalman_rts(A, b, Q, m0, V0, R, ys):
    T, D = ys.shape
    fm, fP, mp, Pp = [m0], [V0], [None], [None]
    for t in range(T):
        m_pred = A[t] @ fm[-1] + b[t]
        P_pred = A[t] @ fP[-1] @ A[t].T + Q[t]
        K = P_pred @ np.linalg.inv(P_pred + R)
        fm.append(m_pred + K @ (ys[t] - m_pred))
        fP.append((np.eye(D) - K) @ P_pred)
        mp.append(m_pred)
        Pp.append(P_pred)
    sm, sP = [fm[-1]], [fP[-1]]
    for t in range(T - 1, -1, -1):
        G = fP[t] @ A[t].T @ np.linalg.inv(Pp[t + 1])
        sm.insert(0, fm[t] + G @ (sm[0] - mp[t + 1]))
        sP.insert(0, fP[t] + G @ (sP[0] - Pp[t + 1]) @ G.T)
    return np.asarray(sm), np.asarray(sP)


@pytest.mark.parametrize("D,T", [(2, 40), (3, 25)])
def test_parallel_lgssm_smooth(D, T):
    A, b, Q, m0, V0, R, ys = _random_lgssm(T=T, D=D, seed=D)
    sm_ref, sP_ref = _sequential_kalman_rts(A, b, Q, m0, V0, R, ys)
    args = (A, b, Q, m0, V0, ys, R)
    jsm, jsP = _jsmooth(*map(jnp.asarray, args))
    tsm, tsP = tp.parallel_lgssm_smooth(*map(torch.as_tensor, args))
    close(tsm, jsm)
    close(tsP, jsP)
    close(tsm, sm_ref, 1e-9)
    close(tsP, sP_ref, 1e-9)


def test_slr_transition():
    rng = np.random.default_rng(1)
    M, D = 8, 2
    Xu = rng.standard_normal((M, D))
    theta = np.log(np.expm1(np.array([1.0, 0.8, 1.2])))
    mu_v = rng.standard_normal(M * D)
    means = 0.5 * rng.standard_normal((5, D))
    covs = np.stack([np.diag(rng.uniform(0.01, 0.04, D)) for _ in range(5)])
    jout = jp.slr_transition(JK, jnp.asarray(theta), jnp.asarray(Xu), jq.SphericalRadial(),
                             _split_blocks(jnp.asarray(mu_v), M, D), jnp.asarray(means),
                             jnp.asarray(covs))
    T = torch.as_tensor
    tout = tp.slr_transition(TK, T(theta), T(Xu), tq.SphericalRadial(),
                             T(mu_v).reshape(D, M), T(means), T(covs))
    for a, b in zip(tout, jout):
        close(a, b)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gpssm_vmp_pit(dtype):
    _, _, rtol = DTYPES[dtype]
    ja, ta = chain_args(dtype)
    for n_polish in (0, 2):
        js, jfe = _jpit(*ja, n_pit=3, n_polish=n_polish)
        ts, tfe = tp.gpssm_vmp_pit(*ta, n_pit=3, n_polish=n_polish)
        close_state(ts, js, rtol)
        close(tfe, jfe, rtol)


@pytest.mark.parametrize("D", [2, 3])
def test_spd_clamp(D):
    rng = np.random.default_rng(10 + D)
    B = rng.standard_normal((5, D, D))
    S = 0.5 * (B + np.swapaxes(B, 1, 2))  # indefinite
    S[1] = 0.3 * np.eye(D)  # isotropic: r = 0 in the closed form
    S[2] = B[2] @ B[2].T + np.eye(D)  # already positive definite
    floor = 1e-3 * np.arange(1, 6)
    tout = spd_clamp(torch.as_tensor(S), torch.as_tensor(floor))
    close(tout, jclamp(jnp.asarray(S), jnp.asarray(floor)), 1e-12)
    close(tout[2], S[2], 1e-12)
    assert np.all(np.linalg.eigvalsh(tout.numpy()) >= floor[:, None] * (1 - 1e-9))
    close(spd_clamp(torch.as_tensor(S), 0.05), jclamp(jnp.asarray(S), 0.05), 1e-12)
