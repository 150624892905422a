"""The port's fast-trainer objective (objectives.py) against the JAX
package's, on the CPU: the loss, the returned Kuu⁻¹ and the θ-gradient of
``neg_log_backwardmess_gram``, cold and warm-started, in f32 and f64, with
the analytic-VJP Gram (``use_pallas`` / ``use_kernel``) and with the plain
one; and once with the JAX Gram in the Pallas interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import objectives as jobj
from gaussianprocessnode_tpu.ops import pallas_gram as pg
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.linalg import effective_jitter as j_effective_jitter
from gaussianprocessnode_tpu_torch import objectives as tobj
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.linalg import effective_jitter

M, N, D = 24, 60, 3
W = 1e4


def _case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    Xu = rng.standard_normal((M, D))
    X = rng.standard_normal((N, D))
    y = np.sin(X.sum(1))
    theta = np.log(np.expm1(np.array([0.9, 1.1, 0.8, 1.3])))
    mu_v = rng.standard_normal(M) * 0.1
    A = rng.standard_normal((M, M)) * 0.05
    Rv = A @ A.T + np.outer(mu_v, mu_v)
    return {k: v.astype(dtype) for k, v in dict(theta=theta, Xu=Xu, X=X, y=y,
                                                mu_v=mu_v, Rv=Rv).items()}


def _jax(c, use_kernel, warm, jitter, ns_iters):
    kern = JKernel("se", "softplus", use_pallas=use_kernel)
    args = {k: jnp.asarray(v) for k, v in c.items() if k != "theta"}

    def f(th):
        return jobj.neg_log_backwardmess_gram(
            th, kernel=kern, w=W, kuu_inv_warm=None if warm is None else jnp.asarray(warm),
            ns_iters=ns_iters, kuu_jitter=jitter, **args)

    (loss, kinv), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(c["theta"]))
    return float(loss), np.asarray(kinv), np.asarray(g)


def _torch(c, use_kernel, warm, jitter, ns_iters):
    kern = Kernel("se", "softplus", use_kernel=use_kernel)
    th = torch.tensor(c["theta"], requires_grad=True)
    args = {k: torch.as_tensor(v) for k, v in c.items() if k != "theta"}
    loss, kinv = tobj.neg_log_backwardmess_gram(
        th, kernel=kern, w=W, kuu_inv_warm=None if warm is None else torch.tensor(warm),
        ns_iters=ns_iters, kuu_jitter=jitter, **args)
    assert not kinv.requires_grad
    (g,) = torch.autograd.grad(loss, th)
    assert g.dtype == th.dtype and loss.dtype == th.dtype
    return float(loss.detach()), kinv.numpy(), g.numpy()


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


# Tolerances, relative: f64 — the same operations in other summation
# orders, carried through a Newton–Schulz inverse of κ(Kuu) ≲ 1e4: 1e-10.
# f32 — each side's Gram and sums round at ε₃₂ and the inverse amplifies
# by κ(Kuu), and the loss is a difference of w-scaled terms of similar
# size: 2e-4 on the loss, Kuu⁻¹ and gradient (measured ≤ 3e-5).
TOL = {np.float64: 1e-10, np.float32: 2e-4}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["analytic_vjp", "autograd"])
def test_objective_loss_inverse_and_gradient_match_jax(dtype, warm, use_kernel):
    c = _case(dtype)
    jitter = effective_jitter(torch.float32 if dtype == np.float32 else torch.float64)
    w0 = None
    iters = 12
    if warm:
        # a near inverse of Kuu at slightly other θ: the guard accepts it
        c2 = dict(c, theta=(c["theta"] + 0.01).astype(dtype))
        _, w0, _ = _jax(c2, use_kernel, None, jitter, 40)
        iters = 4
    jl, jk, jg = _jax(c, use_kernel, w0, jitter, iters)
    tl, tk, tg = _torch(c, use_kernel, w0, jitter, iters)
    tol = TOL[dtype]
    assert abs(tl - jl) <= tol * abs(jl)
    assert _rel(tk, jk) <= tol
    assert _rel(tg, jg) <= tol


def test_objective_matches_jax_pallas_interpreted():
    """f32 with the JAX Gram in the Pallas interpreter (its kernel, padding
    and tiling): the same f32 tolerance as above."""
    c = _case(np.float32, seed=1)
    jitter = effective_jitter(torch.float32)
    pg._INTERPRET = True
    jax.clear_caches()
    try:
        jl, jk, jg = _jax(c, True, None, jitter, 12)
    finally:
        pg._INTERPRET = False
        jax.clear_caches()
    tl, tk, tg = _torch(c, True, None, jitter, 12)
    assert abs(tl - jl) <= 2e-4 * abs(jl)
    assert _rel(tk, jk) <= 2e-4 and _rel(tg, jg) <= 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_effective_jitter_matches_jax(dtype):
    npd = {torch.float32: np.float32, torch.float64: np.float64,
           torch.float16: np.float16}[dtype]
    assert effective_jitter(dtype) == j_effective_jitter(npd)
    assert effective_jitter(dtype, 1e-3) == j_effective_jitter(npd, 1e-3)
