"""The port's banana trainers (infer/minibatch.py: ``banana_epoch_stats``,
``init_banana_state``, ``fit_banana_fast``, ``fit_banana``) against the JAX
package's, on the CPU, at M = 32, D = 2, N = 512 in B = 4 batches.

The JAX trainers are driven one epoch at a time through ``resume_state``,
so one executable serves every epoch of a configuration. Each port epoch
runs twice: on from the port's own carry, and resumed from
``convert.banana_state_from_jax`` of the JAX carry at the epoch's start.
Both Grams are the plain ones with the analytic VJP
(``Kernel(use_pallas=True)`` / ``Kernel(use_kernel=True)`` off the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import minibatch as tmb
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.linalg import effective_jitter
from gaussianprocessnode_tpu_torch.utils.datasets import banana_synthetic

M, N, B = 32, 512, 4
EPOCHS = 3
FIELDS = ("xi_v", "prec_v", "cov_v", "kuu_inv", "theta", "w_shape", "w_rate")


def banana_case(dtype):
    """Inputs shared by both packages, as numpy arrays in ``dtype``: the
    port's banana-shaped data (seed 2), Xu drawn from the training rows,
    θ0 = softplus⁻¹(1), the priors N(0, 50·I) on v and Gamma(1e-2, 1e-2)
    on w."""
    ds = banana_synthetic(2, n_train=N, n_test=8)
    Xu = ds.x_train[np.random.default_rng(2).permutation(N)[:M]]
    return {k: np.asarray(v).astype(dtype) for k, v in dict(
        Xb=ds.x_train.reshape(B, N // B, 2), yb=ds.y_train.reshape(B, N // B), Xu=Xu,
        theta0=np.log(np.expm1(np.ones(3))), xi0=np.zeros(M), prec0=np.eye(M) / 50.0,
        a0=1e-2, b0=1e-2).items()}


def jax_args(c):
    return dict(kernel=JKernel("se", "softplus", use_pallas=True),
                theta0=jnp.asarray(c["theta0"]), Xu=jnp.asarray(c["Xu"]),
                X_batched=jnp.asarray(c["Xb"]), y_batched=jnp.asarray(c["yb"]),
                prior_v=JNat(jnp.asarray(c["xi0"]), jnp.asarray(c["prec0"])),
                prior_w=JGamma(jnp.asarray(c["a0"]), jnp.asarray(c["b0"])))


def port_args(c):
    t = torch.as_tensor
    return dict(kernel=Kernel("se", "softplus", use_kernel=True), theta0=t(c["theta0"]),
                Xu=t(c["Xu"]), X_batched=t(c["Xb"]), y_batched=t(c["yb"]),
                prior_v=MvGaussianNat(t(c["xi0"]), t(c["prec0"])),
                prior_w=GammaShapeRate(t(c["a0"]), t(c["b0"])))


def from_jax(carry):
    return convert.banana_state_from_jax(jax.tree.map(np.asarray, carry), device="cpu")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def carry_errors(t, j):
    """Relative 2-norm error of each carry field, port against JAX."""
    return {f: _rel(getattr(t, f).numpy(), getattr(j, f)) for f in FIELDS}


def trainer_parity(trainer, dtype, tol):
    """Three epochs of the port's and the JAX ``trainer`` from one initial
    carry (the JAX ``init_banana_state``). After each epoch every carry
    field agrees within ``tol`` (relative, 2-norm), for the port run on from
    its own carry and for one port epoch resumed from the JAX carry at the
    epoch's start (``tol["resume"]``); the step counts agree exactly."""
    c = banana_case(dtype)
    ja, ta = jax_args(c), port_args(c)
    jcarry = jmb.init_banana_state(ja["kernel"], ja["theta0"], ja["Xu"], ja["prior_v"],
                                   ja["prior_w"])
    tcarry = from_jax(jcarry)
    jfit, tfit = getattr(jmb, trainer), getattr(tmb, trainer)
    errs = []
    for e in range(EPOCHS):
        *_, jnext = jfit(**ja, epochs=1, resume_state=jcarry)
        *_, tcarry = tfit(**ta, epochs=1, resume_state=tcarry)
        *_, rcarry = tfit(**ta, epochs=1, resume_state=from_jax(jcarry))
        jcarry = jnext
        err = carry_errors(tcarry, jnext)
        err["resume"] = max(carry_errors(rcarry, jnext).values())
        errs.append(err)
        assert tcarry.theta.dtype == torch.from_numpy(c["theta0"]).dtype
        assert tcarry.prec_v.dtype == tcarry.w_rate.dtype == torch.float64
        assert int(tcarry.opt_state["count"]) == int(jnext.opt_state[2][0].count) == (e + 1) * B
        for k, v in err.items():
            assert v <= tol.get(k, tol["carry"]), (e + 1, k, errs)
    return errs


# Tolerances. f64: the same operations in other summation orders; the f64
# q(v) refresh inverts Λ (κ ≈ 1e5–1e6 here) by Newton–Schulz, a gain of up to
# κ on a rounding perturbation, into μ_v, Rv and θ's gradient: κ·ε₆₄ ≈ 1e-10.
# f32: θ's gradient is an f32 sum through Kuu⁻¹ (a few hundred ε₃₂ apart, as
# in the kin40k fast trainer's parity), the probit moments and q(w)'s trace
# forms are f32 sums over the points; AdaMax moves θ by that fraction of
# lr = 1e-3 per step, and ξ, Λ, q(w) follow θ through the f32 Gram.
# Measured over three epochs: ≤ 2.2e-10 (f64), ≤ 2.1e-5 (f32).
F64_TOL = dict(carry=1e-9, resume=1e-9)
F32_TOL = dict(carry=2e-4, resume=2e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fit_banana_fast_matches_jax_epoch_by_epoch(dtype):
    trainer_parity("fit_banana_fast", dtype, F64_TOL if dtype == np.float64 else F32_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fit_banana_matches_jax_epoch_by_epoch(dtype):
    trainer_parity("fit_banana", dtype, F64_TOL if dtype == np.float64 else F32_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_banana_state_matches_jax(dtype):
    """Field for field, dtypes included: q(v) at the prior and q(w) at
    Gamma(1e-2, 1e-2) exactly (the same casts), θ0 and the optimizer's zero
    state exactly; the cold 40-iteration inverse of the jittered Kuu to
    10·κ(Kuu)·ε relative (the iteration's rounding floor: κ ≈ 2.8e5 in f32,
    4.7e6 in f64; measured 2.4e-3 in f32), and that of the prior precision
    (50·I) to an ulp."""
    c = banana_case(dtype)
    ja, ta = jax_args(c), port_args(c)
    want = from_jax(jmb.init_banana_state(ja["kernel"], ja["theta0"], ja["Xu"],
                                          ja["prior_v"], ja["prior_w"]))
    got = tmb.init_banana_state(ta["kernel"], ta["theta0"], ta["Xu"], ta["prior_v"],
                                ta["prior_w"])
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "opt_state":
            assert a.keys() == b.keys()
            assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
            continue
        assert a.dtype == b.dtype, f
        if f == "kuu_inv":
            kuu = ta["kernel"].kuu(ta["theta0"], ta["Xu"],
                                   jitter=effective_jitter(ta["theta0"].dtype))
            kappa = np.linalg.cond(kuu.double().numpy())
            assert _rel(a.numpy(), b.numpy()) <= 10 * kappa * np.finfo(dtype).eps
        elif f == "cov_v":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=4e-16, atol=0)
        else:
            assert torch.equal(a, b), f
    assert got.w_shape.dtype == torch.float64
    assert float(got.w_shape) == float(dtype(1e-2))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_banana_epoch_stats_matches_jax(dtype):
    """One statistics pass from the same carry (the JAX initial carry after
    one JAX epoch, so μ_v ≠ 0 and w̄ is learnt): q(f), q(v) (ξ, Λ, Σ, μ_v,
    Rv) and q(w) against JAX, to the trainers' carry tolerances, and
    ``reduce`` sees the q(v) increments and the q(w) rate increment."""
    c = banana_case(dtype)
    ja, ta = jax_args(c), port_args(c)
    jc = jmb.init_banana_state(ja["kernel"], ja["theta0"], ja["Xu"], ja["prior_v"],
                               ja["prior_w"])
    *_, jc = jmb.fit_banana_fast(**ja, epochs=1, resume_state=jc)
    X = c["Xb"].reshape(-1, 2)
    y = c["yb"].reshape(-1)
    dt = jnp.dtype(dtype)
    lam = jnp.asarray(0.02, jnp.float64)
    want = jmb.banana_epoch_stats(ja["kernel"], ja["Xu"], jnp.asarray(X), jnp.asarray(y),
                                  jc, N, 28, dt, jnp.float64, lambda_min=lam)
    seen = []

    def reduce(t):
        seen.append(tuple(t.shape))
        return t

    got = tmb.banana_epoch_stats(ta["kernel"], ta["Xu"], torch.as_tensor(X),
                                 torch.as_tensor(y), from_jax(jc), N, 28,
                                 torch.from_numpy(c["theta0"]).dtype, torch.float64,
                                 reduce=reduce, lambda_min=torch.tensor(0.02, dtype=torch.float64))
    assert seen == [(M,), (M, M), ()]
    tol = (F64_TOL if dtype == np.float64 else F32_TOL)["carry"]
    (jqf, *jrest), (tqf, *trest) = want, got
    assert _rel(tqf.mean.numpy(), jqf.mean) <= tol and _rel(tqf.var.numpy(), jqf.var) <= tol
    for name, a, b in zip(("xi", "prec", "cov", "mu_v", "Rv", "w_shape", "w_rate"),
                          trest, jrest):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
        assert _rel(a.numpy(), b) <= tol, name


def test_port_resume_is_exact():
    """Three epochs in one call equal 1 + 1 + 1 resumed calls bit for bit
    (the same operations in the same order), for both trainers; the carry
    handed to a resumed call is left as it was."""
    c = banana_case(np.float32)
    ta = port_args(c)
    for fit in (tmb.fit_banana_fast, tmb.fit_banana):
        th3, nat3, qw3, _ = fit(**ta, epochs=3)
        *_, carry = fit(**ta, epochs=1)
        for _ in range(2):
            before = [t.clone() for t in (carry.theta, carry.kuu_inv, carry.cov_v,
                                          carry.w_rate)]
            th, nat, qw, nxt = fit(**ta, epochs=1, resume_state=carry)
            after = (carry.theta, carry.kuu_inv, carry.cov_v, carry.w_rate)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            carry = nxt
        assert torch.equal(th, th3) and torch.equal(nat.prec, nat3.prec)
        assert torch.equal(nat.xi, nat3.xi) and torch.equal(qw.rate, qw3.rate)
        assert torch.equal(qw.shape, qw3.shape)
        assert int(carry.opt_state["count"]) == 3 * B
        # q(w)'s shape accumulates N/2 per epoch from the prior's
        assert float(qw.shape) == pytest.approx(float(np.float32(1e-2)) + 3 * N / 2, rel=1e-15)
