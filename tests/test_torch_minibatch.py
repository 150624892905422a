"""The port's fast trainer (infer/minibatch.py) against the JAX package's,
on the CPU: the optimizer chain against optax, and ``fit_kin40k_fast``
epoch by epoch against the JAX trainer from the same initial carry.

The JAX trainer is driven one epoch at a time through ``resume_state``, so
one executable serves every epoch of a configuration; the port starts from
``convert.fast_state_from_jax`` of the same initial carry and runs on from
its own carry. Both Grams are the plain ones with the analytic VJP
(``Kernel(use_pallas=True)`` / ``Kernel(use_kernel=True)`` off the card).
The float64 θ configurations are in ``test_torch_minibatch_f64.py``, so
two workers share the JAX compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.dists import MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import minibatch as tmb
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

M, N, B, D = 32, 512, 4, 3
W = 1e4
EPOCHS = 3


def trainer_case(dtype):
    """Inputs shared by both packages, as numpy arrays in ``dtype``: the
    data of a smooth function with noise precision W, Xu drawn from the
    training rows, θ0 = softplus⁻¹(1) and the prior N(0, 50·I)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    y = np.sin(X.sum(axis=1)) + rng.standard_normal(N) / np.sqrt(W)
    Xu = X[rng.permutation(N)[:M]]
    theta0 = np.log(np.expm1(np.ones(D + 1)))
    return {k: v.astype(dtype) for k, v in dict(
        Xb=X.reshape(B, N // B, D), yb=y.reshape(B, N // B), Xu=Xu, theta0=theta0,
        xi0=np.zeros(M), prec0=np.eye(M) / 50.0).items()}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / np.linalg.norm(np.asarray(b, np.float64)))


def trainer_parity(dtype, stats_refreshes, lr_decay_rate, tol):
    """Three epochs of both trainers from one initial carry. After each
    epoch θ, ξ and Λ agree within ``tol`` (relative, 2-norm); and one port
    epoch resumed from ``fast_state_from_jax`` of the JAX carry agrees with
    the JAX epoch from the same carry within ``tol["resume"]`` on θ."""
    c = trainer_case(dtype)
    jargs = dict(kernel=JKernel("se", "softplus", use_pallas=True),
                 theta0=jnp.asarray(c["theta0"]), Xu=jnp.asarray(c["Xu"]),
                 X_batched=jnp.asarray(c["Xb"]), y_batched=jnp.asarray(c["yb"]),
                 prior_v=JNat(jnp.asarray(c["xi0"]), jnp.asarray(c["prec0"])),
                 w_val=W, epochs=1, stats_refreshes=stats_refreshes,
                 lr_decay_rate=lr_decay_rate)
    targs = dict(kernel=Kernel("se", "softplus", use_kernel=True),
                 theta0=torch.as_tensor(c["theta0"]), Xu=torch.as_tensor(c["Xu"]),
                 X_batched=torch.as_tensor(c["Xb"]), y_batched=torch.as_tensor(c["yb"]),
                 prior_v=MvGaussianNat(torch.as_tensor(c["xi0"]),
                                       torch.as_tensor(c["prec0"])),
                 w_val=W, epochs=1, stats_refreshes=stats_refreshes,
                 lr_decay_rate=lr_decay_rate)
    groups = max(1, min(stats_refreshes, B))
    jcarry = jmb.init_kin40k_fast_state(
        jargs["theta0"], jargs["prior_v"], M, groups,
        optimizer=jmb.fast_optimizer(1e-3, lr_decay_rate, 1, B))
    tcarry = convert.fast_state_from_jax(jax.tree.map(np.asarray, jcarry), device="cpu")
    errs = []
    for _ in range(EPOCHS):
        jth, jnat, _, jnext = jmb.fit_kin40k_fast(**jargs, resume_state=jcarry)
        tth, tnat, _, tcarry = tmb.fit_kin40k_fast(**targs, resume_state=tcarry)
        # the port resumed from the JAX carry of this epoch's start
        rth, _, _, _ = tmb.fit_kin40k_fast(**targs, resume_state=convert.fast_state_from_jax(
            jax.tree.map(np.asarray, jcarry), device="cpu"))
        jcarry = jnext
        assert tth.dtype == torch.from_numpy(c["theta0"]).dtype
        assert tnat.prec.dtype == torch.float64
        e = dict(theta=_rel(tth, jth), xi=_rel(tnat.xi, jnat.xi),
                 prec=_rel(tnat.prec, jnat.prec), resume=_rel(rth, jth))
        errs.append(e)
        for k, v in e.items():
            assert v <= tol[k], (len(errs), k, errs)
        count = int(jnext[4][2][0].count)
        assert int(tcarry.opt_state["count"]) == count
    return errs


# float32 θ (the shipping dtype). Tolerance: θ's gradient is an f32 sum
# through Kuu⁻¹, so each package's rounds differently by a few hundred ε₃₂
# relative; AdaMax's step lr·m̂/u moves θ by that fraction of lr per step,
# and ξ, Λ follow θ through the f32 Gram. Measured ≤ 2.3e-6 over three
# epochs; held to 2e-5 (~170 ε₃₂).
F32_TOL = dict(theta=2e-5, xi=2e-5, prec=2e-5, resume=2e-5)


@pytest.mark.parametrize("stats_refreshes", [1, 2])
def test_fit_kin40k_fast_f32_matches_jax_epoch_by_epoch(stats_refreshes):
    trainer_parity(np.float32, stats_refreshes, 1.0, F32_TOL)


def _optax_steps(chain, theta0, grads):
    st = chain.init(jnp.asarray(theta0))
    th = jnp.asarray(theta0)
    out = []
    for g in grads:
        upd, st = chain.update(jnp.asarray(g), st, th)
        th = optax.apply_updates(th, upd)
        out.append((np.asarray(upd), np.asarray(th), st))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lr_decay_rate", [1.0, 0.1], ids=["constant", "decayed"])
def test_optimizer_chain_matches_optax(lr_decay_rate, dtype):
    """30 steps of the port's chain against optax's (x64 on, as the JAX
    package runs), with a NaN gradient at step 5 (zeroed, flagged) and one
    of norm 1e9 at step 11 (clipped to 1e8), the rate decaying by 10× over
    the 30 steps. Updates and θ to 1e-6 relative in f32 (the same
    operations in the same order; exp/pow and the f64 scalars rounded to
    f32 may differ by an ulp), 1e-13 in f64; the state's counters and NaN
    flags exactly."""
    rng = np.random.default_rng(1)
    grads = [(rng.standard_normal(9) * 10.0 ** rng.uniform(-3, 3)).astype(dtype)
             for _ in range(30)]
    grads[5][3] = np.nan
    grads[11] = (grads[11] / np.linalg.norm(grads[11]) * 1e9).astype(dtype)
    theta0 = rng.standard_normal(9).astype(dtype)
    want = _optax_steps(jmb.fast_optimizer(1e-3, lr_decay_rate, 3, 10), theta0, grads)
    opt = tmb.fast_optimizer(1e-3, lr_decay_rate, 3, 10)
    theta = torch.tensor(theta0)
    state = opt.init(theta)
    assert set(state) == ({"found_nan", "count", "mu", "nu"} |
                          ({"lr_count"} if lr_decay_rate != 1.0 else set()))
    rtol = 1e-6 if dtype == np.float32 else 1e-13
    for k, (g, (jupd, jth, jst)) in enumerate(zip(grads, want)):
        upd = opt.update_(torch.tensor(g), state)
        theta.add_(upd)
        assert upd.dtype == theta.dtype == torch.from_numpy(theta0).dtype
        np.testing.assert_allclose(upd.numpy(), jupd, rtol=rtol, atol=0, err_msg=str(k))
        np.testing.assert_allclose(theta.numpy(), jth, rtol=rtol, atol=0, err_msg=str(k))
        assert bool(state["found_nan"]) == bool(jst[0].found_nan) == (k == 5)
        assert int(state["count"]) == int(jst[2][0].count) == k + 1
        if lr_decay_rate != 1.0:
            assert int(state["lr_count"]) == int(jst[2][1].count) == k + 1
        np.testing.assert_allclose(state["nu"].numpy(), np.asarray(jst[2][0].nu),
                                   rtol=rtol, atol=0)
    assert np.all(np.isfinite(theta.numpy()))


@pytest.mark.parametrize("lr_decay_rate", [1.0, 0.5])
def test_initial_state_matches_jax(lr_decay_rate):
    """init_kin40k_fast_state equals fast_state_from_jax of the JAX initial
    carry, leaf for leaf, dtypes included."""
    c = trainer_case(np.float32)
    jinit = jmb.init_kin40k_fast_state(
        jnp.asarray(c["theta0"]), JNat(jnp.asarray(c["xi0"]), jnp.asarray(c["prec0"])),
        M, 2, lr_decay_rate=lr_decay_rate, epochs=3, n_batches=B)
    want = convert.fast_state_from_jax(jax.tree.map(np.asarray, jinit), device="cpu")
    got = tmb.init_kin40k_fast_state(
        torch.as_tensor(c["theta0"]),
        MvGaussianNat(torch.as_tensor(c["xi0"]), torch.as_tensor(c["prec0"])), M, 2,
        lr_decay_rate=lr_decay_rate, epochs=3, n_batches=B)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.xi.dtype == got.covs64.dtype == torch.float64
    assert got.theta.dtype == got.kuu_inv.dtype == torch.float32


def _port_args(c, stats_refreshes=1):
    return dict(kernel=Kernel("se", "softplus", use_kernel=True),
                theta0=torch.as_tensor(c["theta0"]), Xu=torch.as_tensor(c["Xu"]),
                X_batched=torch.as_tensor(c["Xb"]), y_batched=torch.as_tensor(c["yb"]),
                prior_v=MvGaussianNat(torch.as_tensor(c["xi0"]), torch.as_tensor(c["prec0"])),
                w_val=W, stats_refreshes=stats_refreshes)


@pytest.mark.parametrize("stats_refreshes", [1, 2])
def test_resume_three_epochs_equal_one_plus_one_plus_one(stats_refreshes):
    """The same operations in the same order: bit for bit. The carry
    handed to a resumed call is left as it was."""
    c = trainer_case(np.float32)
    args = _port_args(c, stats_refreshes)
    th3, nat3, cov3, _ = tmb.fit_kin40k_fast(**args, epochs=3)
    _, _, _, carry = tmb.fit_kin40k_fast(**args, epochs=1)
    for _ in range(2):
        before = [t.clone() for t in (carry.theta, carry.kuu_inv, carry.covs64,
                                      carry.opt_state["mu"])]
        th, nat, cov, nxt = tmb.fit_kin40k_fast(**args, epochs=1, resume_state=carry)
        after = (carry.theta, carry.kuu_inv, carry.covs64, carry.opt_state["mu"])
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        carry = nxt
    assert torch.equal(th, th3) and torch.equal(cov, cov3)
    assert torch.equal(nat.xi, nat3.xi) and torch.equal(nat.prec, nat3.prec)
    assert int(carry.opt_state["count"]) == 3 * B


def test_stats_refreshes_must_divide_batches():
    c = trainer_case(np.float32)
    with pytest.raises(ValueError, match="does not divide"):
        tmb.fit_kin40k_fast(**_port_args(c, stats_refreshes=3), epochs=1)


def test_qv_grand_update_matches_jax_and_calls_reduce():
    """f64: 1e-10 relative (κ(Λ) ≈ 1e7 here times ε₆₄, the refresh's own
    accuracy, with margin); ``reduce`` sees both increments."""
    rng = np.random.default_rng(2)
    K = rng.standard_normal((M, 200)) * 0.3
    y = rng.standard_normal(200)
    prec0 = np.eye(M) / 50.0
    want = jmb.qv_grand_update(jnp.asarray(K), jnp.asarray(y), jnp.zeros(M),
                               jnp.asarray(prec0), W, jnp.zeros((M, M)), 28,
                               lambda_min=jnp.asarray(0.02))
    seen = []

    def reduce(t):
        seen.append(tuple(t.shape))
        return t

    got = tmb.qv_grand_update(torch.as_tensor(K), torch.as_tensor(y),
                              torch.zeros(M, dtype=torch.float64),
                              torch.as_tensor(prec0), W,
                              torch.zeros((M, M), dtype=torch.float64), 28,
                              reduce=reduce, lambda_min=torch.tensor(0.02, dtype=torch.float64))
    assert seen == [(M,), (M, M)]
    for a, b in zip(got, want):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-10
