"""Parity of the port's controlled GPSSM (infer/gpssm_control.py) and the
controlled filter (chain_smoother.filter_stream with ``us``) with the JAX
package's, on the CPU.

The chain is that of tests/test_gpssm_control.py's constant-control
equivalence test, with a varying control: T = 25 steps of a damped
pendulum, D = 2, Dc = 1 control u_t = sin(0.3 t), M = 10 inducing inputs
uniform over [−1.5, 1.5]² with a control coordinate uniform over
[−1, 1], the identity-transform SE kernel at θ = (2, 1), P = 1e-4·I. 3
controlled Jacobi sweeps (cold, then 2 warm), the free energy and the
filter over 10 test steps; float64 to 1e-11 relative (measured ≤ 2.5e-15),
float32 to 2e-3 (tests/test_torch_chain_smoother.py's f32 limit and
reason). In float32 the warm sweeps start from one float64 state cast to
float32 in both packages: the cold first sweep's in-message log-density
spans ~2e4 nats over x_prev's 4 cubature points (W̄ is still the prior's),
so its float32 rounding moves the later x_prev covariance by ~1e-3 (JAX's
f32 run against its f64 run) to ~1e-2 (the port's) after 3 cold sweeps,
while one f32 sweep from a shared state is 1.2e-5 from the f64 sweep in
either package. The known-control augmentation blkdiag(V, 1e-30·I) is a normal
float32 number: the cubature points (and their Cholesky factor) of the
augmented marginal are held to JAX's for Din = 3 and 4 in float32 (1e-6
relative; the ε block's √ε = 1e-15 entries to 1e-6 of themselves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import chain_smoother as jc
from gaussianprocessnode_tpu.infer import gpssm_control as jcc
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch.dists import MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import chain_smoother as tc
from gaussianprocessnode_tpu_torch.infer import gpssm_control as tcc
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from test_torch_chain_smoother import DTYPES, close, close_state

JK = JKernel("se", transform="identity")
TK = Kernel("se", transform="identity", use_kernel=True)
T_CHAIN, M = 25, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(dtype):
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    T = T_CHAIN + 10
    xs = [np.array([0.5, 0.0])]
    us = np.sin(0.3 * np.arange(T))[:, None]
    for t in range(T):
        th, om = xs[-1]
        xs.append(np.array([th + 0.1 * om, om + 0.1 * (-2 * np.sin(th) - 0.3 * om + us[t, 0])]))
    X = np.stack(xs)
    ys = X[1:] + 0.01 * rng.normal(size=(T, 2))
    Xu = np.concatenate([rng.uniform(-1.5, 1.5, (M, 2)), rng.uniform(-1, 1, (M, 1))], axis=1)
    vals = dict(theta=np.array([2.0, 1.0]), Xu=Xu, ys=ys[:T_CHAIN], us=us[:T_CHAIN],
                P=1e-4 * np.eye(2), m0=X[0], V0=0.1 * np.eye(2), xi=np.zeros(2 * M),
                prec=np.eye(2 * M) / 50.0, S0=np.eye(2), yt=ys[T_CHAIN:], ut=us[T_CHAIN:])
    j = {k: jnp.asarray(v, jd) for k, v in vals.items()}
    t = {k: torch.as_tensor(v).to(td) for k, v in vals.items()}
    return j, t


def _args(d, K, nat):
    return (K, d["theta"], d["Xu"], d["ys"], d["us"], d["P"], d["m0"], d["V0"],
            nat(d["xi"], d["prec"]), 100.0, d["S0"])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_controlled_chain_free_energy_and_filter(dtype):
    jd, td, rtol = DTYPES[dtype]
    j, t = _problem(dtype)
    ja, ta = _args(j, JK, JNat), _args(t, TK, MvGaussianNat)
    js, jfe = jcc.gpssm_control_vmp(*ja, n_iters=1)
    ts, tfe = tcc.gpssm_control_vmp(*ta, n_iters=1)
    close_state(ts, js, rtol)
    close(tfe, jfe, rtol)
    if dtype == "f32":
        # warm sweeps from one float64 state cast to float32 in both packages
        # (see the module's docstring: the cold start's rounding is amplified)
        j64, t64 = _problem("f64")
        s64, _ = tcc.gpssm_control_vmp(*_args(t64, TK, MvGaussianNat), n_iters=1,
                                       compute_fe=False)
        ts = type(s64)(*(x.to(td) for x in s64))
        js = type(js)(*(jnp.asarray(x.numpy()) for x in ts))
    js, jfe = jcc.gpssm_control_vmp(*ja, n_iters=2, init_state=js)
    ts, tfe = tcc.gpssm_control_vmp(*ta, n_iters=2, init_state=ts)
    close_state(ts, js, rtol)
    close(tfe, jfe, rtol)
    close(tcc.gpssm_control_free_energy(*ta, ts), jcc.gpssm_control_free_energy(*ja, js), rtol)
    jpm, jpc = jcc.one_step_ahead_control(JK, j["theta"], j["Xu"], js, j["yt"], j["ut"], j["P"])
    tpm, tpc = tcc.one_step_ahead_control(TK, t["theta"], t["Xu"], ts, t["yt"], t["ut"], t["P"])
    close(tpm, jpm, rtol)
    close(tpc, jpc, rtol)
    # the controlled filter chains: two windows equal one
    fr = tc.filter_frozen(ts, t["P"])
    carry = (ts.x_means[-1], ts.x_covs[-1])
    m_all, _, end = tc.filter_stream(TK, t["theta"], t["Xu"], fr, t["yt"], carry, us=t["ut"])
    m1, _, mid = tc.filter_stream(TK, t["theta"], t["Xu"], fr, t["yt"][:4], carry, us=t["ut"][:4])
    m2, _, end2 = tc.filter_stream(TK, t["theta"], t["Xu"], fr, t["yt"][4:], mid, us=t["ut"][4:])
    assert torch.equal(torch.cat([m1, m2]), m_all) and torch.equal(end[0], end2[0])
    assert torch.equal(m_all, tpm)


@pytest.mark.parametrize("Dc", [1, 2])
def test_augmented_marginal_points_in_f32(Dc):
    """blkdiag(V, 1e-30·I) in float32: Din = 3 and 4 take the general
    Cholesky factor in both packages."""
    rng = np.random.default_rng(Dc)
    m = rng.standard_normal(2).astype(np.float32)
    B = rng.standard_normal((2, 2))
    V = (B @ B.T + 0.1 * np.eye(2)).astype(np.float32)
    u = rng.standard_normal(Dc).astype(np.float32)
    jm_, jV = jc.augment_control(jnp.asarray(m), jnp.asarray(V), jnp.asarray(u))
    tm_, tV = tc.augment_control(torch.as_tensor(m), torch.as_tensor(V), torch.as_tensor(u))
    assert tV.dtype == torch.float32 and torch.equal(tV, torch.as_tensor(np.array(jV)))
    assert torch.equal(tm_, torch.as_tensor(np.array(jm_)))
    jpts, _ = jq.sr_points_weights(jm_, jV)
    tpts, _ = tq.sr_points_weights(tm_, tV)
    close(tpts, jpts, 1e-6)
    L = tq._cholsqrt(tV)
    assert bool(torch.isfinite(L).all())
    eps_diag = torch.diagonal(L)[2:].double()
    assert torch.allclose(eps_diag, torch.full_like(eps_diag, 1e-15), rtol=1e-6)
    # the batched form equals the per-marginal one
    bm, bV = tc.augment_control(torch.as_tensor(m)[None].expand(3, 2),
                                torch.as_tensor(V)[None].expand(3, 2, 2),
                                torch.as_tensor(u)[None].expand(3, Dc))
    assert torch.equal(bm[1], tm_) and torch.equal(bV[2], tV)
