"""Parity of the port's infer/gplvm.py with the JAX package's, on the CPU.

Data: ``utils/datasets.py::oil_flow_synthetic(1, n=32)`` (3PhData's shape:
12-D outputs, 3 classes), the latents' priors at its 2-D PCA projection,
M = 8 inducing inputs drawn from it by ``default_rng(86)`` (the runner's
rule), θ = [1.0, 0.6, 0.5] (softplus), W = 100·I, prior variance 100. Both
packages get the same numpy arrays; states cross by
``convert.gplvm_state_from_jax``.

Tolerances, relative to each compared array's largest entry:
- float64 sweeps, the free energy and its θ-gradient, the embedding: 1e-9
  (measured ≤ 5.0e-12: the batched L-BFGS takes every row's steps as
  optax's does, and the Hessians by reverse over reverse agree with
  ``jax.hessian`` to rounding);
- ``fit_gplvm_grad`` (2 epochs of 2 sweeps and 3 M-step L-BFGS steps):
  1e-7 (measured ≤ 1.3e-11, the latents' covariances; θ 8e-13): the M-step
  θ moves every later Laplace mode, so rounding is carried through two
  epochs of both;
- one float32 sweep on the plain Gram: the q(v) naturals, which come from
  the cold marginals before any Laplace step, to 2e-6 (float32 Ψ-statistics
  agree to an ulp; measured 2.9e-7); the latents to 1e-3 (means) and 2e-2
  (covariances) and the free energy to 1e-4 (measured 7.7e-5, 5.3e-4 and
  9.9e-6): the float64 Laplace path starts from the float32 Kuu, whose ulp
  differences between the packages Kuu⁻¹ at the float32 jitter (3.6e-5)
  amplifies, as the JAX runner documents for its f32 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import gplvm as jg
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.experiments.gplvm import pca_2d
from gaussianprocessnode_tpu_torch.infer import gplvm as tg
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.utils.datasets import oil_flow_synthetic

N, M = 32, 8
F64_RTOL = 1e-9
FIT_RTOL = 1e-7
JK = JKernel("se", transform="softplus")
TK = Kernel("se", transform="softplus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(dtype=np.float64):
    Y, labels = oil_flow_synthetic(1, N)
    Xm = pca_2d(Y)
    Xu = Xm[np.random.default_rng(86).permutation(N)[:M]]
    theta = np.array([1.0, 0.6, 0.5])
    arrs = [a.astype(dtype) for a in (theta, Xu, Y, Xm)]
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs], labels


def _rel(got, want):
    g = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))


def _state_errs(ts, js):
    return {f: _rel(getattr(ts, f), getattr(js, f)) for f in tg.GPLVMState._fields}


def _from_jax(state):
    return convert.gplvm_state_from_jax(jax.tree.map(np.asarray, state), device="cpu")


@pytest.fixture(scope="module")
def f64_sweeps():
    J, T, _ = _case()
    js, jfe = jg.gplvm_vmp(JK, *J, n_iters=2)
    counts = {}
    ts, tfe = tg.gplvm_vmp(TK, *T, n_iters=2, counts=counts)
    return J, T, js, jfe, ts, tfe, counts


def test_gplvm_vmp_f64_matches_jax(f64_sweeps):
    _, _, js, jfe, ts, tfe, counts = f64_sweeps
    errs = _state_errs(ts, js)
    assert max(errs.values()) <= F64_RTOL, errs
    assert _rel(tfe, jfe) <= F64_RTOL
    assert ts.xi_v.dtype == ts.prec_v.dtype == tfe.dtype == torch.float64
    # one host read per linesearch iteration of the whole batch
    assert counts["host_reads"] == counts["linesearch_steps"] > 0


def test_gplvm_vmp_f32_one_sweep_matches_jax():
    J, T, _ = _case(np.float32)
    js, jfe = jg.gplvm_vmp(JK, *J, n_iters=1)
    ts, tfe = tg.gplvm_vmp(Kernel("se", transform="softplus", use_kernel=True), *T, n_iters=1)
    errs = _state_errs(ts, js)
    assert ts.x_means.dtype == ts.x_covs.dtype == torch.float32
    assert ts.xi_v.dtype == ts.prec_v.dtype == torch.float64
    assert max(errs["xi_v"], errs["prec_v"]) <= 2e-6, errs
    assert errs["x_means"] <= 1e-3 and errs["x_covs"] <= 2e-2, errs
    assert _rel(tfe, jfe) <= 1e-4


def test_free_energy_and_its_theta_gradient_match_jax(f64_sweeps):
    """At the JAX state (carried by convert), the FE and the M-step's
    θ-terms gradient."""
    J, T, js, _, _, _, _ = f64_sweeps
    st = _from_jax(js)
    jfe = jax.jit(jg.gplvm_free_energy, static_argnums=0)(JK, J[0], J[1], J[2], js, J[3])
    assert _rel(tg.gplvm_free_energy(TK, T[0], T[1], T[2], st, T[3]), jfe) <= F64_RTOL

    def jobj(th):
        mu_v, Binv, _ = jg._qv_stats_kron(js.xi_v, js.prec_v, M, 12)
        cov_v = jnp.kron(jnp.eye(12), Binv)
        mub = mu_v.reshape(12, M)
        R = 12 * Binv + jnp.einsum("dm,dn->mn", mub, mub)
        return jg.gplvm_fe_theta_terms(JK, th, J[1], J[2], js.x_means, js.x_covs, mu_v,
                                       cov_v, R)

    mu_v, cov_v, R, _ = tg._kron_moments(st, M, 12, torch.float64)
    th = T[0].clone().requires_grad_(True)
    val = tg.gplvm_fe_theta_terms(TK, th, T[1], T[2], st.x_means, st.x_covs, mu_v, cov_v, R)
    (g,) = torch.autograd.grad(val, th)
    jval, jgrad = jax.jit(jax.value_and_grad(jobj))(J[0])
    assert _rel(val, jval) <= F64_RTOL and _rel(g, jgrad) <= F64_RTOL


def test_fit_gplvm_grad_matches_jax():
    """2 epochs from the JAX cold state carried by convert; θ, the FE trace
    and the state."""
    J, T, _ = _case()
    j0 = jg.gplvm_init_state(JK, *J)
    jth, jst, jfe = jg.fit_gplvm_grad(JK, *J, epochs=2, n_iters=2, lbfgs_steps=3,
                                      init_state=j0)
    counts, mcounts = {}, {}
    tth, tst, tfe = tg.fit_gplvm_grad(TK, *T, epochs=2, n_iters=2, lbfgs_steps=3,
                                      init_state=_from_jax(j0), counts=counts,
                                      mstep_counts=mcounts)
    errs = _state_errs(tst, jst)
    assert max(errs.values()) <= FIT_RTOL, errs
    assert _rel(tth, jth) <= FIT_RTOL and _rel(tfe, jfe) <= FIT_RTOL
    assert tfe.shape == (2,) and float(tfe[-1]) < float(tfe[0])
    assert mcounts["host_reads"] == mcounts["linesearch_steps"] > 0 and counts["host_reads"] > 0


def test_gplvm_embed_matches_jax_and_keeps_trained_latents(f64_sweeps):
    """Embedding the training rows from the trained latents (the JAX state,
    3 passes); and the trained latents are fixed points of the map at the θ
    their sweeps ran at (the JAX package measured ≤ 4e-10; the L-BFGS of 20
    steps converges to ~1e-10 here)."""
    J, T, js, _, _, _, _ = f64_sweeps
    st = _from_jax(js)
    jm, jV = jg.gplvm_embed(JK, J[0], J[1], J[2], js, J[3], x_start=js.x_means)
    tm, tV = tg.gplvm_embed(TK, T[0], T[1], T[2], st, T[3], x_start=st.x_means)
    assert _rel(tm, jm) <= F64_RTOL and _rel(tV, jV) <= F64_RTOL
    # fixed points after 2 more sweeps at the same θ
    st2, _ = tg.gplvm_vmp(TK, *T, n_iters=2, init_state=st, compute_fe=False)
    tm, _ = tg.gplvm_embed(TK, T[0], T[1], T[2], st2, T[3], x_start=st2.x_means)
    assert float((tm - st2.x_means).abs().max()) <= 1e-8


def test_embed_needs_one_pass(f64_sweeps):
    _, T, _, _, ts, _, _ = f64_sweeps
    with pytest.raises(ValueError, match="n_iters"):
        tg.gplvm_embed(TK, T[0], T[1], T[2], ts, T[3], n_iters=0)


def test_explicit_init_state_is_the_cold_start():
    """``gplvm_init_state`` passed explicitly gives the bits of omitting it."""
    _, T, _ = _case()
    s0 = tg.gplvm_init_state(TK, *T)
    a, fa = tg.gplvm_vmp(TK, *T, n_iters=2)
    b, fb = tg.gplvm_vmp(TK, *T, n_iters=2, init_state=s0)
    assert torch.equal(fa, fb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, f0 = tg.gplvm_vmp(TK, *T, n_iters=1, compute_fe=False)
    assert float(f0) == 0.0 and f0.dtype == T[2].dtype


def test_qv_stats_kron_matches_generic(f64_sweeps):
    """After real sweeps Λ_v is I_D ⊗ B, and the M×M route gives the
    generic (M·D)³ factorization's moments (to their round-off gap at
    κ(B), 1e-6 relative)."""
    _, _, _, _, ts, _, _ = f64_sweeps
    D = 12
    prec = ts.prec_v
    B = prec[:M, :M]
    blocks = prec.reshape(D, M, D, M).permute(0, 2, 1, 3)
    want = torch.zeros_like(blocks)
    want[range(D), range(D)] = B
    assert float((blocks - want).abs().max()) <= 1e-10 * float(B.abs().max())
    mu_k, Binv, Lb = tg._qv_stats_kron(ts.xi_v, prec, M, D)
    mu_g, cov_g = tg._qv_stats(ts.xi_v, prec)
    assert _rel(mu_k, mu_g) <= 1e-6
    assert _rel(torch.kron(torch.eye(D, dtype=Binv.dtype), Binv.contiguous()), cov_g) <= 1e-6
    assert Lb.dtype == torch.float64


def test_precision_guard():
    """Indefinite with a positive diagonal, NaN, and a PD matrix (returned
    symmetrized), alone and in one batch."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    nan = torch.tensor([[1.0, float("nan")], [0.0, 1.0]], dtype=torch.float64)
    good = torch.tensor([[2.0, 0.5], [0.3, 1.0]], dtype=torch.float64)
    assert torch.equal(tg.laplace_precision_guard(bad), torch.zeros(2, 2, dtype=torch.float64))
    assert torch.equal(tg.laplace_precision_guard(nan), torch.zeros(2, 2, dtype=torch.float64))
    sym = 0.5 * (good + good.T)
    assert torch.equal(tg.laplace_precision_guard(good), sym)
    out = tg.laplace_precision_guard(torch.stack([bad, nan, good]))
    assert torch.equal(out, torch.stack([torch.zeros(2, 2, dtype=torch.float64)] * 2 + [sym]))
    assert np.array_equal(out.numpy(), np.stack([np.asarray(jg.laplace_precision_guard(
        jnp.asarray(m.numpy()))) for m in (bad, nan, good)]))


def test_fe_does_not_rise_per_sweep_at_frozen_theta():
    """With θ frozen each sweep is a coordinate update of the same FE: it
    does not rise beyond the Laplace site approximation's slack (1e-6
    relative, the JAX package's test), and it falls overall."""
    _, T, _ = _case()
    fes, state = [], None
    for _ in range(4):
        state, fe = tg.gplvm_vmp(TK, *T, n_iters=1, init_state=state)
        fes.append(float(fe))
    fes = np.asarray(fes)
    assert np.all(np.isfinite(fes))
    assert np.all(np.diff(fes) <= 1e-6 * np.abs(fes[:-1]) + 1e-8), fes
    assert fes[-1] < fes[0] - 10.0, fes
