"""Parity of the port's GPSSM chain smoother (infer/chain_smoother.py), its
batched cubature pieces, the pendulum data, the streaming filter
(serve.GPSSMFilter) and convert.gpssm_state_from_jax with the JAX
package's, on the CPU.

The chain: T = 30 steps of the pendulum draw (utils/datasets.py::pendulum,
seed 69), D = 2, the softplus-SE kernel at θ = softplus⁻¹(1, 1, 1), v ~
N(0, 50·I), W ~ Wishart(100, I), x_prev ~ N([1.6, 0], 0.1·I), and M = 12
inducing inputs on a regular 4×3 grid over [−2, 2]×[−4, 4] (κ(Kuu) ≈ 1e3;
the pendulum's own grid, κ ≈ 3e13, is the runner test's). The JAX
functions run jitted; the port runs on CPU tensors (plain Grams).

Tolerances, relative to each compared array's largest entry:
- float64, 1e-11: measured ≤ 3e-13 after 4 Jacobi or 3 Gauss–Seidel
  sweeps (the same arithmetic summed in other orders; a JAX run on y
  perturbed by 1e-15 relative moves by up to 2e-13 on these inputs);
- float32, 2e-3: the port's f32 against JAX's f32. JAX's own f32 run lies
  9.5e-5–6.5e-4 from its f64 run here (the f32 rounding of the Grams
  carried through Kuu⁻¹ and the 4-point moment matches), and either
  package's f32 arithmetic is one such rounding; measured ≤ 1.3e-4;
- the filter's predictions, 1e-11 relative (float64).
Two chained windows equal one window exactly (the same ops in the same
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import serve as jserve
from gaussianprocessnode_tpu.dists import MvGaussian as JMv
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.dists import WishartFast as JWF
from gaussianprocessnode_tpu.dists import wishart_mean as jwmean
from gaussianprocessnode_tpu.dists import wishart_mean_logdet as jwlogdet
from gaussianprocessnode_tpu.infer import chain_smoother as jc
from gaussianprocessnode_tpu.nodes import multisgp as jm
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.linalg import cholinv as jcholinv
from gaussianprocessnode_tpu.utils.datasets import pendulum as jpendulum
from gaussianprocessnode_tpu_torch import convert, serve
from gaussianprocessnode_tpu_torch.dists import MvGaussian, MvGaussianNat, WishartFast
from gaussianprocessnode_tpu_torch.dists import wishart_mean, wishart_mean_logdet
from gaussianprocessnode_tpu_torch.infer import chain_smoother as tc
from gaussianprocessnode_tpu_torch.nodes import multisgp as tm
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.linalg import cholinv
from gaussianprocessnode_tpu_torch.utils.datasets import pendulum

RTOL = 1e-11
F32_RTOL = 2e-3
T_CHAIN = 30
JK = JKernel("se", transform="softplus")
TK = Kernel("se", transform="softplus", use_kernel=True)
DTYPES = {"f64": (jnp.float64, torch.float64, RTOL), "f32": (jnp.float32, torch.float32, F32_RTOL)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def close(got, want, rtol=RTOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    err = np.max(np.abs(g - w)) / scale
    assert err <= rtol, err


def close_state(got, want, rtol=RTOL):
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), rtol)


def grid_xu():
    g1, g2 = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 3), indexing="ij")
    return np.stack([g1.ravel(), g2.ravel()], axis=1)


def chain_args(dtype="f64", T=T_CHAIN, Xu=None):
    """(JAX args, port args) of gpssm_vmp up to prior_W_scale."""
    jd, td, _ = DTYPES[dtype]
    _, y, _, P, _ = pendulum()
    Xu = grid_xu() if Xu is None else Xu
    M = Xu.shape[0]
    th = np.log(np.expm1(np.ones(3)))

    def j(a):
        return jnp.asarray(np.asarray(a, np.float64), jd)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(td)

    ja = (JK, j(th), j(Xu), j(y[:T]), j(P), j([1.6, 0.0]), j(0.1 * np.eye(2)),
          JNat(j(np.zeros(M * 2)), j(np.eye(M * 2) / 50.0)), 100.0, j(np.eye(2)))
    ta = (TK, t(th), t(Xu), t(y[:T]), t(P), t([1.6, 0.0]), t(0.1 * np.eye(2)),
          MvGaussianNat(t(np.zeros(M * 2)), t(np.eye(M * 2) / 50.0)), 100.0, t(np.eye(2)))
    return ja, ta


@pytest.fixture(scope="module")
def jacobi64():
    ja, ta = chain_args("f64")
    js, jfe = jc.gpssm_vmp(*ja, n_iters=4)
    return ja, ta, js, jfe


def test_pendulum_draw_is_bit_identical():
    for a, b in zip(pendulum(), jpendulum()):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(pendulum(n=50, seed=3, qc=0.02), jpendulum(n=50, seed=3, qc=0.02)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_qv_stats_and_kuu_inv_f64(dtype):
    jd, td, rtol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    A = rng.standard_normal((24, 24))
    prec = A @ A.T + 0.5 * np.eye(24)
    xi = rng.standard_normal(24)
    jm_, jS = jc._qv_stats(jnp.asarray(xi, jd), jnp.asarray(prec, jd))
    tm_, tS = tc._qv_stats(torch.as_tensor(xi).to(td), torch.as_tensor(prec).to(td))
    assert tm_.dtype == td and tS.dtype == td
    # both factor in float64: the f32 case differs only by the f32 inputs'
    # and outputs' roundings, identical in both packages
    close(tm_, jm_, 1e-11)
    close(tS, jS, 1e-11)
    ja, ta = chain_args(dtype)
    jK = jc._kuu_inv_f64(JK, ja[1], ja[2], jd)
    tK = tc._kuu_inv_f64(TK, ta[1], ta[2], td)
    assert tK.dtype == td
    close(tK, jK, rtol if dtype == "f64" else 1e-4)


def test_moment_match_multi_batch_matches_vmapped_rule():
    """Per-row max, floor, Cholesky test and fallback: a row whose log-density
    is NaN falls back to its prior, a sharply peaked row hits the floor."""
    rng = np.random.default_rng(5)
    B = 6
    m = rng.standard_normal((B, 2))
    L = 0.3 * rng.standard_normal((B, 2, 2))
    V = L @ np.swapaxes(L, 1, 2) + 0.1 * np.eye(2)
    c = np.array([0.5, -2.0, np.nan, 3.0, -1e4, 0.0])
    a = rng.standard_normal((B, 2))

    def jlogf(cc, aa):
        return lambda x: cc * jnp.sin(x @ aa) - 0.5 * jnp.sum(x * x)

    for method in (jq.SphericalRadial(), jq.Unscented(alpha=0.5, kappa=1.0)):
        jm_, jV = jax.vmap(lambda mm, VV, cc, aa: jq.moment_match_multi(
            jlogf(cc, aa), mm, VV, method=method))(jnp.asarray(m), jnp.asarray(V),
                                                   jnp.asarray(c), jnp.asarray(a))
        tc_, ta_ = torch.as_tensor(c), torch.as_tensor(a)
        tmeth = getattr(tq, type(method).__name__)(**vars(method))
        tm_, tV = tq.moment_match_multi_batch(
            lambda x: tc_[:, None] * torch.sin(torch.einsum("bpd,bd->bp", x, ta_))
            - 0.5 * torch.sum(x * x, -1), torch.as_tensor(m), torch.as_tensor(V), tmeth)
        close(tm_, jm_)
        close(tV, jV)
        assert np.array_equal(_np(tm_[2]), m[2])  # the NaN row fell back


def test_average_energy_batch_matches_vmapped_rule():
    rng = np.random.default_rng(6)
    ja, ta = chain_args("f64")
    Xu = grid_xu()
    M, D, N = Xu.shape[0], 2, 7
    mu_y, m_in = rng.standard_normal((N, D)), rng.standard_normal((N, D))
    A = 0.3 * rng.standard_normal((2, N, D, D))
    S_y, V_in = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(D)
    mu_v = rng.standard_normal(M * D)
    B = 0.2 * rng.standard_normal((M * D, M * D))
    Sv = B @ B.T + 0.01 * np.eye(M * D)
    W_rate = np.array([[0.02, 0.003], [0.003, 0.015]])
    Kuu_inv = jcholinv(JK.kuu(ja[1], ja[2]), jitter=1e-8)
    jqw = JWF(jnp.asarray(104.0), jnp.asarray(W_rate))
    jargs = jm.MultiSGPArgs(ja[1], ja[2], Kuu_inv)
    je = jax.jit(jax.vmap(lambda a, b, c, d: jm.average_energy(
        JK, jq.SphericalRadial(), jargs, a, b, JMv(c, d), jnp.asarray(mu_v), jnp.asarray(Sv),
        jwmean(jqw), jwlogdet(jqw))))(*map(jnp.asarray, (mu_y, S_y, m_in, V_in)))
    tqw = WishartFast(torch.tensor(104.0, dtype=torch.float64), torch.as_tensor(W_rate))
    targs = tm.MultiSGPArgs(ta[1], ta[2], torch.as_tensor(np.array(Kuu_inv)))
    T = torch.as_tensor
    te = tm.average_energy_batch(TK, tq.SphericalRadial(), targs, T(mu_y), T(S_y),
                                 MvGaussian(T(m_in), T(V_in)), T(mu_v), T(Sv),
                                 wishart_mean(tqw), wishart_mean_logdet(tqw))
    close(te, je)
    # and each row is the single-node rule of the port
    one = tm.average_energy(TK, tq.SphericalRadial(), targs, T(mu_y[3]), T(S_y[3]),
                            MvGaussian(T(m_in[3]), T(V_in[3])), T(mu_v), T(Sv),
                            wishart_mean(tqw), wishart_mean_logdet(tqw))
    close(te[3], one)


def test_chain_cores_match(jacobi64):
    """chain_qv_qw_updates and chain_fe_terms on a post-sweep state."""
    ja, ta, js, _ = jacobi64
    ts = convert.gpssm_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    Kj = jc._kuu_inv_f64(JK, ja[1], ja[2], jnp.float64)
    Kt = tc._kuu_inv_f64(TK, ta[1], ta[2], torch.float64)
    W = np.array(js.W_df * jcholinv(js.W_rate))
    T_ = ja[3].shape[0]
    sr_j, sr_t = jq.SphericalRadial(), tq.SphericalRadial()
    jout = jax.jit(lambda S0i, m, V, W_: jc.chain_qv_qw_updates(
        JK, ja[1], ja[2], sr_j, Kj, ja[7], S0i, 100.0, T_, m[:-1], V[:-1], m[1:], V[1:], W_,
        jnp.float64))(jcholinv(ja[9]), js.x_means, js.x_covs, jnp.asarray(W))
    tout = tc.chain_qv_qw_updates(TK, ta[1], ta[2], sr_t, Kt, ta[7], cholinv(ta[9]), 100.0, T_,
                                  ts.x_means[:-1], ts.x_covs[:-1], ts.x_means[1:],
                                  ts.x_covs[1:], torch.as_tensor(W), torch.float64)
    for a, b in zip(tout, jout):
        close(a, b)
    jfe = jax.jit(lambda st: jc.chain_fe_terms(
        JK, ja[1], ja[2], Kj, ja[3], ja[4], ja[5], ja[6], ja[7], 100.0, ja[9], st.x_means[0],
        st.x_covs[0], st.x_means[1:], st.x_covs[1:], st.x_means[:-1], st.x_covs[:-1], *st[2:],
        sr_j))(js)
    tfe = tc.chain_fe_terms(TK, ta[1], ta[2], Kt, ta[3], ta[4], ta[5], ta[6], ta[7], 100.0,
                            ta[9], ts.x_means[0], ts.x_covs[0], ts.x_means[1:], ts.x_covs[1:],
                            ts.x_means[:-1], ts.x_covs[:-1], *ts[2:], sr_t)
    close(tfe, jfe)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gpssm_vmp_cold_and_warm(dtype, jacobi64):
    jd, td, rtol = DTYPES[dtype]
    if dtype == "f64":
        ja, ta, js, jfe = jacobi64
    else:
        ja, ta = chain_args(dtype)
        js, jfe = jc.gpssm_vmp(*ja, n_iters=4)
    ts, tfe = tc.gpssm_vmp(*ta, n_iters=4)
    assert ts.x_means.dtype == td and tfe.dtype == td
    close_state(ts, js, rtol)
    close(tfe, jfe, rtol)
    # warm start: two more sweeps from each package's own state
    js2, jfe2 = jc.gpssm_vmp(*ja, n_iters=2, init_state=js)
    ts2, tfe2 = tc.gpssm_vmp(*ta, n_iters=2, init_state=ts)
    close_state(ts2, js2, rtol)
    close(tfe2, jfe2, rtol)
    # no free energy: zero, and the same state
    ts3, tfe3 = tc.gpssm_vmp(*ta, n_iters=4, compute_fe=False)
    assert float(tfe3) == 0.0
    assert torch.equal(ts3.x_means, ts.x_means)


def test_warm_start_from_a_jax_state(jacobi64):
    """convert.gpssm_state_from_jax: the port continues a JAX run."""
    ja, ta, js, _ = jacobi64
    ts = convert.gpssm_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert all(torch.equal(getattr(ts, f), torch.as_tensor(np.array(getattr(js, f))))
               for f in js._fields)
    js2, jfe2 = jc.gpssm_vmp(*ja, n_iters=3, init_state=js)
    ts2, tfe2 = tc.gpssm_vmp(*ta, n_iters=3, init_state=ts)
    close_state(ts2, js2)
    close(tfe2, jfe2)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gpssm_vmp_sequential(dtype):
    jd, td, rtol = DTYPES[dtype]
    ja, ta = chain_args(dtype)
    js, jfe = jc.gpssm_vmp_sequential(*ja, n_iters=3)
    ts, tfe = tc.gpssm_vmp_sequential(*ta, n_iters=3)
    close_state(ts, js, rtol)
    close(tfe, jfe, rtol)
    if dtype == "f64":
        js2, _ = jc.gpssm_vmp_sequential(*ja, n_iters=1, init_state=js, compute_fe=False)
        ts2, _ = tc.gpssm_vmp_sequential(*ta, n_iters=1, init_state=ts, compute_fe=False)
        close_state(ts2, js2)


def test_filters_and_the_serving_handle(jacobi64):
    ja, ta, js, _ = jacobi64
    ts = convert.gpssm_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _, y, _, P, _ = pendulum()
    yt = y[T_CHAIN:T_CHAIN + 12]
    # the frozen constants
    jf = jc.filter_frozen(js, ja[4])
    tf = tc.filter_frozen(ts, ta[4])
    for a, b in zip(tf, jf):
        close(a, b)
    # one_step_ahead
    jpm, jpc = jc.one_step_ahead(JK, ja[1], ja[2], js, jnp.asarray(yt), ja[4])
    tpm, tpc = tc.one_step_ahead(TK, ta[1], ta[2], ts, torch.as_tensor(yt), ta[4])
    close(tpm, jpm)
    close(tpc, jpc)
    # filter_stream: two chained windows equal one, and equal JAX's
    carry = (ts.x_means[-1], ts.x_covs[-1])
    m_all, c_all, end = tc.filter_stream(TK, ta[1], ta[2], tf, torch.as_tensor(yt), carry)
    m1, _, mid = tc.filter_stream(TK, ta[1], ta[2], tf, torch.as_tensor(yt[:5]), carry)
    m2, _, end2 = tc.filter_stream(TK, ta[1], ta[2], tf, torch.as_tensor(yt[5:]), mid)
    assert torch.equal(torch.cat([m1, m2]), m_all)
    assert torch.equal(end[0], end2[0]) and torch.equal(end[1], end2[1])
    jm_, jc_, jend = jc.filter_stream(JK, ja[1], ja[2], jf, jnp.asarray(yt),
                                      (js.x_means[-1], js.x_covs[-1]))
    close(m_all, jm_)
    close(c_all, jc_)
    close(end[0], jend[0])
    close(end[1], jend[1])
    # an empty window returns its carry
    m0, c0, same = tc.filter_stream(TK, ta[1], ta[2], tf, torch.zeros((0, 2), dtype=torch.float64),
                                    carry)
    assert m0.shape == (0, 2) and c0.shape == (0, 2, 2) and same[0] is carry[0]
    # serve.GPSSMFilter: the handle, chained windows, and JAX's handle
    jh = jserve.GPSSMFilter.from_state(JK, ja[1], ja[2], js, ja[4])
    th = serve.GPSSMFilter.from_state(TK, ta[1], ta[2], ts, ta[4])
    ja_m, _, jcarry = jh(yt[:7])
    ta_m, _, tcarry = th(yt[:7])
    jb_m, _, _ = jh(yt[7:], jcarry)
    tb_m, tb_c, _ = th(yt[7:], tcarry)
    close(torch.cat([ta_m, tb_m]), np.concatenate([np.asarray(ja_m), np.asarray(jb_m)]))
    assert torch.equal(torch.cat([ta_m, tb_m]), th(yt)[0])
    assert tb_c.shape == (5, 2, 2)
