"""Parity of the port's nodes/multisgp.py and the multi-output objective
(objectives.py::neg_log_backwardmess_multi) with the JAX package's, on the
CPU.

Node state, shaped as the JAX package's MultiSGP tests (tests/test_multisgp.py)
at a smaller width: M = 9 inducing inputs on a 3×3 grid over [1, 3]², D = 2
outputs, the SE kernel with θ = (1, 1) (identity transform; softplus for
the θ rule's second case), μ_v = sin(u) for u uniform from a seed, Σ_v = I,
W̄ = E[Wishart(10, 50·I)] (and a WishartFast), q_in = N((1, 2.7), I),
μ_y = (0.5, 1.4). The rules run under spherical-radial cubature, the
classic UT and GenUT (the JAX tests use SR). The objective: N = 12 data,
Din = 2, random q(x) means and SPD covariances, μ_y and sumRv_W from Rv.

Tolerances, relative to each compared result's largest entry:
- float64, 1e-11 (measured ≤ 1.2e-13, the θ rule's gradient through
  Kuu⁻¹; the cubature points, Grams and contractions are the same
  arithmetic, summed in other orders). The Laplace in-message too: both
  packages' L-BFGS (optax's, and the port's copy of it) take the same 20
  steps (measured 2.8e-15);
- the float32 objective and gradient, 1e-4: the float32 rounding of the
  point Grams carried through the solve against Kuu, jittered by 3.6e-5
  in float32 (measured 3.1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import dists as jd
from gaussianprocessnode_tpu import objectives as jo
from gaussianprocessnode_tpu.nodes import multisgp as jm
from gaussianprocessnode_tpu.ops import psi as jpsi
from gaussianprocessnode_tpu.ops import quadrature as jq
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.linalg import cholinv as jcholinv
from gaussianprocessnode_tpu.ops.linalg import sum_blocks_weighted as jsbw
from gaussianprocessnode_tpu_torch import dists as td
from gaussianprocessnode_tpu_torch import objectives as to
from gaussianprocessnode_tpu_torch.nodes import multisgp as tm
from gaussianprocessnode_tpu_torch.ops import linalg as tl
from gaussianprocessnode_tpu_torch.ops import psi as tpsi
from gaussianprocessnode_tpu_torch.ops import quadrature as tq
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as TKernel

RTOL = 1e-11
F32_RTOL = 1e-4
M, D = 9, 2
METHODS = [jq.SphericalRadial(), jq.Unscented(alpha=0.5, kappa=1.0), jq.GenUT()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(method):
    return getattr(tq, type(method).__name__)(**vars(method))


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.asarray(a, np.float64)


def close(got, want, rtol=RTOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype)


class _State:
    """The node state in numpy, and as both packages' arguments."""

    def __init__(self, transform="identity"):
        rng = np.random.default_rng(42)
        g = np.linspace(1.0, 3.0, 3)
        self.Xu = np.array([[a, b] for b in g for a in g])
        self.theta = np.array([1.0, 1.0]) if transform == "identity" else np.array([0.4, 0.9])
        self.mu_v = np.sin(rng.random(D * M))
        self.Sigma_v = np.eye(D * M)
        self.Rv = np.outer(self.mu_v, self.mu_v) + self.Sigma_v
        self.W = 10.0 * 50.0 * np.eye(D) + np.array([[0.0, 40.0], [40.0, 0.0]])
        self.q_in = (np.array([1.0, 2.7]), np.array([[1.0, 0.2], [0.2, 0.8]]))
        self.mu_y = np.array([0.5, 1.4])
        self.Sigma_y = np.array([[0.3, 0.05], [0.05, 0.2]])
        self.jk = JKernel("se", transform=transform)
        self.tk = TKernel("se", transform=transform, use_kernel=True)
        Kinv = jcholinv(self.jk.kuu(jnp.asarray(self.theta), jnp.asarray(self.Xu)), jitter=1e-12)
        self.Kuu_inv = np.asarray(Kinv)
        self.jargs = jm.MultiSGPArgs(jnp.asarray(self.theta), jnp.asarray(self.Xu),
                                     jnp.asarray(self.Kuu_inv))
        self.targs = tm.MultiSGPArgs(T(self.theta), T(self.Xu), T(self.Kuu_inv))

    def jq_in(self):
        return jd.MvGaussian(jnp.asarray(self.q_in[0]), jnp.asarray(self.q_in[1]))

    def tq_in(self):
        return td.MvGaussian(T(self.q_in[0]), T(self.q_in[1]))


S = _State()


@pytest.mark.parametrize("method", METHODS, ids=lambda m: type(m).__name__)
def test_out_message_matches_jax(method):
    j = jm.out_message(S.jk, method, S.jargs, S.jq_in(), jnp.asarray(S.mu_v), jnp.asarray(S.W))
    t = tm.out_message(S.tk, _port(method), S.targs, S.tq_in(), T(S.mu_v), T(S.W))
    close(t.mean, j.mean)
    close(t.cov, j.cov)


def test_in_log_message_matches_jax_at_a_point_and_on_a_batch():
    """The port's callable takes one point or a batch; both equal JAX's
    per-point closure, and so does the gradient in x."""
    jl = jm.in_log_message(S.jk, S.jargs, jnp.asarray(S.mu_y), jnp.asarray(S.mu_v),
                           jnp.asarray(S.Rv), jnp.asarray(S.W))
    tlog = tm.in_log_message(S.tk, S.targs, T(S.mu_y), T(S.mu_v), T(S.Rv), T(S.W))
    pts = np.array([[1.0, 1.5], [-1.5, 2.0], [2.2, 2.9], [1.7, 0.4]])
    want = np.array([float(jl(jnp.asarray(p))) for p in pts])
    close(tlog(T(pts)), want)
    close(tlog(T(pts[1])), want[1])
    assert tlog(T(pts[1])).shape == ()
    x = T(pts[0]).requires_grad_(True)
    (gx,) = torch.autograd.grad(tlog(x), x)
    close(gx, jax.grad(jl)(jnp.asarray(pts[0])))


@pytest.mark.parametrize("w_scale", [1.0, 0.01])
@pytest.mark.parametrize("method", METHODS, ids=lambda m: type(m).__name__)
def test_marginal_in_matches_jax(method, w_scale):
    """W̄ as it is makes the in-message so peaked that one cubature point
    carries the product's mass (the covariance is the 1e-8·tr(V)/d floor);
    W̄/100 gives a product of full rank, away from q_fwd."""
    q_fwd = (np.array([1.8, 2.1]), np.array([[0.4, 0.1], [0.1, 0.3]]))
    W = S.W * w_scale
    j = jm.marginal_in(S.jk, S.jargs, jnp.asarray(S.mu_y), jnp.asarray(S.mu_v),
                       jnp.asarray(S.Rv), jnp.asarray(W),
                       jd.MvGaussian(jnp.asarray(q_fwd[0]), jnp.asarray(q_fwd[1])), method)
    t = tm.marginal_in(S.tk, S.targs, T(S.mu_y), T(S.mu_v), T(S.Rv), T(W),
                       td.MvGaussian(T(q_fwd[0]), T(q_fwd[1])), _port(method))
    close(t.mean, j.mean)
    close(t.cov, j.cov)
    assert float(torch.max(torch.abs(t.mean - T(q_fwd[0])))) > 0.1


def test_laplace_in_message_matches_jax():
    """20 L-BFGS steps from mean(q_in), then the Hessian at the minimiser;
    the port's Hessian is reverse over reverse through the kernel's
    autograd Function, and agrees with the plain Gram's."""
    mu_y = np.array([1.5, 2.0])
    j = jm.in_message_laplace(S.jk, S.jargs, jnp.asarray(mu_y), jnp.asarray(S.mu_v),
                              jnp.asarray(S.Rv), jnp.asarray(S.W), jnp.asarray(S.q_in[0]))
    t = tm.in_message_laplace(S.tk, S.targs, T(mu_y), T(S.mu_v), T(S.Rv), T(S.W),
                              T(S.q_in[0]))
    close(t.prec, j.prec)
    close(t.xi, j.xi)
    plain = tm.in_message_laplace(TKernel("se"), S.targs, T(mu_y), T(S.mu_v), T(S.Rv),
                                  T(S.W), T(S.q_in[0]))
    close(t.prec, plain.prec, 1e-12)


@pytest.mark.parametrize("method", METHODS, ids=lambda m: type(m).__name__)
def test_v_message_matches_jax(method):
    j = jm.v_message(S.jk, method, S.jargs, jnp.asarray(S.mu_y), S.jq_in(), jnp.asarray(S.W))
    t = tm.v_message(S.tk, _port(method), S.targs, T(S.mu_y), S.tq_in(), T(S.W))
    close(t.xi, j.xi)
    close(t.prec, j.prec)


def test_v_message_batch_is_the_sum_of_v_messages_and_matches_jax():
    rng = np.random.default_rng(7)
    means = rng.standard_normal((4, 2)) + 2.0
    covs = np.tile(0.3 * np.eye(2), (4, 1, 1))
    ys = rng.standard_normal((4, 2))
    sr_t = tq.SphericalRadial()
    _, p1, Kp, w = tpsi.psi_batch_expected_multi(S.tk, T(S.theta), T(S.Xu), sr_t, T(means),
                                                 T(covs))
    sum_psi2 = tpsi.sum_weighted_psi2(Kp, w, torch.ones(4, dtype=torch.float64))
    batch = tm.v_message_batch(p1, sum_psi2, T(ys) @ T(S.W).T, T(S.W))
    xi = sum(tm.v_message(S.tk, sr_t, S.targs, T(ys[t]), td.MvGaussian(T(means[t]),
                          T(covs[t])), T(S.W)).xi for t in range(4))
    prec = sum(tm.v_message(S.tk, sr_t, S.targs, T(ys[t]), td.MvGaussian(T(means[t]),
                            T(covs[t])), T(S.W)).prec for t in range(4))
    close(batch.xi, xi)
    close(batch.prec, prec)
    sr = jq.SphericalRadial()
    _, jp1, jKp, jw = jpsi.psi_batch_expected_multi(S.jk, jnp.asarray(S.theta),
                                                    jnp.asarray(S.Xu), sr, jnp.asarray(means),
                                                    jnp.asarray(covs))
    jb = jm.v_message_batch(jp1, jpsi.sum_weighted_psi2(jKp, jw, jnp.ones(4)),
                            jnp.asarray(ys) @ jnp.asarray(S.W).T, jnp.asarray(S.W))
    close(batch.xi, jb.xi)
    close(batch.prec, jb.prec)


@pytest.mark.parametrize("method", METHODS, ids=lambda m: type(m).__name__)
def test_w_message_matches_jax(method):
    j = jm.w_message(S.jk, method, S.jargs, jnp.asarray(S.mu_y), jnp.asarray(S.Sigma_y),
                     S.jq_in(), jnp.asarray(S.mu_v), jnp.asarray(S.Sigma_v))
    t = tm.w_message(S.tk, _port(method), S.targs, T(S.mu_y), T(S.Sigma_y), S.tq_in(),
                     T(S.mu_v), T(S.Sigma_v))
    assert isinstance(t, td.WishartFast) and t.df.dim() == 0 and float(t.df) == D + 2.0
    close(t.inv_scale, j.inv_scale)


@pytest.mark.parametrize("transform", ["identity", "softplus"])
@pytest.mark.parametrize("method", [jq.SphericalRadial(), jq.GenUT()],
                         ids=lambda m: type(m).__name__)
def test_theta_log_message_and_gradient_match_jax(method, transform):
    s = S if transform == "identity" else _State("softplus")
    jl = jm.theta_log_message(s.jk, method, jnp.asarray(s.Xu), s.jq_in(), jnp.asarray(s.mu_y),
                              jnp.asarray(s.mu_v), jnp.asarray(s.Rv), jnp.asarray(s.W))
    tlog = tm.theta_log_message(s.tk, _port(method), T(s.Xu), s.tq_in(), T(s.mu_y),
                                T(s.mu_v), T(s.Rv), T(s.W))
    jvg = jax.jit(jax.value_and_grad(jl))
    for th in ([1.2, 2.3], [0.5, 1.4]):
        x = T(th).requires_grad_(True)
        v = tlog(x)
        (g,) = torch.autograd.grad(v, x)
        jv, jg = jvg(jnp.asarray(th))
        close(v, jv)
        close(g, jg)


@pytest.mark.parametrize("q_w", ["wishart", "wishart_fast", "point_mass"])
def test_average_energy_matches_jax(q_w):
    if q_w == "point_mass":
        W, E_logdet, Sigma_y = S.W, float(np.linalg.slogdet(S.W)[1]), np.zeros((D, D))
    else:
        scale = np.array([[50.0, 4.0], [4.0, 50.0]])
        if q_w == "wishart":
            jw, tw = (jd.Wishart(jnp.asarray(10.0), jnp.asarray(scale)),
                      td.Wishart(T(10.0), T(scale)))
        else:
            inv = np.linalg.inv(scale)
            jw, tw = (jd.WishartFast(jnp.asarray(10.0), jnp.asarray(inv)),
                      td.WishartFast(T(10.0), T(inv)))
        close(td.wishart_mean_logdet(tw), jd.wishart_mean_logdet(jw))
        W, E_logdet, Sigma_y = np.asarray(jd.wishart_mean(jw)), float(
            jd.wishart_mean_logdet(jw)), S.Sigma_y
    sr = jq.SphericalRadial()
    j = jm.average_energy(S.jk, sr, S.jargs, jnp.asarray(S.mu_y), jnp.asarray(Sigma_y),
                          S.jq_in(), jnp.asarray(S.mu_v), jnp.asarray(S.Sigma_v),
                          jnp.asarray(W), E_logdet)
    t = tm.average_energy(S.tk, _port(sr), S.targs, T(S.mu_y), T(Sigma_y), S.tq_in(),
                          T(S.mu_v), T(S.Sigma_v), T(W), E_logdet)
    close(t, j)


def _objective_inputs(dtype=np.float64):
    rng = np.random.default_rng(11)
    N = 12
    qx_means = rng.uniform(0.8, 3.2, (N, 2))
    A = rng.standard_normal((N, 2, 2)) * 0.2
    qx_covs = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(2)
    y_means = rng.standard_normal((N, D))
    sumRv_W = np.asarray(jsbw(jnp.asarray(S.Rv), jnp.asarray(S.W) / 500.0, D, M))
    arrays = dict(Xu=S.Xu, y_means=y_means, qx_means=qx_means, qx_covs=qx_covs,
                  sumRv_W=sumRv_W, mu_v=S.mu_v, W=S.W / 500.0)
    theta = np.array([0.3, 0.1, -0.2])
    return ({k: v.astype(dtype) for k, v in arrays.items()}, theta.astype(dtype))


@pytest.mark.parametrize("dtype,method", [(np.float64, jq.SphericalRadial()),
                                          (np.float64, jq.GenUT()),
                                          (np.float32, jq.SphericalRadial())],
                         ids=["f64-SR", "f64-GenUT", "f32-SR"])
def test_multi_objective_and_gradient_match_jax(dtype, method):
    """The pendulum M-step's objective (softplus SE, θ of 3) and its
    gradient, ``grad_multi``, in float64 and float32."""
    arrays, theta = _objective_inputs(dtype)
    jk, tk = JKernel("se", transform="softplus"), TKernel("se", "softplus", use_kernel=True)
    jkw = {k: jnp.asarray(v) for k, v in arrays.items()}
    tkw = {k: torch.as_tensor(v) for k, v in arrays.items()}
    jv, jg = jax.jit(jax.value_and_grad(lambda th: jo.neg_log_backwardmess_multi(
        th, kernel=jk, method=method, **jkw)))(jnp.asarray(theta))
    tv = to.neg_log_backwardmess_multi(torch.as_tensor(theta), kernel=tk,
                                       method=_port(method), **tkw)
    tg = to.grad_multi(torch.as_tensor(theta), kernel=tk, method=_port(method), **tkw)
    rtol = RTOL if dtype == np.float64 else F32_RTOL
    assert tv.dtype == torch.as_tensor(np.array(jv)).dtype
    close(tv, jv, rtol)
    close(tg, jg, rtol)


def test_block_helpers_match_jax():
    from gaussianprocessnode_tpu.ops import linalg as jl

    rng = np.random.default_rng(3)
    Rv = rng.standard_normal((D * M, D * M))
    Sm = rng.standard_normal((M, M))
    W = rng.standard_normal((D, D))
    V = rng.standard_normal((D * M, D))
    close(tl.block_trace_products(T(Rv), T(Sm), D, M),
          jl.block_trace_products(jnp.asarray(Rv), jnp.asarray(Sm), D, M))
    close(tl.sum_blocks_weighted(T(Rv), T(W), D, M),
          jl.sum_blocks_weighted(jnp.asarray(Rv), jnp.asarray(W), D, M))
    close(tl.sum_diagonal_blocks(T(V), M), jl.sum_diagonal_blocks(jnp.asarray(V), M))
    close(tl.trace_blocks(T(Rv), D, M), jl.trace_blocks(jnp.asarray(Rv), D, M))
    A = Rv @ Rv.T + np.eye(D * M)
    close(tl.solve_psd(T(A), T(V)), jl.solve_psd(jnp.asarray(A), jnp.asarray(V)))


def test_pendulum_inducing_grid_matches_jax():
    from gaussianprocessnode_tpu.utils.datasets import pendulum_inducing as jgrid
    from gaussianprocessnode_tpu_torch.utils.datasets import pendulum_inducing as tgrid

    assert np.array_equal(tgrid(), jgrid())
    assert tgrid().shape == (48, 2)
