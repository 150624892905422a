"""Whitened SVGP baseline: the ELBO-trained sparse variational GP.

Counterpart of ``gaussianprocessnode_tpu/infer/svgp.py`` (the reference's
baseline notebooks Regression_VSGP.ipynb / Classification_VSGP.ipynb,
ApproximateGPs.jl SVGP with the whitened Cholesky parameterization, AdaMax
on −ELBO). Titsias/Hensman SVGP:

    q(u) = N(Lu·m̃ + μ₀, Lu·Ã·Ãᵀ·Luᵀ)   (whitened: m̃, Ã free parameters)
    ELBO = Σᵢ E_q(fᵢ)[log p(yᵢ|fᵢ)] − KL(q(u)‖p(u))

The Gaussian likelihood has closed-form expectations; Bernoulli-probit
uses Gauss–Hermite. The collapsed Titsias bound (q(u) profiled out) is the
kin40k north-star trainer.

Where the JAX package runs one jitted ``lax.scan``, the trainers here are
eager loops that never wait on the host: the AdaMax chain
(``infer/minibatch.py::AdaMaxChain`` without its clipping link, as
``optax.chain(zero_nans(), adamax(lr))``) keeps its step count on the
device, the parameters are updated in place, and each step's loss goes into
a preallocated device tensor. A Cholesky factor that is not positive
definite is NaN (``ops/linalg.py::chol_lower``); ``zero_nans`` then zeroes
that gradient, as in JAX. ``learn_noise=False`` detaches ``log_noise``
inside the loss, so its gradient is zero and AdaMax leaves it bit for bit
as it was.
"""

import math
from typing import NamedTuple

import torch

from .. import config
from ..config import JITTER_KUU
from ..ops.kernels import softplus
from ..ops.linalg import chol_lower, solve_psd, tri_solve_lower, tri_solve_upper
from ..ops.quadrature import gh_nodes
from ..ops.svgp_var import svgp_var_cuda, svgp_var_reference, svgp_var_route
from ..utils import tracing
from .minibatch import AdaMaxChain, _leaves, _like

__all__ = ["SVGPParams", "init_svgp", "elbo_gaussian", "elbo_bernoulli", "svgp_predict",
           "svgp_factors", "svgp_predict_batch",
           "collapsed_neg_elbo", "vsgp_optimizer", "collapsed_opt_init", "collapsed_step",
           "fit_svgp_collapsed", "fit_svgp_collapsed_resumable", "collapsed_predict",
           "fit_svgp"]

_LOG2PI = math.log(2.0 * math.pi)


class SVGPParams(NamedTuple):
    theta: torch.Tensor  # kernel hyperparameters (softplus-transformed in kernel)
    m_white: torch.Tensor  # whitened variational mean (M,)
    A_raw: torch.Tensor  # raw lower-triangular factor (M, M); diag softplus'd
    log_noise: torch.Tensor  # Gaussian likelihood: log observation variance


def init_svgp(theta0, M, dtype=None, noise: float | None = None,
              raw_tril: bool = False) -> SVGPParams:
    """m̃ = 0, the effective factor _A_tril(A_raw) = I (the reference's
    A_init = I, Regression_VSGP cell 9), log σ² = −2 or log ``noise`` (the
    reference fixes lik_noise = 0.01, cell 8: pass 0.01 and train with
    ``learn_noise=False``), on θ0's device."""
    dtype = dtype or theta0.dtype
    dev = theta0.device
    log_noise = torch.tensor(-2.0 if noise is None else math.log(noise), dtype=dtype,
                             device=dev)
    diag0 = 1.0 if raw_tril else math.log(math.expm1(1.0))
    return SVGPParams(
        theta=theta0,
        m_white=torch.zeros(M, dtype=dtype, device=dev),
        A_raw=diag0 * torch.eye(M, dtype=dtype, device=dev),
        log_noise=log_noise,
    )


def _A_tril(A_raw, raw: bool = False):
    """Lower-triangular variational factor: softplus-positive diagonal, or
    with ``raw`` the diagonal as it is (the reference's parameterization,
    Regression_VSGP cell 8)."""
    if raw:
        return torch.tril(A_raw)
    return torch.tril(A_raw, -1) + torch.diag(softplus(torch.diagonal(A_raw)))


def svgp_factors(kernel, params: SVGPParams, Xu, jitter: float = JITTER_KUU,
                 raw_tril: bool = False):
    """The once-per-model part of the predictive: (Lu, Ã), the lower
    Cholesky factor of Kuu = K(Xu, Xu) + jitter·I and the variational
    factor."""
    Lu = chol_lower(kernel.kuu(params.theta, Xu, jitter=jitter))
    return Lu, _A_tril(params.A_raw, raw_tril)


def svgp_predict_batch(kernel, theta, Xu, X, Lu, m_white, A):
    """The whitened predictive q(f) = N(mean, var) at the rows of X, from
    the factors of :func:`svgp_factors`: Y = Lu⁻¹K(Xu, X), mean = Yᵀm̃, and
    var = k(x, x) − ‖y‖² + ‖Ãᵀy‖² per column, floored at 1e-12 on the
    device, so a CUDA graph can capture the call. After the Gram, the route
    is chosen from what the call can observe (``ops.svgp_var.svgp_var_route``):
    float32 operands (the Gram, Lu, Ã, m̃, k(x, x)) on a CUDA card with
    gradients off and M ≤ ``SVGP_VAR_MAX_M`` (a serving handle's call) go
    to the CUDA kernel ``ops.svgp_var.svgp_var_cuda`` (span
    ``svgp.fused``), which reads only the lower triangles of Lu and Ã;
    every other call (the CPU, float64 or mixed dtypes, the trainers' ELBO
    with gradients on, a larger M) to the plain, differentiable
    ``svgp_var_reference`` (spans ``svgp.solve`` and ``svgp.var``)."""
    Kux = kernel(theta, Xu, X)  # (M, N)
    kxx = kernel.diag(theta, X)
    if svgp_var_route(Kux, Lu, A, m_white, kxx) == "kernel":
        with tracing.span("svgp.fused"):
            return svgp_var_cuda(Kux, Lu, A, m_white, kxx)
    return svgp_var_reference(Kux, Lu, A, m_white, kxx)


def _marginal_f(kernel, params: SVGPParams, Xu, X, whitened: bool = True,
                jitter: float = JITTER_KUU, raw_tril: bool = False):
    """Predictive q(f) = N(mean, var) at inputs X: :func:`svgp_factors`,
    then :func:`svgp_predict_batch`. ``whitened=False`` takes the
    reference's centered q(u) = N(m, AAᵀ) in u-space (Regression_VSGP
    cell 7)."""
    Lu, A = svgp_factors(kernel, params, Xu, jitter, raw_tril)
    if whitened:
        return svgp_predict_batch(kernel, params.theta, Xu, X, Lu, params.m_white, A)
    Kux = kernel(params.theta, Xu, X)  # (M, N)
    Akx = tri_solve_lower(Lu, Kux)  # Lu⁻¹ Kux
    kxx = kernel.diag(params.theta, X)
    # B = Kuu⁻¹ Kux = Lu⁻ᵀ Akx;  mean = Bᵀ m;  cov term = ‖Aᵀ B‖² per column
    B = tri_solve_upper(Lu.mT, Akx)
    mean = B.T @ params.m_white
    SAk = A.T @ B
    var = kxx - torch.sum(Akx * Akx, dim=0) + torch.sum(SAk * SAk, dim=0)
    return mean, torch.maximum(var, var.new_full((), 1e-12))


def _logdet_tril(A):
    """log|AAᵀ| = 2Σ log|A_ii|. The absolute value keeps the value finite
    when the raw diagonal goes negative during optimization (AAᵀ is still
    positive definite)."""
    return 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(A))))


def _kl_whitened(params: SVGPParams, raw_tril: bool = False):
    """KL(q(u)‖p(u)) in whitened coordinates: ½(‖m̃‖² + ‖Ã‖²_F − M − log|ÃÃᵀ|)."""
    A = _A_tril(params.A_raw, raw_tril)
    M = params.m_white.shape[0]
    return 0.5 * (params.m_white @ params.m_white + torch.sum(A * A) - M - _logdet_tril(A))


def _kl_centered(kernel, params: SVGPParams, Xu, jitter: float = JITTER_KUU,
                 raw_tril: bool = False):
    """KL(N(m, AAᵀ) ‖ N(0, Kuu)) for the centered parameterization:
    ½(tr(Kuu⁻¹AAᵀ) + mᵀKuu⁻¹m − M − log|AAᵀ| + log|Kuu|)."""
    A = _A_tril(params.A_raw, raw_tril)
    M = params.m_white.shape[0]
    Lu = chol_lower(kernel.kuu(params.theta, Xu, jitter=jitter))
    LiA = tri_solve_lower(Lu, A)
    Lim = tri_solve_lower(Lu, params.m_white)
    logdet_K = 2.0 * torch.sum(torch.log(torch.diagonal(Lu)))
    return 0.5 * (torch.sum(LiA * LiA) + Lim @ Lim - M - _logdet_tril(A) + logdet_K)


def _kl(kernel, params, Xu, whitened, jitter, raw_tril):
    return (_kl_whitened(params, raw_tril) if whitened
            else _kl_centered(kernel, params, Xu, jitter, raw_tril))


def elbo_gaussian(kernel, params: SVGPParams, Xu, X, y, scale: float = 1.0,
                  whitened: bool = True, jitter: float = JITTER_KUU,
                  raw_tril: bool = False):
    """Gaussian-likelihood ELBO (Regression_VSGP). ``scale`` reweights the
    likelihood term for minibatching (N_total / batch)."""
    mean, var = _marginal_f(kernel, params, Xu, X, whitened, jitter, raw_tril)
    noise = torch.exp(params.log_noise)
    ll = -0.5 * (_LOG2PI + torch.log(noise) + ((y - mean) ** 2 + var) / noise)
    return scale * torch.sum(ll) - _kl(kernel, params, Xu, whitened, jitter, raw_tril)


def elbo_bernoulli(kernel, params: SVGPParams, Xu, X, y, scale: float = 1.0,
                   n_gh: int = 20, whitened: bool = True,
                   jitter: float = JITTER_KUU, raw_tril: bool = False):
    """Probit-Bernoulli ELBO by Gauss–Hermite (Classification_VSGP). The
    nodes are in the default float dtype (float64 unless ``GPNODE_X64=0``)
    on the data's device, as the JAX package's ``gh_nodes`` are in its
    default dtype; log Φ is ``torch.special.log_ndtr``."""
    mean, var = _marginal_f(kernel, params, Xu, X, whitened, jitter, raw_tril)
    z, w = gh_nodes(n_gh, config.default_dtype(), mean.device)
    s = 2.0 * y - 1.0
    pts = mean[:, None] + torch.sqrt(var)[:, None] * z[None, :]
    ll = torch.special.log_ndtr(s[:, None] * pts) @ w
    return scale * torch.sum(ll) - _kl(kernel, params, Xu, whitened, jitter, raw_tril)


def svgp_predict(kernel, params: SVGPParams, Xu, X, whitened: bool = True,
                 jitter: float = JITTER_KUU, raw_tril: bool = False):
    return _marginal_f(kernel, params, Xu, X, whitened, jitter, raw_tril)


def collapsed_neg_elbo(kernel, theta, Xu, X, y, noise, jitter: float = 1e-10):
    """Titsias (2009) collapsed sparse-GP bound −ELBO* for a Gaussian
    likelihood with fixed noise σ², the analytic optimum over q(u) for the
    given hyperparameters:

        ½[log|B| + N log σ² + yᵀy/σ² − cᵀc + N log 2π + (Σ kxx − ‖A‖²_F)/σ²]

    with A = Lu⁻¹Kux, B = I + AAᵀ/σ², c = L_B⁻¹Ay/σ²."""
    N = X.shape[0]
    M = Xu.shape[0]
    Kuu = kernel.kuu(theta, Xu, jitter=jitter)
    Kux = kernel(theta, Xu, X)
    kxx = kernel.diag(theta, X)
    L = chol_lower(Kuu)
    A = tri_solve_lower(L, Kux)  # (M, N)
    B = torch.eye(M, dtype=A.dtype, device=A.device) + A @ A.T / noise
    LB = chol_lower(B)
    c = tri_solve_lower(LB, A @ y / noise)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(LB))) + N * math.log(noise)
    quad = (y @ y) / noise - c @ c
    tr_term = (torch.sum(kxx) - torch.sum(A * A)) / noise
    return 0.5 * (logdet + quad + N * _LOG2PI + tr_term)


def vsgp_optimizer(learning_rate: float = 0.05) -> AdaMaxChain:
    """``optax.chain(zero_nans(), adamax(lr))``, the VSGP and FITC trainers'
    chain: the AdaMax chain without its clipping link."""
    return AdaMaxChain(learning_rate=learning_rate, max_norm=None)


def collapsed_opt_init(theta0, learning_rate: float = 0.05) -> dict:
    return vsgp_optimizer(learning_rate).init(theta0)


def _value_and_grad(loss, params):
    """loss(params) and its gradient in the parameters' structure; a leaf
    the loss does not reach (a detached ``log_noise``) gets a zero
    gradient, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    v = loss(_like(params, leaves))
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return v.detach(), _like(params, grads)


def _step_(loss, optimizer: AdaMaxChain, params, opt_state):
    """One AdaMax step on ``loss``, in place on ``params``' tensors and
    ``opt_state``. Returns the loss at the step's start."""
    v, g = _value_and_grad(loss, params)
    with torch.no_grad():
        for p, u in zip(_leaves(params), _leaves(optimizer.update_(g, opt_state))):
            p.add_(u.to(p.dtype))  # optax.apply_updates: (p + u) in p's dtype
    return v


def collapsed_step(kernel, optimizer: AdaMaxChain, theta, opt_state, Xu, X, y, noise,
                   jitter: float = 1e-6):
    """One AdaMax step on the collapsed bound, in place on ``theta`` and
    ``opt_state`` (so a CUDA graph can capture it). Returns −ELBO at θ
    before the step."""
    return _step_(lambda th: collapsed_neg_elbo(kernel, th, Xu, X, y, noise, jitter),
                  optimizer, theta, opt_state)


def _clone_state(state: dict) -> dict:
    return {k: _like(v, [t.clone() for t in _leaves(v)]) for k, v in state.items()}


def fit_svgp_collapsed_resumable(kernel, theta0, opt_state, Xu, X, y, noise: float,
                                 steps: int = 25, learning_rate: float = 0.05,
                                 jitter: float = 1e-6):
    """``steps`` AdaMax steps on the collapsed bound from (θ0, ``opt_state``)
    (build it with :func:`collapsed_opt_init`), so that a caller can score
    θ between chunks without restarting AdaMax. The inputs are not
    modified. Returns (θ, optimizer state, −ELBO trace); the chunk waits
    on the host nowhere."""
    optimizer = vsgp_optimizer(learning_rate)
    theta = theta0.detach().clone()
    state = _clone_state(opt_state)
    trace = torch.empty(steps, dtype=theta.dtype, device=theta.device)
    for i in range(steps):
        trace[i] = collapsed_step(kernel, optimizer, theta, state, Xu, X, y, noise, jitter)
    return theta, state, trace


def fit_svgp_collapsed(kernel, theta0, Xu, X, y, noise: float, steps: int = 200,
                       learning_rate: float = 0.05, jitter: float = 1e-6):
    """AdaMax on the COLLAPSED Titsias bound, full batch: q(u) is profiled
    out analytically and θ takes ``steps`` steps (the same model and
    variational family as the reference's minibatched ApproximateGPs run,
    Regression_VSGP.ipynb cells 15-19). Returns (θ, −ELBO trace)."""
    theta, _, trace = fit_svgp_collapsed_resumable(
        kernel, theta0, collapsed_opt_init(theta0, learning_rate), Xu, X, y, noise,
        steps=steps, learning_rate=learning_rate, jitter=jitter)
    return theta, trace


def collapsed_predict(kernel, theta, Xu, X_test, X, y, noise, jitter: float = 1e-10):
    """Predictive mean of the collapsed-optimal q(u) at X_test,
    K*u·S⁻¹(Kux y/σ²) with S = Kuu + KuxKuxᵀ/σ² (the two Kuu factors of
    Kuu⁻¹μ_u cancel), S solved through its Cholesky factor."""
    Kuu = kernel.kuu(theta, Xu, jitter=jitter)
    Kux = kernel(theta, Xu, X)
    Kut = kernel(theta, Xu, X_test)
    S = Kuu + Kux @ Kux.T / noise
    return Kut.T @ solve_psd(S, Kux @ y / noise)


def fit_svgp(kernel, params0: SVGPParams, Xu, X_batched, y_batched, n_total: int,
             likelihood: str = "gaussian", epochs: int = 100,
             learning_rate: float = 0.002, learn_noise: bool = True,
             whitened: bool = True, jitter: float = JITTER_KUU,
             raw_tril: bool = False) -> SVGPParams:
    """AdaMax on −ELBO over minibatches X_batched (B, batch, D), one step
    per batch, ``epochs`` passes (reference: Regression_VSGP cells 7-10,
    Flux AdaMax on −elbo). ``learn_noise=False`` holds the Gaussian
    likelihood's variance at its initial value; ``whitened=False``
    optimizes the reference's centered q(u) = N(m, AAᵀ). ``params0`` is
    not modified."""
    elbo = elbo_gaussian if likelihood == "gaussian" else elbo_bernoulli
    scale = n_total / X_batched.shape[1]
    optimizer = vsgp_optimizer(learning_rate)
    params = SVGPParams(*(p.detach().clone() for p in params0))
    opt_state = optimizer.init(params)

    def loss(p, Xb, yb):
        if not learn_noise:
            p = p._replace(log_noise=p.log_noise.detach())
        return -elbo(kernel, p, Xu, Xb, yb, scale=scale, whitened=whitened,
                     jitter=jitter, raw_tril=raw_tril)

    for _ in range(epochs):
        for b in range(X_batched.shape[0]):
            Xb, yb = X_batched[b], y_batched[b]
            _step_(lambda p: loss(p, Xb, yb), optimizer, params, opt_state)
    return params
