"""Serving layer: predictor handles for trained sparse-GP models.

Counterpart of ``gaussianprocessnode_tpu/serve.py``: the regression and the
probit classification handles, and the GPSSM's streaming filter. The trained state is packaged once (μ_v
recovered from the trainer's natural parameters at build time,
matmul-only) and each request batch costs one SE Gram of K(Xu, x*) plus one
mat-vec, and for a classifier the Φ epilogue. Beyond the JAX package's
serving API, ``SVGPRegressor`` serves the whitened SVGP baseline with its
predictive variance: Kuu's factor once, then per batch the Gram, a
triangular solve against it and a product with the q(u) factor, which on
the card in float32 are one hand-written CUDA kernel
(``ops/svgp_var.py``). With ``Kernel(use_kernel=True)`` the Gram is the
hand-written CUDA kernel of ``ops/se_gram.py``. The GPSSM filter (``GPSSMFilter``) costs one Gram of
the inducing inputs against the 2·D cubature points per observation.
``shard_requests`` gives each rank of a data-parallel server its slice of
a request batch; the state is replicated, so no collective is needed.

On the card each regression, classification or SVGP handle holds its
calls as CUDA graphs (:class:`GraphCache`): a call shape's second call
captures the whole call (softplus θ, the Gram, Kᵀμ_v, the fill, Φ; the
SVGP handle's variance kernel) and every later call replays it, so the
host no longer paces the device. The kernels, their order and the answers
are those of an eager call.
"""

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .config import JITTER_KUU
from .dists import GammaShapeRate, MvGaussianNat, gamma_mean
from .infer.batch_vmp import predict_out, predict_probit
from .infer.chain_smoother import filter_frozen, filter_stream
from .infer.svgp import SVGPParams, svgp_factors, svgp_predict_batch
from .ops._build import CallGraph
from .ops.linalg import ir_solve, spd_inverse_ns, sym
from .parallel.comm import rank_slice
from .utils import tracing
from .utils.profiling import synchronize

__all__ = ["SGPRegressor", "SGPClassifier", "SVGPRegressor", "GPSSMFilter", "GraphCache",
           "graph_counts", "serve_fused", "throughput", "throughput_fused", "shard_requests"]

# graphs a handle keeps: each holds a private memory pool the size of its
# call's Gram (629 MB at 600 × 262,144)
GRAPH_SLOTS = 4
# keys a handle's cache remembers (a key called once, a key whose capture
# raised, a graph's), the least recently used forgotten beyond them
CACHE_KEYS = 64
_SEEN, _EAGER = "seen once", "eager"

# the graph caches' engagement over the process: graphs captured, calls
# replayed, calls a cache admitted but ran eagerly (a key's first call, a
# key whose capture raised), and captures that raised. Every admitted call
# is a replay or eager.
graph_counts = {"captures": 0, "replays": 0, "eager": 0, "fallbacks": 0}


def shard_requests(X_test, group=None):
    """This rank's contiguous slice of a request batch along its leading
    dimension (which must divide evenly over the group's ranks), for
    data-parallel serving: each rank serves its slice through a handle or
    :func:`serve_fused` with no collective, the model state replicated on
    every rank, and its predictions are the matching rows of single-device
    serving."""
    return rank_slice(torch.as_tensor(X_test), 0, group,
                      "request batch of {size} does not shard evenly over {n} ranks")


def _recover_mu_v(nat: MvGaussianNat, ns_iters: int = 60, ir_rounds: int = 4):
    """μ_v = Λ⁻¹ξ from natural parameters (Newton–Schulz inverse + iterative
    refinement, matmul-only), in the natural parameters' dtype and device."""
    prec = sym(nat.prec)
    cov = spd_inverse_ns(prec, iters=ns_iters)
    return ir_solve(prec, nat.xi, cov, rounds=ir_rounds)


def _capturable(X) -> bool:
    """A call on ``X`` may be graphed: a CUDA tensor, gradients off, and the
    current stream not already capturing (a handle called inside another
    graph's capture runs into that graph)."""
    return (X.is_cuda and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing())


class GraphCache:
    """A handle's calls held as CUDA graphs, keyed by what a call can
    observe: the function it resolved (``predict_out``, ``predict_probit``
    or ``svgp_predict_batch``, looked up at call time) and the input's
    shape, dtype and device. A key's first call runs eagerly (the warm-up that
    creates the libraries' handles and workspaces); its second captures
    (``capture(call, X)``, a ``CallGraph``) and answers by the replay;
    later calls replay. A capture that raises leaves its key eager.
    ``states`` maps at most ``CACHE_KEYS`` keys, least recently used first,
    to ``_SEEN``, ``_EAGER`` or a graph; at most ``GRAPH_SLOTS`` are
    graphs, the least recently used evicted to ``_SEEN``. Calls
    ``graphable`` refuses (CPU tensors, gradients on, inside another
    capture) run eagerly and are not counted. Engagement is counted in
    :data:`graph_counts`. A graph's replays share its buffers, so one
    handle's calls come from one thread, as a server's request loop makes
    them."""

    def __init__(self, capture=CallGraph, graphable=_capturable):
        self.capture, self.graphable = capture, graphable
        self.states = OrderedDict()

    @property
    def graphs(self) -> dict:
        """The captured calls by key, least recently used first."""
        return {k: s for k, s in self.states.items() if s is not _SEEN and s is not _EAGER}

    def __call__(self, fn, call, X):
        """``call(X)``, or its graph's replay; ``fn`` is the function
        ``call`` runs, part of the key."""
        if not self.graphable(X):
            return call(X)
        key = (fn, tuple(X.shape), X.dtype, X.device)
        state = self.states.get(key)
        if state is None or state is _EAGER:
            self.states[key] = state or _SEEN
            self.states.move_to_end(key)
            if len(self.states) > CACHE_KEYS:
                self.states.popitem(last=False)
            graph_counts["eager"] += 1
            return call(X)
        self.states.move_to_end(key)
        if state is _SEEN:
            graphs = list(self.graphs)
            if len(graphs) >= GRAPH_SLOTS:
                self.states[graphs[0]] = _SEEN
            try:
                with tracing.span("serve.capture"):
                    state = self.capture(call, X)
            except RuntimeError:  # an operation the capture forbids, such as a sync
                self.states[key] = _EAGER
                graph_counts["fallbacks"] += 1
                graph_counts["eager"] += 1
                return call(X)
            graph_counts["captures"] += 1
            self.states[key] = state
        graph_counts["replays"] += 1
        with tracing.span("serve.replay"):
            tracing.attrs(launches=state.launches)
            return state(X)


def _served(handle, out, X_test, *state):
    """``out(kernel, θ, Xu, X, *state)`` of a serving handle on ``X_test``
    in the handle's dtype and device, through its graph cache, gradients
    off (``state``: μ_v and w̄ of a UniSGP handle). The caller passes
    ``out`` as it resolves it at call time, so a function patched into this
    module takes effect on the next call."""
    X = torch.as_tensor(X_test, dtype=handle.Xu.dtype, device=handle.Xu.device)
    with torch.no_grad():
        return handle._graphs(out, lambda x: out(handle.kernel, handle.theta, handle.Xu, x,
                                                 *state), X)


@dataclass(frozen=True)
class SGPRegressor:
    """Frozen serving handle for a UniSGP regression model.

    Build once from a trainer's output (``from_natural``), then call with
    test inputs. Predictive law: N(K(Xu,x*)ᵀ μ_v, w̄⁻¹) — the reference's
    :out rule (UniSGPnode.jl:96-104). ``w_mean`` is a 0-dim float64 tensor
    on the handle's device.
    """

    kernel: object
    theta: torch.Tensor
    Xu: torch.Tensor
    mu_v: torch.Tensor
    w_mean: torch.Tensor
    _graphs: GraphCache = field(default_factory=GraphCache, init=False, repr=False,
                                compare=False)

    @classmethod
    @tracing.traced("serve.from_natural")
    def from_natural(cls, kernel, theta, Xu, qv_nat: MvGaussianNat, w_mean,
                     dtype=None, device="cuda"):
        """Recover μ_v from ``qv_nat`` in its own dtype (float64 for the
        trainers' state) on ``device``, then hold θ, Xu and μ_v in ``dtype``
        (Xu's dtype by default)."""
        dev = torch.device(device)
        nat = MvGaussianNat(torch.as_tensor(qv_nat.xi, device=dev),
                            torch.as_tensor(qv_nat.prec, device=dev))
        mu = _recover_mu_v(nat)
        Xu = torch.as_tensor(Xu, device=dev)
        dtype = dtype or Xu.dtype
        w = torch.as_tensor(w_mean, dtype=torch.float64, device=dev)
        return cls(kernel, torch.as_tensor(theta, device=dev).to(dtype),
                   Xu.to(dtype), mu.to(dtype), w.reshape(()))

    @tracing.traced("serve.predict")
    def __call__(self, X_test):
        return _served(self, predict_out, X_test, self.mu_v, self.w_mean)


@dataclass(frozen=True)
class SGPClassifier:
    """Frozen serving handle for the probit classification model:
    ``probabilities`` returns P(y=1|x*) = Φ(m/√(1+v)) with m, v the :out
    rule's (classification_banana.ipynb cell 13); a call thresholds them.
    ``w_mean`` is the Gamma q(w)'s mean, a 0-dim float64 tensor on the
    handle's device."""

    kernel: object
    theta: torch.Tensor
    Xu: torch.Tensor
    mu_v: torch.Tensor
    w_mean: torch.Tensor
    _graphs: GraphCache = field(default_factory=GraphCache, init=False, repr=False,
                                compare=False)

    @classmethod
    def from_natural(cls, kernel, theta, Xu, qv_nat: MvGaussianNat,
                     qw: GammaShapeRate, dtype=None, device="cuda"):
        """As ``SGPRegressor.from_natural``; w̄ = shape/rate of ``qw`` in
        its own dtype, then held in float64 on the device (never as a
        Python number, which would wait on the device)."""
        dev = torch.device(device)

        def t(a):
            return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                                   device=dev)

        w = gamma_mean(GammaShapeRate(t(qw.shape), t(qw.rate)))
        reg = SGPRegressor.from_natural(kernel, theta, Xu, qv_nat,
                                        w.to(torch.float64), dtype=dtype, device=dev)
        return cls(reg.kernel, reg.theta, reg.Xu, reg.mu_v, reg.w_mean)

    @tracing.traced("serve.predict")
    def probabilities(self, X_test):
        return _served(self, predict_probit, X_test, self.mu_v, self.w_mean)

    def __call__(self, X_test, threshold: float = 0.5):
        return (self.probabilities(X_test) >= threshold).to(self.Xu.dtype)


@dataclass(frozen=True)
class SVGPRegressor:
    """Frozen serving handle for a whitened SVGP (``infer/svgp.py``; the
    reference's ApproximateGPs.jl baseline, Regression_VSGP.ipynb cells
    15-19): q(u) = N(Lu·m̃, Lu·ÃÃᵀ·Luᵀ), and a call returns the predictive
    q(f) = N(mean, var) of ``svgp_predict`` at its rows: Y = Lu⁻¹K(Xu, x*),
    mean = Yᵀm̃, var = k(x*, x*) − ‖y‖² + ‖Ãᵀy‖², floored at 1e-12.

    ``from_params`` factors Kuu and forms Ã once, in float64; a call costs
    the Gram, one triangular solve against it and one product with Ãᵀ (on
    the card in float32, one launch of the variance kernel,
    ``ops/svgp_var.py``), held as a CUDA graph on the card as the UniSGP
    handles' calls are (:class:`GraphCache`)."""

    kernel: object
    theta: torch.Tensor
    Xu: torch.Tensor
    Lu: torch.Tensor
    m_white: torch.Tensor
    A: torch.Tensor
    _graphs: GraphCache = field(default_factory=GraphCache, init=False, repr=False,
                                compare=False)

    @classmethod
    @tracing.traced("serve.from_svgp")
    def from_params(cls, kernel, params: SVGPParams, Xu, dtype=None, device="cuda",
                    jitter: float = JITTER_KUU, raw_tril: bool = False):
        """Form Lu (Kuu at ``jitter``) and Ã from ``params`` in float64 on
        ``device``, as ``svgp_predict`` does with the same ``jitter`` and
        ``raw_tril``, then hold θ, Xu, Lu, m̃ and Ã in ``dtype`` (Xu's
        dtype by default)."""
        dev, f64 = torch.device(device), torch.float64
        Xu = torch.as_tensor(Xu, device=dev)
        dtype = dtype or Xu.dtype
        p64 = SVGPParams(*(torch.as_tensor(p, device=dev).to(f64) for p in params))
        with torch.no_grad():
            Lu, A = svgp_factors(kernel, p64, Xu.to(f64), jitter, raw_tril)
        return cls(kernel, p64.theta.to(dtype), Xu.to(dtype), Lu.to(dtype),
                   p64.m_white.to(dtype), A.to(dtype))

    @tracing.traced("serve.predict")
    def __call__(self, X_test):
        return _served(self, svgp_predict_batch, X_test, self.Lu, self.m_white, self.A)


@dataclass(frozen=True)
class GPSSMFilter:
    """Frozen streaming handle for a trained GPSSM: 1-step-ahead state
    prediction (PredictState, the MultiSGP :out rule from the previous
    filtered marginal; UpdateState, the Gaussian product with the
    observation message; Pendulum_Wishart_2d.ipynb cells 3, 36). The state
    recovery (the (M·D)² q(v) solve, W̄ and its inverse) runs once, in
    ``from_state``; each call filters one window on the handle's device and
    returns the carry, so that consecutive windows chain exactly:
    handle(y[:k]) then handle(y[k:], carry) equals handle(y)."""

    kernel: object
    theta: torch.Tensor
    Xu: torch.Tensor
    frozen: object  # infer.chain_smoother.GPSSMFilterFrozen
    start: tuple  # (mean, cov): the trained smoother's last marginal
    dtype: torch.dtype

    @classmethod
    def from_state(cls, kernel, theta, Xu, state, P):
        """Build from a trained ``GPSSMState`` and the observation
        covariance P, on the state's device, in P's dtype."""
        P = torch.as_tensor(P, device=state.x_means.device)
        with torch.no_grad():
            frozen = filter_frozen(state, P)
        return cls(kernel, theta, Xu, frozen, (state.x_means[-1], state.x_covs[-1]), P.dtype)

    def __call__(self, ys, carry=None):
        """Filter one window. Returns (pred_means, pred_covs, carry); pass
        the carry back to continue the stream (without it the window starts
        from the trained smoother's last marginal)."""
        if carry is None:
            carry = self.start
        ys = torch.as_tensor(ys, dtype=self.dtype, device=self.Xu.device)
        with torch.no_grad():
            return filter_stream(self.kernel, self.theta, self.Xu, self.frozen, ys, carry)


def serve_fused(predictor, X_batches):
    """Serve a (R, B, Din) stack of request batches, dispatched on the
    handle's type: for an :class:`SGPRegressor` or an
    :class:`SVGPRegressor`, ``(means, vars)``, each (R, B), row i equal to
    ``predictor(X_batches[i])``; for an :class:`SGPClassifier`, the (R, B)
    probabilities, row i equal to
    ``predictor.probabilities(X_batches[i])``. The batches are queued back
    to back on the device with no host sync between them (the counterpart
    of the JAX package's one scanned program)."""
    X = torch.as_tensor(X_batches, dtype=predictor.Xu.dtype,
                        device=predictor.Xu.device)
    if isinstance(predictor, SGPClassifier):
        return torch.stack([predictor.probabilities(Xb) for Xb in X])
    means, vars_ = [], []
    for Xb in X:
        m, v = predictor(Xb)
        means.append(m)
        vars_.append(v)
    return torch.stack(means), torch.stack(vars_)


def throughput_fused(predictor, X_test, n_batches: int = 64,
                     iters: int = 5) -> float:
    """Predictions per second of :func:`serve_fused` (either handle) on
    ``n_batches`` copies of the batch ``X_test``, by host clock between two
    device synchronisations, after one warm-up call."""
    X = torch.as_tensor(X_test, dtype=predictor.Xu.dtype,
                        device=predictor.Xu.device)
    reps = X[None].expand(n_batches, *X.shape)
    serve_fused(predictor, reps)
    synchronize(X.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        serve_fused(predictor, reps)
    synchronize(X.device)
    dt = time.perf_counter() - t0
    return X.shape[0] * n_batches * iters / dt


def throughput(predictor, X_test, iters: int = 20) -> float:
    """Predictions per second of a per-batch handle (either kind) at this
    batch shape, by host clock between two device synchronisations, after
    one warm-up call."""
    X = torch.as_tensor(X_test, dtype=predictor.Xu.dtype,
                        device=predictor.Xu.device)
    predictor(X)
    synchronize(X.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        predictor(X)
    synchronize(X.device)
    dt = time.perf_counter() - t0
    n = X.shape[0] if X.dim() > 1 else 1
    return n * iters / dt
