"""Serving layer: predictor handles for trained sparse-GP models.

Counterpart of ``gaussianprocessnode_tpu/serve.py``: the regression and the
probit classification handles, and the GPSSM's streaming filter. The trained state is packaged once (μ_v
recovered from the trainer's natural parameters at build time,
matmul-only) and each request batch costs one SE Gram of K(Xu, x*) plus one
mat-vec, and for a classifier the Φ epilogue. With
``Kernel(use_kernel=True)`` the Gram is the hand-written CUDA kernel of
``ops/se_gram.py``. The GPSSM filter (``GPSSMFilter``) costs one Gram of
the inducing inputs against the 2·D cubature points per observation.
``shard_requests`` gives each rank of a data-parallel server its slice of
a request batch; the state is replicated, so no collective is needed.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from .dists import GammaShapeRate, MvGaussianNat, gamma_mean
from .infer.batch_vmp import predict_out, predict_probit
from .infer.chain_smoother import filter_frozen, filter_stream
from .ops.linalg import ir_solve, spd_inverse_ns, sym
from .parallel.comm import rank_slice
from .utils import tracing
from .utils.profiling import synchronize

__all__ = ["SGPRegressor", "SGPClassifier", "GPSSMFilter", "serve_fused", "throughput",
           "throughput_fused", "shard_requests"]


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
        X = torch.as_tensor(X_test, dtype=self.Xu.dtype, device=self.Xu.device)
        with torch.no_grad():
            return predict_out(self.kernel, self.theta, self.Xu, X, self.mu_v,
                               self.w_mean)


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
        X = torch.as_tensor(X_test, dtype=self.Xu.dtype, device=self.Xu.device)
        with torch.no_grad():
            return predict_probit(self.kernel, self.theta, self.Xu, X, self.mu_v,
                                  self.w_mean)

    def __call__(self, X_test, threshold: float = 0.5):
        return (self.probabilities(X_test) >= threshold).to(self.Xu.dtype)


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
    handle's type: for an :class:`SGPRegressor`, ``(means, vars)``, each
    (R, B), row i equal to ``predictor(X_batches[i])``; for an
    :class:`SGPClassifier`, the (R, B) probabilities, row i equal to
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
