"""Data-parallel VMP over ranks: the kin40k and banana trainers with the
points sharded.

Counterpart of ``gaussianprocessnode_tpu/parallel/sharding.py``. Every
UniSGP message is a per-datum natural-parameter contribution, and the q(v)
and q(w) updates are sums of those contributions, so a data-parallel sweep
is

    per rank:    ξ_loc = w·K_loc y_loc,  Λ_loc = w·K_loc K_locᵀ, ...
    collective:  ξ = all_reduce_sum(ξ_loc),  Λ = all_reduce_sum(Λ_loc)

with the small q(v) solve done identically on every rank. Where JAX runs
one ``shard_map`` over a mesh, each rank here calls the function on its own
slice (:func:`shard_data`, :func:`shard_batched_data`) with a process group
(``group=None``: the default group); the carry is replicated, identical on
every rank. The trainers are the single-device trainers of
``infer/minibatch.py`` with the all-reduce in their ``reduce`` hooks, so
the numerics cannot fork: at world size 1 an epoch is the single-device
epoch plus one-rank all-reduces, which return their input.
"""

import torch

from ..dists import GammaShapeRate, MvGaussianNat
from ..infer.minibatch import (NS_ITERS_STEADY, REFRESH_NS_ITERS_SCALED, FastCarry,
                               MinibatchCarry, fit_banana_fast, fit_kin40k_fast,
                               init_kin40k_fast_state)
from ..objectives import neg_log_backwardmess_gram
from ..ops.linalg import effective_jitter, ir_solve, spd_inverse, sym
from .comm import all_reduce_sum, make_mesh, rank_slice, world_size

__all__ = [
    "make_mesh",
    "shard_data",
    "shard_batched_data",
    "dp_regression_sweep",
    "dp_train_step",
    "fit_kin40k_fast_dp",
    "fit_banana_fast_dp",
    "init_kin40k_fast_dp_state",
]


def shard_data(*arrays, group=None):
    """This rank's contiguous slice of each array's leading (data)
    dimension, which must divide evenly over the group's ranks."""
    msg = ("leading dim {size} does not shard evenly over {n} ranks — pick a size that is "
           "a multiple of the rank count")
    return tuple(rank_slice(a, 0, group, msg) for a in arrays)


def shard_batched_data(X_batched, y_batched, group=None):
    """This rank's slice of pre-batched arrays (B, batch, ...) along the
    WITHIN-batch point dimension (JAX's ``P(None, axis, None)``); the batch
    index stays whole."""
    msg = ("within-batch size {size} is not divisible by the {n} ranks; pick a batch size "
           "that is a multiple of the rank count (e.g. 512 on 8 ranks instead of the "
           "reference's 500)")
    return rank_slice(X_batched, 1, group, msg), rank_slice(y_batched, 1, group, msg)


def _reducer(group):
    def reduce(v):
        return all_reduce_sum(v, group)
    return reduce


@torch.no_grad()
def dp_regression_sweep(kernel, theta, Xu, X, y, prior_v: MvGaussianNat, w_val, group=None,
                        ns_iters: int = 40):
    """One data-parallel VMP sweep for the regression model on this rank's
    points (X, y): the local natural-parameter increments all-reduced, then
    q(v) solved identically on every rank. Returns (μ_v, Σ_v-estimate,
    natural parameters)."""
    K = kernel(theta, Xu, X).to(prior_v.xi.dtype)
    xi = prior_v.xi + all_reduce_sum(w_val * (K @ y.to(K.dtype)), group)
    prec = sym(prior_v.prec + all_reduce_sum(w_val * (K @ K.T), group))
    cov = spd_inverse(prec, iters=ns_iters)
    mu = ir_solve(prec, xi, cov, rounds=2)
    return mu, cov, MvGaussianNat(xi, prec)


def dp_train_step(kernel, theta, opt_state, optimizer, Xu, X, y, prior_v: MvGaussianNat,
                  w_val, group=None, ns_iters: int = 40):
    """One data-parallel training step: the DP sweep for q(v), then one
    step of ``optimizer`` (an ``AdaMaxChain``, e.g. ``utils/optim.py::adamax``)
    on the hyperparameter objective, whose gradient is a sum over the
    points: each rank differentiates its local objective, the gradients are
    all-reduced. ``opt_state`` is updated in place. Returns (θ, opt_state,
    natural parameters)."""
    mu, cov, nat = dp_regression_sweep(kernel, theta, Xu, X, y, prior_v, w_val, group,
                                       ns_iters)
    Rv = (cov + torch.outer(mu, mu)).to(X.dtype)
    mu_v = mu.to(X.dtype)
    th = theta.detach().requires_grad_(True)
    loss, _ = neg_log_backwardmess_gram(th, kernel=kernel, Xu=Xu, X=X, y=y, mu_v=mu_v, Rv=Rv,
                                        w=w_val, ns_iters=ns_iters,
                                        kuu_jitter=effective_jitter(X.dtype))
    (g,) = torch.autograd.grad(loss, th)
    g = all_reduce_sum(g, group)
    theta = theta + optimizer.update_(g, opt_state)
    return theta, opt_state, nat


def init_kin40k_fast_dp_state(theta0, prior_v: MvGaussianNat, M: int,
                              learning_rate: float = 1e-3, acc_dt=None) -> FastCarry:
    """Initial carry for :func:`fit_kin40k_fast_dp` on θ0's device: the
    one-group carry of ``fit_kin40k_fast`` (replicated on every rank; only
    the training data is sharded)."""
    return init_kin40k_fast_state(theta0, prior_v, M, 1, learning_rate=learning_rate,
                                  acc_dt=acc_dt)


def fit_kin40k_fast_dp(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch/P, Din): this rank's slice (shard_batched_data)
    y_batched,  # (B, batch/P)
    prior_v: MvGaussianNat,
    w_val: float,
    epochs: int,
    group=None,
    learning_rate: float = 0.001,
    resume_state: FastCarry | None = None,
    refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
    obj_ns_iters: int = 12,
):
    """Data-parallel ``fit_kin40k_fast`` (one statistics refresh per epoch)
    over the group's ranks: that trainer with the all-reduce in its
    ``reduce`` hook. Per epoch each rank computes its slice of the grand
    Gram (M × N/P) and local increments, which are all-reduced into the
    replicated (ξ, Λ) update; the float64 Newton–Schulz refresh is
    replicated; per θ-step each rank differentiates its slice of the batch
    objective (a pure sum over points) and the gradients are all-reduced,
    the AdaMax update applied identically everywhere. Collectives: two
    all-reduces of (M,) and (M, M) per epoch and one of (dim θ,) per
    θ-step.

    ``resume_state``: a carry from an earlier call, from
    :func:`init_kin40k_fast_dp_state` or from
    ``convert.fast_dp_state_from_jax``; it is copied, not changed. Returns
    ``(θ, MvGaussianNat(ξ, Λ), Σ, carry)``."""
    return fit_kin40k_fast(kernel, theta0, Xu, X_batched, y_batched, prior_v, w_val, epochs,
                           learning_rate=learning_rate, resume_state=resume_state,
                           refresh_ns_iters=refresh_ns_iters, obj_ns_iters=obj_ns_iters,
                           reduce=_reducer(group))


def fit_banana_fast_dp(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch/P, 2): this rank's slice (shard_batched_data)
    y_batched,  # (B, batch/P) in {0,1}
    prior_v: MvGaussianNat,
    prior_w: GammaShapeRate,
    epochs: int,
    group=None,
    learning_rate: float = 0.001,
    resume_state: MinibatchCarry | None = None,
    refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
    obj_ns_iters: int = NS_ITERS_STEADY,
):
    """Data-parallel ``fit_banana_fast`` over the group's ranks: that
    trainer with the all-reduce in its ``reduce`` hook. Each rank
    probit-tilts its slice of the forward f-messages (a per-datum map); the
    three global reductions are sums over the points and are all-reduced:
    the (ξ, Λ) increments, the scalar Σ(I1+I2) of the carried q(w) rate,
    and each θ-step's gradient. The float64 refresh and the AdaMax update
    are replicated. The global point count is N = B · batch/P · P.

    ``resume_state``: a ``MinibatchCarry`` (from an earlier call,
    ``init_banana_state`` or ``convert.banana_state_from_jax``); copied, not
    changed. Returns ``(θ, MvGaussianNat(ξ, Λ), GammaShapeRate, carry)``."""
    B, b_loc = X_batched.shape[:2]
    return fit_banana_fast(kernel, theta0, Xu, X_batched, y_batched, prior_v, prior_w, epochs,
                           learning_rate=learning_rate, resume_state=resume_state,
                           refresh_ns_iters=refresh_ns_iters, obj_ns_iters=obj_ns_iters,
                           reduce=_reducer(group), N_global=B * b_loc * world_size(group))
