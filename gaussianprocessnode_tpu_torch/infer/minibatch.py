"""Minibatched sparse-GP training with warm-started q(v): the kin40k and
banana trainers.

Counterpart of ``gaussianprocessnode_tpu/infer/minibatch.py``:

- ``fit_kin40k_fast`` / ``fit_banana_fast``, the epoch-granular paths: per
  epoch one grand natural-parameter update of q(v) per statistics group
  (one f32 Gram K(Xu, X), the products in f64, a warm-started
  spectrum-scaled Newton–Schulz inverse and iterative refinement; for
  banana also the probit tilted marginals and the carried Gamma q(w)), then
  AdaMax θ-steps in the working dtype against the frozen statistics, each
  on ``objectives.neg_log_backwardmess_gram``;
- ``fit_kin40k`` / ``fit_banana``, the reference's per-batch schedules: one
  VMP sweep per minibatch (q(v), and for banana q(w), updated from that
  batch alone), then one AdaMax step.

Where the JAX package runs the whole training as one jitted ``lax.scan``,
this is an eager Python loop, written so that an epoch never waits on the
host: the loops have fixed counts (``tol=None``), every guard is a
``torch.where``, the optimizer's step count and learning rate stay device
tensors, scalars such as w̄ stay 0-d device tensors, and θ, the optimizer
state and the warm starts are updated in place. That also makes a θ-step
or an epoch capturable in a CUDA graph.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import config
from ..dists import GammaShapeRate, MvGaussianNat
from ..nodes.probit import tilted_marginal_batch
from ..objectives import neg_log_backwardmess_gram
from ..ops.linalg import (effective_jitter, gershgorin_lambda_min, ir_solve,
                          spd_inverse, sym)

__all__ = [
    "NS_ITERS_WARMUP",
    "NS_ITERS_STEADY",
    "REFRESH_NS_ITERS_SCALED",
    "BANANA_BATCH_NS_ITERS",
    "KIN40K_BATCH_NS_ITERS",
    "AdaMaxChain",
    "FastCarry",
    "MinibatchCarry",
    "banana_epoch_stats",
    "banana_epoch_steps",
    "clone_carry",
    "default_optimizer",
    "fast_epoch_steps",
    "fast_optimizer",
    "fit_banana",
    "fit_banana_fast",
    "fit_kin40k",
    "fit_kin40k_fast",
    "init_banana_state",
    "init_kin40k_fast_state",
    "make_theta_step",
    "qv_grand_update",
]

# Newton–Schulz budgets, as the JAX package's: warm starts make a few
# iterations enough in steady state; the per-epoch refresh of the fast
# trainer runs the spectrum-scaled iteration, which reaches the f64 floor at
# κ ~ 1e9–1e12 in ~22–24 iterations, so 28 keeps a margin.
NS_ITERS_WARMUP = 40
NS_ITERS_STEADY = 8
REFRESH_NS_ITERS_SCALED = 28
# the per-batch trainers' warm q(v) refresh: fit_banana's plain iteration,
# fit_kin40k's spectrum-scaled one (the default of its ``ns_budget``)
BANANA_BATCH_NS_ITERS = 30
KIN40K_BATCH_NS_ITERS = 34

_INT32_MAX = 2**31 - 1
# optax.adamax's defaults and the chain's clipping norm
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_MAX_NORM = 1e8


def _identity(x):
    return x


def qv_grand_update(Kall64, y64, xi, prec, w64, cov_warm, ns_iters,
                    ns_tol=None, reduce=_identity, lambda_min=None):
    """One grand natural-parameter update of q(v) and its refresh:

        ξ ← ξ + w·reduce(K y),  Λ ← sym(Λ + w·reduce(K Kᵀ)),
        Σ = NS⁻¹(Λ) warm-started,  μ = IR-solve(Λ, ξ; Σ, 2 rounds).

    ``reduce`` is the identity on one device; a data-parallel trainer puts
    its all-reduce there (both increments are sums over the points).
    ``lambda_min``: a rigorous λ_min bound on Λ (that of the prior, since
    Λ ⪰ Λ_prior), which turns on the optimally scaled iteration.
    Returns ``(ξ, Λ, Σ, μ)``."""
    xi = xi + w64 * reduce(torch.matmul(Kall64, y64))
    prec = sym(prec + w64 * reduce(torch.matmul(Kall64, Kall64.T)))
    cov64 = spd_inverse(prec, warm=cov_warm, iters=ns_iters, tol=ns_tol,
                        lambda_min=lambda_min)
    mu64 = ir_solve(prec, xi, cov64, rounds=2)
    return xi, prec, cov64, mu64


def _leaves(x):
    """The tensors of a parameter set: one tensor, or a tuple (a NamedTuple
    such as ``SVGPParams``) of them, as optax maps over a pytree's leaves."""
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _like(template, leaves):
    """``leaves`` in the structure of ``template`` (a tensor or a tuple)."""
    if isinstance(template, torch.Tensor):
        return leaves[0]
    if hasattr(template, "_fields"):  # a NamedTuple
        return type(template)(*leaves)
    return tuple(leaves)


@dataclass(frozen=True)
class AdaMaxChain:
    """The trainers' optimizer, optax's chain ``zero_nans`` →
    ``clip_by_global_norm(max_norm)`` → ``adamax(lr)`` (b1 0.9, b2 0.999,
    eps 1e-8; optax 0.2.6) written out by hand, with an optional
    ``exponential_decay`` of the learning rate over ``transition_steps``
    steps. ``max_norm=None`` drops the clipping link: the chain
    ``zero_nans`` → ``adamax`` of the VSGP and FITC trainers; with
    ``zero_nans=False`` as well it is bare ``optax.adamax`` (the pendulum
    M-step's, ``utils/optim.py::adamax``), where a NaN gradient reaches the
    parameters as NaN.

    The parameters are one tensor or a tuple of tensors (a NamedTuple such
    as ``SVGPParams``); like optax, the chain works leaf by leaf, with one
    step count and, where it clips, one global norm over all leaves. Its
    state is a dict that maps one to one onto the optax state:
    ``found_nan`` (zero_nans, where the chain has it; one flag per leaf),
    ``count``, ``mu``, ``nu``
    (adamax's ScaleByAdamState; ``mu`` and ``nu`` in the parameters'
    structure) and, with a decaying rate, ``lr_count`` (the schedule's
    ScaleByScheduleState). The step count and the learning rate stay on the
    device. The scalars keep optax's dtypes: 1 − b1^count is formed in the
    default float dtype (``config.default_dtype()``; float64 with JAX's x64
    on) and the decayed rate in float32; both are then cast to each leaf's
    dtype."""

    learning_rate: float = 1e-3
    decay_rate: float = 1.0
    transition_steps: int = 1
    max_norm: float | None = _MAX_NORM
    zero_nans: bool = True

    @property
    def decays(self) -> bool:
        return self.decay_rate != 1.0

    def init(self, params) -> dict:
        leaves = _leaves(params)
        dev = leaves[0].device
        state = {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": _like(params, [torch.zeros_like(p) for p in leaves]),
            "nu": _like(params, [torch.zeros_like(p) for p in leaves]),
        }
        if self.zero_nans:
            state["found_nan"] = _like(params, [torch.zeros((), dtype=torch.bool, device=dev)
                                                for _ in leaves])
        if self.decays:
            state["lr_count"] = torch.zeros((), dtype=torch.int32, device=dev)
        return state

    def learning_rate_at(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate of step ``count`` (an int32 device tensor):
        optax.exponential_decay with no transition_begin, no staircase and
        no end value. Float32 whatever ``config.default_dtype()`` is, as
        optax forms it: JAX divides an int32 count in float32."""
        c = count.to(torch.float32)
        decayed = self.learning_rate * torch.pow(self.decay_rate, c / self.transition_steps)
        return torch.where(count <= 0, torch.full_like(c, self.learning_rate), decayed)

    def update_(self, grads, state: dict):
        """One step of the chain on ``grads`` (in the parameters'
        structure): writes the new state into ``state``'s tensors and
        returns the updates (to add to the parameters), in that
        structure."""
        sdt = config.default_dtype()
        gs = list(_leaves(grads))
        if self.zero_nans:
            for i, (g, found) in enumerate(zip(gs, _leaves(state["found_nan"]))):
                nan = torch.isnan(g)
                found.copy_(torch.any(nan))
                gs[i] = torch.where(nan, torch.zeros_like(g), g)
        # clip_by_global_norm
        if self.max_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
            gs = [torch.where(g_norm < self.max_norm, g, (g / g_norm) * self.max_norm)
                  for g in gs]
        # scale_by_adamax
        count = state["count"]
        count.copy_(torch.where(count < _INT32_MAX, count + 1, count))
        bias = 1 - torch.pow(_B1, count.to(sdt))
        upds = []
        for g, mu, nu in zip(gs, _leaves(state["mu"]), _leaves(state["nu"])):
            mu.copy_((1 - _B1) * g + _B1 * mu)
            nu.copy_(torch.maximum(torch.abs(g) + _EPS, _B2 * nu))
            upds.append((mu / bias.to(mu.dtype)) / nu)
        # scale_by_learning_rate
        if self.decays:
            lr_count = state["lr_count"]
            lr = self.learning_rate_at(lr_count)
            lr_count.copy_(torch.where(lr_count < _INT32_MAX, lr_count + 1, lr_count))
            upds = [(-lr).to(u.dtype) * u for u in upds]
        else:
            upds = [(-self.learning_rate) * u for u in upds]
        return _like(grads, upds)


def default_optimizer(learning_rate=1e-3) -> AdaMaxChain:
    """The trainers' shared chain: zero_nans and the clipping keep a single
    inf/NaN gradient from freezing AdaMax's max-accumulator at inf."""
    return AdaMaxChain(learning_rate=learning_rate)


def fast_optimizer(learning_rate=1e-3, lr_decay_rate=1.0, epochs=1,
                   n_batches=1) -> AdaMaxChain:
    """The chain :func:`fit_kin40k_fast` builds for a schedule: a constant
    rate, or one decaying by ``lr_decay_rate`` over ``epochs·n_batches``
    steps."""
    if lr_decay_rate != 1.0:
        return AdaMaxChain(learning_rate=learning_rate, decay_rate=lr_decay_rate,
                           transition_steps=epochs * n_batches)
    return default_optimizer(learning_rate)


def make_theta_step(grad_one, optimizer: AdaMaxChain, reduce=_identity):
    """The AdaMax θ-step against frozen epoch statistics.

    ``grad_one(theta, kuu_warm, batch) -> (grad, kuu_inv)`` computes the
    objective's gradient for one minibatch; ``reduce`` folds per-shard
    gradients into the full-batch one (identity on one device). The
    returned ``theta_step(theta, opt_state, kuu_inv, batch)`` updates θ,
    the optimizer state and the warm Kuu⁻¹ in place."""

    def theta_step(theta, opt_state, kuu_inv, batch):
        g, kw = grad_one(theta, kuu_inv, batch)
        g = reduce(g)
        theta.add_(optimizer.update_(g, opt_state))
        kuu_inv.copy_(kw)

    return theta_step


class FastCarry(NamedTuple):
    """The fast trainer's state between epochs, field for field the JAX
    carry: q(v)'s natural parameters after the last epoch, one warm
    Newton–Schulz estimate of Λ⁻¹ per statistics group, θ, the optimizer
    state and the warm Kuu⁻¹."""

    xi: torch.Tensor
    prec: torch.Tensor
    covs64: torch.Tensor
    theta: torch.Tensor
    opt_state: dict
    kuu_inv: torch.Tensor


def _acc_dtype(obj_dt):
    return torch.float64 if config.default_dtype() == torch.float64 else obj_dt


def init_kin40k_fast_state(theta0, prior_v: MvGaussianNat, M, groups,
                           optimizer=None, acc_dt=None, obj_dt=None,
                           learning_rate=1e-3, lr_decay_rate=1.0, epochs=1,
                           n_batches=1) -> FastCarry:
    """Initial carry for :func:`fit_kin40k_fast`, on θ0's device: q(v) at
    the prior in the accumulation dtype (float64 unless
    ``config.default_dtype()`` is float32), zero warm starts (which the
    guard rejects, so the first inverses start cold), and the state of the
    same optimizer chain the trainer builds for the schedule."""
    if optimizer is None:
        optimizer = fast_optimizer(learning_rate, lr_decay_rate, epochs, n_batches)
    obj_dt = theta0.dtype if obj_dt is None else obj_dt
    acc_dt = _acc_dtype(obj_dt) if acc_dt is None else acc_dt
    dev = theta0.device
    theta0 = theta0.to(obj_dt).clone()
    return FastCarry(
        prior_v.xi.to(device=dev, dtype=acc_dt),
        prior_v.prec.to(device=dev, dtype=acc_dt),
        torch.zeros((groups, M, M), dtype=acc_dt, device=dev),
        theta0,
        optimizer.init(theta0),
        torch.zeros((M, M), dtype=obj_dt, device=dev),
    )


def clone_carry(c):
    """A copy of a trainer's carry: a NamedTuple of tensors and one
    optimizer dict of tensors."""
    return type(c)(*({k: v.clone() for k, v in f.items()} if isinstance(f, dict) else f.clone()
                     for f in c))


def _objective_grad(kernel, Xu, dt, ns_iters, ns_tol=None):
    """``grad(θ, Kuu⁻¹ warm, Xb, yb, μ_v, Rv, w) -> (∂loss/∂θ, Kuu⁻¹)`` of
    ``neg_log_backwardmess_gram`` for θ of dtype ``dt``, with Kuu jittered
    by ``effective_jitter(dt)``. ``w`` may be a Python number or a 0-d
    device tensor."""
    kuu_jit = effective_jitter(dt)

    def grad(th, kw, Xb, yb, mu_v, Rv, w):
        th = th.detach().requires_grad_(True)
        loss, kuu_inv = neg_log_backwardmess_gram(
            th, kernel=kernel, Xu=Xu, X=Xb, y=yb, mu_v=mu_v, Rv=Rv, w=w,
            kuu_inv_warm=kw, ns_iters=ns_iters, ns_tol=ns_tol, kuu_jitter=kuu_jit,
        )
        (g,) = torch.autograd.grad(loss, th)
        return g, kuu_inv

    return grad


def fast_epoch_steps(kernel, Xu, prior_v: MvGaussianNat, w_val, optimizer: AdaMaxChain,
                     dt, refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
                     refresh_ns_tol: float | None = None, obj_ns_iters: int = 12,
                     obj_ns_tol: float | None = None, reduce=_identity):
    """The two steps of a :func:`fit_kin40k_fast` epoch, for θ of dtype
    ``dt``, as functions (so each can also be timed alone); ``reduce`` is
    the identity on one device, a data-parallel trainer's all-reduce over
    the points (the natural-parameter increments and the θ-gradient):

    - ``statistics_refresh(theta, xi, prec, cov_warm, Xg, yg) -> (ξ, Λ, Σ,
      μ_v, Rv)``: one Gram K(Xu, Xg) in ``dt``, cast to the accumulation
      dtype (float64 unless ``config.default_dtype()`` is float32; an f32
      product would make Λ indefinite), and ``qv_grand_update`` with the
      prior's λ_min bound; μ_v and Rv = Σ + μμᵀ come back in ``dt``;
    - ``theta_step(theta, opt_state, kuu_inv, (Xb, yb, mu_v, Rv))``: one
      AdaMax step on ``neg_log_backwardmess_gram`` with Kuu jittered by
      ``effective_jitter(dt)``, in place."""
    acc_dt = _acc_dtype(dt)
    # rigorous λ_min bound for every epoch's Λ (⪰ the prior precision)
    lam_v = gershgorin_lambda_min(sym(prior_v.prec)).to(acc_dt)

    @torch.no_grad()
    def statistics_refresh(theta, xi, prec, cov_warm, Xg, yg):
        Kall = kernel(theta, Xu, Xg).to(acc_dt)
        xi, prec, cov64, mu64 = qv_grand_update(
            Kall, yg.to(acc_dt), xi, prec, w_val, cov_warm, refresh_ns_iters,
            ns_tol=refresh_ns_tol, reduce=reduce, lambda_min=lam_v)
        return xi, prec, cov64, mu64.to(dt), (cov64 + torch.outer(mu64, mu64)).to(dt)

    grad = _objective_grad(kernel, Xu, dt, obj_ns_iters, obj_ns_tol)

    def grad_one(th, kw, batch):
        return grad(th, kw, *batch, w_val)

    return statistics_refresh, make_theta_step(grad_one, optimizer, reduce=reduce)


def fit_kin40k_fast(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch, Din)
    y_batched,  # (B, batch)
    prior_v: MvGaussianNat,
    w_val: float,
    epochs: int,
    learning_rate: float = 0.001,
    lr_decay_rate: float = 1.0,
    stats_refreshes: int = 1,
    resume_state: FastCarry | None = None,
    refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
    refresh_ns_tol: float | None = None,
    obj_ns_iters: int = 12,
    obj_ns_tol: float | None = None,
    reduce=_identity,
):
    """Epoch-granular kin40k trainer (the benchmark's fast path), on the
    device of its tensors.

    ``stats_refreshes``: q(v) statistics refreshes per epoch, i.e. groups
    of batches (1 = one grand update per epoch; B = per-batch freshness);
    it must divide the batch count B. ``lr_decay_rate``: exponential decay
    of the learning rate over the whole run (1.0 = constant).
    ``resume_state``: a carry from an earlier call (or from
    ``convert.fast_state_from_jax``); it is copied, not changed.

    Per epoch, q(v) restarts from the prior; per group, one
    ``statistics_refresh`` warm-started from the same group's inverse of
    the previous epoch, then one ``theta_step`` per batch of the group
    (:func:`fast_epoch_steps`). With ``obj_ns_tol`` or ``refresh_ns_tol``
    set, the Newton–Schulz loops exit early, which reads a residual on the
    host each iteration. ``reduce``: the identity on one device; the
    data-parallel trainer's all-reduce over the points
    (:func:`fast_epoch_steps`).

    Returns ``(theta, MvGaussianNat(ξ, Λ), Σ of the last group, carry)``."""
    B = X_batched.shape[0]
    optimizer = fast_optimizer(learning_rate, lr_decay_rate, epochs, B)
    M = Xu.shape[0]
    dt = theta0.dtype
    groups = max(1, min(stats_refreshes, B))
    if B % groups != 0:
        raise ValueError(
            f"stats_refreshes={stats_refreshes} does not divide the batch "
            f"count B={B}: the trailing {B % groups} batches would be "
            "silently dropped from the statistics and θ-steps"
        )
    gsz = B // groups
    nb = X_batched.shape[1]
    Xg = X_batched.reshape(groups, gsz * nb, -1)
    yg = y_batched.reshape(groups, gsz * nb)
    Xbg = X_batched.reshape(groups, gsz, *X_batched.shape[1:])
    ybg = y_batched.reshape(groups, gsz, *y_batched.shape[1:])
    refresh, theta_step = fast_epoch_steps(
        kernel, Xu, prior_v, w_val, optimizer, dt, refresh_ns_iters=refresh_ns_iters,
        refresh_ns_tol=refresh_ns_tol, obj_ns_iters=obj_ns_iters, obj_ns_tol=obj_ns_tol,
        reduce=reduce)

    if resume_state is None:
        carry = init_kin40k_fast_state(theta0, prior_v, M, groups, optimizer=optimizer)
    else:
        carry = clone_carry(resume_state)
    xi, prec, covs64, theta, opt_state, kuu_inv = carry
    acc_dt = covs64.dtype
    xi_prior, prec_prior = prior_v.xi.to(acc_dt), prior_v.prec.to(acc_dt)

    for _ in range(epochs):
        # q(v) resets to the prior each epoch (regression_kin40k.ipynb
        # cell 9) and accumulates group by group
        xi, prec = xi_prior, prec_prior
        for gi in range(groups):
            xi, prec, cov64, mu_v, Rv = refresh(theta, xi, prec, covs64[gi], Xg[gi], yg[gi])
            covs64[gi].copy_(cov64)
            for b in range(gsz):
                theta_step(theta, opt_state, kuu_inv, (Xbg[gi, b], ybg[gi, b], mu_v, Rv))

    carry = FastCarry(xi, prec, covs64, theta, opt_state, kuu_inv)
    # the last group's inverse is the full-posterior estimate callers expect
    return theta, MvGaussianNat(xi, prec), covs64[-1], carry


class MinibatchCarry(NamedTuple):
    """The per-batch trainers' and the banana fast trainer's state between
    epochs, field for field the JAX carry: q(v)'s natural parameters (in the
    accumulation dtype), the warm Newton–Schulz estimates of Λ⁻¹ and of
    Kuu(θ)⁻¹, θ, the optimizer state, and the Gamma q(w) (classification
    only; 0 for kin40k)."""

    xi_v: torch.Tensor
    prec_v: torch.Tensor
    cov_v: torch.Tensor
    kuu_inv: torch.Tensor
    theta: torch.Tensor
    opt_state: dict
    w_shape: torch.Tensor
    w_rate: torch.Tensor


def _scalar(x, dtype, device):
    """A 0-d tensor of ``dtype`` on ``device``: a tensor is cast (rounding
    in its own dtype first, as ``jnp.asarray(x, dtype)`` does), a number is
    filled in on the device with no host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), float(x), dtype=dtype, device=device)


def fit_kin40k(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch, Din)
    y_batched,  # (B, batch)
    prior_v: MvGaussianNat,
    w_val: float,
    epochs: int,
    learning_rate: float = 0.001,
    resume_state: MinibatchCarry | None = None,
    ns_budget: int = KIN40K_BATCH_NS_ITERS,
):
    """kin40k trainer with the reference's per-batch schedule
    (regression_kin40k.ipynb cells 9-10), on the device of its tensors: w is
    a PointMass (``w_val``); q(v) resets to the prior each epoch; per batch,
    q(v) takes that batch's natural-parameter increment (f64 products), its
    inverse is refreshed by ``spd_inverse`` warm-started from the previous
    batch's (``ns_budget`` spectrum-scaled iterations, λ_min bound of the
    prior), μ_v by ``ir_solve`` (3 rounds), then one AdaMax step on the
    objective (Kuu⁻¹ by as many iterations). ``ns_budget`` is the JAX
    trainer's: 34 in production, 60 for the budget measurement.

    ``resume_state``: a carry from an earlier call (or from
    ``convert.banana_state_from_jax`` of a JAX carry); it is copied, not
    changed. The initial warm starts are zeros, as the JAX carry's are.
    Returns ``(θ, MvGaussianNat(ξ, Λ), carry)``."""
    optimizer = default_optimizer(learning_rate)
    M = Xu.shape[0]
    dt = theta0.dtype
    acc_dt = _acc_dtype(dt)
    dev = theta0.device
    # Λ = Λ_prior + Σ w·KKᵀ ⪰ Λ_prior for every batch of every epoch
    lam_v = gershgorin_lambda_min(sym(prior_v.prec)).to(acc_dt)
    grad = _objective_grad(kernel, Xu, dt, ns_budget)
    theta_step = make_theta_step(lambda th, kw, b: grad(th, kw, *b, w_val), optimizer)
    xi_prior, prec_prior = prior_v.xi.to(acc_dt), prior_v.prec.to(acc_dt)

    if resume_state is None:
        theta = theta0.clone()
        carry = MinibatchCarry(
            xi_prior, prec_prior, torch.zeros((M, M), dtype=acc_dt, device=dev),
            torch.zeros((M, M), dtype=dt, device=dev), theta, optimizer.init(theta),
            torch.zeros((), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev))
    else:
        carry = clone_carry(resume_state)
    xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate = carry

    for _ in range(epochs):
        # the reference resets q(v) to its prior at every epoch start
        # (regression_kin40k.ipynb cell 9: μ_v = zeros; Σ_v = 50I)
        xi, prec = xi_prior, prec_prior
        for Xb, yb in zip(X_batched, y_batched):
            with torch.no_grad():
                Kux64 = kernel(theta, Xu, Xb).to(acc_dt)
                xi = xi + w_val * torch.matmul(Kux64, yb.to(acc_dt))
                prec = prec + w_val * torch.matmul(Kux64, Kux64.T)
                cov = spd_inverse(sym(prec), warm=cov, iters=ns_budget, lambda_min=lam_v)
                mu64 = ir_solve(sym(prec), xi, cov, rounds=3)
                mu_v = mu64.to(dt)
                Rv = (cov + torch.outer(mu64, mu64)).to(dt)
            theta_step(theta, opt_state, kuu_inv, (Xb, yb, mu_v, Rv))

    carry = MinibatchCarry(xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate)
    return theta, MvGaussianNat(xi, prec), carry


def init_banana_state(kernel, theta0, Xu, prior_v: MvGaussianNat,
                      prior_w: GammaShapeRate, optimizer=None) -> MinibatchCarry:
    """Initial carry of :func:`fit_banana_fast` and :func:`fit_banana`, on
    θ0's device: q(v) at the prior in the accumulation dtype, cold
    40-iteration Newton–Schulz inverses of Kuu(θ0) (jittered) and of the
    prior precision, θ0, the optimizer's state (``default_optimizer()``
    unless given) and q(w) at ``prior_w`` in the accumulation dtype."""
    if optimizer is None:
        optimizer = default_optimizer()
    dt = theta0.dtype
    acc_dt = _acc_dtype(dt)
    dev = theta0.device
    with torch.no_grad():
        kuu_inv0 = spd_inverse(kernel.kuu(theta0, Xu, jitter=effective_jitter(dt)),
                               iters=NS_ITERS_WARMUP)
        cov0 = spd_inverse(sym(prior_v.prec).to(acc_dt), iters=NS_ITERS_WARMUP)
    theta = theta0.clone()
    return MinibatchCarry(
        prior_v.xi.to(acc_dt), prior_v.prec.to(acc_dt), cov0, kuu_inv0,
        theta, optimizer.init(theta),
        _scalar(prior_w.shape, acc_dt, dev), _scalar(prior_w.rate, acc_dt, dev))


def _qw_increment(Kux, kxx, kuu_inv, qf, mu_v, Rv):
    """Σ(I1 + I2) of the Gamma q(w) rate update in trace form
    (UniSGPnode.jl:219-238): I1 = kxx − kᵀKuu⁻¹k (floored at 0),
    I2 = E[f]² + Var f − 2E[f]·kᵀμ_v + kᵀRv k, per column k of Kux."""
    I1 = torch.clamp_min(kxx - torch.sum(Kux * torch.matmul(kuu_inv, Kux), dim=0), 0.0)
    I2 = (qf.mean**2 + qf.var - 2.0 * qf.mean * torch.matmul(Kux.T, mu_v)
          + torch.sum(Kux * torch.matmul(Rv, Kux), dim=0))
    return torch.sum(I1 + I2)


@torch.no_grad()
def banana_epoch_stats(kernel, Xu, X, y, carry: MinibatchCarry, N_global,
                       refresh_ns_iters, dt, acc_dt, reduce=_identity, lambda_min=None):
    """The grand per-epoch statistics pass of :func:`fit_banana_fast`:
    forward f-messages at the carry's (μ_v, w̄) and probit tilted marginals
    for (this shard of) the data, the accumulating q(v) update with its f64
    Newton–Schulz refresh (``qv_grand_update``), and the carried q(w)
    update (shape += N/2, rate += Σ(I1+I2)/2; I1 with the carry's warm
    Kuu⁻¹). Every global quantity is a sum over the points, so a
    data-parallel pass puts its all-reduce in ``reduce`` and passes the
    pre-shard ``N_global``. Returns ``(qf, ξ, Λ, Σ, μ_v, Rv, w_shape,
    w_rate)``: μ_v and Rv in ``dt``, q(w) in ``acc_dt``."""
    theta = carry.theta
    Kall = kernel(theta, Xu, X)
    Kall64 = Kall.to(acc_dt)
    kxx = kernel.diag(theta, X)
    w_mean = (carry.w_shape / carry.w_rate).to(dt)
    mu_v_prev = ir_solve(carry.prec_v, carry.xi_v, carry.cov_v, rounds=2).to(dt)
    # forward f messages → probit tilted marginals (a per-datum map)
    f_fwd = torch.matmul(Kall.T, mu_v_prev)
    f_var = (1.0 / w_mean).expand_as(f_fwd)
    qf = tilted_marginal_batch(f_fwd, f_var, y)
    # one grand q(v) update (accumulating across epochs, f64 products)
    w64 = (carry.w_shape / carry.w_rate).to(acc_dt)
    xi, prec, cov64, mu64 = qv_grand_update(
        Kall64, qf.mean.to(acc_dt), carry.xi_v, carry.prec_v, w64, carry.cov_v,
        refresh_ns_iters, reduce=reduce, lambda_min=lambda_min)
    mu_v = mu64.to(dt)
    Rv = (cov64 + torch.outer(mu64, mu64)).to(dt)
    # one grand q(w) update
    w_shape = (carry.w_shape + 0.5 * N_global).to(acc_dt)
    w_rate = (carry.w_rate
              + 0.5 * reduce(_qw_increment(Kall, kxx, carry.kuu_inv, qf, mu_v, Rv))
              ).to(acc_dt)
    return qf, xi, prec, cov64, mu_v, Rv, w_shape, w_rate


def banana_epoch_steps(kernel, Xu, X, y, prior_v: MvGaussianNat, optimizer: AdaMaxChain,
                       dt, reduce=_identity, N_global=None,
                       refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
                       obj_ns_iters: int = NS_ITERS_STEADY):
    """The two steps of a :func:`fit_banana_fast` epoch on all the training
    points (X, y), for θ of dtype ``dt``, as functions (so each can also be
    timed alone). A data-parallel trainer passes its shard of the points,
    its all-reduce as ``reduce`` and the global point count ``N_global``
    (default: X's rows):

    - ``statistics(carry) -> (qf, ξ, Λ, Σ, μ_v, Rv, w_shape, w_rate)``:
      :func:`banana_epoch_stats` with the prior's λ_min bound;
    - ``theta_step(theta, opt_state, kuu_inv, (Xb, f̄b, μ_v, Rv, w̄))``: one
      AdaMax step on ``neg_log_backwardmess_gram`` against pseudo-targets
      f̄ = E[f] with w̄ a 0-d tensor of ``dt``, in place."""
    acc_dt = _acc_dtype(dt)
    # Λ accumulates PSD increments from the prior up → its λ_min bound
    lam_v = gershgorin_lambda_min(sym(prior_v.prec)).to(acc_dt)
    N = X.shape[0] if N_global is None else N_global

    def statistics(carry):
        return banana_epoch_stats(kernel, Xu, X, y, carry, N, refresh_ns_iters, dt,
                                  acc_dt, reduce=reduce, lambda_min=lam_v)

    grad = _objective_grad(kernel, Xu, dt, obj_ns_iters)
    return statistics, make_theta_step(lambda th, kw, b: grad(th, kw, *b), optimizer,
                                       reduce=reduce)


def fit_banana_fast(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch, 2)
    y_batched,  # (B, batch) in {0,1}
    prior_v: MvGaussianNat,
    prior_w: GammaShapeRate,
    epochs: int,
    learning_rate: float = 0.001,
    resume_state: MinibatchCarry | None = None,
    refresh_ns_iters: int = REFRESH_NS_ITERS_SCALED,
    obj_ns_iters: int = NS_ITERS_STEADY,
    reduce=_identity,
    N_global: int | None = None,
):
    """Epoch-granular banana trainer (the :func:`fit_banana` fixed point at
    the fast trainer's cost), on the device of its tensors. Per epoch:

    - :func:`banana_epoch_stats` on all N points at the epoch's (μ_v, w̄):
      one Gram K(Xu, X), the probit tilted marginals, one grand update of
      the accumulating q(v) (the reference's per-batch increments at
      frozen statistics sum to it) with its f64 refresh, and one grand q(w)
      update;
    - one AdaMax θ-step per batch against those frozen statistics, with
      pseudo-targets E[f] and w̄ = shape/rate.

    ``resume_state``: a carry from an earlier call, from
    :func:`init_banana_state` or from ``convert.banana_state_from_jax``; it
    is copied, not changed. ``reduce`` and ``N_global``: the identity and
    the batches' point count on one device; the data-parallel trainer's
    all-reduce and the global point count (:func:`banana_epoch_steps`).
    Returns ``(θ, MvGaussianNat(ξ, Λ), GammaShapeRate(shape, rate),
    carry)``."""
    optimizer = default_optimizer(learning_rate)
    dt = theta0.dtype
    # grand arrays derived from the batches, so (x, y) pairs cannot be
    # mispaired
    X = X_batched.reshape(-1, X_batched.shape[-1])
    y = y_batched.reshape(-1)
    statistics, theta_step = banana_epoch_steps(
        kernel, Xu, X, y, prior_v, optimizer, dt, reduce=reduce, N_global=N_global,
        refresh_ns_iters=refresh_ns_iters, obj_ns_iters=obj_ns_iters)

    if resume_state is None:
        carry = init_banana_state(kernel, theta0, Xu, prior_v, prior_w, optimizer=optimizer)
    else:
        carry = clone_carry(resume_state)
    theta, opt_state, kuu_inv = carry.theta, carry.opt_state, carry.kuu_inv

    for _ in range(epochs):
        qf, xi, prec, cov, mu_v, Rv, w_shape, w_rate = statistics(carry)
        f_b = qf.mean.reshape(y_batched.shape)
        w_bar = (w_shape / w_rate).to(dt)
        for Xb, fb in zip(X_batched, f_b):
            theta_step(theta, opt_state, kuu_inv, (Xb, fb, mu_v, Rv, w_bar))
        carry = MinibatchCarry(xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate)

    return theta, MvGaussianNat(carry.xi_v, carry.prec_v), \
        GammaShapeRate(carry.w_shape, carry.w_rate), carry


def fit_banana(
    kernel,
    theta0,
    Xu,
    X_batched,  # (B, batch, 2)
    y_batched,  # (B, batch) in {0,1}
    prior_v: MvGaussianNat,
    prior_w: GammaShapeRate,
    epochs: int,
    learning_rate: float = 0.001,
    resume_state: MinibatchCarry | None = None,
):
    """Banana classification trainer with the reference's per-batch
    schedule (classification_banana.ipynb cell 9), on the device of its
    tensors. Per batch: forward f at the carried (μ_v, w̄), probit tilted
    q(f), the batch's f64 q(v) increment, ``spd_inverse`` warm-started from
    the previous batch's (``BANANA_BATCH_NS_ITERS`` iterations), μ_v by
    ``ir_solve`` (2 rounds), the carried q(w) update (I1 with the warm
    Kuu⁻¹), then one AdaMax step on pseudo-targets E[f] with the updated w̄.
    Unlike kin40k, q(v) and q(w) accumulate across epochs with no reset.

    ``resume_state`` as in :func:`fit_banana_fast`. Returns ``(θ,
    MvGaussianNat(ξ, Λ), GammaShapeRate(shape, rate), carry)``."""
    optimizer = default_optimizer(learning_rate)
    dt = theta0.dtype
    acc_dt = _acc_dtype(dt)
    batch = X_batched.shape[1]
    grad = _objective_grad(kernel, Xu, dt, NS_ITERS_STEADY)
    theta_step = make_theta_step(lambda th, kw, b: grad(th, kw, *b), optimizer)

    if resume_state is None:
        carry = init_banana_state(kernel, theta0, Xu, prior_v, prior_w, optimizer=optimizer)
    else:
        carry = clone_carry(resume_state)
    xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate = carry

    for _ in range(epochs):
        for Xb, yb in zip(X_batched, y_batched):
            with torch.no_grad():
                Kux = kernel(theta, Xu, Xb)
                Kux64 = Kux.to(acc_dt)
                kxx = kernel.diag(theta, Xb)
                w_mean = w_shape / w_rate
                mu_v_prev = ir_solve(prec, xi, cov, rounds=2).to(dt)
                # forward f messages → probit tilted marginals
                # (UniSGPnode.jl:96-104 and the EP product)
                f_fwd = torch.matmul(Kux.T, mu_v_prev)
                f_var = (1.0 / w_mean.to(dt)).expand_as(f_fwd)
                qf = tilted_marginal_batch(f_fwd, f_var, yb)
                # q(v) accumulates across batches and epochs (f64 products)
                xi = xi + w_mean * torch.matmul(Kux64, qf.mean.to(acc_dt))
                prec = sym(prec + w_mean * torch.matmul(Kux64, Kux64.T))
                cov = spd_inverse(prec, warm=cov, iters=BANANA_BATCH_NS_ITERS)
                mu64 = ir_solve(prec, xi, cov, rounds=2)
                mu_v = mu64.to(dt)
                Rv = (cov + torch.outer(mu64, mu64)).to(dt)
                # the carried q(w) is the next batch's prior: shape and rate
                # accumulate, which damps the w ↔ forward-variance loop
                w_shape = (w_shape + 0.5 * batch).to(acc_dt)
                w_rate = (w_rate + 0.5 * _qw_increment(Kux, kxx, kuu_inv, qf, mu_v, Rv)
                          ).to(acc_dt)
            theta_step(theta, opt_state, kuu_inv,
                       (Xb, qf.mean, mu_v, Rv, (w_shape / w_rate).to(dt)))

    carry = MinibatchCarry(xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate)
    return theta, MvGaussianNat(xi, prec), GammaShapeRate(w_shape, w_rate), carry
