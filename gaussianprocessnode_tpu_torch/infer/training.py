"""Training loops that alternate VMP inference with L-BFGS on θ (L5/L6 glue).

Counterpart of ``gaussianprocessnode_tpu/infer/training.py``. The reference
alternates RxInfer ``infer`` with Optim.LBFGS steps (SURVEY.md §3.1); the
JAX package runs ``optax.lbfgs()`` with its zoom linesearch for a fixed
number of steps per epoch. That optimizer is written out here, with the
optax 0.2.6 defaults and arithmetic:

- ``scale_by_lbfgs``: memory 10, the two-loop recursion, the initial
  preconditioner scaled by sᵀy/yᵀy (by min(1, 1/‖g‖) at the first step),
  and a curvature pair weighted 0 where sᵀy = 0;
- ``scale(-1)``;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')``: the interval search and the zoom of
  Nocedal & Wright (Algorithms 3.5, 3.6) with cubic, then quadratic
  interpolation, then bisection; Armijo (slope_rtol 1e-4) or the
  approximate decrease of Hager & Zhang (approx_dec_rtol 1e-6), curvature
  (curv_rtol 0.9), interval threshold 1e-5, and the safe step (the best
  point with sufficient decrease) when the search fails.

The linesearch state lives on the tensors' device. Its loop runs until a
step is found or the search fails, which depends on device values: each
iteration reads its three flags in one host read (``counts["host_reads"]``
counts them). Everything else is queued without a read: which step the
L-BFGS memory is at is known on the host, every other choice is a
``torch.where``, and a step whose iterate is not finite is rejected on the
device. All ``max_steps`` steps always run.

On the card, each ``lbfgs_solve`` captures the objective's value and
gradient (a few hundred kernels of 20×50 tensors, forward and backward) in
one CUDA graph and replays it for every evaluation: queued one by one, the
host took ~6 ms to launch what the card ran in ~1 ms, once for every
linesearch iteration.
"""

import math
from typing import NamedTuple

import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..objectives import neg_log_backwardmess_fast
from ..ops.linalg import rv_chol_upper
from .batch_vmp import classification_vmp, regression_vmp

__all__ = ["lbfgs_solve", "fit_regression", "fit_classification"]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5  # the zoom's interval threshold
TOL = 0.0


def _add(counts, key, n=1):
    if counts is not None:
        counts[key] = counts.get(key, 0) + n


def _value_and_grad(objective, x, counts):
    th = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = objective(th)
        (g,) = torch.autograd.grad(v, th)
    _add(counts, "evaluations")
    return v.detach(), g


class _ValueAndGrad:
    """The objective's value and gradient at x; on a CUDA tensor, by one CUDA
    graph of the whole evaluation, captured at construction (after one
    eager warm-up on a side stream, which creates the libraries' handles and
    workspaces; ``counts["graph_captures"]``) and replayed for each x copied
    into its static input. A replay runs no Python, so the kernels' wrappers
    count the launches they make while the graph is captured, not those the
    replays make: a profiler trace counts those."""

    def __init__(self, objective, x, counts):
        self.objective, self.counts, self.graph = objective, counts, None
        if x.device.type != "cuda":
            return
        self.x = x.detach().clone()
        # capture on a side stream, as torch.cuda.graph does, but without its
        # device synchronisation, garbage collection and cache release
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            _value_and_grad(objective, self.x, None)
            self.graph.capture_begin()
            try:
                self.v, self.g = _value_and_grad(objective, self.x, None)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        _add(counts, "graph_captures")

    def __call__(self, x):
        if self.graph is None:
            return _value_and_grad(self.objective, x, self.counts)
        self.x.copy_(x)
        self.graph.replay()
        _add(self.counts, "evaluations")
        return self.v.clone(), self.g.clone()


# ---------------------------------------------------------------------------
# scale_by_lbfgs (optax/_src/transform.py: _precondition_by_lbfgs, scale_by_lbfgs)
# ---------------------------------------------------------------------------


class LBFGSState(NamedTuple):
    count: int  # the step, known on the host
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor  # (MEMORY_SIZE, n)
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor  # (MEMORY_SIZE,)


def _lbfgs_init(x) -> LBFGSState:
    z = torch.zeros((MEMORY_SIZE,) + x.shape, dtype=x.dtype, device=x.device)
    return LBFGSState(0, torch.zeros_like(x), torch.zeros_like(x), z, z.clone(),
                      torch.zeros((MEMORY_SIZE,), dtype=x.dtype, device=x.device))


def _precondition(updates, dws, dus, rhos, identity_scale, memory_idx):
    """Two-loop recursion (Nocedal & Wright Algorithm 7.4), newest pair
    last, in optax's order."""
    indices = [(memory_idx + i) % MEMORY_SIZE for i in range(MEMORY_SIZE)]
    vec = updates
    alphas = [None] * MEMORY_SIZE
    for i in reversed(range(MEMORY_SIZE)):
        idx = indices[i]
        alpha = rhos[idx] * torch.dot(dws[idx], vec)
        vec = vec + (-alpha) * dus[idx]
        alphas[i] = alpha
    vec = identity_scale * vec
    for i in range(MEMORY_SIZE):
        idx = indices[i]
        beta = rhos[idx] * torch.dot(dus[idx], vec)
        vec = vec + (alphas[i] - beta) * dws[idx]
    return vec


def _lbfgs_update(g, state: LBFGSState, params):
    """The L-BFGS direction P·g and the next state (the memory takes the
    pair (Δparams, Δgrad) of the previous step first)."""
    k = state.count
    memory_idx = k % MEMORY_SIZE
    prev_idx = (k - 1) % MEMORY_SIZE
    diff_params = params - state.params
    diff_updates = g - state.updates
    vdot = torch.dot(diff_updates, diff_params)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    if k == 0:
        diff_params = torch.zeros_like(diff_params)
        diff_updates = torch.zeros_like(diff_updates)
        weight = torch.zeros_like(weight)
    dws = state.diff_params_memory.clone()
    dus = state.diff_updates_memory.clone()
    rhos = state.weights_memory.clone()
    dws[prev_idx] = diff_params
    dus[prev_idx] = diff_updates
    rhos[prev_idx] = weight
    if k > 0:
        numerator = torch.dot(diff_updates, diff_params)
        denominator = torch.sum(diff_updates * diff_updates)
        identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                     torch.ones_like(numerator))
    else:
        update_norm = torch.sqrt(torch.sum(g * g))
        identity_scale = torch.clamp_max(1.0 / update_norm, 1.0)
    precond = _precondition(g, dws, dus, rhos, identity_scale, memory_idx)
    return precond, LBFGSState(k + 1, params, g, dws, dus, rhos)


# ---------------------------------------------------------------------------
# zoom linesearch (optax/_src/linesearch.py: _cubicmin, _quadmin, zoom_linesearch)
# ---------------------------------------------------------------------------


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + (-(db**2)) * r1) / denom
    B = ((-(dc**3)) * r0 + db**3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    """Armijo, or the approximate decrease near a minimum, whichever is
    smaller; violations only, NaN as +inf."""
    decrease_error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    decrease_error = torch.minimum(approx, decrease_error)
    decrease_error = torch.clamp_min(decrease_error, 0.0)
    return torch.where(torch.isnan(decrease_error), math.inf, decrease_error)


def _curvature_error(slope_step, slope_init):
    curvature_error = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    curvature_error = torch.clamp_min(curvature_error, 0.0)
    return torch.where(torch.isnan(curvature_error), math.inf, curvature_error)


def _where(c, a, b):
    return [torch.where(c, x, y) for x, y in zip(a, b)]


def zoom_linesearch(value_and_grad, params, updates, value, grad, counts=None):
    """optax ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` along ``updates`` from ``params``, with
    ``value_and_grad(x) -> (value, gradient)``: returns the stepsize. One
    host read per iteration. The state is optax's ``ZoomLinesearchState``
    less the fields that decide no stepsize (the gradients, the curvature
    error, the slope at ``high``)."""
    zero = torch.zeros((), dtype=params.dtype, device=params.device)
    slope = torch.dot(updates, grad)
    s = dict(stepsize=zero, value=value, slope=slope, decrease_error=zero + math.inf,
             low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
             cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero, safe_value=value)
    value_init, slope_init = value, slope
    interval_found = False
    it = 0
    while True:
        last = it + 1 >= MAX_LINESEARCH_STEPS
        if not interval_found:
            # the interval search (Nocedal & Wright Algorithm 3.5)
            new_stepsize = zero + 1.0 if it == 0 else INCREASE_FACTOR * s["stepsize"]
            v, g = value_and_grad(params + new_stepsize * updates)
            sl = torch.dot(g, updates)
            dec = _decrease_error(new_stepsize, v, sl, value_init, slope_init)
            curv = _curvature_error(sl, slope_init)
            err = torch.maximum(dec, curv)
            s["safe_stepsize"], s["safe_value"] = _where(
                dec <= TOL, [new_stepsize, v], [s["safe_stepsize"], s["safe_value"]])
            set_high = dec > 0.0
            if it > 0:
                set_high = set_high | (v >= s["value"])
            set_low = (sl >= 0.0) & ~set_high
            prev = [s["stepsize"], s["value"], s["slope"]]
            new = [new_stepsize, v, sl]
            lo = _where(set_low, new, prev)
            hi = _where(set_low, prev, new)
            s["low"], s["value_low"], s["slope_low"] = lo
            s["high"], s["value_high"] = hi[0], hi[1]
            s["cubic_ref"], s["value_cubic_ref"] = lo[0], lo[1]
            found = set_high | set_low | (err <= TOL)
            done = err <= TOL
            failed = ~done if last else torch.zeros_like(done)
        else:
            # the zoom (Nocedal & Wright Algorithm 3.6)
            low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
            high, value_high = s["high"], s["value_high"]
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
            too_small_int = delta <= STEPSIZE_PRECISION
            mc = _cubicmin(low, value_low, slope_low, high, value_high, s["cubic_ref"],
                           s["value_cubic_ref"])
            use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
            mq = _quadmin(low, value_low, slope_low, high, value_high)
            use_quad = ~use_cubic & (mq > left + quad_chk) & (mq < right - quad_chk)
            use_bisection = ~use_cubic & ~use_quad
            middle = torch.where(use_cubic, mc, s["cubic_ref"])
            middle = torch.where(use_quad, mq, middle)
            middle = torch.where(use_bisection, (low + high) / 2.0, middle)
            new_stepsize = middle
            v, g = value_and_grad(params + middle * updates)
            sl = torch.dot(g, updates)
            dec = _decrease_error(middle, v, sl, value_init, slope_init)
            curv = _curvature_error(sl, slope_init)
            err = torch.maximum(dec, curv)
            update_safe = (dec <= TOL) & (v < s["safe_value"])
            s["safe_stepsize"], s["safe_value"] = _where(
                update_safe, [middle, v], [s["safe_stepsize"], s["safe_value"]])
            done = err <= TOL
            set_high_to_middle = (dec > 0.0) | (v >= value_low)
            set_high_to_low = (sl * (high - low) >= 0.0) & ~set_high_to_middle
            set_low_to_middle = ~set_high_to_middle
            hi = _where(set_high_to_middle, [middle, v], [high, value_high])
            hi = _where(set_high_to_low, [low, value_low], hi)
            lo = _where(set_low_to_middle, [middle, v, sl], [low, value_low, slope_low])
            s["cubic_ref"], s["value_cubic_ref"] = _where(
                set_high_to_middle | set_high_to_low, [high, value_high], [low, value_low])
            s["high"], s["value_high"] = hi
            s["low"], s["value_low"], s["slope_low"] = lo
            presumably_failed = too_small_int & (s["safe_stepsize"] > 0.0)
            if last:
                presumably_failed = torch.ones_like(presumably_failed)
            failed = presumably_failed & ~done
            found = torch.ones_like(done)
        s["stepsize"], s["value"], s["slope"], s["decrease_error"] = new_stepsize, v, sl, dec
        it += 1
        flags = torch.stack([found, done, failed]).tolist()  # the one host read
        _add(counts, "host_reads")
        _add(counts, "linesearch_steps")
        interval_found, is_done, is_failed = flags
        if is_failed:
            # the safe step: the best point with sufficient decrease, or no
            # move when the last point lies outside the domain (NaN value)
            take_safe = (s["safe_stepsize"] > 0.0) | torch.isinf(s["decrease_error"])
            s["stepsize"] = torch.where(take_safe, s["safe_stepsize"], s["stepsize"])
        if is_done or is_failed:
            return s["stepsize"]


# ---------------------------------------------------------------------------
# optax.lbfgs() for a fixed number of steps
# ---------------------------------------------------------------------------


def lbfgs_solve(objective, x0, max_steps: int = 60, counts=None):
    """Minimise a smooth objective of a 1-D tensor by ``optax.lbfgs()`` (its
    defaults: memory 10, scaled initial preconditioner, zoom linesearch of
    at most 20 steps starting from stepsize 1), for exactly ``max_steps``
    steps. A step whose iterate is not finite is rejected (the optimizer
    state advances all the same). Returns (x, the objective's value at
    each step's start).

    ``counts``: a dict to which the objective's evaluations
    (``evaluations``), the linesearch iterations (``linesearch_steps``), the
    host reads (``host_reads``) and, on the card, the CUDA graph captures of
    the evaluation (``graph_captures``) are added."""
    x = x0.detach().clone()
    state = _lbfgs_init(x)
    values = []
    value_and_grad = _ValueAndGrad(objective, x, counts)
    with torch.no_grad():
        for _ in range(max_steps):
            v, g = value_and_grad(x)
            precond, state = _lbfgs_update(g, state, x)
            direction = -precond
            stepsize = zoom_linesearch(value_and_grad, x, direction, v, g, counts)
            x_new = x + stepsize * direction
            x = torch.where(torch.all(torch.isfinite(x_new)), x_new, x)
            values.append(v)
    return x, torch.stack(values)


# ---------------------------------------------------------------------------
# the toy trainers
# ---------------------------------------------------------------------------


def fit_regression(kernel, theta0, Xu, X, y, prior_v: MvGaussianNat,
                   prior_w: GammaShapeRate, epochs: int, n_iters: int = 7,
                   lbfgs_steps: int = 60, counts=None):
    """Toy-regression trainer (reference: GPT_regression.ipynb cells 9-10):
    per epoch, ``n_iters`` VMP sweeps, then L-BFGS on the θ objective given
    (μ_v, Uv, w̄). Returns (θ, the free energy of each epoch, the final VMP
    result). ``counts`` as in :func:`lbfgs_solve`."""
    theta = theta0
    fes = []
    for _ in range(epochs):
        res = regression_vmp(kernel, theta, Xu, X, y, prior_v, prior_w, n_iters=n_iters)
        mu_v = res.qv.mean
        Uv = rv_chol_upper(mu_v, res.qv.cov)
        w = gamma_mean(res.qw)

        def objective(th, mu_v=mu_v, Uv=Uv, w=w):
            return neg_log_backwardmess_fast(th, kernel=kernel, Xu=Xu, X=X, y=y, mu_v=mu_v,
                                             Uv=Uv, w=w)

        theta, _ = lbfgs_solve(objective, theta, max_steps=lbfgs_steps, counts=counts)
        fes.append(res.free_energy)
    res = regression_vmp(kernel, theta, Xu, X, y, prior_v, prior_w, n_iters=n_iters)
    return theta, _stack(fes, theta), res


def fit_classification(kernel, theta0, Xu, X, y, prior_v: MvGaussianNat,
                       prior_w: GammaShapeRate, init_w: GammaShapeRate, epochs: int,
                       n_iters: int = 30, lbfgs_steps: int = 60,
                       probit_product: str = "exact", counts=None):
    """Toy-classification trainer (reference: GPT_classification.ipynb
    cell 9): per epoch, ``n_iters`` VMP sweeps, then L-BFGS on the
    pseudo-targets f̄ = E[q(f)]. ``probit_product="gh32"`` takes the
    reference's ProbitMeta(32) product. Returns (θ, the free energy of each
    epoch, the final VMP result)."""
    theta = theta0
    fes = []
    for _ in range(epochs):
        res = classification_vmp(kernel, theta, Xu, X, y, prior_v, prior_w, init_w,
                                 n_iters=n_iters, probit_product=probit_product)
        mu_v = res.qv.mean
        Uv = rv_chol_upper(mu_v, res.qv.cov)
        w = gamma_mean(res.qw)
        f = res.qf.mean

        def objective(th, mu_v=mu_v, Uv=Uv, w=w, f=f):
            return neg_log_backwardmess_fast(th, kernel=kernel, Xu=Xu, X=X, y=f, mu_v=mu_v,
                                             Uv=Uv, w=w)

        theta, _ = lbfgs_solve(objective, theta, max_steps=lbfgs_steps, counts=counts)
        fes.append(res.free_energy)
    res = classification_vmp(kernel, theta, Xu, X, y, prior_v, prior_w, init_w,
                             n_iters=n_iters, probit_product=probit_product)
    return theta, _stack(fes, theta), res


def _stack(fes, like):
    if fes:
        return torch.stack(fes)
    return torch.zeros((0,), dtype=like.dtype, device=like.device)
