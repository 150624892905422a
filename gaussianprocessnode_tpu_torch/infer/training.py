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

``lbfgs_solve_batched`` runs the same optimizer, the same arithmetic, over
the rows of a batch as ``jax.vmap(lbfgs_solve)`` does (the GPLVM's
Laplace step): each row keeps its own memory, phase and stop, a finished
row is frozen by ``torch.where``, the objective is evaluated once per
linesearch iteration for all rows, and the one host read per iteration is
whether any row is still active.
"""

import math
from typing import NamedTuple

import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..objectives import neg_log_backwardmess_fast
from ..ops._build import CallGraph
from ..ops.linalg import rv_chol_upper
from .batch_vmp import classification_vmp, regression_vmp

__all__ = ["lbfgs_solve", "lbfgs_solve_batched", "fit_regression", "fit_classification"]

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


def _value_and_grad(objective, x):
    th = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = objective(th)
        (g,) = torch.autograd.grad(v, th)
    return v.detach(), g


class _ValueAndGrad:
    """The objective's value and gradient at x; on a CUDA tensor, by one CUDA
    graph of the whole evaluation (``ops._build.CallGraph``), captured at
    construction after one eager warm-up (``counts["graph_captures"]``) and
    replayed for each x."""

    def __init__(self, objective, x, counts):
        self.counts = counts
        self.call = lambda t: _value_and_grad(objective, t)
        if x.device.type == "cuda":
            self.call = CallGraph(self.call, x, warmup=True)
            _add(counts, "graph_captures")

    def __call__(self, x):
        _add(self.counts, "evaluations")
        return self.call(x)


# ---------------------------------------------------------------------------
# scale_by_lbfgs (optax/_src/transform.py: _precondition_by_lbfgs, scale_by_lbfgs)
# ---------------------------------------------------------------------------


class LBFGSState(NamedTuple):
    count: int  # the step, known on the host
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor  # (MEMORY_SIZE, *x.shape)
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor  # (MEMORY_SIZE,) or (MEMORY_SIZE, N, 1) by row


# The solver runs on one problem (x of shape (n,), its scalars 0-d, reduced
# by torch.dot / torch.sum) or on the rows of a batch (x of shape (N, d),
# each row's scalars kept as (N, 1) so that they broadcast against the rows
# as a 0-d scalar against a vector): the same arithmetic, row by row.
def _rowdot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _rowsum(t):
    return torch.sum(t, dim=-1, keepdim=True)


def _lbfgs_init(x, scalar_shape=()) -> LBFGSState:
    z = torch.zeros((MEMORY_SIZE,) + x.shape, dtype=x.dtype, device=x.device)
    return LBFGSState(0, torch.zeros_like(x), torch.zeros_like(x), z, z.clone(),
                      torch.zeros((MEMORY_SIZE,) + scalar_shape, dtype=x.dtype,
                                  device=x.device))


def _precondition(updates, dws, dus, rhos, identity_scale, memory_idx, dot):
    """Two-loop recursion (Nocedal & Wright Algorithm 7.4), newest pair
    last, in optax's order."""
    indices = [(memory_idx + i) % MEMORY_SIZE for i in range(MEMORY_SIZE)]
    vec = updates
    alphas = [None] * MEMORY_SIZE
    for i in reversed(range(MEMORY_SIZE)):
        idx = indices[i]
        alpha = rhos[idx] * dot(dws[idx], vec)
        vec = vec + (-alpha) * dus[idx]
        alphas[i] = alpha
    vec = identity_scale * vec
    for i in range(MEMORY_SIZE):
        idx = indices[i]
        beta = rhos[idx] * dot(dus[idx], vec)
        vec = vec + (alphas[i] - beta) * dws[idx]
    return vec


def _lbfgs_update(g, state: LBFGSState, params, dot=torch.dot, total=torch.sum):
    """The L-BFGS direction P·g and the next state (the memory takes the
    pair (Δparams, Δgrad) of the previous step first)."""
    k = state.count
    memory_idx = k % MEMORY_SIZE
    prev_idx = (k - 1) % MEMORY_SIZE
    diff_params = params - state.params
    diff_updates = g - state.updates
    vdot = dot(diff_updates, diff_params)
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
        numerator = dot(diff_updates, diff_params)
        denominator = total(diff_updates * diff_updates)
        identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                     torch.ones_like(numerator))
    else:
        update_norm = torch.sqrt(total(g * g))
        identity_scale = torch.clamp_max(1.0 / update_norm, 1.0)
    precond = _precondition(g, dws, dus, rhos, identity_scale, memory_idx, dot)
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


def _linesearch_init(value, slope):
    """optax's ``ZoomLinesearchState`` less the fields that decide no
    stepsize (the gradients, the curvature error, the slope at ``high``)."""
    zero = torch.zeros_like(value)
    return dict(stepsize=zero, value=value, slope=slope, decrease_error=zero + math.inf,
                low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
                cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero, safe_value=value)


def _zoom_candidate(s):
    """The zoom's trial stepsize (Nocedal & Wright Algorithm 3.6): the cubic
    interpolant's minimiser, else the quadratic's, each only well inside
    the interval, else bisection; and whether the interval is below its
    threshold."""
    low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
    high, value_high = s["high"], s["value_high"]
    delta = torch.abs(high - low)
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
    mc = _cubicmin(low, value_low, slope_low, high, value_high, s["cubic_ref"],
                   s["value_cubic_ref"])
    use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
    mq = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = ~use_cubic & (mq > left + quad_chk) & (mq < right - quad_chk)
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, mc, s["cubic_ref"])
    middle = torch.where(use_quad, mq, middle)
    middle = torch.where(use_bisection, (low + high) / 2.0, middle)
    return middle, delta <= STEPSIZE_PRECISION


def _search_update(s, stepsize, v, sl, dec, first):
    """The interval search's state after the trial (stepsize, v, sl)
    (Nocedal & Wright Algorithm 3.5), and whether it bracketed an
    interval."""
    new = dict(s)
    new["safe_stepsize"], new["safe_value"] = _where(
        dec <= TOL, [stepsize, v], [s["safe_stepsize"], s["safe_value"]])
    set_high = dec > 0.0
    if not first:
        set_high = set_high | (v >= s["value"])
    set_low = (sl >= 0.0) & ~set_high
    prev = [s["stepsize"], s["value"], s["slope"]]
    trial = [stepsize, v, sl]
    lo = _where(set_low, trial, prev)
    hi = _where(set_low, prev, trial)
    new["low"], new["value_low"], new["slope_low"] = lo
    new["high"], new["value_high"] = hi[0], hi[1]
    new["cubic_ref"], new["value_cubic_ref"] = lo[0], lo[1]
    return new, set_high | set_low


def _zoom_update(s, middle, v, sl, dec):
    """The zoom's state after the trial (middle, v, sl)."""
    new = dict(s)
    low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
    high, value_high = s["high"], s["value_high"]
    update_safe = (dec <= TOL) & (v < s["safe_value"])
    new["safe_stepsize"], new["safe_value"] = _where(
        update_safe, [middle, v], [s["safe_stepsize"], s["safe_value"]])
    set_high_to_middle = (dec > 0.0) | (v >= value_low)
    set_high_to_low = (sl * (high - low) >= 0.0) & ~set_high_to_middle
    set_low_to_middle = ~set_high_to_middle
    hi = _where(set_high_to_middle, [middle, v], [high, value_high])
    new["high"], new["value_high"] = _where(set_high_to_low, [low, value_low], hi)
    new["low"], new["value_low"], new["slope_low"] = _where(
        set_low_to_middle, [middle, v, sl], [low, value_low, slope_low])
    new["cubic_ref"], new["value_cubic_ref"] = _where(
        set_high_to_middle | set_high_to_low, [high, value_high], [low, value_low])
    return new


def _safe_step(s):
    """The stepsize a failed search takes: the best point with sufficient
    decrease, or no move when the last point lies outside the domain (NaN
    value)."""
    take_safe = (s["safe_stepsize"] > 0.0) | torch.isinf(s["decrease_error"])
    return torch.where(take_safe, s["safe_stepsize"], s["stepsize"])


def zoom_linesearch(value_and_grad, params, updates, value, grad, counts=None):
    """optax ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` along ``updates`` from ``params``, with
    ``value_and_grad(x) -> (value, gradient)``: returns the stepsize. One
    host read per iteration: the phase (interval search or zoom) and the
    end are steered from the host."""
    slope = torch.dot(updates, grad)
    s = _linesearch_init(value, slope)
    value_init, slope_init = value, slope
    interval_found = False
    it = 0
    while True:
        last = it + 1 >= MAX_LINESEARCH_STEPS
        if interval_found:
            new_stepsize, too_small_int = _zoom_candidate(s)
        else:
            new_stepsize = s["stepsize"] + 1.0 if it == 0 else INCREASE_FACTOR * s["stepsize"]
        v, g = value_and_grad(params + new_stepsize * updates)
        sl = torch.dot(g, updates)
        dec = _decrease_error(new_stepsize, v, sl, value_init, slope_init)
        err = torch.maximum(dec, _curvature_error(sl, slope_init))
        done = err <= TOL
        if interval_found:
            s = _zoom_update(s, new_stepsize, v, sl, dec)
            presumably_failed = too_small_int & (s["safe_stepsize"] > 0.0)
            if last:
                presumably_failed = torch.ones_like(presumably_failed)
            failed = presumably_failed & ~done
            found = torch.ones_like(done)
        else:
            s, found = _search_update(s, new_stepsize, v, sl, dec, it == 0)
            found = found | done
            failed = ~done if last else torch.zeros_like(done)
        s.update(stepsize=new_stepsize, value=v, slope=sl, decrease_error=dec)
        it += 1
        flags = torch.stack([found, done, failed]).tolist()  # the one host read
        _add(counts, "host_reads")
        _add(counts, "linesearch_steps")
        interval_found, is_done, is_failed = flags
        if is_failed:
            s["stepsize"] = _safe_step(s)
        if is_done or is_failed:
            return s["stepsize"]


def zoom_linesearch_rows(value_and_grad, params, updates, value, grad, counts=None):
    """:func:`zoom_linesearch` for every row of ``params`` (N, d) at once,
    as ``jax.vmap`` runs optax's: each row has its own phase, state and
    ``done``/``failed`` (scalars as (N, 1)); a finished row is frozen
    while the others go on. Each iteration takes each active row's trial
    stepsize from its phase, evaluates the objective once on the whole
    batch (rows are independent, so this is each row's own evaluation) and
    updates every state by ``torch.where``. One host read per iteration:
    whether any row is still active. Returns the stepsizes (N, 1)."""
    slope = _rowdot(updates, grad)
    s = _linesearch_init(value, slope)
    value_init, slope_init = value, slope
    interval_found = torch.zeros_like(value, dtype=torch.bool)
    active = torch.ones_like(interval_found)
    it = 0
    while True:
        last = it + 1 >= MAX_LINESEARCH_STEPS
        middle, too_small_int = _zoom_candidate(s)
        grown = s["stepsize"] + 1.0 if it == 0 else INCREASE_FACTOR * s["stepsize"]
        # a finished row is evaluated at its last point and keeps its state
        new_stepsize = torch.where(active, torch.where(interval_found, middle, grown),
                                   s["stepsize"])
        v, g = value_and_grad(params + new_stepsize * updates)
        sl = _rowdot(g, updates)
        dec = _decrease_error(new_stepsize, v, sl, value_init, slope_init)
        err = torch.maximum(dec, _curvature_error(sl, slope_init))
        done = err <= TOL
        search, found = _search_update(s, new_stepsize, v, sl, dec, it == 0)
        zoom = _zoom_update(s, new_stepsize, v, sl, dec)
        failed = active & ~done & torch.where(
            interval_found, too_small_int & (zoom["safe_stepsize"] > 0.0) | last,
            torch.full_like(done, last))
        for key in s:
            s[key] = torch.where(active, torch.where(interval_found, zoom[key], search[key]),
                                 s[key])
        for key, val in (("stepsize", new_stepsize), ("value", v), ("slope", sl),
                         ("decrease_error", dec)):
            s[key] = torch.where(active, val, s[key])
        s["stepsize"] = torch.where(failed, _safe_step(s), s["stepsize"])
        interval_found = interval_found | (active & (found | done))
        active = active & ~done & ~failed
        it += 1
        _add(counts, "linesearch_steps")
        _add(counts, "host_reads")
        if not bool(active.any()):  # the one host read
            return s["stepsize"]


# ---------------------------------------------------------------------------
# optax.lbfgs() for a fixed number of steps
# ---------------------------------------------------------------------------


def _lbfgs_steps(value_and_grad, linesearch, x, state, max_steps, dot, total):
    """``max_steps`` L-BFGS steps from x; a step whose iterate is not
    finite keeps x (per row in a batch). Returns (x, values at each step's
    start)."""
    values = []
    with torch.no_grad():
        for _ in range(max_steps):
            v, g = value_and_grad(x)
            precond, state = _lbfgs_update(g, state, x, dot, total)
            direction = -precond
            x_new = x + linesearch(value_and_grad, x, direction, v, g) * direction
            x = torch.where(total((~torch.isfinite(x_new)).to(x.dtype)) == 0, x_new, x)
            values.append(v)
    return x, torch.stack(values)


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
    value_and_grad = _ValueAndGrad(objective, x, counts)

    def linesearch(vg, x, direction, v, g):
        return zoom_linesearch(vg, x, direction, v, g, counts)

    return _lbfgs_steps(value_and_grad, linesearch, x, _lbfgs_init(x), max_steps, torch.dot,
                        torch.sum)


def lbfgs_solve_batched(objective, X0, max_steps: int = 60, counts=None):
    """``jax.vmap(lbfgs_solve)`` over the rows of ``X0`` (N, d), for a
    row-separable ``objective``: (N, d) → (N,), row i a function of row i
    alone. Every row runs optax L-BFGS as :func:`lbfgs_solve` does, with its
    own memory, preconditioner scale and linesearch
    (:func:`zoom_linesearch_rows`); all rows take ``max_steps`` steps, and a
    row whose iterate is not finite keeps its point. One evaluation of the
    objective serves all rows at each linesearch iteration. Returns (X, the
    values (max_steps, N) at each step's start). ``counts`` as in
    :func:`lbfgs_solve` (no graph captures: the evaluation runs eagerly)."""
    x = X0.detach().clone()

    def value_and_grad(X):
        th = X.detach().requires_grad_(True)
        with torch.enable_grad():
            v = objective(th)
            # the gradient of the sum is each row's own
            (g,) = torch.autograd.grad(v.sum(), th)
        _add(counts, "evaluations")
        return v.detach().unsqueeze(-1), g

    def linesearch(vg, x, direction, v, g):
        return zoom_linesearch_rows(vg, x, direction, v, g, counts)

    x, values = _lbfgs_steps(value_and_grad, linesearch, x, _lbfgs_init(x, (x.shape[0], 1)),
                             max_steps, _rowdot, _rowsum)
    return x, values[..., 0]


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
