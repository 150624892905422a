"""Parity of the port's infer/training.py (its hand-written optax L-BFGS and
the toy trainers) and utils/optim.py with the JAX package's, on the CPU.

- ``lbfgs_solve`` on the toy-regression θ objective, started from the JAX
  package's first-epoch (μ_v, Uv, w̄) through ``convert.vmp_state_from_jax``,
  and on an ill-scaled quadratic (curvatures 1 and 1e4, where the
  preconditioner's scaling and the zoom's interpolation both matter); and
  on an objective that goes NaN past a wall, which the linesearch must
  treat as outside the domain. θ is held to 1e-8 relative: relative
  perturbations of y of 1e-15…1e-11 move JAX's own θ by less than that
  (its value by ≤ 3.6e-9), so a faithful port lands there too
  (measured ~1e-10).
- The number of linesearch iterations of every L-BFGS step equals optax's
  own ``ZoomLinesearchInfo.num_linesearch_steps``, step for step, until the
  objective reaches its rounding floor (past it rounding decides which
  trial point passes, in either package); and on an objective that is NaN
  everywhere but at the start, every linesearch exhausts its 20 iterations
  and takes no step, with the sᵀy = 0 pair weighted 0, as in optax.
- ``fit_regression`` and ``fit_classification`` one epoch at a time, each
  epoch resumed from JAX's θ: θ to 1e-8 relative, the free energy to 1e-9
  relative (the VMP free energy's own bound, tests/test_torch_batch_vmp.py).
- ``utils/optim.py``: ``adamax`` against ``optax.adamax`` over 25 steps
  (1e-12 relative); ``lbfgs_minimize`` and ``nelder_mead`` run the same scipy
  routine on both packages' values, held to 1e-9 (the values agree to
  ~1e-15, and scipy's iterates follow them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.dists import gamma_mean as jgamma_mean
from gaussianprocessnode_tpu.infer import batch_vmp as jb
from gaussianprocessnode_tpu.infer import training as jt
from gaussianprocessnode_tpu.objectives import neg_log_backwardmess_fast as jobjective
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.linalg import rv_chol_upper as jrv
from gaussianprocessnode_tpu.utils import optim as joptim
from gaussianprocessnode_tpu.utils.datasets import toy_classification, toy_sinc
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat, gamma_mean
from gaussianprocessnode_tpu_torch.infer import training as tt
from gaussianprocessnode_tpu_torch.objectives import neg_log_backwardmess_fast as tobjective
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.linalg import rv_chol_upper
from gaussianprocessnode_tpu_torch.utils import optim as toptim

JK = JKernel("se", transform="softplus")
TK = Kernel("se", transform="softplus", use_kernel=True)
THETA_RTOL = 1e-8
FE_RTOL = 1e-9
THETA0 = np.log(np.expm1(np.ones(2)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def rel(got, want):
    g, w = _np(got), _np(want)
    return np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-300))


def problem(kind):
    if kind == "regression":
        d, M, lim = toy_sinc(), 20, 4.0
    else:
        d, M, lim = toy_classification(), 15, 5.0
    arrays = dict(Xu=np.linspace(-lim, lim, M)[:, None], X=d.x_train, y=d.y_train,
                  xi=np.zeros(M), prec=np.eye(M) / 50.0, a=np.asarray(1e-2), b=np.asarray(1e-2))
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.as_tensor(np.array(v, np.float64)) for k, v in arrays.items()}
    j["prior_v"], j["prior_w"] = JNat(j["xi"], j["prec"]), JGamma(j["a"], j["b"])
    t["prior_v"], t["prior_w"] = MvGaussianNat(t["xi"], t["prec"]), GammaShapeRate(t["a"], t["b"])
    return j, t


@pytest.fixture(scope="module")
def toy_objectives():
    """JAX's first-epoch VMP result on the toy regression, its θ objective,
    and the port's objective built from the same state through
    convert.vmp_state_from_jax."""
    j, t = problem("regression")
    res = jb.regression_vmp(JK, jnp.asarray(THETA0), j["Xu"], j["X"], j["y"], j["prior_v"],
                            j["prior_w"], n_iters=7)
    mu, Uv, w = res.qv.mean, jrv(res.qv.mean, res.qv.cov), jgamma_mean(res.qw)

    def jf(th):
        return jobjective(th, kernel=JK, Xu=j["Xu"], X=j["X"], y=j["y"], mu_v=mu, Uv=Uv, w=w)

    th0, tres = convert.vmp_state_from_jax(jax.tree.map(np.asarray, res), THETA0, device="cpu")
    tmu = tres.qv.mean
    tUv = rv_chol_upper(tmu, tres.qv.cov)
    tw = gamma_mean(tres.qw)

    def tf(th):
        return tobjective(th, kernel=TK, Xu=t["Xu"], X=t["X"], y=t["y"], mu_v=tmu, Uv=tUv, w=tw)

    return jf, tf, th0, res, tres


def test_vmp_state_from_jax_keeps_every_field(toy_objectives):
    _, _, th0, res, tres = toy_objectives
    np.testing.assert_array_equal(th0.numpy(), THETA0)
    for g, w in [(tres.qv.mean, res.qv.mean), (tres.qv.cov, res.qv.cov),
                 (tres.qv_nat.xi, res.qv_nat.xi), (tres.qv_nat.prec, res.qv_nat.prec),
                 (tres.qw.shape, res.qw.shape), (tres.qw.rate, res.qw.rate), (tres.Uv, res.Uv),
                 (tres.free_energy, res.free_energy)]:
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert g.dtype == torch.float64
    assert tres.qf is None
    _, cres = convert.vmp_state_from_jax(
        jax.tree.map(np.asarray, jb.classification_vmp(
            JK, jnp.asarray(THETA0), *(problem("classification")[0][k] for k in ("Xu", "X", "y")),
            problem("classification")[0]["prior_v"], problem("classification")[0]["prior_w"],
            problem("classification")[0]["prior_w"], n_iters=2)), THETA0, device="cpu")
    assert cres.qf is not None and cres.qf.mean.shape == (100,)


@pytest.mark.parametrize("th,grad_rtol", [
    (THETA0, 1e-8), ([0.50388678, 0.54250778], 1e-8), ([-2.0, 1.5], 1e-8), ([0.3, -1.0], 1e-12)],
    ids=["theta0", "optimum", "long_lengthscale", "short_lengthscale"])
def test_objective_and_gradient_match_jax(toy_objectives, th, grad_rtol):
    """The value to 1e-12 relative. The gradient is held to a bound on the
    value's magnitude, which its terms cancel from (at the optimum it is
    ~1e-6 of terms of order 100): 1e-12 where Kuu is well conditioned (ℓ =
    0.31), 1e-8 where its solves carry κ(Kuu) ≈ 4.6e8 (ℓ ≈ 1: κ·ε ≈ 1e-7 of
    those terms; measured up to 2.8e-10)."""
    jf, tf, th0, _, _ = toy_objectives
    th = np.asarray(th, np.float64)
    t = torch.as_tensor(th).requires_grad_(True)
    v = tf(t)
    (g,) = torch.autograd.grad(v, t)
    jv, jg = jf(jnp.asarray(th)), np.asarray(jax.grad(jf)(jnp.asarray(th)))
    assert rel(v, jv) <= 1e-12
    bound = grad_rtol * max(abs(float(jv)), np.max(np.abs(jg)))
    assert np.max(np.abs(_np(g) - jg)) <= bound
    assert np.max(np.abs(_np(tt_grad(th)) - jg)) <= bound


@pytest.mark.parametrize("method", ["GaussHermite", "GenUT", "SphericalRadial"])
def test_uncertain_input_objective_and_gradient_match_jax(method):
    """neg_log_backwardmess_uncertain and grad_uncertain at seeded Gaussian
    inputs (N = 7), M = 6 inducing inputs one unit apart and ℓ ≈ 0.47, where
    Kuu (jitter 1e-12) is well conditioned: value and gradient to 1e-12 of
    the value's magnitude."""
    from gaussianprocessnode_tpu.objectives import neg_log_backwardmess_uncertain as jobj_u
    from gaussianprocessnode_tpu.ops import quadrature as jq
    from gaussianprocessnode_tpu_torch.objectives import grad_uncertain
    from gaussianprocessnode_tpu_torch.objectives import neg_log_backwardmess_uncertain as tobj_u
    from gaussianprocessnode_tpu_torch.ops import quadrature as tq

    rng = np.random.default_rng(6)
    M, N = 6, 7
    A = rng.standard_normal((M, M)) * 0.3
    arrays = dict(Xu=np.linspace(-2.5, 2.5, M)[:, None], y=rng.standard_normal(N),
                  qx_means=rng.uniform(-2.0, 2.0, N), qx_vars=rng.uniform(0.05, 0.4, N),
                  mu_v=rng.standard_normal(M), Uv=np.linalg.cholesky(A @ A.T + np.eye(M)).T,
                  w=np.asarray(3.0))
    th = np.array([0.2, -0.4])
    jm = getattr(jq, method)()
    tm = getattr(tq, method)()
    jkw = {k: jnp.asarray(v) for k, v in arrays.items()}
    tkw = {k: torch.as_tensor(np.array(v, np.float64)) for k, v in arrays.items()}
    jv = jobj_u(jnp.asarray(th), kernel=JK, method=jm, **jkw)
    jg = np.asarray(jax.grad(lambda t: jobj_u(t, kernel=JK, method=jm, **jkw))(jnp.asarray(th)))
    tv = tobj_u(torch.as_tensor(th), kernel=TK, method=tm, **tkw)
    tg = grad_uncertain(torch.as_tensor(th), kernel=TK, method=tm, **tkw)
    scale = max(abs(float(jv)), np.max(np.abs(jg)))
    assert abs(float(tv) - float(jv)) <= 1e-12 * scale
    assert np.max(np.abs(_np(tg) - jg)) <= 1e-12 * scale


def tt_grad(th):
    """objectives.grad_fast on the toy data at the fixture's state."""
    from gaussianprocessnode_tpu_torch.objectives import grad_fast

    j, t = problem("regression")
    res = jb.regression_vmp(JK, jnp.asarray(THETA0), j["Xu"], j["X"], j["y"], j["prior_v"],
                            j["prior_w"], n_iters=7)
    _, tres = convert.vmp_state_from_jax(jax.tree.map(np.asarray, res), THETA0, device="cpu")
    return grad_fast(torch.as_tensor(th), kernel=TK, Xu=t["Xu"], X=t["X"], y=t["y"],
                     mu_v=tres.qv.mean, Uv=rv_chol_upper(tres.qv.mean, tres.qv.cov),
                     w=gamma_mean(tres.qw))


def test_lbfgs_solve_on_the_toy_objective_matches_jax(toy_objectives):
    jf, tf, th0, _, _ = toy_objectives
    jth, jvals = jax.jit(lambda x: jt.lbfgs_solve(jf, x))(jnp.asarray(THETA0))
    counts = {}
    th, vals = tt.lbfgs_solve(tf, th0, counts=counts)
    assert rel(th, jth) <= THETA_RTOL
    assert np.max(np.abs(_np(vals) - np.asarray(jvals))) <= 1e-9 * np.max(np.abs(jvals))
    assert vals.shape == (60,)
    # one host read per linesearch iteration, one evaluation more per step
    assert counts["host_reads"] == counts["linesearch_steps"]
    assert counts["evaluations"] == 60 + counts["linesearch_steps"]


def _optax_trace(f, x0, steps=60):
    """optax.lbfgs() stepped from Python, as jt.lbfgs_solve steps it: each
    step's iterate, starting value and linesearch iteration count."""
    opt = optax.lbfgs()
    vg = jax.jit(jax.value_and_grad(f))
    update = jax.jit(lambda g, s, x, v: opt.update(g, s, x, value=v, grad=g, value_fn=f))
    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    xs, vs, ls = [], [], []
    for _ in range(steps):
        v, g = vg(x)
        u, state = update(g, state, x, v)
        x_new = optax.apply_updates(x, u)
        x = jnp.where(jnp.all(jnp.isfinite(x_new)), x_new, x)
        xs.append(np.asarray(x))
        vs.append(float(v))
        ls.append(int(state[-1].info.num_linesearch_steps))
    return np.array(xs), np.array(vs), ls


def _port_trace(f, x0, steps=60):
    """The same of the port's L-BFGS, one step at a time."""
    xs, ls = [], []
    x = torch.as_tensor(x0)
    state = tt._lbfgs_init(x)
    with torch.no_grad():
        for _ in range(steps):
            v, g = tt._value_and_grad(f, x)
            precond, state = tt._lbfgs_update(g, state, x)
            counts = {}
            step = tt.zoom_linesearch(lambda z: tt._value_and_grad(f, z), x, -precond,
                                      v, g, counts)
            x_new = x + step * (-precond)
            x = torch.where(torch.all(torch.isfinite(x_new)), x_new, x)
            xs.append(x.numpy().copy())
            ls.append(counts["linesearch_steps"])
    return np.array(xs), ls


def _above_noise_floor(values):
    """The leading steps whose starting value is still above the final one
    by more than 1e-12 of it: past them the objective has reached its
    rounding floor (it then moves by ~1e-15 relative from step to step, in
    either package), and which trial points pass the linesearch's tests is
    decided by rounding."""
    final = values[-1]
    above = values - final > 1e-12 * max(abs(final), 1.0)
    return int(np.argmin(above)) if not above.all() else len(values)


def test_linesearch_iterations_match_optax_step_by_step(toy_objectives):
    jf, tf, _, _, _ = toy_objectives
    jxs, jvs, jls = _optax_trace(jf, THETA0, steps=20)
    txs, tls = _port_trace(tf, THETA0, steps=20)
    n = _above_noise_floor(jvs)
    assert n >= 5
    assert tls[:n] == jls[:n]
    assert np.max(np.abs(txs - jxs) / np.abs(jxs)) <= THETA_RTOL


def _nowhere_jax(x):
    # NaN at every point but the start: every linesearch runs out
    return jnp.sum((x - 2.0) ** 2) + jnp.where(jnp.any(x != 0.5), jnp.nan, 0.0)


def _nowhere_torch(x):
    return torch.sum((x - 2.0) ** 2) + torch.where(torch.any(x != 0.5), float("nan"), 0.0)


def test_an_exhausted_linesearch_takes_no_step_as_in_optax():
    """Every trial point is NaN (outside the domain): each linesearch runs
    its 20 iterations, fails with no safe step, and returns stepsize 0, so
    x never moves; the L-BFGS memory then sees sᵀy = 0 and stores the pair
    with weight 0, and the preconditioner's scale falls back to 1. Step for
    step as optax."""
    x0 = np.full(2, 0.5)
    jxs, _, jls = _optax_trace(_nowhere_jax, x0, steps=4)
    txs, tls = _port_trace(_nowhere_torch, x0, steps=4)
    assert jls == tls == [tt.MAX_LINESEARCH_STEPS] * 4
    np.testing.assert_array_equal(txs, jxs)
    np.testing.assert_array_equal(txs[-1], x0)
    th, vals = tt.lbfgs_solve(_nowhere_torch, torch.as_tensor(x0), max_steps=3)
    np.testing.assert_array_equal(th.numpy(), x0)
    state = tt._lbfgs_init(torch.as_tensor(x0))
    g = torch.tensor([-3.0, -3.0], dtype=torch.float64)
    _, state = tt._lbfgs_update(g, state, torch.as_tensor(x0))
    p, state = tt._lbfgs_update(g, state, torch.as_tensor(x0))
    assert float(state.weights_memory[0]) == 0.0
    np.testing.assert_array_equal(p.numpy(), g.numpy())  # scale 1, no pair: P = I


ILL_D = np.array([1.0, 1e4])
ILL_C = np.array([3.0, -0.02])


def _ill_jax(x):
    d = x - jnp.asarray(ILL_C)
    return 0.5 * jnp.sum(jnp.asarray(ILL_D) * d * d) + 0.1 * jnp.sum(d**4)


def _ill_torch(x):
    d = x - torch.as_tensor(ILL_C)
    return 0.5 * torch.sum(torch.as_tensor(ILL_D) * d * d) + 0.1 * torch.sum(d**4)


def _wall_jax(x):
    return jnp.sum((x - 2.0) ** 2) + jnp.where(x[0] > 1.0, jnp.nan, 0.0)


def _wall_torch(x):
    return torch.sum((x - 2.0) ** 2) + torch.where(x[0] > 1.0, float("nan"), 0.0)


@pytest.mark.parametrize("fj,ft,x0", [(_ill_jax, _ill_torch, [0.0, 1.0]),
                                      (_wall_jax, _wall_torch, [-3.0, 0.5])],
                         ids=["ill_scaled_quadratic", "nan_past_a_wall"])
def test_lbfgs_solve_matches_jax(fj, ft, x0):
    x0 = np.asarray(x0, np.float64)
    jth, jvals = jax.jit(lambda x: jt.lbfgs_solve(fj, x))(jnp.asarray(x0))
    th, vals = tt.lbfgs_solve(ft, torch.as_tensor(x0))
    scale = np.maximum(np.abs(np.asarray(jth)), 1e-3)
    assert np.max(np.abs(_np(th) - np.asarray(jth)) / scale) <= THETA_RTOL
    np.testing.assert_allclose(_np(vals), np.asarray(jvals), rtol=1e-8, atol=1e-12)
    jxs, jvs, jls = _optax_trace(fj, x0, steps=12)
    _, tls = _port_trace(ft, x0, steps=12)
    n = _above_noise_floor(jvs)
    assert n >= 3
    assert tls[:n] == jls[:n]
    assert bool(torch.all(torch.isfinite(th)))


def test_a_non_finite_iterate_is_rejected_and_the_state_advances():
    """An objective whose gradient is NaN at the start gives a NaN direction:
    every step's iterate is rejected and x stays at x0 for all 60 steps,
    as in JAX."""
    def jf(x):
        return jnp.sum(jnp.sqrt(x - 1.0))  # x0 = 0: NaN value and gradient

    def tf(x):
        return torch.sum(torch.sqrt(x - 1.0))

    x0 = np.zeros(2)
    jth, _ = jax.jit(lambda x: jt.lbfgs_solve(jf, x))(jnp.asarray(x0))
    th, vals = tt.lbfgs_solve(tf, torch.as_tensor(x0))
    np.testing.assert_array_equal(_np(th), np.asarray(jth))
    np.testing.assert_array_equal(_np(th), x0)
    assert vals.shape == (60,) and bool(torch.all(torch.isnan(vals)))


# ---------------------------------------------------------------------------
# the trainers, one epoch at a time from JAX's θ
# ---------------------------------------------------------------------------

_jfit_reg = jax.jit(lambda th, Xu, X, y, pv, pw: jt.fit_regression(
    JK, th, Xu, X, y, pv, pw, epochs=1))


def _jfit_cls(product):
    return jax.jit(lambda th, Xu, X, y, pv, pw: jt.fit_classification(
        JK, th, Xu, X, y, pv, pw, pw, epochs=1, probit_product=product))


def test_fit_regression_epoch_by_epoch_matches_jax():
    j, t = problem("regression")
    theta = jnp.asarray(THETA0)
    for _ in range(3):
        jth, jfe, jres = _jfit_reg(theta, j["Xu"], j["X"], j["y"], j["prior_v"], j["prior_w"])
        th, fe, res = tt.fit_regression(TK, torch.as_tensor(np.asarray(theta)), t["Xu"], t["X"],
                                        t["y"], t["prior_v"], t["prior_w"], epochs=1)
        assert rel(th, jth) <= THETA_RTOL
        assert rel(fe, jfe) <= FE_RTOL
        assert rel(res.free_energy, jres.free_energy) <= FE_RTOL
        theta = jth


@pytest.mark.parametrize("product", ["exact", "gh32"])
def test_fit_classification_epoch_by_epoch_matches_jax(product):
    j, t = problem("classification")
    fit = _jfit_cls(product)
    theta = jnp.asarray(THETA0)
    for _ in range(2 if product == "exact" else 1):
        jth, jfe, jres = fit(theta, j["Xu"], j["X"], j["y"], j["prior_v"], j["prior_w"])
        th, fe, res = tt.fit_classification(TK, torch.as_tensor(np.asarray(theta)), t["Xu"],
                                            t["X"], t["y"], t["prior_v"], t["prior_w"],
                                            t["prior_w"], epochs=1, probit_product=product)
        assert rel(th, jth) <= THETA_RTOL
        assert rel(fe, jfe) <= FE_RTOL
        assert rel(res.free_energy, jres.free_energy) <= FE_RTOL
        assert rel(res.qf.mean, jres.qf.mean) <= 1e-8
        theta = jth


def test_fit_with_zero_epochs_returns_the_start():
    _, t = problem("regression")
    th0 = torch.as_tensor(THETA0)
    th, fe, res = tt.fit_regression(TK, th0, t["Xu"], t["X"], t["y"], t["prior_v"],
                                    t["prior_w"], epochs=0)
    assert torch.equal(th, th0) and fe.shape == (0,)


# ---------------------------------------------------------------------------
# utils/optim.py
# ---------------------------------------------------------------------------


def test_adamax_matches_optax_adamax():
    opt = toptim.adamax()
    jopt = joptim.adamax()
    x = np.array([0.3, -1.2, 2.0])
    tx = torch.as_tensor(x)
    state, jstate, jx = opt.init(tx), jopt.init(jnp.asarray(x)), jnp.asarray(x)
    for k in range(25):
        g = np.sin(np.arange(3) + k) * (1.0 + k)
        tx = tx + opt.update_(torch.as_tensor(g), state)
        u, jstate = jopt.update(jnp.asarray(g), jstate)
        jx = optax.apply_updates(jx, u)
    assert rel(tx, jx) <= 1e-12
    assert opt.learning_rate == 0.002


@pytest.mark.parametrize("decay", [1.0, 0.2])
def test_adamax_is_bare_optax_adamax_on_a_nan_gradient(decay):
    """No zero_nans, no clipping: the NaN reaches θ and the state as NaN in
    both packages, at the same positions; the finite entries and the state
    (ScaleByAdamState, plus ScaleByScheduleState with a decaying rate) agree
    to 1e-12. The trainers' chains keep their zero_nans (checked last)."""
    lr = 0.01
    if decay == 1.0:
        opt, jopt = toptim.adamax(lr), joptim.adamax(lr)
    else:
        opt = toptim.adamax(lr, decay_rate=decay, transition_steps=10)
        jopt = optax.adamax(optax.exponential_decay(lr, transition_steps=10, decay_rate=decay))
    x = np.array([0.1, 0.2, 0.3])
    tx = torch.as_tensor(x)
    state, jstate, jx = opt.init(tx), jopt.init(jnp.asarray(x)), jnp.asarray(x)
    assert "found_nan" not in state
    for g in (np.array([np.nan, 1.0, -1.0]), np.array([0.5, -2.0, 3.0])):
        tx = tx + opt.update_(torch.as_tensor(g), state)
        u, jstate = jopt.update(jnp.asarray(g), jstate)
        jx = optax.apply_updates(jx, u)
    jadam = jstate[0]  # (ScaleByAdamState, EmptyState or ScaleByScheduleState)
    pairs = [(tx, jx), (state["mu"], jadam.mu), (state["nu"], jadam.nu)]
    for t, j in pairs:
        t, j = _np(t), np.asarray(j)
        assert np.array_equal(np.isnan(t), np.isnan(j)) and np.isnan(t[0])
        np.testing.assert_allclose(t[1:], j[1:], rtol=1e-12)
    assert int(state["count"]) == int(jadam.count) == 2
    if decay != 1.0:
        assert int(state["lr_count"]) == int(jstate[-1].count) == 2
    # the trainers' chain still zeroes the NaN
    from gaussianprocessnode_tpu_torch.infer.minibatch import default_optimizer

    chain = default_optimizer(lr)
    cs = chain.init(torch.as_tensor(x))
    upd = chain.update_(torch.as_tensor([np.nan, 1.0, -1.0]), cs)
    assert bool(torch.isfinite(upd).all()) and float(upd[0]) == 0.0 and bool(cs["found_nan"])


def _rosen_np(x):
    return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2))


def test_lbfgs_minimize_and_nelder_mead_match_jax():
    def tvg(x, scale):
        x = x.detach().requires_grad_(True)
        v = scale * torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
        (g,) = torch.autograd.grad(v, x)
        return v, g

    jvg = jax.jit(jax.value_and_grad(
        lambda x, s: s * jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)))
    x0 = np.array([-1.2, 1.0, 0.5])
    tx, tv = toptim.lbfgs_minimize(tvg, torch.as_tensor(x0), args=(2.0,), maxiter=50)
    jx, jv = joptim.lbfgs_minimize(jvg, jnp.asarray(x0), args=(2.0,), maxiter=50)
    assert np.max(np.abs(_np(tx) - np.asarray(jx))) <= 1e-9
    assert abs(tv - jv) <= 1e-9 * max(abs(jv), 1.0)
    tx, tv, th = toptim.nelder_mead(lambda x: torch.tensor(_rosen_np(x.numpy()), dtype=torch.float64),
                                    torch.as_tensor(x0), maxiter=40)
    jx, jv, jh = joptim.nelder_mead(lambda x: _rosen_np(np.asarray(x)), jnp.asarray(x0),
                                    maxiter=40)
    assert np.max(np.abs(_np(tx) - np.asarray(jx))) <= 1e-9
    np.testing.assert_allclose(th, jh, rtol=1e-12)
