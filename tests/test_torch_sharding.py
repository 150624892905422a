"""The port's data-parallel layer (parallel/sharding.py, serve.shard_requests)
on P = 2 and 4 gloo ranks, against the JAX package's on the same number of
virtual CPU devices and against the port's single-device functions.

One spawn per rank count runs every data-parallel function on every rank
(``tests/_torch_dist_ranks.py::sharding_rank``); the JAX counterparts run
here on a mesh of the first P of the 8 virtual devices that
``tests/conftest.py`` sets up, on the same numpy-seeded inputs. Gloo's
all-reduce sums the ranks' partial sums in another order than the JAX psum
and than one device's single contraction, so the two agree to float64
round-off of that reordering, with the JAX package's own bands for the same
comparison (``tests/test_sharding.py``): the natural parameters 1e-10
relative, μ_v 1e-8, θ after a step 1e-8 absolute and after the trainers
1e-9, Λ 1e-6 of its largest entry, Σ_v 1e-8 of its largest, the q(w) rate
1e-8 relative. The carry every rank holds is replicated: bit-equal across
ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist_ranks as R
from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.parallel import sharding as jsh
from gaussianprocessnode_tpu_torch import convert, serve
from gaussianprocessnode_tpu_torch.dists import GammaShapeRate
from gaussianprocessnode_tpu_torch.infer.minibatch import fit_banana_fast, fit_kin40k_fast
from gaussianprocessnode_tpu_torch.objectives import neg_log_backwardmess_gram
from gaussianprocessnode_tpu_torch.ops.linalg import ir_solve, spd_inverse, sym
from gaussianprocessnode_tpu_torch.parallel.comm import spawn_ranks
from gaussianprocessnode_tpu_torch.utils.optim import adamax

JK = JKernel("se", transform="softplus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _jax_refs(P):
    """The JAX package's data-parallel functions on a P-device mesh."""
    mesh = jsh.make_mesh(jax.devices()[:P])
    out = {}
    c = R.sweep_case()
    Xs, ys = jsh.shard_data(mesh, _j(c["X"]), _j(c["y"]))
    prior = JNat(jnp.zeros(12), jnp.eye(12) / 50.0)
    # jitted as the JAX dry run jits its step (eager, each op of the
    # shard_map dispatches on its own: 20× slower here)
    sweep = jax.jit(lambda th, X_, y_: jsh.dp_regression_sweep(JK, th, _j(c["Xu"]), X_, y_,
                                                               prior, c["w"], mesh))
    out["sweep"] = _np_tree(sweep(_j(c["theta"]), Xs, ys))
    opt = optax.adamax(0.001)
    th = _j(c["theta"])
    step = jax.jit(lambda th, os_, X_, y_: jsh.dp_train_step(JK, th, os_, opt, _j(c["Xu"]), X_,
                                                             y_, prior, c["w"], mesh)[0])
    out["step_theta"] = np.asarray(step(th, opt.init(th), Xs, ys))

    k = R.trainer_case()
    Xs, ys = jsh.shard_batched_data(mesh, _j(k["Xb"]), _j(k["yb"]))
    prior32 = JNat(jnp.zeros(32), jnp.eye(32) / 50.0)
    args = (JK, _j(k["theta0"]), _j(k["Xu"]), Xs, ys, prior32, k["w"])
    out["kin40k"] = _np_tree(jsh.fit_kin40k_fast_dp(*args, 2, mesh))
    out["kin40k_carry1"] = _np_tree(jsh.fit_kin40k_fast_dp(*args, 1, mesh)[3])

    b = R.banana_case()
    Xs, ys = jsh.shard_batched_data(mesh, _j(b["Xb"]), _j(b["yb"]))
    args = (JK, _j(b["theta0"]), _j(b["Xu"]), Xs, ys, prior32,
            JGamma(jnp.asarray(1e-2), jnp.asarray(1e-2)))
    out["banana"] = _np_tree(jsh.fit_banana_fast_dp(*args, 2, mesh))
    out["banana_carry1"] = _np_tree(jsh.fit_banana_fast_dp(*args, 1, mesh)[3])
    return out


def _served_case():
    """A regression handle on the sweep problem's θ and Xu, and 4 request
    batches of 24 rows (divisible by 2 and 4)."""
    c = R.sweep_case()
    r = np.random.default_rng(11)
    mu = r.standard_normal(12)
    handle = serve.SGPRegressor(R.KER, R.t(c["theta"]), R.t(c["Xu"]), R.t(mu),
                                torch.full((), c["w"], dtype=R.F64))
    return handle, R.t(r.standard_normal((8, 24, 2)))


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def run(request):
    P = request.param
    jax_out = _jax_refs(P)
    kin_resume = convert.fast_dp_state_from_jax(jax_out["kin40k_carry1"], device="cpu",
                                                mesh_size=P)
    banana_resume = convert.banana_state_from_jax(jax_out["banana_carry1"], device="cpu",
                                                  mesh_size=P)
    ranks = spawn_ranks(R.sharding_rank, P, "gloo", kin_resume, banana_resume, _served_case(),
                        timeout_s=240)
    return P, jax_out, ranks


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _single_sweep():
    """The sweep on one device: the whole data's increments, the same solve."""
    c = R.sweep_case()
    K = R.KER(R.t(c["theta"]), R.t(c["Xu"]), R.t(c["X"]))
    prior = R.nat_prior(12)
    xi = prior.xi + c["w"] * (K @ R.t(c["y"]))
    prec = sym(prior.prec + c["w"] * (K @ K.T))
    cov = spd_inverse(prec, iters=40)
    return ir_solve(prec, xi, cov, rounds=2), cov, xi, prec


def test_dp_sweep_matches_jax_and_one_device(run):
    P, jx, ranks = run
    mu, _, nat = ranks[0]["sweep"]
    jmu, _, jnat = jx["sweep"]
    _close(nat.xi, jnat.xi, rtol=1e-10)
    _close(nat.prec, jnat.prec, rtol=1e-10)
    _close(mu, jmu, rtol=1e-8)
    smu, _, sxi, sprec = _single_sweep()
    _close(nat.xi, sxi, rtol=1e-10)
    _close(nat.prec, sprec, rtol=1e-10)
    _close(mu, smu, rtol=1e-8)


def test_dp_train_step_matches_jax_and_one_device(run):
    P, jx, ranks = run
    theta = ranks[0]["step_theta"]
    _close(theta, jx["step_theta"], atol=1e-8)
    c = R.sweep_case()
    mu, cov, _, _ = _single_sweep()
    th = R.t(c["theta"]).requires_grad_(True)
    loss, _ = neg_log_backwardmess_gram(th, kernel=R.KER, Xu=R.t(c["Xu"]), X=R.t(c["X"]),
                                        y=R.t(c["y"]), mu_v=mu, Rv=cov + torch.outer(mu, mu),
                                        w=c["w"], ns_iters=40, kuu_jitter=1e-8)
    (g,) = torch.autograd.grad(loss, th)
    opt = adamax(0.001)
    want = R.t(c["theta"]) + opt.update_(g, opt.init(R.t(c["theta"])))
    _close(theta, want, atol=1e-8)


def _kin40k_one_device(epochs):
    k = R.trainer_case()
    return fit_kin40k_fast(R.KER, R.t(k["theta0"]), R.t(k["Xu"]), R.t(k["Xb"]), R.t(k["yb"]),
                           R.nat_prior(32), k["w"], epochs)


def _held_kin40k(got, want_theta, want_prec, want_cov):
    theta, nat, cov, _ = got
    _close(theta, want_theta, atol=1e-9)
    _close(nat.prec, want_prec, rtol=1e-10, atol=1e-6 * float(np.abs(want_prec).max()))
    _close(cov, want_cov, atol=1e-8 * float(np.abs(want_cov).max()))


def test_dp_kin40k_trainer_matches_jax_and_one_device(run):
    P, jx, ranks = run
    jth, jnat, jcov, _ = jx["kin40k"]
    _held_kin40k(ranks[0]["kin40k"], jth, jnat.prec, jcov)
    th, nat, cov, _ = _kin40k_one_device(2)
    _held_kin40k(ranks[0]["kin40k"], th, nat.prec, cov)


def test_dp_kin40k_trainer_resumes_a_jax_carry(run):
    """One epoch from JAX's carry after one (``convert.fast_dp_state_from_jax``)
    is JAX's second epoch."""
    P, jx, ranks = run
    jth, jnat, jcov, _ = jx["kin40k"]
    _held_kin40k(ranks[0]["kin40k_resumed"], jth, jnat.prec, jcov)


@pytest.mark.parametrize("trainer", ["kin40k", "banana"])
def test_jax_dp_moments_are_mesh_size_times_the_ports(run, trainer):
    """The JAX DP trainers psum a gradient that ``jax.grad`` already summed
    over the mesh: their AdaMax moments are P times the full-batch ones
    (the port's), and θ agrees regardless. After 2 epochs the two sets of
    gradients differ by the reordering's round-off carried through θ
    (measured ≤ 7e-9 relative, banana's smaller moments); 1e-6 tells that
    apart from the factor P."""
    P, jx, ranks = run
    adam = jx[trainer][3][4 if trainer == "kin40k" else 5][2][0]  # optax's ScaleByAdamState
    opt = ranks[0][trainer][3].opt_state
    _close(np.asarray(adam.mu) / P, opt["mu"], rtol=1e-6)
    _close(np.asarray(adam.nu) / P, opt["nu"], rtol=1e-6)


def _held_banana(got, want_theta, want_prec, want_shape, want_rate):
    theta, nat, qw, _ = got
    _close(theta, want_theta, atol=1e-9)
    _close(nat.prec, want_prec, atol=1e-6 * float(np.abs(want_prec).max()))
    _close(qw.rate, want_rate, rtol=1e-8)
    _close(qw.shape, want_shape, rtol=1e-12)


def test_dp_banana_trainer_matches_jax_and_one_device(run):
    P, jx, ranks = run
    jth, jnat, jqw, _ = jx["banana"]
    _held_banana(ranks[0]["banana"], jth, jnat.prec, jqw.shape, jqw.rate)
    b = R.banana_case()
    prior_w = GammaShapeRate(torch.full((), 1e-2, dtype=R.F64), torch.full((), 1e-2, dtype=R.F64))
    th, nat, qw, _ = fit_banana_fast(R.KER, R.t(b["theta0"]), R.t(b["Xu"]), R.t(b["Xb"]),
                                     R.t(b["yb"]), R.nat_prior(32), prior_w, 2)
    _held_banana(ranks[0]["banana"], th, nat.prec, qw.shape, qw.rate)
    # the global point count, not this rank's, enters the q(w) shape
    assert float(ranks[0]["banana"][2].shape) == pytest.approx(1e-2 + 2 * 0.5 * 4 * 32)


def test_dp_banana_trainer_resumes_a_jax_carry(run):
    P, jx, ranks = run
    jth, jnat, jqw, _ = jx["banana"]
    _held_banana(ranks[0]["banana_resumed"], jth, jnat.prec, jqw.shape, jqw.rate)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    return [v for item in x for v in _leaves(item)]


@pytest.mark.parametrize("key", ["sweep", "step_theta", "kin40k", "kin40k_resumed", "banana",
                                 "banana_resumed"])
def test_replicated_results_are_bit_equal_across_ranks(run, key):
    P, _, ranks = run
    first = _leaves(ranks[0][key])
    assert len(first) > 0
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, _leaves(r[key]))), key


def test_uneven_sizes_raise_the_jax_messages(run):
    P, _, ranks = run
    for r in ranks:
        assert "does not shard evenly" in r["errors"]["shard_data"]
        assert "is not divisible by the" in r["errors"]["shard_batched_data"]


def test_shard_requests_serves_each_rank_its_slice(run):
    """Each rank serves its slice with no collective; the slices, in rank
    order, are single-device serving."""
    P, _, ranks = run
    handle, X = _served_case()
    means, vars_ = serve.serve_fused(handle, X)
    assert all(r["served_rows"] == X.shape[0] // P for r in ranks)
    _close(torch.cat([r["served"][0] for r in ranks]), means, rtol=1e-12, atol=1e-14)
    _close(torch.cat([r["served"][1] for r in ranks]), vars_, rtol=0)
