"""Rank functions and shared inputs for the parallel layer's CPU tests.

The port's parallel functions run one process per rank
(``parallel/comm.py::spawn_ranks``), which pickles each rank function by
its module: they live here, in a module that imports torch, numpy and the
port and nothing of JAX, so a rank never imports JAX. The inputs are drawn
from numpy seeds by the ``*_case`` functions, which the test modules call
too, to feed the JAX counterparts the same arrays.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.parallel import comm
from gaussianprocessnode_tpu_torch.parallel import seq_parallel as sp
from gaussianprocessnode_tpu_torch.parallel import sharding as sh
from gaussianprocessnode_tpu_torch.parallel import tensor_parallel as tp
from gaussianprocessnode_tpu_torch.utils.optim import adamax

KER = Kernel("se", transform="softplus")
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def nat_prior(M, var=50.0):
    return MvGaussianNat(torch.zeros(M, dtype=F64), torch.eye(M, dtype=F64) / var)


# --- data parallelism --------------------------------------------------------

def sweep_case():
    """The JAX sharding tests' sweep problem: M = 12, D = 2, N = 64."""
    r = np.random.default_rng(0)
    M, D, N = 12, 2, 64
    return dict(Xu=r.standard_normal((M, D)), X=r.standard_normal((N, D)),
                y=r.standard_normal(N), theta=np.log(np.expm1(np.ones(D + 1))), w=100.0)


def trainer_case():
    """kin40k-shaped trainer inputs at a small width: M = 32, Din = 3,
    B = 4 batches of 64 (divisible by 2 and 4 ranks), w = 100."""
    r = np.random.default_rng(2)
    M, Din, B, batch = 32, 3, 4, 64
    return dict(Xu=r.standard_normal((M, Din)), Xb=r.standard_normal((B, batch, Din)),
                yb=r.standard_normal((B, batch)), theta0=np.log(np.expm1(np.ones(Din + 1))),
                w=100.0)


def banana_case():
    """Banana-shaped inputs at a small width: M = 32, 2-D, B = 4 batches of
    32, labels in {0, 1}, q(w) prior Gamma(1e-2, 1e-2)."""
    r = np.random.default_rng(3)
    M, B, batch = 32, 4, 32
    return dict(Xu=r.standard_normal((M, 2)), Xb=r.standard_normal((B, batch, 2)),
                yb=(r.uniform(size=(B, batch)) > 0.5).astype(float),
                theta0=np.log(np.expm1(np.ones(3))))


def sharding_rank(kin_resume, banana_resume, serve_args):
    """Every data-parallel function on this rank: the regression sweep and
    train step, 2 epochs of each trainer from its cold start and 1 from a
    carry (``*_resume``, converted from JAX), the uneven-size errors, and
    this rank's slice of a served request batch."""
    out = {"rank": comm.rank(), "world": comm.world_size()}
    c = sweep_case()
    X, y = sh.shard_data(t(c["X"]), t(c["y"]))
    Xu, th = t(c["Xu"]), t(c["theta"])
    out["sweep"] = sh.dp_regression_sweep(KER, th, Xu, X, y, nat_prior(12), c["w"])
    opt = adamax(0.001)
    out["step_theta"] = sh.dp_train_step(KER, th, opt.init(th), opt, Xu, X, y, nat_prior(12),
                                         c["w"])[0]

    k = trainer_case()
    Xs, ys = sh.shard_batched_data(t(k["Xb"]), t(k["yb"]))
    out["kin40k"] = sh.fit_kin40k_fast_dp(KER, t(k["theta0"]), t(k["Xu"]), Xs, ys,
                                          nat_prior(32), k["w"], 2)
    out["kin40k_resumed"] = sh.fit_kin40k_fast_dp(KER, t(k["theta0"]), t(k["Xu"]), Xs, ys,
                                                  nat_prior(32), k["w"], 1,
                                                  resume_state=kin_resume)

    b = banana_case()
    Xs, ys = sh.shard_batched_data(t(b["Xb"]), t(b["yb"]))
    prior_w = GammaShapeRate(torch.full((), 1e-2, dtype=F64), torch.full((), 1e-2, dtype=F64))
    out["banana"] = sh.fit_banana_fast_dp(KER, t(b["theta0"]), t(b["Xu"]), Xs, ys,
                                          nat_prior(32), prior_w, 2)
    out["banana_resumed"] = sh.fit_banana_fast_dp(KER, t(b["theta0"]), t(b["Xu"]), Xs, ys,
                                                  nat_prior(32), prior_w, 1,
                                                  resume_state=banana_resume)

    errors = {}
    for name, fn in (("shard_data", lambda: sh.shard_data(torch.zeros(comm.world_size() + 1, 2))),
                     ("shard_batched_data", lambda: sh.shard_batched_data(
                         torch.zeros(2, comm.world_size() + 1, 2),
                         torch.zeros(2, comm.world_size() + 1)))):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors

    from gaussianprocessnode_tpu_torch import serve

    handle, X_batches = serve_args
    mine = serve.shard_requests(X_batches)
    out["served"] = serve.serve_fused(handle, mine)
    out["served_rows"] = mine.shape[0]
    return out


# --- tensor parallelism ------------------------------------------------------

def tp_case():
    """The JAX TP tests' problem at M = 48 (divisible by 2 and 4): D = 3,
    N = 96, 17 test points, prior variance 50, w = 100."""
    r = np.random.default_rng(7)
    M, D, N = 48, 3, 96
    return dict(Xu=r.standard_normal((M, D)), X=r.standard_normal((N, D)),
                y=r.standard_normal(N), XT=r.standard_normal((17, D)),
                theta=np.log(np.expm1(np.asarray([1.0, 0.7, 1.3, 0.9]))), prior_var=50.0,
                w=100.0)


def tp_rank(lam, with_2d):
    """The TP sweep (plain and spectrum-scaled Newton–Schulz), the
    prediction, the uneven-size error, and with ``with_2d`` the (2, 2)
    composition; every sharded output gathered whole."""
    c = tp_case()
    Xu, X, y, th = t(c["Xu"]), t(c["X"]), t(c["y"]), t(c["theta"])
    Xu_loc = tp.shard_inducing(Xu)

    def whole(outs):
        return tuple(comm.all_gather_rows(o) for o in outs)

    res = {"rank": comm.rank()}
    sweep = tp.tp_regression_sweep(KER, th, Xu_loc, X, y, c["prior_var"], c["w"])
    res["sweep"] = whole(sweep)
    res["scaled"] = whole(tp.tp_regression_sweep(KER, th, Xu_loc, X, y, c["prior_var"], c["w"],
                                                 ns_iters=28, lambda_min=lam))
    res["predict"] = tp.tp_predict(KER, th, Xu_loc, sweep[0], c["w"], t(c["XT"]))
    try:
        tp.shard_inducing(torch.zeros(comm.world_size() * 3 + 1, 2))
    except ValueError as e:
        res["uneven"] = str(e)
    if with_2d:
        mesh = comm.make_mesh((2, 2))
        Xd, yd = sh.shard_data(X, y, group=mesh.dp)
        out = tp.dp_tp_regression_sweep(KER, th, tp.shard_inducing(Xu, group=mesh.tp), Xd, yd,
                                         c["prior_var"], c["w"], mesh)
        res["dp_tp"] = tuple(comm.all_gather_rows(o, mesh.tp) for o in out)
    return res


# --- sequence parallelism ----------------------------------------------------

def sp_case(T, grid="pendulum"):
    """A GPSSM chain: the first T steps of the pendulum draw, x_prev ~
    N([1.6, 0], 0.1·I), v ~ N(0, 50·I), W ~ Wishart(100, I), and either the
    JAX SP tests' model (``grid="pendulum"``: the pendulum's 48-point grid,
    κ(Kuu) ≈ 3e13, θ = softplus⁻¹([1, 2, 2])) or the chain smoother tests'
    (``"regular"``: 12 inducing inputs on a regular 4×3 grid over
    [−2, 2]×[−4, 4], κ(Kuu) ≈ 1e3, θ = softplus⁻¹([1, 1, 1]))."""
    from gaussianprocessnode_tpu_torch.utils.datasets import pendulum, pendulum_inducing

    _, y_obs, _, P, _ = pendulum()
    if grid == "pendulum":
        Xu, theta = pendulum_inducing(), np.asarray([1.0, 2.0, 2.0])
    else:
        g1, g2 = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 3), indexing="ij")
        Xu, theta = np.stack([g1.ravel(), g2.ravel()], 1), np.ones(3)
    return dict(ys=y_obs[:T], Xu=Xu, P=P, theta=np.log(np.expm1(theta)),
                x0_mean=np.asarray([1.6, 0.0]), x0_cov=0.1 * np.eye(2), W_df=100.0,
                W_scale=np.eye(2))


def sp_args(c):
    M, D = c["Xu"].shape[0], 2
    return (t(c["P"]), t(c["x0_mean"]), t(c["x0_cov"]), nat_prior(M * D), c["W_df"],
            t(c["W_scale"]))


def sp_rank(T, mids, fresh_sweeps):
    """``gpssm_vmp_sp`` on this rank's block, for each model of ``mids``
    (grid → a mid-trajectory state): ``fresh_sweeps`` sweeps from the cold
    start and one from the mid state; and the uneven-length error."""
    res = {"rank": comm.rank()}
    for grid, mid in mids.items():
        c = sp_case(T, grid)
        ys = sp.shard_chain_data(t(c["ys"]))
        Xu, th = t(c["Xu"]), t(c["theta"])
        res[grid] = {
            "fresh": sp.gpssm_vmp_sp(KER, th, Xu, ys, *sp_args(c), n_iters=fresh_sweeps),
            "mid": sp.gpssm_vmp_sp(KER, th, Xu, ys, *sp_args(c), n_iters=1, init_state=mid)}
    try:
        sp.shard_chain_data(torch.zeros(comm.world_size() * 4 + 1, 2))
    except ValueError as e:
        res["uneven"] = str(e)
    return res


# --- launching -----------------------------------------------------------------

def mismatched_rank():
    """Rank 0 waits in an all-reduce that no other rank joins; the others
    stay alive, asleep, past any test's timeout."""
    if comm.rank() == 0:
        dist.all_reduce(torch.ones(3))
    else:
        time.sleep(300)
    return comm.rank()


def raising_rank():
    """Rank 1 raises before any collective."""
    if comm.rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return comm.rank()


def collectives_rank():
    """Each collective of ``comm`` on rank-dependent inputs."""
    r, P = comm.rank(), comm.world_size()
    x = torch.arange(3, dtype=F64) + r
    x_before = x.clone()
    return {
        "sum": comm.all_reduce_sum(x),
        "max": comm.all_reduce_max(x),
        "input_kept": torch.equal(x, x_before),
        "gather": comm.all_gather_rows(x[None]),
        "ring": comm.ring_shift(x),
        "left": comm.halo_from_left(x),
        "right": comm.halo_from_right(x),
        "rank": r, "world": P,
    }
