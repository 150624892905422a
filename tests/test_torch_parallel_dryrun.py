"""The port's multi-rank dry run (parallel/dryrun.py) and its launcher and
collectives (parallel/comm.py), on gloo ranks on the CPU.

The dry run on 2 ranks is held to the JAX dry run's sequence of library
calls (``__graft_entry__.py::dryrun_multichip``, composed here on a
2-device mesh, on the same ``default_rng(0)`` draws in the same order;
its full-scale epoch is drawn but not run): θ after the data-parallel step
1e-8 absolute and after the two trainers' epoch 1e-9 (the JAX sharding
tests' bands for all-reduce reordering), the sequence-parallel free
energy 1e-9 relative and the tensor-parallel prediction 1e-10 absolute
(on this random 6- and 16-point inducing set κ(Kuu) is small). The
launcher: a collective that one rank never joins fails by its timeout, a
rank that raises fails the launch with its traceback, and each collective
returns what its JAX counterpart computes.
"""

import time

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
from gaussianprocessnode_tpu.parallel import seq_parallel as jsp
from gaussianprocessnode_tpu.parallel import sharding as jsh
from gaussianprocessnode_tpu.parallel import tensor_parallel as jtp
from gaussianprocessnode_tpu_torch.parallel import comm, dryrun

JK = JKernel("se", transform="softplus")
N_RANKS = 2


def _jax_dryrun(n):
    """The JAX dry run's calls at ``n`` devices, full-scale epoch excluded."""
    devices = jax.devices()[:n]
    mesh = jsh.make_mesh(devices)
    rng = np.random.default_rng(0)
    ones = jnp.ones
    M, D, N = 16, 2, 8 * n
    Xu, X, y = (jnp.asarray(rng.standard_normal(s)) for s in ((M, D), (N, D), (N,)))
    Xs, ys = jsh.shard_data(mesh, X, y)
    theta = jnp.log(jnp.expm1(ones(D + 1)))
    prior = JNat(jnp.zeros(M), jnp.eye(M) / 50.0)
    opt = optax.adamax(0.001)
    step = jax.jit(lambda th, os_, X_, y_: jsh.dp_train_step(JK, th, os_, opt, Xu, X_, y_, prior,
                                                             100.0, mesh)[0])
    out = {"theta_step": np.asarray(step(theta, opt.init(theta), Xs, ys))}

    M2, D2, B2, b2 = 48, 8, 3, 16 * n
    Xu2 = jnp.asarray(rng.standard_normal((M2, D2)))
    Xs2, ys2 = jsh.shard_batched_data(mesh, jnp.asarray(rng.standard_normal((B2, b2, D2))),
                                      jnp.asarray(rng.standard_normal((B2, b2))))
    out["theta_kin40k"] = np.asarray(jsh.fit_kin40k_fast_dp(
        JK, jnp.log(jnp.expm1(ones(D2 + 1))), Xu2, Xs2, ys2,
        JNat(jnp.zeros(M2), jnp.eye(M2) / 50.0), 1e4, 1, mesh)[0])

    M3, B3, b3 = 32, 3, 16 * n
    Xu3 = jnp.asarray(rng.standard_normal((M3, 2)))
    Xs3, ys3 = jsh.shard_batched_data(
        mesh, jnp.asarray(rng.standard_normal((B3, b3, 2))),
        jnp.asarray((rng.uniform(size=(B3, b3)) > 0.5).astype(float)))
    out["theta_banana"] = np.asarray(jsh.fit_banana_fast_dp(
        JK, jnp.log(jnp.expm1(ones(3))), Xu3, Xs3, ys3, JNat(jnp.zeros(M3), jnp.eye(M3) / 50.0),
        JGamma(jnp.asarray(1e-2), jnp.asarray(1e-2)), 1, mesh)[0])

    # the full-scale epoch's draws (not run here)
    rng.standard_normal((600, 8))
    rng.standard_normal((20, 64 * n, 8))
    rng.standard_normal((20, 64 * n))

    T6, M6, D6 = 4 * n, 6, 2
    mesh_sp = jsh.make_mesh(devices, axis="sp")
    Xu6 = jnp.asarray(rng.standard_normal((M6, D6)))
    ys6 = jsp.shard_chain_data(mesh_sp, jnp.asarray(0.3 * rng.standard_normal((T6, D6))))
    _, fe6 = jsp.gpssm_vmp_sp(JK, jnp.log(jnp.expm1(ones(D6 + 1))), Xu6, ys6, 0.1 * jnp.eye(D6),
                              jnp.zeros(D6), 0.1 * jnp.eye(D6),
                              JNat(jnp.zeros(M6 * D6), jnp.eye(M6 * D6) / 50.0), 10.0,
                              jnp.eye(D6), mesh=mesh_sp, n_iters=3)
    out["sp_fe"] = float(fe6)

    M7, D7, N7 = 8 * n, 3, 64
    mesh_tp = jsh.make_mesh(devices, axis="tp")
    Xu7 = jtp.shard_inducing(mesh_tp, jnp.asarray(rng.standard_normal((M7, D7))))
    X7, y7 = jnp.asarray(rng.standard_normal((N7, D7))), jnp.asarray(rng.standard_normal(N7))
    th7 = jnp.log(jnp.expm1(ones(D7 + 1)))
    mu7, _, _, _ = jax.jit(lambda a: jtp.tp_regression_sweep(JK, th7, a, X7, y7, 50.0, 100.0,
                                                             mesh_tp))(Xu7)
    mu7_s = jtp.shard_inducing(mesh_tp, jnp.asarray(np.asarray(mu7)))
    out["tp_mean"] = np.asarray(jtp.tp_predict(JK, th7, Xu7, mu7_s, 100.0, X7[:5], mesh_tp)[0])
    return out


@pytest.fixture(scope="module")
def dry():
    torch.set_num_threads(1)
    return dryrun.dryrun_multichip(N_RANKS, "cpu"), _jax_dryrun(N_RANKS)


def test_dryrun_theta_matches_the_jax_dryrun(dry):
    port, jx = dry
    np.testing.assert_allclose(port["theta_step"].numpy(), jx["theta_step"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(port["theta_kin40k"].numpy(), jx["theta_kin40k"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(port["theta_banana"].numpy(), jx["theta_banana"], rtol=0,
                               atol=1e-9)


def test_dryrun_sp_and_tp_match_the_jax_dryrun(dry):
    port, jx = dry
    assert port["sp_fe"] == pytest.approx(jx["sp_fe"], rel=1e-9)
    np.testing.assert_allclose(port["replicated"][-1].numpy(), jx["tp_mean"], rtol=0, atol=1e-10)


def test_dryrun_reports_its_shapes_and_backend(dry):
    port, _ = dry
    assert port["backend"] == "gloo" and port["device"] == "cpu"
    assert (port["M5"], port["N5"], port["T6"], port["M7"]) == (600, 20 * 64 * N_RANKS,
                                                                4 * N_RANKS, 8 * N_RANKS)
    # all-reduced per epoch: (ξ, Λ) in float64 and a float32 θ-gradient per batch
    assert port["comms_bytes"] == (600 * 600 + 600) * 8 + 20 * 9 * 4
    assert port["full_epoch_s"] > 0 and all(bool(torch.isfinite(t).all())
                                            for t in port["replicated"])


def test_dryrun_on_the_card_refuses_more_ranks_than_cards():
    """No silent move to the CPU: without enough cards the run refuses."""
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(n, "cuda")


def test_mismatched_collective_fails_by_timeout_quickly():
    """Rank 0 waits in an all-reduce that rank 1, alive and asleep, never
    joins: the launch fails by its 10 s timeout, well inside a minute, and
    does not hang."""
    t0 = time.monotonic()
    with pytest.raises(comm.RankFailure):
        comm.spawn_ranks(R.mismatched_rank, 2, "gloo", timeout_s=10)
    assert time.monotonic() - t0 < 60


def test_a_dead_rank_raises_in_the_parent_with_its_traceback():
    with pytest.raises(comm.RankFailure, match="rank 1 fails on purpose"):
        comm.spawn_ranks(R.raising_rank, 2, "gloo", timeout_s=60)


@pytest.fixture(scope="module")
def collectives():
    return comm.spawn_ranks(R.collectives_rank, 3, "gloo", timeout_s=120)


def test_collectives_on_three_ranks(collectives):
    """psum, pmax, all_gather(tiled), the ring ppermute and the chain halos,
    at a rank count that is not a power of two."""
    P = 3
    xs = [torch.arange(3, dtype=torch.float64) + r for r in range(P)]
    for r, o in enumerate(collectives):
        assert o["world"] == P and o["rank"] == r and o["input_kept"]
        assert torch.equal(o["sum"], sum(xs))
        assert torch.equal(o["max"], xs[-1])
        assert torch.equal(o["gather"], torch.stack(xs))
        assert torch.equal(o["ring"], xs[(r - 1) % P])
        assert torch.equal(o["left"], xs[r - 1] if r > 0 else torch.zeros(3, dtype=torch.float64))
        assert torch.equal(o["right"],
                           xs[r + 1] if r < P - 1 else torch.zeros(3, dtype=torch.float64))


def test_one_rank_group_collectives_return_their_input():
    """At world size 1 the reductions and gathers return their input and the
    point-to-point exchanges post nothing (a ring of one keeps its block,
    the chain ends receive zeros)."""
    x = torch.arange(4, dtype=torch.float64)
    with comm.single_rank_group("cpu"):
        assert comm.world_size() == 1 and comm.rank() == 0
        assert torch.equal(comm.all_reduce_sum(x), x) and torch.equal(comm.all_reduce_max(x), x)
        assert torch.equal(comm.all_gather_rows(x[None]), x[None])
        assert comm.ring_shift(x) is x
        assert torch.equal(comm.halo_from_left(x), torch.zeros(4, dtype=torch.float64))
        assert torch.equal(comm.halo_from_right(x), torch.zeros(4, dtype=torch.float64))
        assert comm.make_mesh() is None
