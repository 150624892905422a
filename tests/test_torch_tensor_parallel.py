"""The port's tensor-parallel layer (parallel/tensor_parallel.py) on P = 2
and 4 gloo ranks (and a 2 × 2 dp × tp layout), against the JAX package's
on the same number of virtual CPU devices and against the dense sweep.

One spawn per rank count runs the sweep (plain and spectrum-scaled
Newton–Schulz), the prediction and, at P = 4, the 2-D composition on every
rank (``tests/_torch_dist_ranks.py::tp_rank``), gathering each row-sharded
output whole. The ring splits each product into P partial contractions
(kept in JAX's block order), and the Newton–Schulz inverse amplifies that
reassociation by κ(Λ): the bands are the JAX package's for the same
comparison (``tests/test_tensor_parallel.py``): the natural parameters,
one dot product per element either way, 1e-12 relative (1e-10 where a dp
all-reduce reorders Λ's data sum), Σ_v 1e-8 absolute, μ_v 1e-7, the
prediction 1e-10 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import _torch_dist_ranks as R
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.parallel import tensor_parallel as jtp
from gaussianprocessnode_tpu.parallel.sharding import make_mesh as jmake_mesh
from gaussianprocessnode_tpu_torch.ops.linalg import (gershgorin_lambda_min, ir_solve,
                                                      spd_inverse, sym)
from gaussianprocessnode_tpu_torch.parallel.comm import spawn_ranks

JK = JKernel("se", transform="softplus")
C = R.tp_case()
M = C["Xu"].shape[0]
LAM = float(gershgorin_lambda_min(torch.eye(M, dtype=torch.float64) / C["prior_var"]))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_refs(P):
    mesh = jmake_mesh(jax.devices()[:P], axis="tp")
    Xu = jtp.shard_inducing(mesh, jnp.asarray(C["Xu"]))
    X, y, th = jnp.asarray(C["X"]), jnp.asarray(C["y"]), jnp.asarray(C["theta"])

    @jax.jit
    def sweeps(Xu_s):
        return (jtp.tp_regression_sweep(JK, th, Xu_s, X, y, C["prior_var"], C["w"], mesh),
                jtp.tp_regression_sweep(JK, th, Xu_s, X, y, C["prior_var"], C["w"], mesh,
                                        ns_iters=28, lambda_min=LAM))

    plain, scaled = sweeps(Xu)
    mu_s = jtp.shard_inducing(mesh, jnp.asarray(np.asarray(plain[0])))
    mean, var = jtp.tp_predict(JK, th, Xu, mu_s, C["w"], jnp.asarray(C["XT"]), mesh)
    out = {"sweep": [np.asarray(a) for a in plain], "scaled": [np.asarray(a) for a in scaled],
           "predict": (np.asarray(mean), np.asarray(var))}
    if P == 4:
        mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
        args = (jax.device_put(jnp.asarray(C["Xu"]), NamedSharding(mesh2, PartitionSpec("tp", None))),
                jax.device_put(X, NamedSharding(mesh2, PartitionSpec("dp", None))),
                jax.device_put(y, NamedSharding(mesh2, PartitionSpec("dp"))))
        out["dp_tp"] = [np.asarray(a) for a in jax.jit(
            lambda a, b, c: jtp.dp_tp_regression_sweep(JK, th, a, b, c, C["prior_var"], C["w"],
                                                       mesh2))(*args)]
    return out


@pytest.fixture(scope="module")
def runs():
    return {P: (_jax_refs(P), spawn_ranks(R.tp_rank, P, "gloo", LAM, P == 4, timeout_s=240))
            for P in (2, 4)}


def _dense(ns_iters=40, lambda_min=None):
    """The sweep on one device, as the JAX tests' dense path."""
    K = R.KER(R.t(C["theta"]), R.t(C["Xu"]), R.t(C["X"]))
    xi = C["w"] * (K @ R.t(C["y"]))
    prec = sym(torch.eye(M, dtype=torch.float64) / C["prior_var"] + C["w"] * (K @ K.T))
    cov = spd_inverse(prec, iters=ns_iters, lambda_min=lambda_min)
    return ir_solve(prec, xi, cov, rounds=2), cov, xi, prec


def _held(got, want, nat_rtol=1e-12):
    mu, cov, xi, prec = (np.asarray(a) for a in got)
    wmu, wcov, wxi, wprec = (np.asarray(a) for a in want)
    np.testing.assert_allclose(xi, wxi, rtol=nat_rtol)
    np.testing.assert_allclose(prec, wprec, rtol=nat_rtol)
    np.testing.assert_allclose(cov, wcov, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mu, wmu, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("P", [2, 4])
def test_tp_sweep_matches_jax_and_dense(runs, P):
    jx, ranks = runs[P]
    _held(ranks[0]["sweep"], jx["sweep"])
    _held(ranks[0]["sweep"], _dense())


@pytest.mark.parametrize("P", [2, 4])
def test_tp_scaled_sweep_matches_jax_and_dense(runs, P):
    """The spectrum-scaled iteration (the prior's λ_min bound) distributes
    the same way."""
    jx, ranks = runs[P]
    _held(ranks[0]["scaled"], jx["scaled"])
    _held(ranks[0]["scaled"], _dense(28, LAM))


@pytest.mark.parametrize("P", [2, 4])
def test_tp_predict_matches_jax_and_dense(runs, P):
    jx, ranks = runs[P]
    mean, var = ranks[0]["predict"]
    np.testing.assert_allclose(mean.numpy(), jx["predict"][0], rtol=0, atol=1e-10)
    mu = _dense()[0]
    Kst = R.KER(R.t(C["theta"]), R.t(C["Xu"]), R.t(C["XT"]))
    np.testing.assert_allclose(mean.numpy(), (Kst.T @ mu).numpy(), rtol=0, atol=1e-10)
    assert var.shape == mean.shape and bool(torch.all(var == 1.0 / C["w"]))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("key", ["sweep", "scaled", "predict"])
def test_whole_outputs_are_bit_equal_across_ranks(runs, P, key):
    _, ranks = runs[P]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(ranks[0][key], r[key]))


@pytest.mark.parametrize("P", [2, 4])
def test_shard_inducing_rejects_uneven(runs, P):
    _, ranks = runs[P]
    assert all("does not shard evenly" in r["uneven"] for r in ranks)


def test_dp_tp_sweep_matches_jax_and_dense(runs):
    """The 2 × 2 composition: Gram tiles, ξ and Λ all-reduced over dp, the
    tp solve; the dp all-reduce reorders Λ's data sum (1e-10)."""
    jx, ranks = runs[4]
    _held(ranks[0]["dp_tp"], jx["dp_tp"], nat_rtol=1e-10)
    _held(ranks[0]["dp_tp"], _dense(), nat_rtol=1e-10)
    # the dp replicas hold the same rows: ranks 0 and 2 are tp column 0
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["dp_tp"], ranks[2]["dp_tp"]))
