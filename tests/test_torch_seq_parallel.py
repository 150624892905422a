"""The port's sequence-parallel GPSSM smoother (parallel/seq_parallel.py) on
P = 2 and 4 gloo ranks, against the JAX package's on the same number of
virtual CPU devices and against the port's single-device Jacobi smoother.

Two models of T = 32 steps of the pendulum draw (T/P ≥ 8 steps per rank;
``tests/_torch_dist_ranks.py::sp_case``): the chain smoother tests' regular
4×3 inducing grid (κ(Kuu) ≈ 1e3), on which the port and the JAX package
agree to float64 round-off, and the JAX SP tests' pendulum grid (κ(Kuu) ≈
3e13), on which the two packages' Kuu⁻¹ differ by κ·ε ≈ 1e-2 relative
(``tests/test_torch_pendulum_runner.py``), so there the port's SP smoother
is held to the port's single-device one, as the JAX SP tests hold the JAX
pair. One spawn per rank count runs, per model, 3 sweeps from the cold
start and one from a mid-trajectory state (40 single-device sweeps: JAX's,
carried over by ``convert.gpssm_state_from_jax``, on the regular grid; the
port's on the pendulum grid).

Bands: on the regular grid 1e-11 of each array's largest entry (the chain
smoother tests' float64 band for the same arithmetic summed in other
orders). On the pendulum grid, the JAX SP tests': from the mid state, where
the sweep map is what the halos must reproduce, 1e-9 (absolute on the
marginals, relative on q(v), q(W) and the free energy, whose sums over t
are reordered); from the cold start, whose map at this untrained θ
amplifies ulp-level differences ~1e10×, 5e-4 on the marginals and 1e-4
relative on the global terms (one sweep). Whatever every rank holds (x_prev,
the gathered marginals, q(v), q(W), the free energy) is bit-equal across
ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer.chain_smoother import gpssm_vmp as jgpssm_vmp
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.parallel import seq_parallel as jsp
from gaussianprocessnode_tpu.parallel.sharding import make_mesh as jmake_mesh
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.infer.chain_smoother import gpssm_vmp
from gaussianprocessnode_tpu_torch.parallel.comm import spawn_ranks

T = 32
FRESH_SWEEPS = 3
JK = JKernel("se", transform="softplus")
GRIDS = ("regular", "pendulum")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jargs(c):
    M, D = c["Xu"].shape[0], 2
    return (jnp.asarray(c["theta"]), jnp.asarray(c["Xu"])), (
        jnp.asarray(c["P"]), jnp.asarray(c["x0_mean"]), jnp.asarray(c["x0_cov"]),
        JNat(jnp.zeros(M * D), jnp.eye(M * D) / 50.0), c["W_df"], jnp.asarray(c["W_scale"]))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's SP smoother on the regular grid (its mid state: 40
    single-device JAX sweeps), the port's mid state on the pendulum grid
    (40 single-device port sweeps), and one spawn per rank count."""
    vmp = jax.jit(jgpssm_vmp, static_argnums=0, static_argnames=("n_iters",))
    c = R.sp_case(T, "regular")
    (th, Xu), chain = _jargs(c)
    ys = jnp.asarray(c["ys"])
    mid = _np(vmp(JK, th, Xu, ys, *chain, n_iters=40)[0])
    mids = {"regular": convert.gpssm_state_from_jax(mid, device="cpu"),
            "pendulum": _one_device("pendulum", 40)[0]}
    out = {"mid": mids}
    for P in (2, 4):
        mesh = jmake_mesh(jax.devices()[:P], axis="sp")
        ys_s = jsp.shard_chain_data(mesh, ys)
        jx = {"regular": {
            "fresh": _np(jsp.gpssm_vmp_sp(JK, th, Xu, ys_s, *chain, mesh=mesh,
                                          n_iters=FRESH_SWEEPS)),
            "mid": _np(jsp.gpssm_vmp_sp(JK, th, Xu, ys_s, *chain, mesh=mesh, n_iters=1,
                                        init_state=mid))}}
        out[P] = (jx, spawn_ranks(R.sp_rank, P, "gloo", T, mids, FRESH_SWEEPS, timeout_s=240))
    return out


def _rel_held(got, want, rtol):
    """Every field and the free energy within ``rtol`` of the compared
    array's largest entry."""
    st, fe = got
    wst, wfe = want
    for k in ("x_means", "x_covs", "xi_v", "prec_v", "W_df", "W_rate"):
        a, b = np.asarray(getattr(st, k)), np.asarray(getattr(wst, k))
        assert np.max(np.abs(a - b)) <= rtol * np.max(np.abs(b)), k
    assert abs(float(fe) - float(wfe)) <= rtol * abs(float(wfe))


def _held(got, want, atol, g_rtol):
    st, fe = got
    wst, wfe = want
    np.testing.assert_allclose(np.asarray(st.x_means), np.asarray(wst.x_means), atol=atol)
    np.testing.assert_allclose(np.asarray(st.x_covs), np.asarray(wst.x_covs), atol=atol)
    for k in ("xi_v", "prec_v", "W_rate"):
        np.testing.assert_allclose(np.asarray(getattr(st, k)), np.asarray(getattr(wst, k)),
                                   rtol=g_rtol, atol=atol)
    assert float(st.W_df) == float(wst.W_df)
    np.testing.assert_allclose(float(fe), float(wfe), rtol=g_rtol, atol=atol)


def _one_device(grid, n_iters, init_state=None):
    c = R.sp_case(T, grid)
    return gpssm_vmp(R.KER, R.t(c["theta"]), R.t(c["Xu"]), R.t(c["ys"]), *R.sp_args(c),
                     n_iters=n_iters, init_state=init_state)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("start", ["fresh", "mid"])
def test_sp_on_the_regular_grid_matches_jax_and_one_device(runs, P, start):
    jx, ranks = runs[P]
    got = ranks[0]["regular"][start]
    _rel_held(got, jx["regular"][start], 1e-11)
    if start == "fresh":
        _rel_held(got, _one_device("regular", FRESH_SWEEPS), 1e-11)
    else:
        _rel_held(got, _one_device("regular", 1, runs["mid"]["regular"]), 1e-11)


@pytest.mark.parametrize("P", [2, 4])
def test_sp_sweep_from_a_mid_state_on_the_pendulum_grid_matches_one_device(runs, P):
    _, ranks = runs[P]
    _held(ranks[0]["pendulum"]["mid"], _one_device("pendulum", 1, runs["mid"]["pendulum"]),
          atol=1e-9, g_rtol=1e-9)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("start", ["fresh", "mid"])
def test_sp_state_is_bit_equal_across_ranks(runs, P, grid, start):
    """Every rank returns the whole gathered state: x_prev (refined on rank 0
    and handed out by a masked all-reduce), the gathered marginals, q(v),
    q(W) and the free energy are the same bits everywhere."""
    _, ranks = runs[P]
    st0, fe0 = ranks[0][grid][start]
    for r in ranks[1:]:
        st, fe = r[grid][start]
        assert all(torch.equal(a, b) for a, b in zip(st0, st)) and torch.equal(fe0, fe)


@pytest.mark.parametrize("P", [2, 4])
def test_sp_uneven_chain_rejected(runs, P):
    _, ranks = runs[P]
    assert all("is not divisible by the" in r["uneven"] for r in ranks)
