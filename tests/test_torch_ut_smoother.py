"""Parity of the port's UT smoother (infer/ut_smoother.py) and
convert.ut_state_from_jax with the JAX package's, on the CPU.

The pendulum's known dynamics g(x) = [x1 + x2·Δt, x2 − 9.81·sin(x1)·Δt] on
T = 40 steps of the draw (seed 69), P = 0.1·I, x_prev ~ N([1.6, 0], 0.1·I),
W ~ Wishart(100, I), float64 (the runner's baseline always is): the UT
statistics of a batch of marginals, 8 smoothing sweeps and the 1-step-ahead
filter over 15 test steps, held to JAX's to 1e-11 relative (measured ~3e-14:
the same arithmetic, the LU solve for the linearisation's gain in LAPACK on
both sides). The UT parameters are the smoother's own α = 1, β = 0, κ = 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import ut_smoother as ju
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.infer import ut_smoother as tu
from gaussianprocessnode_tpu_torch.utils.datasets import pendulum
from test_torch_chain_smoother import close, close_state

T_CHAIN = 40
_, Y, _, P, DT = pendulum()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jg(x):
    return jnp.stack([x[0] + x[1] * DT, x[1] - 9.81 * jnp.sin(x[0]) * DT])


def tg(x):
    return torch.stack([x[..., 0] + x[..., 1] * DT, x[..., 1] - 9.81 * torch.sin(x[..., 0]) * DT],
                       -1)


def _args(lib):
    a = jnp.asarray if lib == "jax" else torch.as_tensor
    return (a(Y[:T_CHAIN]), a(P), a(np.array([1.6, 0.0])), a(0.1 * np.eye(2)), 100.0,
            a(np.eye(2)))


def test_ut_propagate_batched():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((5, 2))
    B = 0.3 * rng.standard_normal((5, 2, 2))
    V = B @ np.swapaxes(B, 1, 2) + 0.05 * np.eye(2)
    jout = jax.vmap(lambda mm, VV: ju._ut_propagate(jg, mm, VV))(jnp.asarray(m), jnp.asarray(V))
    tout = tu._ut_propagate(tg, torch.as_tensor(m), torch.as_tensor(V))
    for a, b in zip(tout, jout):
        close(a, b)
    one = tu._ut_propagate(tg, torch.as_tensor(m[3]), torch.as_tensor(V[3]))
    for a, b in zip(one, tout):
        close(a, b[3])


def test_smoother_filter_and_convert():
    js = jax.jit(ju.ut_smoother_vmp, static_argnames=("g", "n_iters"))(jg, *_args("jax"),
                                                                        n_iters=8)
    ts = tu.ut_smoother_vmp(tg, *_args("torch"), n_iters=8)
    close_state(ts, js)
    yt = Y[T_CHAIN:T_CHAIN + 15]
    jpm, jpc = ju.ut_one_step_ahead(jg, js, jnp.asarray(yt), jnp.asarray(P))
    tpm, tpc = tu.ut_one_step_ahead(tg, ts, torch.as_tensor(yt), torch.as_tensor(P))
    close(tpm, jpm)
    close(tpc, jpc)
    # the port's filter from JAX's smoother state
    cs = convert.ut_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert all(torch.equal(getattr(cs, f), torch.as_tensor(np.array(getattr(js, f))))
               for f in js._fields)
    cpm, _ = tu.ut_one_step_ahead(tg, cs, torch.as_tensor(yt), torch.as_tensor(P))
    close(cpm, jpm)
