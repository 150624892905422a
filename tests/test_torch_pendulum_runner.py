"""The port's pendulum runner (experiments/pendulum.py) against the same
composition of JAX library calls as the JAX runner (``experiments/
pendulum.py::run``: not called itself, since it writes a compile cache into
the repository), on the CPU in float64, at a tiny schedule: 2 epochs of 3
warm Jacobi sweeps, each followed by an M-step (2 L-BFGS steps; or 5 bare
AdaMax steps with the decaying rate, ``use_lbfgs=False``), then the
runner's final smoothing (150 Jacobi sweeps; ``pit``: 4 PIT sweeps and 30
Jacobi sweeps), the 400-step filter and the 150-sweep UT baseline, at the
runner's full width (T = 300, M = 48 on the pendulum's grid).

That grid holds inducing pairs 9e-5 apart: κ(Kuu) ≈ 3e13 at θ0, so every
product with Kuu⁻¹ carries κ·ε ≈ 1e-2 relative rounding, and the JAX
composition itself, fed y perturbed by 1e-15 relative, moves its θ by up to
1.8e-5, its FE trace by 3.8e-5 and its SMSEs by 7.1e-4 relative over these
three modes. The port is held to JAX within 1e-3 relative on θ, the FE
trace and the SMSEs (measured ≤ 3.0e-5, 4.9e-5 and 4.5e-4: the twin's
spread). The UT baseline involves no Gram and matches to 1e-10 (measured
4.3e-16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import chain_smoother as jc
from gaussianprocessnode_tpu.infer import pit_gpssm as jp
from gaussianprocessnode_tpu.infer import training as jt
from gaussianprocessnode_tpu.infer.ut_smoother import ut_smoother_vmp as jut
from gaussianprocessnode_tpu.objectives import neg_log_backwardmess_multi as jobj
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.linalg import cholinv as jcholinv
from gaussianprocessnode_tpu.ops.linalg import sum_blocks_weighted as jsbw
from gaussianprocessnode_tpu.ops.quadrature import SphericalRadial as JSR
from gaussianprocessnode_tpu.utils.datasets import pendulum, pendulum_inducing
from gaussianprocessnode_tpu_torch.experiments import pendulum as runner

RTOL = 1e-3
EPOCHS, N_ITERS = 2, 3
JK = JKernel("se", transform="softplus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smse(truth, est):
    return [float(np.mean((truth[:, d] - est[:, d]) ** 2) / np.var(truth[:, d], ddof=1))
            for d in range(2)]


_vmp = jax.jit(jc.gpssm_vmp, static_argnums=0, static_argnames=("n_iters", "compute_fe"))
_pit = jax.jit(jp.gpssm_vmp_pit, static_argnums=0, static_argnames=("n_pit", "n_polish"))
_DT = pendulum()[4]


def _g(x):
    """The pendulum's known dynamics, one function for every mode (the
    jitted UT smoother then compiles once)."""
    return jnp.stack([x[0] + x[1] * _DT, x[1] - 9.81 * jnp.sin(x[0]) * _DT])


def jax_run(use_lbfgs, steps, pit=False):
    """The JAX runner's run(), composed of the JAX package's functions."""
    x_state, y_obs, _, P, _ = pendulum()
    y, yt = jnp.asarray(y_obs[:300]), jnp.asarray(y_obs[300:])
    Xu = jnp.asarray(pendulum_inducing())
    M, D = 48, 2
    prior = (jnp.asarray(P), jnp.asarray([1.6, 0.0]), 0.1 * jnp.eye(2),
             JNat(jnp.zeros(M * D), jnp.eye(M * D) / 50.0), 100.0, jnp.eye(2))
    theta = jnp.log(jnp.expm1(jnp.ones(3)))
    opt = optax.adamax(optax.exponential_decay(0.01, transition_steps=EPOCHS * steps,
                                               decay_rate=0.2))
    opt_state = opt.init(theta)
    state, fes = None, []
    for _ in range(EPOCHS):
        state, fe = _vmp(JK, theta, Xu, y, *prior, n_iters=N_ITERS, init_state=state)
        mu_v, cov_v = jc._qv_stats(state.xi_v, state.prec_v)
        W = state.W_df * jcholinv(0.5 * (state.W_rate + state.W_rate.T))
        kw = dict(kernel=JK, Xu=Xu, y_means=state.x_means[1:], qx_means=state.x_means[:-1],
                  qx_covs=state.x_covs[:-1],
                  sumRv_W=jsbw(cov_v + jnp.outer(mu_v, mu_v), W, D, M), mu_v=mu_v, W=W,
                  method=JSR())
        if use_lbfgs:
            theta, _ = jt.lbfgs_solve(lambda th: jobj(th, **kw), theta, max_steps=steps // 4)
        else:
            for _ in range(steps):
                upd, opt_state = opt.update(jax.grad(lambda th: jobj(th, **kw))(theta), opt_state)
                theta = optax.apply_updates(theta, upd)
        fes.append(float(fe))
    if pit:
        state, _ = _pit(JK, theta, Xu, y, *prior, n_pit=4, n_polish=30)
    else:
        state, _ = _vmp(JK, theta, Xu, y, *prior, n_iters=150)
    pm, _ = jc.one_step_ahead(JK, theta, Xu, state, yt, prior[0])
    ut = jut(_g, y, *prior[:3], 100.0, jnp.eye(2), n_iters=150)
    return dict(theta=np.asarray(theta), fe_trace=fes,
                smse_smooth=_smse(x_state[:300], np.asarray(state.x_means[1:])),
                smse_predict=_smse(x_state[300:], np.asarray(pm)),
                smse_ut_baseline=_smse(x_state[:300], np.asarray(ut.x_means[1:])))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("mode", ["lbfgs", "adamax", "pit"])
def test_runner_matches_the_jax_composition(mode):
    use_lbfgs = mode != "adamax"
    steps = 8 if use_lbfgs else 5
    out = runner.run(epochs=EPOCHS, n_iters=N_ITERS, adamax_steps=steps, use_lbfgs=use_lbfgs,
                     pit=mode == "pit", device="cpu")
    ref = jax_run(use_lbfgs, steps, pit=mode == "pit")
    assert out["finite"] and out["epochs"] == EPOCHS and out["gram_launches"] == 0
    for key in ("theta", "fe_trace", "smse_smooth", "smse_predict"):
        assert rel(out[key], ref[key]) <= RTOL, (key, rel(out[key], ref[key]))
    assert rel(out["smse_ut_baseline"], ref["smse_ut_baseline"]) <= 1e-10
    assert out["lbfgs_evaluations"] > 0 if use_lbfgs else out["lbfgs_evaluations"] == 0


def test_command_line_writes_the_json_line(tmp_path, capsys):
    path = tmp_path / "out.json"
    assert runner.main(["0", "--device", "cpu", f"--json={path}"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert path.read_text().strip() == line
    import json

    out = json.loads(line)
    assert out["epochs"] == 0 and out["fe_trace"] == [] and out["mstep"] == "lbfgs"
    assert out["smse_ut_baseline"][0] < 0.01
