"""Pendulum GPSSM with Wishart process noise (Pendulum_Wishart_2d.ipynb), on the card.

Counterpart of ``experiments/pendulum.py::run``, at its configuration: the
pendulum draw of ``utils/datasets.py::pendulum`` (seed 69; 300 training and
400 test steps), D = 2 states, M = 48 inducing inputs on
``pendulum_inducing()``, the softplus-SE kernel from θ0 = softplus⁻¹([1, 1,
1]), v ~ N(0, 50·I), W ~ Wishart(100, I), P = 0.1·I, x_prev ~ N([1.6, 0],
0.1·I). Each of ``epochs`` epochs runs 25 warm-started Jacobi sweeps
(``infer/chain_smoother.py::gpssm_vmp``), then an M-step on θ against the
multivariate backward-message objective given the E-step's statistics: 25
L-BFGS steps (``infer/training.py::lbfgs_solve``) by default, or 100 bare
AdaMax steps (``use_lbfgs=False``; ``--faithful`` is the reference's
schedule: lr 0.002, constant, each E-step from the fresh initialisation).
Then the final smoothing (150 Jacobi sweeps; ``--pit``: 4 parallel-in-time
sweeps and 30 Jacobi sweeps, ``infer/pit_gpssm.py``; ``--sp=N``: the 150
Jacobi sweeps sequence-parallel, ``parallel/seq_parallel.py::gpssm_vmp_sp``
on N ranks spawned after the hyperparameter epochs, one card each on the
card, gloo ranks with ``--device cpu``; N must divide the 300 steps, and a
bare ``--sp`` is 4), the 1-step-ahead
filter over the 400 test steps, and the UT smoother with the known
dynamics (150 sweeps, float64) as the baseline, each scored by SMSE
against the true states.

    python -m gaussianprocessnode_tpu_torch.experiments.pendulum [EPOCHS] [--f32] [--pit]
        [--sp[=N]] [--faithful] [--chunk=K] [--ckpt=PATH] [--device cpu] [--json=PATH]

``--chunk=K`` runs the epochs in chunks of K (one host read each);
``--ckpt=PATH`` saves θ, the optimizer and E-step state, the epochs done,
the free-energy trace and the seconds so far to PATH after every chunk
(``utils/checkpoint.py``), and a run started with an existing PATH resumes
from it.

prints one JSON line: ``smse_smooth``, ``smse_ut_baseline`` and
``smse_predict`` (state 1, state 2), ``fe_trace`` (the free energy of every
epoch's E-step), ``theta`` (raw) and ``theta_softplus``,
``hyperopt_seconds`` and ``smoothing_seconds`` (host clock between two
``torch.cuda.synchronize()`` calls), ``host_ms_per_epoch``,
``lbfgs_evaluations``, ``host_reads`` (one per linesearch iteration) and
``lbfgs_graph_captures`` (on the card, one CUDA graph of the objective's
value and gradient per M-step),
``gram_launches`` (the SE Gram kernel's launches the device ran during
the hyperparameter epochs, as its wrapper counts them: the eager ones and
those of each replay of an M-step's CUDA graph) and ``device`` (the
card's name and power limit from nvidia-smi). ``--f32`` is the JAX
runner's f32-first mode: every model input in float32, so every Gram goes
through the hand-written CUDA kernel, the q(v) and Kuu factorisations
pinned to float64 inside the chain smoother. In float64 (the default) the
Grams take the plain route by dtype, as in the JAX package. ``--json=PATH``
also writes the line to PATH.
"""

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from ..dists import MvGaussianNat
from ..infer.chain_smoother import (GPSSMState, _cold_state, _qv_stats, gpssm_vmp,
                                    one_step_ahead)
from ..infer.pit_gpssm import gpssm_vmp_pit
from ..infer.training import lbfgs_solve
from ..infer.ut_smoother import ut_smoother_vmp
from ..objectives import grad_multi, neg_log_backwardmess_multi
from ..ops._build import load_library
from ..ops.kernels import Kernel, invsoftplus, softplus
from ..ops.linalg import cholinv, sum_blocks_weighted, sym
from ..ops.quadrature import SphericalRadial
from ..ops.se_gram import se_gram_cuda
from ..parallel import comm
from ..parallel.seq_parallel import gpssm_vmp_sp, shard_chain_data
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.datasets import pendulum, pendulum_inducing
from ..utils.metrics import smse
from ..utils.optim import adamax
from ..utils.profiling import card_info, synchronize

__all__ = ["N_TRAIN", "PRIOR_W_DF", "setup", "vmp", "mstep_stats", "check_sp_ranks", "run"]

N_TRAIN = 300
PRIOR_W_DF = 100.0
SMOOTHING_SWEEPS = 150


def setup(device="cuda", dtype=torch.float64) -> dict:
    """The runner's data and model, as ``experiments/pendulum.py::run``
    builds them, in ``dtype`` on ``device``: a dict of the kernel, θ0, Xu,
    the training and test observations, the true states (float64, host),
    P, the priors, Δt."""
    dev = torch.device(device)
    x_state, y_obs, _, P, dt = pendulum()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64).to(dtype).to(dev)

    Xu = t(pendulum_inducing())
    M, D = Xu.shape[0], 2
    return dict(
        kernel=Kernel("se", transform="softplus", use_kernel=True),
        theta0=invsoftplus(torch.ones(3, dtype=torch.float64)).to(dtype).to(dev),
        Xu=Xu, y_train=t(y_obs[:N_TRAIN]), y_test=t(y_obs[N_TRAIN:]),
        x_train=torch.as_tensor(x_state[:N_TRAIN]), x_test=torch.as_tensor(x_state[N_TRAIN:]),
        P=t(P), prior_v=MvGaussianNat(torch.zeros(M * D, dtype=dtype, device=dev),
                                      torch.eye(M * D, dtype=dtype, device=dev) / 50.0),
        prior_x0_mean=t([1.6, 0.0]), prior_x0_cov=0.1 * torch.eye(D, dtype=dtype, device=dev),
        prior_W_scale=torch.eye(D, dtype=dtype, device=dev), dt=dt)


def vmp(s, theta, n_iters, init_state=None, compute_fe=True):
    """``gpssm_vmp`` on the training chain of ``setup``'s dict ``s``."""
    return gpssm_vmp(s["kernel"], theta, s["Xu"], s["y_train"], s["P"], s["prior_x0_mean"],
                     s["prior_x0_cov"], s["prior_v"], PRIOR_W_DF, s["prior_W_scale"],
                     n_iters=n_iters, compute_fe=compute_fe, init_state=init_state)


def mstep_stats(state, M, D) -> dict:
    """The M-step objective's statistics from an E-step state (reference
    cell 16), through the chain smoother's float64 q(v) solve: y_means,
    qx_means, qx_covs, sumRv_W, mu_v, W."""
    mu_v, cov_v = _qv_stats(state.xi_v, state.prec_v)
    Rv = cov_v + torch.outer(mu_v, mu_v)
    W_bar = state.W_df * cholinv(sym(state.W_rate))
    return dict(y_means=state.x_means[1:], qx_means=state.x_means[:-1],
                qx_covs=state.x_covs[:-1], sumRv_W=sum_blocks_weighted(Rv, W_bar, D, M),
                mu_v=mu_v, W=W_bar)


def _pendulum_step(dt):
    """The known dynamics x ↦ [x1 + x2·Δt, x2 − 9.81·sin(x1)·Δt] on (..., 2) points."""
    def g(x):
        return torch.stack([x[..., 0] + x[..., 1] * dt,
                            x[..., 1] - 9.81 * torch.sin(x[..., 0]) * dt], -1)
    return g


def _sp_rank(theta, device, dtype, n_iters):
    """One rank of the sequence-parallel final smoothing: the training
    chain's block of this rank, ``gpssm_vmp_sp`` from the cold start;
    returns the gathered state and the free energy on the host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", comm.rank())
    s = setup(dev, dtype)
    state, fe = gpssm_vmp_sp(s["kernel"], theta.to(dev), s["Xu"], shard_chain_data(s["y_train"]),
                             s["P"], s["prior_x0_mean"], s["prior_x0_cov"], s["prior_v"],
                             PRIOR_W_DF, s["prior_W_scale"], n_iters=n_iters)
    return GPSSMState(*(t.cpu() for t in state)), fe.cpu()


def check_sp_ranks(sp_ranks: int, device) -> None:
    """Refuse an ``--sp`` rank count before the hyperparameter epochs:
    it must divide the 300 training steps, and on the card not exceed the
    card count."""
    if sp_ranks > 1 and N_TRAIN % sp_ranks:
        raise ValueError(f"--sp={sp_ranks}: {N_TRAIN} training steps do not shard evenly over "
                         f"{sp_ranks} ranks (use a divisor of {N_TRAIN}, e.g. 2, 4, 6, 10)")
    if sp_ranks > 1 and torch.device(device).type == "cuda" \
            and sp_ranks > torch.cuda.device_count():
        raise ValueError(f"--sp={sp_ranks} needs {sp_ranks} cards, this machine has "
                         f"{torch.cuda.device_count()}")


def run(epochs: int = 150, n_iters: int = 25, adamax_steps: int = 100,
        fresh_estep: bool = False, use_lbfgs: bool = True, adamax_lr: float = 0.01,
        adamax_decay: float = 0.2, pit: bool = False, device="cuda",
        dtype=torch.float64, sp_ranks: int = 0, chunk: int | None = None,
        checkpoint_path: str | None = None) -> dict:
    """Train for ``epochs`` epochs (in chunks of ``chunk``, checkpointed to
    ``checkpoint_path`` after each and resumed from it), smooth (on
    ``sp_ranks`` ranks where it is above 1), filter and score. Returns the
    result dict that the command line prints."""
    check_sp_ranks(sp_ranks, device)
    dev = torch.device(device)
    s = setup(dev, dtype)
    kernel, Xu = s["kernel"], s["Xu"]
    M, D = Xu.shape[0], 2
    sr = SphericalRadial()
    if dev.type == "cuda" and dtype == torch.float32:
        load_library()  # build and load the kernels before the clock starts

    optimizer = opt_state = None
    if not use_lbfgs:
        # lr 0.01 > the reference's: the free energy's valley along the second
        # lengthscale is shallow and 0.002 crawls; the decay keeps the end stable
        optimizer = adamax(adamax_lr, decay_rate=adamax_decay,
                           transition_steps=epochs * adamax_steps)

    theta = s["theta0"].clone()
    opt_state = optimizer.init(theta) if optimizer is not None else {}
    counts = {}
    fe_all = np.zeros(epochs)
    # the first E-step starts cold (None), or after a resume from the
    # checkpoint's state
    state, done, prev_s = None, 0, 0.0
    if checkpoint_path and os.path.exists(checkpoint_path):
        cold = _cold_state(s["y_train"], s["prior_x0_mean"], s["prior_x0_cov"], s["prior_v"],
                           PRIOR_W_DF, s["prior_W_scale"], 50.0)
        ck = load_pytree(checkpoint_path, {"theta": theta, "opt_state": opt_state,
                                           "state": cold, "done": np.zeros((), np.int64),
                                           "fe": fe_all, "hyperopt_seconds": np.zeros(())})
        theta, opt_state, state = ck["theta"], ck["opt_state"], ck["state"]
        done, prev_s = int(ck["done"]), float(ck["hyperopt_seconds"])
        fe_all[:done] = ck["fe"].numpy()[:done]  # the run may be longer than the saved one
    chunk = epochs if chunk is None else chunk
    synchronize(dev)
    se_gram_cuda.launches = 0
    t0 = time.perf_counter()
    while done < epochs:
        fes = []
        for _ in range(min(chunk, epochs - done)):
            state, fe = vmp(s, theta, n_iters, init_state=None if fresh_estep else state)
            kw = dict(kernel=kernel, Xu=Xu, method=sr, **mstep_stats(state, M, D))
            if use_lbfgs:
                # L-BFGS: the reference's 100 AdaMax steps crawl along the shallow
                # valley; a curvature-aware step reaches its floor in a few epochs
                theta, _ = lbfgs_solve(lambda th, kw=kw: neg_log_backwardmess_multi(th, **kw),
                                       theta, max_steps=adamax_steps // 4, counts=counts)
            else:
                for _ in range(adamax_steps):
                    theta = theta + optimizer.update_(grad_multi(theta, **kw), opt_state)
            fes.append(fe)
        fe_all[done:done + len(fes)] = torch.stack(fes).cpu().numpy()  # the chunk's host read
        done += len(fes)
        if checkpoint_path:
            save_pytree(checkpoint_path, {
                "theta": theta, "opt_state": opt_state, "state": state,
                "done": np.asarray(done, np.int64), "fe": fe_all,
                "hyperopt_seconds": np.asarray(prev_s + time.perf_counter() - t0)})
    synchronize(dev)
    hyperopt_s = prev_s + time.perf_counter() - t0
    launches = se_gram_cuda.launches

    t0 = time.perf_counter()
    if sp_ranks > 1:
        state, _ = comm.spawn_ranks(_sp_rank, sp_ranks, comm.backend_for(dev), theta.cpu(),
                                    device, dtype, SMOOTHING_SWEEPS)[0]
        state = GPSSMState(*(t.to(dev) for t in state))
    elif pit:
        state, _ = gpssm_vmp_pit(kernel, theta, Xu, s["y_train"], s["P"], s["prior_x0_mean"],
                                 s["prior_x0_cov"], s["prior_v"], PRIOR_W_DF,
                                 s["prior_W_scale"], n_pit=4, n_polish=30)
    else:
        state, _ = vmp(s, theta, SMOOTHING_SWEEPS)
    synchronize(dev)
    smooth_s = time.perf_counter() - t0

    def score(truth, est):
        return [float(smse(truth[:, d], est[:, d].detach().cpu().to(torch.float64)))
                for d in range(D)]

    with torch.no_grad():
        pred_means, _ = one_step_ahead(kernel, theta, Xu, state, s["y_test"], s["P"])
        # the UT smoother with the known dynamics, always in float64: a
        # baseline metric, not part of the timed workload
        f64 = torch.float64
        ut = ut_smoother_vmp(_pendulum_step(s["dt"]), s["y_train"].to(f64), s["P"].to(f64),
                             s["prior_x0_mean"].to(f64), s["prior_x0_cov"].to(f64),
                             PRIOR_W_DF, s["prior_W_scale"].to(f64), n_iters=SMOOTHING_SWEEPS)
    fe_trace = fe_all.tolist()
    return {
        "metric": "pendulum_hyperopt_wallclock",
        "value": hyperopt_s,
        "unit": "s",
        "epochs": epochs,
        "smse_smooth": score(s["x_train"], state.x_means[1:]),
        "smse_ut_baseline": score(s["x_train"], ut.x_means[1:]),
        "smse_predict": score(s["x_test"], pred_means),
        "fe_trace": fe_trace,
        "fe_first": fe_trace[0] if fe_trace else None,
        "fe_last": fe_trace[-1] if fe_trace else None,
        "theta": theta.tolist(),
        "theta_softplus": softplus(theta).tolist(),
        "hyperopt_seconds": hyperopt_s,
        "smoothing_seconds": smooth_s,
        "host_ms_per_epoch": hyperopt_s / max(epochs, 1) * 1e3,
        "lbfgs_evaluations": counts.get("evaluations", 0),
        "lbfgs_graph_captures": counts.get("graph_captures", 0),
        "host_reads": counts.get("host_reads", 0),
        "gram_launches": launches,
        "final_smoothing": (f"sp_jacobi({SMOOTHING_SWEEPS}, {sp_ranks} ranks)" if sp_ranks > 1
                            else "pit(4, 30)" if pit else f"jacobi({SMOOTHING_SWEEPS})"),
        "mstep": "lbfgs" if use_lbfgs else "adamax",
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "dtype": str(dtype).removeprefix("torch."),
        "finite": all(math.isfinite(v) for v in fe_trace),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("--f32", action="store_true", help="f32-first mode (kernel Grams)")
    ap.add_argument("--pit", action="store_true", help="parallel-in-time final smoothing")
    ap.add_argument("--faithful", action="store_true",
                    help="the reference's M-step: AdaMax lr 0.002, constant, fresh E-steps")
    ap.add_argument("--sp", nargs="?", type=int, const=4, default=0, metavar="N",
                    help="sequence-parallel final smoothing on N ranks (default 4)")
    ap.add_argument("--chunk", type=int, help="epochs per chunk")
    ap.add_argument("--ckpt", metavar="PATH", help="checkpoint after every chunk; resume from it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", help="also write the result line to PATH")
    args = ap.parse_args(argv)
    try:
        check_sp_ranks(args.sp, args.device)  # now, not after the hyperparameter epochs
    except ValueError as e:
        ap.error(str(e))
    kw = dict(epochs=args.epochs, pit=args.pit, device=args.device,
              dtype=torch.float32 if args.f32 else torch.float64, sp_ranks=args.sp,
              chunk=args.chunk, checkpoint_path=args.ckpt)
    if args.faithful:
        kw.update(n_iters=25, adamax_steps=100, fresh_estep=True, use_lbfgs=False,
                  adamax_lr=0.002, adamax_decay=1.0)
    line = json.dumps(run(**kw))
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
