"""The VSGP (ELBO-trained SVGP) and FITC/SoR baselines, on the card.

Counterpart of ``experiments/vsgp_baselines.py`` (the reference's
comparison notebooks Regression_VSGP.ipynb, Classification_VSGP.ipynb and
Regression_FITC_SoR), one runner for each of its runners:

- ``kin40k_collapsed``: the north-star run. Titsias' collapsed bound at
  M = 600, N = 10,000, D = 8 in float32, full-batch AdaMax (lr 0.05, fixed
  noise 0.01, jitter 1e-5) for 400 steps in chunks of 25, θ snapshotted per
  chunk (one host read of the chunk's last −ELBO, as the JAX runner); after
  training each snapshot is scored by ``collapsed_predict`` in float64 on
  the card (the JAX runner pins that solve to the host CPU only because its
  TPU emulates float64). Both Grams of a step, Kuu 600×600 and Kux
  600×10000, go through the hand-written CUDA kernel; their VJP is in
  matmuls;
- ``kin40k``: the uncollapsed minibatch SVGP (batches of 500);
- ``banana``: the Bernoulli-probit ELBO, M = 500, batches of 200;
- ``fitc_sor_kin40k``: SoR and FITC on the NLML at kin40k width;
- ``toy_regression``, ``toy_classification`` and ``fitc_sor_toy`` on the
  port's local toy draws.

All but the first run in float64, as the JAX runners do, so their Grams
take the plain route by dtype.

The inducing inputs are M training rows drawn by ``--seed`` (the kin40k
and banana runners of this package do the same), or the toy runners' grids:
the reference's saved ``Xu_*.jld`` sets are not in the repository. The
kin40k and banana runners train on ``utils/datasets.py``'s synthetic data
of those shapes unless ``--data kin40k`` / ``--data banana`` names the
reference's files (which must then be present); the toy runners on the
local draws unless ``--data reference``.

    python -m gaussianprocessnode_tpu_torch.experiments.vsgp_baselines kin40k_collapsed [...]

prints one JSON line per runner named (``toy_regression`` and
``toy_classification`` when none is). ``--steps`` and ``--epochs`` replace
the runners' defaults; ``--device cpu`` runs on the host. Every line holds
the runner's accuracy, its training seconds (host clock between two
``torch.cuda.synchronize()`` calls) and the card's name and power limit
from nvidia-smi; ``kin40k_collapsed`` adds its kernel launches, SMSE and
−ELBO by snapshot and the per-step host and device time.
"""

import argparse
import json
import math
import time

import torch

from ..infer.fitc import fit_sparse_gp, init_sparse_gp, sparse_predict
from ..infer.svgp import (collapsed_opt_init, collapsed_predict, collapsed_step,
                          fit_svgp, fit_svgp_collapsed_resumable, init_svgp, svgp_predict,
                          vsgp_optimizer)
from ..nodes.probit import ndtr
from ..ops._build import load_library
from ..ops.kernels import Kernel, softplus
from ..ops.se_gram import se_gram_cuda
from ..serve import SVGPRegressor
from ..utils.datasets import (toy_classification, toy_classification_reference, toy_sinc,
                              toy_sinc_reference)
from ..utils.metrics import error_rate, num_error, smse
from ..utils.profiling import card_info, cuda_kernel_times, synchronize
from . import banana as banana_runner
from . import kin40k as kin40k_runner

__all__ = ["RUNNERS", "TARGET_SMSE", "COLLAPSED_NOISE", "COLLAPSED_JITTER",
           "run_kin40k_collapsed", "run_kin40k", "run_banana",
           "run_fitc_sor_kin40k", "run_toy_regression", "run_toy_classification",
           "run_fitc_sor_toy"]

KERNEL = Kernel("se", transform="softplus", use_kernel=True)
TARGET_SMSE = 0.087478  # the reference's kin40k VSGP SMSE (BASELINE.md)
# the collapsed run's fixed likelihood variance and Kuu jitter (the
# reference's lik_noise and jitter, Regression_VSGP.ipynb cells 15-19)
COLLAPSED_NOISE, COLLAPSED_JITTER = 0.01, 1e-5


def _device(dev):
    return card_info() if dev.type == "cuda" else {"name": str(dev)}


def _kin40k(data, seed, m_inducing, n_train, n_test, batch, dev, dtype):
    """kin40k's training batches, inducing rows, θ0 = softplus⁻¹(1) and the
    test set (``experiments/kin40k.py::setup``)."""
    ds = kin40k_runner.load_data(data, seed, n_test)
    theta0, Xu, Xb, yb, _ = kin40k_runner.setup(ds, m_inducing, batch, n_train, seed, dev,
                                                dtype)
    return ds, theta0, Xu, Xb, yb


def _toy(data, reference, local):
    return local() if data == "local" else reference()


def _classify(mean, var, y_test):
    """P(y=1) = Φ(m/√(1+v)), thresholded at ½: (errors, error rate)."""
    probs = ndtr(mean / torch.sqrt(1.0 + var))
    pred = (probs >= 0.5).to(torch.float64).cpu()
    y = torch.as_tensor(y_test)
    return float(num_error(y, pred)), float(error_rate(y, pred))


def run_kin40k_collapsed(steps: int = 400, eval_every: int = 25, learning_rate: float = 0.05,
                         m_inducing: int = 600, n_train: int = 10_000, n_test: int = 30_000,
                         seed: int = 1, data: str = "synthetic", device="cuda") -> dict:
    """Collapsed-bound training in float32 and float64 scoring of every
    snapshot (see the module docstring). ``step_device_ms`` is one chunk's
    kernel time by ``torch.profiler`` over its steps, ``step_host_ms`` the
    training seconds over the steps, ``idle_share`` 1 − their ratio."""
    dev = torch.device(device)
    noise, jitter = COLLAPSED_NOISE, COLLAPSED_JITTER
    ds, theta0, Xu, Xb, yb = _kin40k(data, seed, m_inducing, n_train, n_test, 500, dev,
                                     torch.float32)
    X, y = Xb.reshape(-1, Xb.shape[-1]), yb.reshape(-1)
    if dev.type == "cuda":
        load_library()  # build and load the kernels before the clock starts
    # warm-up outside the clock (the JAX runner compiles its chunk there):
    # the libraries' handles and workspaces, on a copy of the state
    fit_svgp_collapsed_resumable(KERNEL, theta0, collapsed_opt_init(theta0, learning_rate),
                                 Xu, X, y, noise, steps=2, learning_rate=learning_rate,
                                 jitter=jitter)
    theta, opt_state = theta0.clone(), collapsed_opt_init(theta0, learning_rate)
    snapshots = []
    synchronize(dev)
    se_gram_cuda.launches = 0
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        n = min(eval_every, steps - done)
        theta, opt_state, trace = fit_svgp_collapsed_resumable(
            KERNEL, theta, opt_state, Xu, X, y, noise, steps=n,
            learning_rate=learning_rate, jitter=jitter)
        first, last = torch.stack((trace[0], trace[-1])).tolist()  # the chunk's one host read
        done += n
        snapshots.append((done, time.perf_counter() - t0, theta.clone(), first, last))
    train_s = time.perf_counter() - t0
    launches = se_gram_cuda.launches

    step_device_ms = None
    if dev.type == "cuda":
        th, st = theta.clone(), {k: v.clone() for k, v in opt_state.items()}
        opt = vsgp_optimizer(learning_rate)
        _, kernels = cuda_kernel_times(lambda: [collapsed_step(
            KERNEL, opt, th, st, Xu, X, y, noise, jitter) for _ in range(eval_every)],
            warmup=0)
        step_device_ms = sum(ms for _, ms in kernels.values()) / eval_every

    f64 = torch.float64
    X64, y64 = X.to(f64), y.to(f64)
    Xu64 = Xu.to(f64)
    X_test = torch.as_tensor(ds.x_test, dtype=f64, device=dev)
    history, crossed = [], None
    with torch.no_grad():
        for step_n, wall, th, first, last in snapshots:
            pred = collapsed_predict(KERNEL, th.to(f64), Xu64, X_test, X64, y64, noise,
                                     jitter=jitter)
            score = float(smse(torch.as_tensor(ds.y_test), pred.cpu()))
            history.append({"step": step_n, "smse": score, "neg_elbo": last,
                            "neg_elbo_chunk_start": first, "train_wall_s": wall})
            if crossed is None and score <= TARGET_SMSE:
                crossed = history[-1]
    step_host_ms = train_s / steps * 1e3
    return {
        "runner": "kin40k_collapsed",
        "metric": "kin40k_collapsed_train_wallclock",
        "value": train_s,
        "unit": "s",
        "steps": steps,
        "eval_every": eval_every,
        "final_smse": history[-1]["smse"],
        "target_smse": TARGET_SMSE,
        "crossed": crossed,
        "history": history,
        "train_wall_s": train_s,
        "step_host_ms": step_host_ms,
        "step_device_ms": step_device_ms,
        "idle_share": None if step_device_ms is None else 1.0 - step_device_ms / step_host_ms,
        "gram_launches": launches,
        "launches_per_step": launches / steps,
        "dtype": "float32",
        "predict_dtype": "float64",
        "device": _device(dev),
        "data": data,
        "seed": seed,
        "m_inducing": m_inducing,
        "n_train": int(X.shape[0]),
        "theta_softplus": softplus(theta).tolist(),
    }


def run_kin40k(epochs: int = 2200, m_inducing: int = 600, batch: int = 500, seed: int = 1,
               data: str = "synthetic", device="cuda") -> dict:
    """The uncollapsed minibatch SVGP (fixed noise 0.01, AdaMax 0.002), in
    float64 as the JAX runner; the test rows are served through
    ``serve.SVGPRegressor`` built from the trained parameters."""
    dev, dtype = torch.device(device), torch.float64
    ds, theta0, Xu, Xb, yb = _kin40k(data, seed, m_inducing, 10_000, 30_000, batch, dev,
                                     dtype)
    params = init_svgp(theta0, m_inducing, dtype, noise=0.01)
    synchronize(dev)
    t0 = time.perf_counter()
    params = fit_svgp(KERNEL, params, Xu, Xb, yb, Xb.shape[0] * Xb.shape[1],
                      likelihood="gaussian", epochs=epochs, learn_noise=False)
    synchronize(dev)
    train_s = time.perf_counter() - t0
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    mean, _ = SVGPRegressor.from_params(KERNEL, params, Xu, device=dev)(X_test)
    return {"runner": "kin40k", "value": train_s, "unit": "s", "epochs": epochs,
            "smse": float(smse(torch.as_tensor(ds.y_test), mean.cpu().double())),
            "dtype": "float64", "device": _device(dev), "data": data, "seed": seed,
            "theta_softplus": softplus(params.theta).tolist()}


def run_banana(epochs: int = 1000, m_inducing: int = 500, batch: int = 200, seed: int = 1,
               data: str = "synthetic", device="cuda") -> dict:
    """The Bernoulli-probit SVGP (AdaMax 0.002), float64 as the JAX runner."""
    dev, dtype = torch.device(device), torch.float64
    ds = banana_runner.load_data(data, seed)
    theta0, Xu, Xb, yb, _, _ = banana_runner.setup(ds, m_inducing, batch, seed, dev, dtype)
    params = init_svgp(theta0, m_inducing, dtype)
    synchronize(dev)
    t0 = time.perf_counter()
    params = fit_svgp(KERNEL, params, Xu, Xb, yb, Xb.shape[0] * Xb.shape[1],
                      likelihood="bernoulli", epochs=epochs)
    synchronize(dev)
    train_s = time.perf_counter() - t0
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        mean, var = svgp_predict(KERNEL, params, Xu, X_test)
    errs, rate = _classify(mean, var, ds.y_test)
    return {"runner": "banana", "value": train_s, "unit": "s", "epochs": epochs,
            "errors": errs, "error_rate": rate, "n_test": int(len(ds.y_test)),
            "dtype": "float64", "device": _device(dev), "data": data, "seed": seed,
            "theta_softplus": softplus(params.theta).tolist()}


def _fitc_sor(kernel, theta0, Xu, X, y, X_test, y_test, steps, jitter):
    out = {}
    for method in ("sor", "fitc"):
        t0 = time.perf_counter()
        params, trace = fit_sparse_gp(kernel, init_sparse_gp(theta0), Xu, X, y,
                                      method=method, steps=steps, jitter=jitter)
        synchronize(X.device)
        train_s = time.perf_counter() - t0
        with torch.no_grad():
            mean, _ = sparse_predict(kernel, params, Xu, X_test, X, y, method=method,
                                     jitter=jitter)
        out[method] = {"smse": float(smse(torch.as_tensor(y_test), mean.cpu().double())),
                       "mll": -float(trace[-1]), "train_s": train_s,
                       "theta_softplus": softplus(params.theta).tolist(),
                       "noise": math.exp(float(params.log_noise))}
    return out


def run_fitc_sor_kin40k(steps: int = 300, m_inducing: int = 600, seed: int = 1,
                        data: str = "synthetic", device="cuda") -> dict:
    """SoR and FITC (learned noise, jitter 1e-6, AdaMax 0.05) at kin40k
    width, float64 as the JAX runner."""
    dev, dtype = torch.device(device), torch.float64
    ds, theta0, Xu, Xb, yb = _kin40k(data, seed, m_inducing, 10_000, 30_000, 500, dev, dtype)
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    synchronize(dev)
    out = _fitc_sor(KERNEL, theta0, Xu, Xb.reshape(-1, Xb.shape[-1]), yb.reshape(-1), X_test,
                    ds.y_test, steps, 1e-6)
    return {"runner": "fitc_sor_kin40k", "steps": steps, **out,
            "dtype": "float64", "device": _device(dev),
            "data": data, "seed": seed}


def run_toy_regression(epochs: int = 5000, data: str = "local", device="cuda") -> dict:
    """The reference's toy configuration: fixed noise 0.01, jitter 1e-5,
    ``epochs`` full-batch AdaMax(0.002) steps (Regression_VSGP cells 5-10),
    M = 20 inducing inputs on the toy runner's grid over [−4, 4]."""
    from .toy_regression import setup

    dev, dtype = torch.device(device), torch.float64
    ds = _toy(data, toy_sinc_reference, toy_sinc)
    theta0, Xu, X, y, _, _ = setup(ds, 20, dev, dtype)
    params = init_svgp(theta0, Xu.shape[0], dtype, noise=0.01)
    synchronize(dev)
    t0 = time.perf_counter()
    params = fit_svgp(KERNEL, params, Xu, X[None], y[None], len(y), likelihood="gaussian",
                      epochs=epochs, learning_rate=0.002, learn_noise=False, jitter=1e-5)
    synchronize(dev)
    train_s = time.perf_counter() - t0
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        mean, _ = svgp_predict(KERNEL, params, Xu, X_test, jitter=1e-5)
    return {"runner": "toy_regression", "value": train_s, "unit": "s", "epochs": epochs,
            "smse": float(smse(torch.as_tensor(ds.y_test), mean.cpu().double())),
            "dtype": "float64", "device": _device(dev),
            "data": data, "theta_softplus": softplus(params.theta).tolist()}


def run_toy_classification(epochs: int = 3000, data: str = "local", device="cuda") -> dict:
    """Bernoulli-probit SVGP on the toy draw (AdaMax 0.002), M = 15
    inducing inputs on the toy runner's grid over [−5, 5]."""
    from .toy_classification import setup

    dev, dtype = torch.device(device), torch.float64
    ds = _toy(data, toy_classification_reference, toy_classification)
    theta0, Xu, X, y = setup(ds, 15, dev, dtype)[:4]
    params = init_svgp(theta0, Xu.shape[0], dtype)
    synchronize(dev)
    t0 = time.perf_counter()
    params = fit_svgp(KERNEL, params, Xu, X[None], y[None], len(y), likelihood="bernoulli",
                      epochs=epochs)
    synchronize(dev)
    train_s = time.perf_counter() - t0
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        mean, var = svgp_predict(KERNEL, params, Xu, X_test)
    errs, rate = _classify(mean, var, ds.y_test)
    return {"runner": "toy_classification", "value": train_s, "unit": "s", "epochs": epochs,
            "errors": errs, "error_rate": rate, "n_test": int(len(ds.y_test)),
            "dtype": "float64", "device": _device(dev),
            "data": data, "theta_softplus": softplus(params.theta).tolist()}


def run_fitc_sor_toy(steps: int = 800, data: str = "local", device="cuda") -> dict:
    """SoR and FITC on the toy draw (the legacy notebook's toy run,
    jitter 1e-8), M = 20 on the toy regression grid."""
    from .toy_regression import setup

    dev, dtype = torch.device(device), torch.float64
    ds = _toy(data, toy_sinc_reference, toy_sinc)
    theta0, Xu, X, y, _, _ = setup(ds, 20, dev, dtype)
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    out = _fitc_sor(KERNEL, theta0, Xu, X, y, X_test, ds.y_test, steps, 1e-8)
    return {"runner": "fitc_sor_toy", "steps": steps, **out,
            "dtype": "float64", "device": _device(dev),
            "data": data}


RUNNERS = {"toy_regression": run_toy_regression,
           "toy_classification": run_toy_classification,
           "kin40k": run_kin40k,
           "kin40k_collapsed": run_kin40k_collapsed,
           "fitc_sor_toy": run_fitc_sor_toy,
           "fitc_sor_kin40k": run_fitc_sor_kin40k,
           "banana": run_banana}
_STEPS = ("kin40k_collapsed", "fitc_sor_toy", "fitc_sor_kin40k")
_SEEDED = ("kin40k", "kin40k_collapsed", "fitc_sor_kin40k", "banana")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runners", nargs="*", metavar="RUNNER",
                    help=f"any of {', '.join(RUNNERS)}")
    ap.add_argument("--steps", type=int, help="steps of the full-batch runners")
    ap.add_argument("--epochs", type=int, help="epochs of the minibatch runners")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--data", help="synthetic | kin40k | banana | local | reference")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.runners) - set(RUNNERS)
    if unknown:
        ap.error(f"unknown runner(s) {sorted(unknown)}: choose from {', '.join(RUNNERS)}")
    for name in args.runners or ["toy_regression", "toy_classification"]:
        kw = {"device": args.device}
        if args.steps is not None and name in _STEPS:
            kw["steps"] = args.steps
        if args.epochs is not None and name not in _STEPS:
            kw["epochs"] = args.epochs
        if name in _SEEDED:
            kw["seed"] = args.seed
        if args.data is not None:
            kw["data"] = args.data
        print(json.dumps(RUNNERS[name](**kw)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
