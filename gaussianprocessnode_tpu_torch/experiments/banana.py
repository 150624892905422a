"""Banana 2-D probit classification, on the card.

Counterpart of ``experiments/banana.py::run`` (classification_banana.ipynb):
4,000 training and 1,300 test points, M = 500 inducing inputs drawn from
the training rows (or given: ``--xu PATH``, an array file or a JLD file,
e.g. the reference's saved draw; M is then its rows), minibatches of 200
(20 batches), ARD-SE kernel (3 θ, softplus) through the hand-written CUDA
Gram, probit likelihood, q(v) with prior N(0, 50·I) and the Gamma q(w)
(prior shape and rate 1e-2) carried across batches. The fast trainer
``fit_banana_fast`` is the default, started from ``init_banana_state``
(built before the clock); ``--faithful`` runs the per-batch
``fit_banana``, started from None. As in the JAX runner, the epochs run
through ``utils/driver.py::chunked_run`` in chunks of 100 (``CHUNK``),
each chunk resumed from the last one's carry and ended by one host read.
Then μ_v is recovered (60 Newton–Schulz iterations, 4 rounds of
refinement) and the test points are classified by ``predict_probit`` at
the 0.5 threshold.

    python -m gaussianprocessnode_tpu_torch.experiments.banana [--epochs 500] [--faithful]
        [--f64] [--xu PATH] [--warm] [--json=PATH]

prints one JSON line: ``errors`` and ``error_rate`` on the test points,
``seconds`` (the training, host clock between two
``torch.cuda.synchronize()`` calls; with ``--warm`` those of a second run
from the same θ0 and initial carry), ``first_seconds`` (the first run's),
``warm_timing``, ``warm_equals_first`` (with ``--warm``: whether the
second run's θ, ξ, Λ and q(w) equal the first's bit for bit; else null),
``theta`` and ``theta_softplus``, ``w_mean``, ``m_inducing``, ``device`` (the card's
name and power limit from nvidia-smi), ``gram_launches`` (kernel launches
during the first run's training) and ``data``. ``--data synthetic`` (the
default) trains on ``utils/datasets.py::banana_synthetic`` data from
``--seed``; ``--data banana`` reads the banana file and raises where it is
absent. ``--f64`` trains in float64, whose Grams take the plain route by
dtype. ``--json=PATH`` also writes the line to PATH.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..infer.batch_vmp import predict_probit
from ..infer.minibatch import fit_banana, fit_banana_fast, init_banana_state
from ..ops._build import load_library
from ..ops.kernels import Kernel, invsoftplus, softplus
from ..ops.linalg import ir_solve, spd_inverse_ns, sym
from ..ops.se_gram import se_gram_cuda
from ..utils.datasets import banana, banana_synthetic
from ..utils.driver import chunked_run
from ..utils.metrics import error_rate, num_error
from ..utils.profiling import card_info, synchronize
from .kin40k import load_xu

__all__ = ["CHUNK", "load_data", "load_xu", "setup", "predict", "run"]

CHUNK = 100  # epochs per chunk, both trainers (the JAX runner's)


def load_data(data: str = "synthetic", seed: int = 1):
    """The training and test data: ``"synthetic"`` (from ``seed``) or
    ``"banana"`` (the reference's file, which must be present)."""
    if data == "synthetic":
        return banana_synthetic(seed)
    if data == "banana":
        return banana()
    raise ValueError(f"data must be 'synthetic' or 'banana', not {data!r}")


def setup(ds, m_inducing=500, batch_size=200, seed=1, device="cuda",
          dtype=torch.float32, xu=None):
    """The trainer's arguments, as ``experiments/banana.py::run`` builds
    them: batched training data, M inducing inputs drawn from the training
    rows by ``seed`` (or ``xu``, given; M is then its rows), θ0 =
    softplus⁻¹(1), the prior N(0, 50·I) on v and Gamma(1e-2, 1e-2) on w,
    made in ``dtype`` on ``device``."""
    dev = torch.device(device)
    n_train = ds.x_train.shape[0]
    Xtr = torch.as_tensor(ds.x_train, dtype=dtype, device=dev)
    ytr = torch.as_tensor(ds.y_train, dtype=dtype, device=dev)
    if xu is None:
        xu = ds.x_train[np.random.default_rng(seed).permutation(n_train)[:m_inducing]]
    Xu = torch.as_tensor(np.asarray(xu), dtype=dtype, device=dev)
    m_inducing = Xu.shape[0]
    B = n_train // batch_size
    Xb = Xtr[: B * batch_size].reshape(B, batch_size, -1)
    yb = ytr[: B * batch_size].reshape(B, batch_size)
    theta0 = invsoftplus(torch.ones(1 + Xtr.shape[1], dtype=dtype, device=dev))
    prior_v = MvGaussianNat(torch.zeros(m_inducing, dtype=dtype, device=dev),
                            torch.eye(m_inducing, dtype=dtype, device=dev) / 50.0)
    prior_w = GammaShapeRate(torch.full((), 1e-2, dtype=dtype, device=dev),
                             torch.full((), 1e-2, dtype=dtype, device=dev))
    return theta0, Xu, Xb, yb, prior_v, prior_w


def predict(kernel, theta, Xu, qv_nat, qw, X_test):
    """P(y=1) at ``X_test``: μ_v from the trained (ξ, Λ) (60 Newton–Schulz
    iterations, 4 rounds of refinement) in Λ's dtype, then
    ``predict_probit`` in θ's dtype with w̄ = shape/rate."""
    prec = sym(qv_nat.prec)
    cov = spd_inverse_ns(prec, iters=60)
    mu_v = ir_solve(prec, qv_nat.xi, cov, rounds=4).to(theta.dtype)
    return predict_probit(kernel, theta, Xu, X_test, mu_v, gamma_mean(qw))


def run(epochs: int = 500, m_inducing: int = 500, batch_size: int = 200, seed: int = 1,
        fast: bool = True, data: str = "synthetic", device: str = "cuda",
        dtype=torch.float32, xu=None, warm_timing: bool = False) -> dict:
    """Train for ``epochs`` epochs (learning rate 1e-3) with
    ``fit_banana_fast`` (``fast``, from ``init_banana_state``) or
    ``fit_banana`` (from None), in chunks of ``CHUNK`` epochs through
    ``chunked_run``, then classify the test points. ``xu``: the inducing
    inputs (default: M training rows drawn by ``seed``). With
    ``warm_timing`` the epochs run a second time, from the same θ0 and
    initial carry, and ``seconds`` is that run's (the first allocations
    are then outside it); ``first_seconds`` is the first run's in both
    modes. The second run's θ, ξ, Λ and q(w) equal the first's bit for bit
    (the trainers draw nothing at random), which ``warm_equals_first``
    records (None without ``warm_timing``). Returns the result dict that
    the command line prints; ``gram_launches`` counts the first run's."""
    dev = torch.device(device)
    ds = load_data(data, seed)
    theta0, Xu, Xb, yb, prior_v, prior_w = setup(ds, m_inducing, batch_size, seed, dev,
                                                 dtype, xu)
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    if dev.type == "cuda":
        load_library()  # build and load the kernels before the clock starts
    trainer = fit_banana_fast if fast else fit_banana
    state0 = init_banana_state(kernel, theta0, Xu, prior_v, prior_w) if fast else None

    def timed():
        synchronize(dev)
        t0 = time.perf_counter()
        theta, qv_nat, qw, _ = chunked_run(
            lambda e, st: trainer(kernel, theta0, Xu, Xb, yb, prior_v, prior_w, e,
                                  resume_state=st),
            epochs, CHUNK, state0)
        synchronize(dev)
        return (theta, qv_nat, qw), time.perf_counter() - t0

    se_gram_cuda.launches = 0
    (theta, qv_nat, qw), seconds = timed()
    launches = se_gram_cuda.launches
    first_seconds = seconds
    warm_equal = None
    if warm_timing:
        first = (theta, qv_nat.xi, qv_nat.prec, qw.shape, qw.rate)
        (theta, qv_nat, qw), seconds = timed()
        warm_equal = all(torch.equal(a, b) for a, b in
                         zip(first, (theta, qv_nat.xi, qv_nat.prec, qw.shape, qw.rate)))
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        probs = predict(kernel, theta, Xu, qv_nat, qw, X_test)
    pred = (probs >= 0.5).to(torch.float64).cpu()
    y_test = torch.as_tensor(ds.y_test)
    return {
        "metric": "banana_train_wallclock",
        "value": seconds,
        "unit": "s",
        "first_seconds": first_seconds,
        "warm_timing": warm_timing,
        "warm_equals_first": warm_equal,
        "trainer": "fit_banana_fast" if fast else "fit_banana",
        "epochs": epochs,
        "errors": float(num_error(y_test, pred)),
        "error_rate": float(error_rate(y_test, pred)),
        "n_test": int(y_test.shape[0]),
        "seconds": seconds,
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "gram_launches": launches,
        "data": data,
        "seed": seed,
        "dtype": str(dtype).removeprefix("torch."),
        "m_inducing": Xu.shape[0],
        "theta": theta.tolist(),
        "theta_softplus": softplus(theta).tolist(),
        "w_mean": float(gamma_mean(qw)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--data", choices=("synthetic", "banana"), default="synthetic")
    ap.add_argument("--faithful", action="store_true",
                    help="the per-batch schedule fit_banana")
    ap.add_argument("--f64", action="store_true", help="train in float64")
    ap.add_argument("--xu", metavar="PATH", help="inducing inputs (.npy or .jld)")
    ap.add_argument("--warm", action="store_true",
                    help="train a second time from the same start and time that run")
    ap.add_argument("--json", metavar="PATH", help="also write the result line to PATH")
    args = ap.parse_args(argv)
    out = run(epochs=args.epochs, seed=args.seed, data=args.data, fast=not args.faithful,
              dtype=torch.float64 if args.f64 else torch.float32,
              xu=None if args.xu is None else load_xu(args.xu), warm_timing=args.warm)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
