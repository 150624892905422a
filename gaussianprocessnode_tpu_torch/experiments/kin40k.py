"""kin40k large-scale regression, on the card.

Counterpart of ``experiments/kin40k.py::run``: N = 10,000 training and
30,000 test points in 8-D, M = 600 inducing inputs drawn from the training
rows (or given: ``--xu PATH``, an array file or a JLD file, e.g. the
reference's saved draw), minibatches of 500 (20 batches), w fixed at 1e4,
ARD-SE kernel (9 θ, softplus) through the hand-written CUDA Gram,
``fit_kin40k_fast`` for ``--epochs`` epochs (``--stats-refreshes`` q(v)
refreshes per epoch, learning rate ``--learning-rate``), then the
predictive means at the test inputs and their SMSE. As in the JAX runner,
the epochs run through ``utils/driver.py::chunked_run``: in chunks of 100
epochs, and with ``--faithful`` of max(10, ⌊50·34/budget⌋), each chunk
resumed from the last one's carry and ended by one host read. ``--faithful``
trains with the per-batch ``fit_kin40k`` instead and, as the JAX runner
does, in float64, whose Grams take the plain route by dtype
(``ops/se_gram.py::se_gram_auto``); ``run(faithful=True,
dtype=torch.float32)`` keeps it in float32, through the kernel.
``--ns-budget`` sets the faithful trainer's Newton–Schulz count (34 by
default).

    python -m gaussianprocessnode_tpu_torch.experiments.kin40k --epochs 500 [--faithful [--ns-budget 60]]
        [--xu PATH] [--learning-rate LR] [--stats-refreshes G]

prints one JSON line: ``value`` (seconds for the epochs, host clock
between two ``torch.cuda.synchronize()`` calls; with ``run(warm_timing=
True)`` those of a second run from the same start), ``first_seconds``
(the first run's), ``smse``, ``device`` (the
card's name and power limit from nvidia-smi), ``gram_launches`` (kernel
launches during the epochs) and ``data``. ``--data synthetic`` (the
default) trains on ``utils/datasets.py::kin40k_synthetic`` data from
``--seed``; ``--data kin40k`` reads the kin40k files and raises where they
are absent.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..dists import MvGaussianNat
from ..infer.batch_vmp import predict_out
from ..infer.minibatch import (KIN40K_BATCH_NS_ITERS, fit_kin40k, fit_kin40k_fast,
                               init_kin40k_fast_state)
from ..ops.kernels import Kernel, invsoftplus
from ..ops.linalg import ir_solve, spd_inverse_ns, sym
from ..ops.se_gram import se_gram_cuda
from ..utils.datasets import kin40k, kin40k_synthetic
from ..utils.driver import chunked_run
from ..utils.metrics import smse
from ..utils.profiling import card_info, synchronize

__all__ = ["W_VAL", "FAST_CHUNK", "faithful_chunk", "load_data", "load_xu", "setup", "run"]

W_VAL = 1e4  # kin40k's fixed noise precision
FAST_CHUNK = 100  # the fast trainer's epochs per chunk


def faithful_chunk(ns_budget: int) -> int:
    """The per-batch trainer's epochs per chunk, scaled by its budget as
    the JAX runner scales them: max(10, ⌊50·34/budget⌋)."""
    return max(10, int(50 * 34 / ns_budget))


def load_xu(path: str) -> np.ndarray:
    """Inducing inputs (M, 8) from a JLD file (``utils/jld.py``) or an
    array file numpy reads (.npy)."""
    if path.endswith(".jld"):
        from ..utils.jld import load_jld

        return np.asarray(load_jld(path))
    return np.load(path)


def load_data(data: str = "synthetic", seed: int = 1, n_test: int = 30_000):
    """The training and test data: ``"synthetic"`` (from ``seed``) or
    ``"kin40k"`` (the reference's files, which must be present)."""
    if data == "synthetic":
        return kin40k_synthetic(seed, n_test=n_test)
    if data == "kin40k":
        return kin40k()
    raise ValueError(f"data must be 'synthetic' or 'kin40k', not {data!r}")


def setup(ds, m_inducing=600, batch_size=500, n_train=10_000, seed=1, device="cuda",
          dtype=torch.float32, xu=None):
    """The trainer's arguments, as ``experiments/kin40k.py::run`` builds
    them: batched training data, M inducing inputs drawn from the training
    rows by ``seed`` (or ``xu``, given; M is then its rows), θ0 =
    softplus⁻¹(1), the prior N(0, 50·I) on v, made in ``dtype`` on
    ``device``."""
    dev = torch.device(device)
    Xtr = torch.as_tensor(ds.x_train[:n_train], dtype=dtype, device=dev)
    ytr = torch.as_tensor(ds.y_train[:n_train], dtype=dtype, device=dev)
    if xu is None:
        pos = np.random.default_rng(seed).permutation(n_train)[:m_inducing]
        xu = ds.x_train[pos]
    Xu = torch.as_tensor(np.asarray(xu), dtype=dtype, device=dev)
    m_inducing = Xu.shape[0]
    B = n_train // batch_size
    Xb = Xtr[: B * batch_size].reshape(B, batch_size, -1)
    yb = ytr[: B * batch_size].reshape(B, batch_size)
    theta0 = invsoftplus(torch.ones(1 + Xtr.shape[1], dtype=dtype, device=dev))
    prior_v = MvGaussianNat(torch.zeros(m_inducing, dtype=dtype, device=dev),
                            torch.eye(m_inducing, dtype=dtype, device=dev) / 50.0)
    return theta0, Xu, Xb, yb, prior_v


def predict(kernel, theta, Xu, qv_nat, cov64, X_test):
    """Predictive means at ``X_test``: μ_v from the trained (ξ, Λ) by
    iterative refinement on the trainer's warm inverse (``cov64``; None
    computes it, by 60 Newton–Schulz iterations, as the JAX runner does
    after its faithful trainer), then K(Xu, X)ᵀμ_v in θ's dtype."""
    prec = sym(qv_nat.prec)
    if cov64 is None:
        cov64 = spd_inverse_ns(prec, iters=60)
    mu_v = ir_solve(prec, qv_nat.xi, cov64, rounds=4).to(theta.dtype)
    w = torch.full((), W_VAL, dtype=torch.float64, device=theta.device)
    mean, _ = predict_out(kernel, theta, Xu, X_test, mu_v, w)
    return mean


def run(epochs: int = 500, m_inducing: int = 600, batch_size: int = 500,
        n_train: int = 10_000, n_test: int = 30_000, seed: int = 1,
        data: str = "synthetic", device: str = "cuda", faithful: bool = False,
        dtype=None, ns_budget: int = KIN40K_BATCH_NS_ITERS, xu=None,
        learning_rate: float = 0.001, stats_refreshes: int = 1,
        warm_timing: bool = False) -> dict:
    """Train θ for ``epochs`` epochs at ``learning_rate`` with
    ``fit_kin40k_fast`` (``stats_refreshes`` statistics refreshes per
    epoch) or, with ``faithful``, ``fit_kin40k`` at ``ns_budget``, in
    chunks through ``chunked_run``, and score the test set. ``xu``: the
    inducing inputs (default: M training rows drawn by ``seed``). ``dtype``
    defaults to float32, and to float64 with ``faithful``. With
    ``warm_timing`` the epochs run a second time, from the same θ0 and
    carry, and ``value`` is that run's seconds (the kernel's build and the
    first allocations are then outside it); ``first_seconds`` is the first
    run's in both modes. The second run's θ, ξ and Λ equal the first's bit
    for bit (the trainers draw nothing at random), which
    ``warm_equals_first`` records (None without ``warm_timing``). Returns
    the result dict that the command line prints; ``gram_launches`` counts
    the first run's."""
    dev = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if faithful else torch.float32
    ds = load_data(data, seed, n_test)
    theta0, Xu, Xb, yb, prior_v = setup(ds, m_inducing, batch_size, n_train, seed, dev,
                                        dtype, xu)
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    if dev.type == "cuda":
        from ..ops.se_gram import _kernel_fn

        _kernel_fn()  # build and load the kernel before the clock starts

    def train():
        if faithful:
            theta, qv_nat, _ = chunked_run(
                lambda e, st: fit_kin40k(kernel, theta0, Xu, Xb, yb, prior_v, W_VAL, e,
                                         learning_rate=learning_rate, resume_state=st,
                                         ns_budget=ns_budget),
                epochs, faithful_chunk(ns_budget), None)
            return theta, qv_nat, None
        groups = max(1, min(stats_refreshes, Xb.shape[0]))
        theta, qv_nat, cov64, _ = chunked_run(
            lambda e, st: fit_kin40k_fast(kernel, theta0, Xu, Xb, yb, prior_v, W_VAL, e,
                                          learning_rate=learning_rate,
                                          stats_refreshes=stats_refreshes, resume_state=st),
            epochs, FAST_CHUNK, init_kin40k_fast_state(theta0, prior_v, Xu.shape[0], groups))
        return theta, qv_nat, cov64

    def timed():
        synchronize(dev)
        t0 = time.perf_counter()
        out = train()
        synchronize(dev)
        return out, time.perf_counter() - t0

    se_gram_cuda.launches = 0
    (theta, qv_nat, cov64), seconds = timed()
    launches = se_gram_cuda.launches
    first_seconds = seconds
    warm_equal = None
    if warm_timing:
        first = (theta, qv_nat.xi, qv_nat.prec)
        (theta, qv_nat, cov64), seconds = timed()
        warm_equal = all(torch.equal(a, b) for a, b in zip(first, (theta, qv_nat.xi, qv_nat.prec)))
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    mean = predict(kernel, theta, Xu, qv_nat, cov64, X_test)
    score = float(smse(torch.as_tensor(ds.y_test), mean.cpu().double()))
    return {
        "metric": "kin40k_train_wallclock",
        "value": seconds,
        "unit": "s",
        "first_seconds": first_seconds,
        "warm_timing": warm_timing,
        "warm_equals_first": warm_equal,
        "trainer": "fit_kin40k" if faithful else "fit_kin40k_fast",
        "dtype": str(dtype).removeprefix("torch."),
        "epochs": epochs,
        "smse": score,
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "gram_launches": launches,
        "data": data,
        "seed": seed,
        "ns_budget": ns_budget if faithful else None,
        "learning_rate": learning_rate,
        "stats_refreshes": None if faithful else stats_refreshes,
        "m_inducing": Xu.shape[0],
        "theta": theta.tolist(),
        "theta_softplus": torch.logaddexp(theta, torch.zeros_like(theta)).tolist(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--data", choices=("synthetic", "kin40k"), default="synthetic")
    ap.add_argument("--faithful", action="store_true",
                    help="the per-batch schedule fit_kin40k, in float64")
    ap.add_argument("--ns-budget", type=int, default=KIN40K_BATCH_NS_ITERS,
                    help="fit_kin40k's Newton-Schulz iterations per batch (--faithful)")
    ap.add_argument("--xu", metavar="PATH", help="inducing inputs (.npy or .jld)")
    ap.add_argument("--learning-rate", type=float, default=0.001)
    ap.add_argument("--stats-refreshes", type=int, default=1,
                    help="fit_kin40k_fast's q(v) statistics refreshes per epoch")
    args = ap.parse_args(argv)
    out = run(epochs=args.epochs, seed=args.seed, data=args.data, faithful=args.faithful,
              ns_budget=args.ns_budget, xu=None if args.xu is None else load_xu(args.xu),
              learning_rate=args.learning_rate, stats_refreshes=args.stats_refreshes)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
