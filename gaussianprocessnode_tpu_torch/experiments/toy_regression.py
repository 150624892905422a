"""Toy 1-D sinc regression (the reference's GPT_regression.ipynb), on the card.

Counterpart of ``experiments/toy_regression.py::run``, at its configuration:
N = 50 training points of ``utils/datasets.py::toy_sinc`` (seed 3), 600 test
points, M = 20 inducing inputs on a grid over [−4, 4], prior v ~ N(0, 50·I),
w ~ Γ(1e-2, 1e-2), softplus-SE kernel from θ0 = softplus⁻¹([1, 1]), and per
epoch 7 VMP sweeps then 60 L-BFGS steps on the backward-message objective
(``infer/training.py::fit_regression``), in float64. Then the test points
are predicted by the :out rule and scored by SMSE against the noiseless
sinc.

    python -m gaussianprocessnode_tpu_torch.experiments.toy_regression [--epochs 300]

prints one JSON line: ``smse``, ``theta_softplus``, ``fe_first`` and
``fe_last`` (the free energy of the first and last epoch), ``seconds`` (the
training, host clock between two ``torch.cuda.synchronize()`` calls),
``host_ms_per_epoch``, ``linesearch_steps_per_lbfgs_step`` and
``evaluations_per_lbfgs_step`` (the objective's value-and-gradient calls,
the step's own included), ``host_reads_per_epoch`` (one per linesearch
iteration: the trainer's only reads of the device), ``gram_launches`` (the
SE Gram kernel's launches the device ran during training, as its wrapper
counts them: the eager ones and those of each replay of an epoch's CUDA
graph) and ``device`` (the card's name and power limit from
nvidia-smi). ``--f32`` trains in float32, whose Grams go through the
hand-written CUDA kernel; in float64 they take the plain route by dtype,
as in the JAX package. ``--data reference`` reads the reference's
own draw (``savefiles/*_toyregression.jld``) and raises where it is
absent. ``--device cpu`` runs on the host. ``--json=PATH`` also writes the
line to PATH.
"""

import argparse
import json
import time

import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..infer.batch_vmp import predict_out
from ..infer.training import fit_regression
from ..ops._build import load_library
from ..ops.kernels import Kernel, invsoftplus, softplus
from ..ops.se_gram import se_gram_cuda
from ..utils.datasets import toy_sinc, toy_sinc_reference
from ..utils.metrics import smse
from ..utils.profiling import card_info, synchronize

__all__ = ["LBFGS_STEPS", "setup", "run"]

LBFGS_STEPS = 60


def setup(ds, m_inducing: int = 20, device="cuda", dtype=torch.float64):
    """The trainer's arguments, as ``experiments/toy_regression.py::run``
    builds them, in ``dtype`` on ``device``: (θ0, Xu, X, y, prior_v,
    prior_w)."""
    dev = torch.device(device)
    X = torch.as_tensor(ds.x_train, dtype=dtype, device=dev)
    y = torch.as_tensor(ds.y_train, dtype=dtype, device=dev)
    Xu = torch.linspace(-4.0, 4.0, m_inducing, dtype=torch.float64).to(dtype).to(dev)[:, None]
    theta0 = invsoftplus(torch.ones(2, dtype=torch.float64)).to(dtype).to(dev)
    prior_v = MvGaussianNat(torch.zeros(m_inducing, dtype=dtype, device=dev),
                            torch.eye(m_inducing, dtype=dtype, device=dev) / 50.0)
    prior_w = GammaShapeRate(torch.full((), 1e-2, dtype=dtype, device=dev),
                             torch.full((), 1e-2, dtype=dtype, device=dev))
    return theta0, Xu, X, y, prior_v, prior_w


def run(epochs: int = 300, n_iters: int = 7, m_inducing: int = 20, data: str = "local",
        device="cuda", dtype=torch.float64) -> dict:
    """Train for ``epochs`` epochs and score the test points. Returns the
    result dict that the command line prints."""
    dev = torch.device(device)
    ds = toy_sinc() if data == "local" else toy_sinc_reference()
    theta0, Xu, X, y, prior_v, prior_w = setup(ds, m_inducing, dev, dtype)
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    if dev.type == "cuda" and dtype == torch.float32:
        load_library()  # build and load the kernels before the clock starts
    counts = {}
    synchronize(dev)
    se_gram_cuda.launches = 0
    t0 = time.perf_counter()
    theta, fe_trace, res = fit_regression(kernel, theta0, Xu, X, y, prior_v, prior_w,
                                          epochs=epochs, n_iters=n_iters, lbfgs_steps=LBFGS_STEPS,
                                          counts=counts)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = se_gram_cuda.launches
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        mean, _ = predict_out(kernel, theta, Xu, X_test, res.qv.mean, gamma_mean(res.qw))
    fe = fe_trace.tolist()
    steps = epochs * LBFGS_STEPS
    return {
        "metric": "toy_regression_train_wallclock",
        "value": seconds,
        "unit": "s",
        "epochs": epochs,
        "smse": float(smse(torch.as_tensor(ds.y_test), mean.cpu().to(torch.float64))),
        "theta_softplus": softplus(theta).tolist(),
        "fe_first": fe[0] if fe else None,
        "fe_last": fe[-1] if fe else None,
        "seconds": seconds,
        "host_ms_per_epoch": seconds / max(epochs, 1) * 1e3,
        "linesearch_steps_per_lbfgs_step": counts.get("linesearch_steps", 0) / max(steps, 1),
        "evaluations_per_lbfgs_step": counts.get("evaluations", 0) / max(steps, 1),
        "host_reads_per_epoch": counts.get("host_reads", 0) / max(epochs, 1),
        "gram_launches": launches,
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "data": data,
        "dtype": str(dtype).removeprefix("torch."),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--data", choices=("local", "reference"), default="local")
    ap.add_argument("--f32", action="store_true", help="train in float32 (kernel Grams)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", help="also write the result line to PATH")
    args = ap.parse_args(argv)
    out = run(epochs=args.epochs, data=args.data, device=args.device,
              dtype=torch.float32 if args.f32 else torch.float64)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
