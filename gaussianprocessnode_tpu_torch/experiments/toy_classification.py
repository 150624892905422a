"""Toy 1-D probit classification (the reference's GPT_classification.ipynb),
on the card.

Counterpart of ``experiments/toy_classification.py::run``, at its
configuration: N = 100 training points of
``utils/datasets.py::toy_classification`` (seed 7), 400 test points on a
grid, M = 15 inducing inputs on a grid over [−5, 5], prior v ~ N(0, 50·I),
w ~ Γ(1e-2, 1e-2) (also q(w)'s start), a probit likelihood with latent f,
softplus-SE kernel from θ0 = softplus⁻¹([1, 1]), and per epoch 30 VMP
sweeps then 60 L-BFGS steps on the pseudo-targets f̄ = E[q(f)]
(``infer/training.py::fit_classification``), in float64. Then the test
points are classified by ``predict_probit`` at the 0.5 threshold.

    python -m gaussianprocessnode_tpu_torch.experiments.toy_classification [--epochs 500]

prints one JSON line: ``errors`` and ``error_rate``, ``theta_softplus``,
``fe_first`` and ``fe_last``, ``seconds`` (the training, host clock between
two ``torch.cuda.synchronize()`` calls), ``host_ms_per_epoch``,
``linesearch_steps_per_lbfgs_step``, ``evaluations_per_lbfgs_step``,
``host_reads_per_epoch``, ``gram_launches``, ``device`` (the card's name
and power limit from nvidia-smi), and ``near_half`` (the test points whose
probability lies within 1e-6 of 0.5). ``--f32``, ``--data reference``,
``--device`` and ``--json`` as in ``toy_regression``.
"""

import argparse
import json
import time

import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..infer.batch_vmp import predict_probit
from ..infer.training import fit_classification
from ..ops._build import load_library
from ..ops.kernels import Kernel, invsoftplus, softplus
from ..ops.se_gram import se_gram_cuda
from ..utils.datasets import toy_classification, toy_classification_reference
from ..utils.metrics import error_rate, num_error
from ..utils.profiling import card_info, synchronize

__all__ = ["LBFGS_STEPS", "setup", "run"]

LBFGS_STEPS = 60


def setup(ds, m_inducing: int = 15, device="cuda", dtype=torch.float64):
    """The trainer's arguments, as ``experiments/toy_classification.py::run``
    builds them, in ``dtype`` on ``device``: (θ0, Xu, X, y, prior_v,
    prior_w, init_w)."""
    dev = torch.device(device)
    X = torch.as_tensor(ds.x_train, dtype=dtype, device=dev)
    y = torch.as_tensor(ds.y_train, dtype=dtype, device=dev)
    Xu = torch.linspace(-5.0, 5.0, m_inducing, dtype=torch.float64).to(dtype).to(dev)[:, None]
    theta0 = invsoftplus(torch.ones(2, dtype=torch.float64)).to(dtype).to(dev)
    prior_v = MvGaussianNat(torch.zeros(m_inducing, dtype=dtype, device=dev),
                            torch.eye(m_inducing, dtype=dtype, device=dev) / 50.0)

    def gamma():
        return GammaShapeRate(torch.full((), 1e-2, dtype=dtype, device=dev),
                              torch.full((), 1e-2, dtype=dtype, device=dev))

    return theta0, Xu, X, y, prior_v, gamma(), gamma()


def run(epochs: int = 500, n_iters: int = 30, m_inducing: int = 15, data: str = "local",
        device="cuda", dtype=torch.float64) -> dict:
    """Train for ``epochs`` epochs and classify the test points. Returns the
    result dict that the command line prints."""
    dev = torch.device(device)
    ds = toy_classification() if data == "local" else toy_classification_reference()
    theta0, Xu, X, y, prior_v, prior_w, init_w = setup(ds, m_inducing, dev, dtype)
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    if dev.type == "cuda" and dtype == torch.float32:
        load_library()  # build and load the kernels before the clock starts
    counts = {}
    synchronize(dev)
    se_gram_cuda.launches = 0
    t0 = time.perf_counter()
    theta, fe_trace, res = fit_classification(kernel, theta0, Xu, X, y, prior_v, prior_w,
                                              init_w, epochs=epochs, n_iters=n_iters,
                                              lbfgs_steps=LBFGS_STEPS, counts=counts)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = se_gram_cuda.launches
    X_test = torch.as_tensor(ds.x_test, dtype=dtype, device=dev)
    with torch.no_grad():
        probs = predict_probit(kernel, theta, Xu, X_test, res.qv.mean,
                               gamma_mean(res.qw)).cpu().to(torch.float64)
    pred = (probs >= 0.5).to(torch.float64)
    y_test = torch.as_tensor(ds.y_test)
    near = torch.nonzero(torch.abs(probs - 0.5) <= 1e-6).flatten().tolist()
    fe = fe_trace.tolist()
    steps = epochs * LBFGS_STEPS
    return {
        "metric": "toy_classification_train_wallclock",
        "value": seconds,
        "unit": "s",
        "epochs": epochs,
        "errors": float(num_error(y_test, pred)),
        "error_rate": float(error_rate(y_test, pred)),
        "n_test": int(y_test.shape[0]),
        "near_half": [[i, float(probs[i])] for i in near],
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
    ap.add_argument("--epochs", type=int, default=500)
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
