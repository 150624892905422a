"""GPLVM on oil-flow-shaped data (GPLVM.ipynb), on the card.

Counterpart of ``experiments/gplvm.py::run``, at its configuration: N = 200
rows of 12-D outputs, Din = 2, M = 30 inducing inputs drawn from the PCA
projection by ``default_rng(86)``, W = 1e2·I point mass, spherical-radial
cubature, 6 VMP sweeps per free-energy evaluation, θ = [σ², ℓ₁, ℓ₂]
(softplus) from θ0 = [1.0, 0.6, 0.5], float64 throughout (the f64 Grams
take the plain route by dtype). The hyperparameters are fitted by the
gradient EM of ``infer/gplvm.py::fit_gplvm_grad`` for ``grad_epochs``
epochs (warm-started 6-sweep E-steps, 8 L-BFGS steps on the frozen-q FE),
or with ``--nm`` by the reference's Nelder–Mead over cold 6-sweep FE
evaluations (``utils/optim.py::nelder_mead``, ``nm_iters`` iterations);
then the final 30-sweep inference gives the latents, scored by 1-NN
accuracy against the labels beside the PCA projection's.

There is no float32 mode, as in the JAX runner: the whitened prior makes
the family f64-bound (B = Kuu + w·ΣΨ2 has κ ≈ 2e8, and f32 Ψ-statistics
noise swamps the subspace the Laplace in-message needs; the JAX package
measured latent 1-NN accuracy fall from 0.875 to 0.67–0.77 in f32).

    python -m gaussianprocessnode_tpu_torch.experiments.gplvm [N] [--nm]
        [--data synthetic|oil] [--seed S] [--chunk=K] [--ckpt=PATH] [--device cuda]
        [--json=PATH]

``--chunk=K`` runs the gradient epochs in chunks of K (one host read
each), and with K < 30 the final inference as five warm-started 6-sweep
blocks (the same 30 sweeps); ``--ckpt=PATH`` saves θ, the mean-field
state, the epochs done, the free-energy trace and the seconds so far after
every chunk (``utils/checkpoint.py``), and a run started with an existing
PATH resumes from it.

``N`` is the gradient epochs (default 25), or the Nelder–Mead iterations
with ``--nm``. ``--data synthetic`` (the default) draws
``utils/datasets.py::oil_flow_synthetic(seed)``; ``--data oil`` reads the
3PhData files and raises where they are absent. Prints one JSON line: the
JAX runner's keys (``fe``, ``fe_hyperopt``, ``knn_acc``, ``knn_acc_pca``,
``theta``, ``seconds``, ``device_hyperopt_seconds``,
``final_infer_seconds``, ``fe_trace``), ``theta_softplus``, the E-step's
batched L-BFGS counts in all and per sweep (``host_reads``,
``linesearch_steps``, ``evaluations``), the M-step's, and ``device`` (the
card's name and power limit from nvidia-smi). ``--json=PATH`` also
writes the line to PATH.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..infer.gplvm import fit_gplvm_grad, gplvm_init_state, gplvm_vmp
from ..ops.kernels import Kernel, softplus
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.datasets import oil_flow, oil_flow_synthetic
from ..utils.optim import nelder_mead
from ..utils.profiling import card_info, synchronize

__all__ = ["M_INDUCING", "THETA0", "pca_2d", "knn_accuracy", "load_data", "setup", "run"]

M_INDUCING = 30
THETA0 = (1.0, 0.6, 0.5)  # reference cell 17 (raw, before softplus)
FINAL_SWEEPS = 30


def pca_2d(Y):
    """The 2-D PCA projection of the rows of Y (the latents' prior means)."""
    Yc = Y - Y.mean(axis=0)
    _, _, Vt = np.linalg.svd(Yc, full_matrices=False)
    return Yc @ Vt[:2].T


def knn_accuracy(Z, labels, k=1):
    """Leave-one-out 1-NN label accuracy of the points Z."""
    d = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nn = d.argmin(axis=1)
    return float((labels[nn] == labels).mean())


def load_data(data: str = "synthetic", seed: int = 0):
    """(Y, labels) of 200 rows: ``"synthetic"`` from ``seed``, or ``"oil"``
    (the 3PhData files, which must be present)."""
    if data == "synthetic":
        return oil_flow_synthetic(seed)
    if data == "oil":
        return oil_flow()
    raise ValueError(f"data must be 'synthetic' or 'oil', not {data!r}")


def setup(Y_np, m_inducing: int = M_INDUCING, device="cuda", dtype=torch.float64):
    """The runner's model inputs as ``experiments/gplvm.py::run`` builds
    them: (kernel, θ0, Xu, Y, prior means, prior means as numpy), Xu the
    PCA projections of ``m_inducing`` rows drawn by ``default_rng(86)``."""
    dev = torch.device(device)
    mean_X = pca_2d(Y_np)
    pos = np.random.default_rng(86).permutation(len(Y_np))[:m_inducing]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    kernel = Kernel("se", transform="softplus")
    return kernel, t(THETA0), t(mean_X[pos]), t(Y_np), t(mean_X), mean_X


def _per_sweep(counts, sweeps):
    return {k: v / sweeps for k, v in counts.items()} if sweeps else {}


def run(nm_iters: int = 25, n_iters: int = 6, grad: bool = True, grad_epochs: int = 25,
        verbose: bool = True, data: str = "synthetic", seed: int = 0,
        device: str = "cuda", chunk: int | None = None,
        checkpoint_path: str | None = None) -> dict:
    """Fit θ (gradient EM by default, in chunks of ``chunk`` epochs,
    checkpointed to ``checkpoint_path`` after each and resumed from it;
    Nelder–Mead with ``grad=False``), run the final inference (30 sweeps;
    five warm-started 6-sweep blocks when ``chunk`` < 30) and score the
    latents. Returns the result dict that the command line prints, plus
    ``latents`` and ``labels``."""
    dev = torch.device(device)
    Y_np, labels = load_data(data, seed)
    kernel, theta0, Xu, Y, Xm, mean_X = setup(Y_np, device=dev)
    counts, mcounts = {}, {}

    synchronize(dev)
    t0 = time.perf_counter()
    prev_s = 0.0  # a resumed run's seconds before this process
    if grad:
        chunk_g = grad_epochs if chunk is None else chunk
        # an explicit cold start: every chunk, the first included, resumes
        theta, state = theta0, gplvm_init_state(kernel, theta0, Xu, Y, Xm)
        fe_all = np.zeros(grad_epochs)
        done = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            ck = load_pytree(checkpoint_path, {
                "theta": theta0, "state": state, "done": np.zeros((), np.int64),
                "fe": fe_all, "hyperopt_seconds": np.zeros(())})
            theta, state = ck["theta"], ck["state"]
            done, prev_s = int(ck["done"]), float(ck["hyperopt_seconds"])
            fe_all[:done] = ck["fe"].numpy()[:done]  # the run may be longer than the saved one
        while done < grad_epochs:
            n = min(chunk_g, grad_epochs - done)
            theta, state, fe_c = fit_gplvm_grad(kernel, theta, Xu, Y, Xm, epochs=n,
                                                n_iters=n_iters, init_state=state, counts=counts,
                                                mstep_counts=mcounts)
            fe_all[done:done + n] = fe_c.cpu().numpy()
            done += n
            if checkpoint_path:
                save_pytree(checkpoint_path, {
                    "theta": theta, "state": state, "done": np.asarray(done, np.int64),
                    "fe": fe_all,
                    "hyperopt_seconds": np.asarray(prev_s + time.perf_counter() - t0)})
        history = fe_all.tolist()
        fe_val = history[-1] if history else float("nan")
        sweeps = grad_epochs * n_iters
    else:
        def fe_obj(theta):
            return gplvm_vmp(kernel, theta, Xu, Y, Xm, n_iters=n_iters, counts=counts)[1]

        theta, fe_val, history = nelder_mead(fe_obj, theta0, maxiter=nm_iters)
        sweeps = len(history) * n_iters
    synchronize(dev)
    hyperopt_s = prev_s + time.perf_counter() - t0

    t_fi = time.perf_counter()
    if chunk is not None and chunk < FINAL_SWEEPS:
        # the same 30 sweeps as five warm-started blocks of 6
        state = gplvm_init_state(kernel, theta, Xu, Y, Xm)
        for _ in range(FINAL_SWEEPS // 6):
            state, fe = gplvm_vmp(kernel, theta, Xu, Y, Xm, n_iters=6, init_state=state)
            float(fe)
    else:
        state, fe = gplvm_vmp(kernel, theta, Xu, Y, Xm, n_iters=FINAL_SWEEPS)
    synchronize(dev)
    final_infer_s = time.perf_counter() - t_fi
    Z = state.x_means.cpu().numpy()
    acc = knn_accuracy(Z, labels)
    acc_pca = knn_accuracy(mean_X, labels)
    theta_sp = softplus(theta).tolist()
    if verbose:
        which = "gradient (EM, L-BFGS M-step)" if grad else "NelderMead"
        print(f"final FE = {float(fe):.3f} ({which} best {fe_val:.3f}, "
              f"{len(history)} evals/epochs)", file=sys.stderr)
        print(f"latent 1-NN accuracy = {acc:.4f} (PCA init baseline: {acc_pca:.4f})",
              file=sys.stderr)
        print(f"hyperopt wall: {hyperopt_s:.1f}s; optimal θ (softplus) = {theta_sp}",
              file=sys.stderr)
    return {
        "fe": float(fe), "fe_hyperopt": fe_val, "knn_acc": acc, "knn_acc_pca": acc_pca,
        "theta": theta.tolist(), "theta_softplus": theta_sp,
        "seconds": hyperopt_s, "device_hyperopt_seconds": hyperopt_s,
        "final_infer_seconds": final_infer_s, "fe_trace": history,
        "optimizer": "grad" if grad else "nm", "estep_sweeps": sweeps,
        "host_reads": counts.get("host_reads", 0),
        "linesearch_steps": counts.get("linesearch_steps", 0),
        "evaluations": counts.get("evaluations", 0),
        "per_sweep": _per_sweep(counts, sweeps),
        "mstep": mcounts,
        "data": data, "seed": seed,
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "latents": Z, "labels": labels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("count", nargs="?", type=int, default=25,
                    help="gradient epochs, or Nelder-Mead iterations with --nm")
    ap.add_argument("--nm", action="store_true", help="the reference's Nelder-Mead hyperopt")
    ap.add_argument("--data", choices=("synthetic", "oil"), default="synthetic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, help="gradient epochs per chunk")
    ap.add_argument("--ckpt", metavar="PATH", help="checkpoint after every chunk; resume from it")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", help="also write the result line to PATH")
    args = ap.parse_args(argv)
    res = run(nm_iters=args.count, grad_epochs=args.count, grad=not args.nm, data=args.data,
              seed=args.seed, device=args.device, chunk=args.chunk, checkpoint_path=args.ckpt)
    line = json.dumps({k: v for k, v in res.items() if k not in ("latents", "labels")})
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
