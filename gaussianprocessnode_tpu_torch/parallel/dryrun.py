"""Multi-rank dry run of the parallel layer: one step of every parallel path.

Counterpart of ``__graft_entry__.py::dryrun_multichip``. It spawns N ranks
(``comm.spawn_ranks``; NCCL on the card, one card per rank, or gloo with
``--device cpu``) and runs on each, with data drawn from ``default_rng(0)``
on every rank and sharded there:

- one data-parallel training step (``dp_train_step``: M = 16, D = 2,
  N = 8·N, float64);
- one epoch of ``fit_kin40k_fast_dp`` (M = 48, D = 8, 3 batches of 16·N);
- one epoch of ``fit_banana_fast_dp`` (M = 32, 3 batches of 16·N);
- one full-scale ``fit_kin40k_fast_dp`` epoch (M = 600, D = 8, 20 batches
  of 64·N, float32 θ), with its all-reduce volume against the GEMM
  operations of its Λ update;
- the sequence-parallel chain smoother (T = 4·N, M = 6, D = 2, 3 sweeps);
- the tensor-parallel sweep and prediction (M = 8·N, D = 3, N = 64).

Every result is checked finite on every rank and the replicated results
(θ, the naturals) bit-equal across ranks; rank 0's summary is printed.

    python -m gaussianprocessnode_tpu_torch.parallel.dryrun N [--device cpu]

On the card N may not exceed the card count: the run refuses, and never
moves to the CPU.
"""

import argparse
import time

import numpy as np
import torch

from ..dists import GammaShapeRate, MvGaussianNat
from ..ops.kernels import Kernel, invsoftplus
from ..utils.optim import adamax
from . import comm
from .seq_parallel import gpssm_vmp_sp, shard_chain_data
from .sharding import (dp_train_step, fit_banana_fast_dp, fit_kin40k_fast_dp,
                       shard_batched_data, shard_data)
from .tensor_parallel import shard_inducing, tp_predict, tp_regression_sweep

__all__ = ["dryrun_rank", "dryrun_multichip", "main"]


def _finite(name, *ts):
    for t in ts:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"dry run: {name} is not finite")


def dryrun_rank(device: str) -> dict:
    """Everything the dry run runs, on this rank; returns the replicated
    results (on the host) and the summary figures."""
    n = comm.world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", comm.rank())
    f64 = torch.float64
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    rng = np.random.default_rng(0)

    def t(a, dtype=f64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # the DP train step
    M, D, N = 16, 2, 8 * n
    Xu, X, y = t(rng.standard_normal((M, D))), t(rng.standard_normal((N, D))), \
        t(rng.standard_normal(N))
    X, y = shard_data(X, y)
    theta = invsoftplus(torch.ones(D + 1, dtype=f64, device=dev))
    prior = MvGaussianNat(torch.zeros(M, dtype=f64, device=dev),
                          torch.eye(M, dtype=f64, device=dev) / 50.0)
    opt = adamax(0.001)
    theta, _, nat = dp_train_step(kernel, theta, opt.init(theta), opt, Xu, X, y, prior, 100.0)
    _finite("the DP step's θ and Λ", theta, nat.prec)

    # one epoch of the kin40k trainer
    M2, D2, B2, b2 = 48, 8, 3, 16 * n
    Xu2 = t(rng.standard_normal((M2, D2)))
    Xs2, ys2 = shard_batched_data(t(rng.standard_normal((B2, b2, D2))),
                                  t(rng.standard_normal((B2, b2))))
    prior2 = MvGaussianNat(torch.zeros(M2, dtype=f64, device=dev),
                           torch.eye(M2, dtype=f64, device=dev) / 50.0)
    theta2, nat2, cov2, _ = fit_kin40k_fast_dp(
        kernel, invsoftplus(torch.ones(D2 + 1, dtype=f64, device=dev)), Xu2, Xs2, ys2, prior2,
        1e4, 1)
    _finite("the kin40k DP epoch's θ and Σ_v", theta2, cov2)

    # one epoch of the banana trainer (probit tilts, carried Gamma q(w))
    M3, B3, b3 = 32, 3, 16 * n
    Xu3 = t(rng.standard_normal((M3, 2)))
    Xs3, ys3 = shard_batched_data(t(rng.standard_normal((B3, b3, 2))),
                                  t((rng.uniform(size=(B3, b3)) > 0.5).astype(float)))
    prior3 = MvGaussianNat(torch.zeros(M3, dtype=f64, device=dev),
                           torch.eye(M3, dtype=f64, device=dev) / 50.0)
    theta3, nat3, qw3, _ = fit_banana_fast_dp(
        kernel, invsoftplus(torch.ones(3, dtype=f64, device=dev)), Xu3, Xs3, ys3, prior3,
        GammaShapeRate(1e-2, 1e-2), 1)
    _finite("the banana DP epoch's θ and Λ", theta3, nat3.prec)
    if not bool(qw3.rate > 0):
        raise FloatingPointError("dry run: the banana DP q(w) rate is not positive")

    # the full-scale kin40k epoch (float32 θ, float64 statistics)
    M5, D5, B5, b5 = 600, 8, 20, 64 * n
    f32 = torch.float32
    Xu5 = t(rng.standard_normal((M5, D5)), f32)
    Xs5, ys5 = shard_batched_data(t(rng.standard_normal((B5, b5, D5)), f32),
                                  t(rng.standard_normal((B5, b5)), f32))
    prior5 = MvGaussianNat(torch.zeros(M5, dtype=f32, device=dev),
                           torch.eye(M5, dtype=f32, device=dev) / 50.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t5 = time.perf_counter()
    theta5, nat5, cov5, _ = fit_kin40k_fast_dp(
        kernel, invsoftplus(torch.ones(D5 + 1, dtype=f32, device=dev)), Xu5, Xs5, ys5, prior5,
        1e4, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    full_epoch_s = time.perf_counter() - t5
    _finite("the full-scale DP epoch's θ and Σ_v", theta5, cov5)
    item = nat5.prec.dtype.itemsize
    # all-reduced per epoch: the (ξ, Λ) increments and one θ-gradient per batch
    comms_bytes = (M5 * M5 + M5) * item + B5 * (D5 + 1) * theta5.dtype.itemsize
    flops_epoch = 2.0 * M5 * M5 * (B5 * b5)  # the Λ update's GEMM alone

    # the sequence-parallel chain smoother
    T6, M6, D6 = 4 * n, 6, 2
    Xu6 = t(rng.standard_normal((M6, D6)))
    ys6 = shard_chain_data(t(0.3 * rng.standard_normal((T6, D6))))
    eye2 = torch.eye(D6, dtype=f64, device=dev)
    state6, fe6 = gpssm_vmp_sp(
        kernel, invsoftplus(torch.ones(D6 + 1, dtype=f64, device=dev)), Xu6, ys6, 0.1 * eye2,
        torch.zeros(D6, dtype=f64, device=dev), 0.1 * eye2,
        MvGaussianNat(torch.zeros(M6 * D6, dtype=f64, device=dev),
                      torch.eye(M6 * D6, dtype=f64, device=dev) / 50.0),
        10.0, eye2, n_iters=3)
    _finite("the SP smoother's q(x) and free energy", state6.x_means, fe6)

    # the tensor-parallel sweep and prediction
    M7, D7, N7 = 8 * n, 3, 64
    Xu7 = shard_inducing(t(rng.standard_normal((M7, D7))))
    X7, y7 = t(rng.standard_normal((N7, D7))), t(rng.standard_normal(N7))
    th7 = invsoftplus(torch.ones(D7 + 1, dtype=f64, device=dev))
    mu7, _, _, _ = tp_regression_sweep(kernel, th7, Xu7, X7, y7, 50.0, 100.0)
    mean7, _ = tp_predict(kernel, th7, Xu7, mu7, 100.0, X7[:5])
    _finite("the TP sweep's μ_v and prediction", mu7, mean7)

    def host(x):
        return x.detach().cpu()

    return {
        "replicated": [host(v) for v in (theta, nat.prec, theta2, cov2, theta3, nat3.prec,
                                         qw3.rate, theta5, cov5, state6.x_means, fe6, mean7)],
        "theta_step": host(theta), "theta_kin40k": host(theta2), "theta_banana": host(theta3),
        "sp_fe": float(fe6), "full_epoch_s": full_epoch_s, "comms_bytes": comms_bytes,
        "flops_epoch": flops_epoch, "M5": M5, "N5": B5 * b5, "T6": T6, "M7": M7,
        "backend": torch.distributed.get_backend(), "device": str(dev),
    }


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """Spawn ``n_ranks`` ranks on ``device``'s backend, run
    :func:`dryrun_rank` on each, check the replicated results bit-equal
    across ranks, print and return rank 0's summary."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dry run on the card needs CUDA; pass --device cpu for gloo")
        if n_ranks > torch.cuda.device_count():
            raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards, this machine has "
                               f"{torch.cuda.device_count()}")
    outs = comm.spawn_ranks(dryrun_rank, n_ranks, comm.backend_for(device), device)
    for r, o in enumerate(outs[1:], 1):
        for a, b in zip(o["replicated"], outs[0]["replicated"]):
            if not torch.equal(a, b):
                raise RuntimeError(f"dry run: rank {r}'s replicated state differs from rank 0's")
    s = outs[0]
    print(f"dryrun_multichip({n_ranks}) ok on {s['backend']} ({s['device']} on rank 0): "
          f"θ={s['theta_step'].numpy().round(4)}, Λ finite; fit_kin40k_fast_dp 1 epoch ok "
          f"(θ={s['theta_kin40k'].numpy().round(3)}); fit_banana_fast_dp 1 epoch ok "
          f"(θ={s['theta_banana'].numpy().round(3)}, w̄ carried); seq-parallel GPSSM "
          f"smoother ok (T={s['T6']} over {n_ranks} ranks, FE={s['sp_fe']:.2f}); "
          f"tensor-parallel q(v) sweep ok (M={s['M7']} over {n_ranks} ranks); full-scale dp "
          f"epoch (M={s['M5']}, N={s['N5']}, {n_ranks} ranks): {s['full_epoch_s']:.1f}s "
          f"incl. first execution; all-reduce volume {s['comms_bytes'] / 1e6:.2f} MB/epoch "
          f"vs ≥{s['flops_epoch'] / 1e9:.0f} GFLOP/epoch of the Λ update's GEMM; replicated "
          f"state bit-equal across ranks", flush=True)
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a card per rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
