"""Serving-throughput record of the kin40k regression handle, on the card.

Counterpart of ``experiments/serving_bench.py``. Through the float32
``SGPRegressor`` at kin40k's serving shapes (M = 600, 8-D; the SE Gram by
the CUDA kernel) it records three rates, in predictions per second by host
clock between two device synchronisations:

- ``dispatch_bound_B1024`` and ``dispatch_bound_B30000``: one handle call
  per request batch (``serve.throughput``; 40 and 20 calls);
- ``fused_B30000``: R copies of the 30,000-request batch queued back to
  back (``serve.throughput_fused``; R = 64, 5 calls).

On the CPU it is a smoke: 2 calls at each batch, and 4 batches × 2 calls
fused. Before any rate counts, a correctness gate runs:

- with ``--save DIR`` (the reference's ``qv_kin40k``, ``params_optimal_kin40k``,
  ``Xu_kin40k`` and ``SMSE_kin40k``, each ``.jld`` or ``.npy``, and the kin40k
  data files) the handle is the reference's saved posterior, the requests
  are the 30,000 kin40k test inputs, and its SMSE must lie within 1e-2
  relative of the golden;
- by default the handle is the committed trained state
  (``benchmarks/kin40k_refxu_trained.npz``, through
  ``convert.serving_state_from_jax``) with 600 inducing inputs and 30,000
  requests drawn standard normal from ``--seed`` (inducing inputs first);
- in both cases, at each batch shape the rates time (the first 1,024
  requests and all 30,000), the float32 handle's means must agree with the
  same state's float64 means to the float32 Gram's rounding bound carried
  through |K|ᵀ|μ_v|, plus M·ε for each side's mat-vec (:func:`means_bound`,
  the limit ``chip_smoke.py`` holds the served means to).

    python -m gaussianprocessnode_tpu_torch.experiments.serving_bench [--save DIR]
        [--json=PATH] [--device cpu] [--seed S]

prints one line per rate and, last, the record as one JSON line (with the
card's name and power limit); ``--json=PATH`` also writes it to PATH.
"""

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..dists import MvGaussianNat
from ..ops.kernels import Kernel
from ..ops.se_gram import se_gram_cuda
from ..serve import SGPRegressor, throughput, throughput_fused
from ..utils.datasets import kin40k
from ..utils.metrics import smse
from ..utils.profiling import card_info

__all__ = ["load_golden", "means_bound", "record", "main"]

_TRAINED = Path(__file__).resolve().parents[2] / "benchmarks" / "kin40k_refxu_trained.npz"
M_IND, D_IN = 600, 8
W_MEAN = 1e4            # kin40k's fixed noise precision
N_REQ = 30_000          # kin40k's test set
# (calls at B = 1024, calls at B = 30,000, fused batches, fused calls); the
# CPU's plan is a smoke
PLAN = {"cuda": (40, 20, 64, 5), "cpu": (2, 2, 4, 2)}
SMSE_RTOL = 1e-2        # float32 serving against the float64 golden
EPS32 = float(np.finfo(np.float32).eps)


def load_golden(save, name):
    """``save/name.jld`` (``utils/jld.py``) or ``save/name.npy``; raises
    FileNotFoundError naming the path where neither exists."""
    base = os.path.join(save, name)
    if os.path.isfile(base + ".jld"):
        from ..utils.jld import load_jld

        return load_jld(base + ".jld")
    if os.path.isfile(base + ".npy"):
        return np.load(base + ".npy", allow_pickle=False)
    raise FileNotFoundError(f"{base}.jld (or .npy) is absent")


def means_bound(kernel, theta, Xu, mu_v, X) -> tuple[torch.Tensor, float]:
    """|K|ᵀ|μ_v| per request (in the inputs' dtype) and the relative limit
    on the float32 means' distance from the plain or float64 means over it:
    each side's float32 d² carries at most (D+2)·ε·(‖z/ℓ‖² + ‖x/ℓ‖²) of
    rounding and K moves by σ²/2 per unit of d² (exp and the σ² product add
    a few ulp), so |ΔK| ≤ ε·(4 + (D+2)·(max ‖z/ℓ‖² + max ‖x/ℓ‖²))·K-scale;
    each side's mat-vec adds M·ε."""
    _, ls = kernel.params(theta)
    scale = kernel(theta, Xu, X).abs().T @ mu_v.abs()
    zz = float(torch.sum((Xu / ls) ** 2, dim=1).max())
    xx = float(torch.sum((X / ls) ** 2, dim=1).max())
    M, D = Xu.shape
    return scale, EPS32 * (4.0 + (D + 2) * (zz + xx)) + 2 * M * EPS32


def _golden_handles(save, device):
    """The reference's saved posterior as float32 and float64 handles, the
    kin40k test set and the golden SMSE."""
    qv = load_golden(save, "qv_kin40k")
    theta = torch.as_tensor(np.asarray(load_golden(save, "params_optimal_kin40k"), np.float64))
    Xu = torch.as_tensor(np.asarray(load_golden(save, "Xu_kin40k"), np.float64))
    smse_ref = float(np.asarray(load_golden(save, "SMSE_kin40k")))
    mu, Sig = np.asarray(qv["μ_"], np.float64), np.asarray(qv["Σ_"], np.float64)
    prec = np.linalg.inv(0.5 * (Sig + Sig.T))
    nat = MvGaussianNat(torch.as_tensor(prec @ mu), torch.as_tensor(prec))
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    handle, h64 = (SGPRegressor.from_natural(kernel, theta, Xu, nat, W_MEAN, dtype=dtype,
                                             device=device)
                   for dtype in (torch.float32, torch.float64))
    ds = kin40k()
    return handle, h64, ds.x_test, ds.y_test, smse_ref


def _committed_handles(seed, device):
    """The committed trained state as float32 and float64 handles, with
    600 inducing inputs and 30,000 requests drawn from ``seed``."""
    z = np.load(_TRAINED, allow_pickle=False)
    rng = np.random.default_rng(seed)
    Xu = rng.standard_normal((M_IND, D_IN))
    x_test = rng.standard_normal((N_REQ, D_IN))
    h64 = convert.serving_state_from_jax(z["theta"], Xu, z["xi"], z["prec"], W_MEAN,
                                         dtype=torch.float64, device=device)
    # the float32 handle of the same state: serving_state_from_jax(dtype=
    # float32) recovers the same float64 μ_v and casts, as here
    handle = SGPRegressor(h64.kernel, h64.theta.float(), h64.Xu.float(), h64.mu_v.float(),
                          h64.w_mean)
    return handle, h64, x_test


def _means_held(handle, h64, X64) -> dict:
    """The float32 handle's means at the requests X64 against the float64
    handle's, relative to |K|ᵀ|μ_v|, within :func:`means_bound`."""
    m32, _ = handle(X64.float())
    m64, _ = h64(X64)
    scale, limit = means_bound(h64.kernel, h64.theta, h64.Xu, h64.mu_v, X64)
    rel = float(((m32.double() - m64).abs() / scale).max())
    return {"max_rel": rel, "limit": limit, "passed": rel <= limit}


def record(save=None, device="cuda", seed=0) -> dict:
    """The gate, then the three rates; returns the record. Raises
    RuntimeError if the gate fails. ``se_gram_launches`` counts the kernel
    launches of the gate and the rates."""
    dev = torch.device(device)
    se_gram_cuda.launches = 0
    if save is not None:
        handle, h64, x_test, y_test, smse_ref = _golden_handles(save, dev)
        mean, _ = handle(torch.as_tensor(x_test, dtype=torch.float32, device=dev))
        s = float(smse(torch.as_tensor(y_test), mean.cpu().double()))
        rel = abs(s - smse_ref) / smse_ref
        gate = {"kind": "golden SMSE, and float32 means against float64",
                "smse": s, "smse_ref": smse_ref, "rel": rel, "limit": SMSE_RTOL,
                "passed": rel < SMSE_RTOL}
    else:
        handle, h64, x_test = _committed_handles(seed, dev)
        gate = {"kind": "float32 means against the same state's float64 means", "passed": True}
    X64 = torch.as_tensor(x_test, dtype=torch.float64, device=dev)
    n = X64.shape[0]
    for B in (1024, n):
        gate[f"means_B{B}"] = held = _means_held(handle, h64, X64[:B])
        gate["passed"] = gate["passed"] and held["passed"]
    print(f"gate ({gate['kind']}): {gate}", flush=True)
    if not gate["passed"]:
        raise RuntimeError(f"serving gate failed: {gate}")
    X = X64.float()
    calls_small, calls_full, nb, iters = PLAN["cuda" if dev.type == "cuda" else "cpu"]
    rows = {}
    for B, calls in ((1024, calls_small), (n, calls_full)):
        rows[f"dispatch_bound_B{B}"] = throughput(handle, X[:B], iters=calls)
        print(f"dispatch-bound B={B} ({calls} calls): "
              f"{rows[f'dispatch_bound_B{B}']:.6e} preds/s", flush=True)
    rows[f"fused_B{n}"] = throughput_fused(handle, X, n_batches=nb, iters=iters)
    print(f"fused B={n} x {nb} batches ({iters} calls): {rows[f'fused_B{n}']:.6e} preds/s",
          flush=True)
    return {
        "description": (
            "kin40k serving rates of the float32 SGPRegressor (M=600, 8-D), "
            "predictions per second by host clock between device "
            "synchronisations: 'dispatch_bound_*' one handle call per batch, "
            "'fused_*' R batches queued back to back (serve.throughput_fused)."),
        "state": "reference savefiles" if save is not None else str(_TRAINED.name),
        "gate": gate,
        "dtype": "float32",
        "preds_per_second": rows,
        "dispatch_calls": [calls_small, calls_full],
        "fused_batches": nb,
        "fused_calls": iters,
        "requests": n,
        "se_gram_launches": se_gram_cuda.launches,
        "device": card_info() if dev.type == "cuda" else {"name": str(dev)},
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", metavar="DIR", help="the reference's savefiles")
    ap.add_argument("--json", metavar="PATH", help="also write the record to PATH")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = record(args.save, args.device, args.seed)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
