"""Long-chain GPSSM smoothing benchmark: parallel-in-time against Jacobi, on the card.

Counterpart of ``experiments/pit_bench.py``. For each chain length T it
draws a pendulum chain at the reference's Δt (``utils/datasets.py::pendulum``
with ``max_time`` scaled to T, seed 69), freezes θ at the learned pendulum
optimum softplus⁻¹([0.66, 2.27, 4.85]) with M = 48 inducing inputs on
``pendulum_inducing()``, and measures

- ``pit``: ``gpssm_vmp_pit`` (6 PIT sweeps, 30 Jacobi polish sweeps) to its
  fixed point, timed after an untimed first call (an extra 10 Jacobi
  sweeps must move the free energy by less than ``fp_tol``), its free
  energy and smoothing SMSE;
- ``jacobi``: ``gpssm_vmp`` from the cold start in warm-started chunks of
  100 sweeps until its free energy reaches the PIT fixed point plus
  ``fe_tol`` nats, the sweep cap, or a stall (two chunks improving by at
  most fe_tol/10), with its seconds and sweeps;
- ``jacobi_sweep_ms``: one warm sweep's time (10 sweeps).

Times are host clock between ``torch.cuda.synchronize()`` calls. Each T
runs in its own process (its memory returned to the card between rows),
and the rows are written to ``--out`` after every T, merged with that
file's rows of other devices or other T. A T whose process fails ends the
run with a non-zero exit code; the rows before it are kept.

    python -m gaussianprocessnode_tpu_torch.experiments.pit_bench [--T=2048,8192]
        [--out=PATH] [--device cpu]
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..dists import MvGaussianNat
from ..infer.chain_smoother import gpssm_vmp
from ..infer.pit_gpssm import gpssm_vmp_pit
from ..ops.kernels import Kernel, invsoftplus
from ..utils.datasets import pendulum, pendulum_inducing
from ..utils.metrics import smse
from ..utils.profiling import card_info, synchronize

__all__ = ["THETA_SOFTPLUS", "bench_one", "child_one", "main"]

THETA_SOFTPLUS = (0.66, 2.27, 4.85)  # the learned pendulum optimum
OUT_DEFAULT = "pit_bench.json"


def _f(x, nd):
    """Rounded, or None where not finite (the JSON stays valid)."""
    return round(x, nd) if math.isfinite(x) else None


def bench_one(T: int, *, n_pit: int = 6, n_polish: int = 30, jacobi_chunk: int = 100,
              sweep_cap: int = 4000, fe_tol: float = 1.0, fp_tol: float = 0.05, seed: int = 69,
              device="cuda", dtype=torch.float64, verbose: bool = True) -> dict:
    """One row: the PIT engine and the Jacobi race to its fixed point at
    chain length ``T`` (see the module docstring)."""
    dev = torch.device(device)
    x_true, y_obs, _, P, _ = pendulum(n=T, max_time=0.01 * (T - 1), seed=seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device=dev, dtype=dtype)

    ys, P_t, Xu = t(y_obs), t(P), t(pendulum_inducing())
    M, D = Xu.shape[0], 2
    kernel = Kernel("se", transform="softplus", use_kernel=True)
    theta = invsoftplus(t(THETA_SOFTPLUS))
    prior_v = MvGaussianNat(torch.zeros(M * D, dtype=dtype, device=dev),
                            torch.eye(M * D, dtype=dtype, device=dev) / 50.0)
    m0 = t(x_true[0])
    V0 = 0.1 * torch.eye(2, dtype=dtype, device=dev)
    eye = torch.eye(2, dtype=dtype, device=dev)

    def pit(init_state=None):
        return gpssm_vmp_pit(kernel, theta, Xu, ys, P_t, m0, V0, prior_v, 100.0, eye,
                             n_pit=n_pit, n_polish=n_polish, init_state=init_state)

    def jacobi(init_state=None, n_iters=jacobi_chunk):
        return gpssm_vmp(kernel, theta, Xu, ys, P_t, m0, V0, prior_v, 100.0, eye,
                         n_iters=n_iters, compute_fe=True, init_state=init_state)

    def score(state):
        return [float(smse(torch.as_tensor(x_true[:, d]),
                           state.x_means[1:, d].cpu().to(torch.float64))) for d in range(D)]

    # PIT: a first (untimed) call, then the timed one
    pit()
    synchronize(dev)
    t0 = time.perf_counter()
    state_p, fe_p = pit()
    fe_pit = float(fe_p)
    pit_s = time.perf_counter() - t0
    # fixed-point check: one more polish block must not move the free energy
    _, fe_pp = jacobi(init_state=state_p, n_iters=10)
    fp_resid = abs(float(fe_pp) - fe_pit)
    sm = score(state_p)
    if verbose:
        print(f"[T={T}] pit: {pit_s:.2f}s  FE={fe_pit:.2f}  fixed-point resid={fp_resid:.3f}  "
              f"SMSE={sm}", file=sys.stderr, flush=True)

    # Jacobi: warm-started chunks until the PIT fixed point (a first cold
    # chunk untimed); a non-finite PIT free energy races Jacobi to its own
    # converged free energy instead, so the row still carries both engines
    jacobi()
    synchronize(dev)
    target = fe_pit + fe_tol if math.isfinite(fe_pit) else -math.inf
    state_j, sweeps, jac_s = None, 0, 0.0
    fe_j = math.inf
    stall_tol = fe_tol / 10 if math.isfinite(fe_pit) else fe_tol
    stalled = 0
    while state_j is None or (sweeps < sweep_cap and fe_j > target and stalled < 2):
        fe_prev = fe_j
        t0 = time.perf_counter()
        state_j, fe = jacobi(init_state=state_j)
        fe_j = float(fe)
        jac_s += time.perf_counter() - t0
        sweeps += jacobi_chunk
        stalled = stalled + 1 if fe_prev - fe_j <= stall_tol else 0
        if verbose:
            print(f"[T={T}] jacobi: {sweeps} sweeps  FE={fe_j:.2f} (target {target:.2f})  "
                  f"{jac_s:.1f}s", file=sys.stderr, flush=True)
    sm_j = score(state_j)

    # a warm sweep's time (timing, not convergence)
    synchronize(dev)
    t0 = time.perf_counter()
    _, fe = jacobi(init_state=state_j, n_iters=10)
    float(fe)
    sweep_ms = (time.perf_counter() - t0) / 10 * 1e3

    return {
        "T": T,
        "pit_seconds": round(pit_s, 3),
        "pit_fe": _f(fe_pit, 3),
        "pit_fixed_point_resid_nats": _f(fp_resid, 4),
        "pit_smse": [_f(s, 6) for s in sm],
        "pit_sweeps": [n_pit, n_polish],
        "jacobi_seconds_to_pit_fe": round(jac_s, 3),
        "jacobi_sweeps": sweeps,
        "jacobi_fe": _f(fe_j, 3),
        "jacobi_fe_gap": _f(fe_j - fe_pit, 3),
        "jacobi_converged": bool(fe_j <= target),
        "jacobi_smse": [_f(s, 6) for s in sm_j],
        "jacobi_sweep_ms": round(sweep_ms, 2),
        "speedup_to_fixed_point": _f(jac_s / pit_s, 1),
    }


def _device_name(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = card_info()
        return f"{info['name']}, {info['power_limit']}"
    return str(dev)


def child_one(T: int, row_out: str, device="cuda"):
    """Run one T and write its row to ``row_out``: the per-T process's body."""
    row = bench_one(T, device=device)
    row["device"] = _device_name(device)
    with open(row_out, "w") as f:
        json.dump(row, f)


def main(argv=None) -> int:
    """One process per T; rows merge per (device, T) into ``--out``, which
    is written after every T. Returns the failing process's exit code
    (its standard error passed through) at the first T that fails."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", default="2048,8192", help="comma-separated chain lengths")
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one-T", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--row-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_T is not None:
        child_one(args.one_T, args.row_out, args.device)
        return 0
    Ts = [int(x) for x in args.T.split(",")]
    device = _device_name(args.device)
    artifact = {"workload": "pit_gpssm_long_chain", "theta_softplus": list(THETA_SOFTPLUS),
                "M": 48, "fe_tol_nats": 1.0, "rows": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        artifact["rows"] = [r for r in prev.get("rows", [])
                            if r.get("device") != device or r["T"] not in Ts]
    tmp = tempfile.mkdtemp(prefix="pit_bench_")
    try:
        return _rows(Ts, args, artifact, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rows(Ts, args, artifact, tmp) -> int:
    for T in Ts:
        row_out = os.path.join(tmp, f"row_{T}.json")
        cmd = [sys.executable, "-m", "gaussianprocessnode_tpu_torch.experiments.pit_bench",
               f"--one-T={T}", f"--row-out={row_out}", f"--device={args.device}"]
        rc = subprocess.run(cmd).returncode
        if rc != 0 or not os.path.exists(row_out):
            print(f"[pit_bench] T={T} failed with exit code {rc}", file=sys.stderr, flush=True)
            return rc or 1
        with open(row_out) as f:
            row = json.load(f)
        artifact["rows"].append(row)
        artifact["rows"].sort(key=lambda r: (r.get("device", ""), r["T"]))
        with open(args.out, "w") as f:  # after every T
            json.dump(artifact, f, indent=1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
