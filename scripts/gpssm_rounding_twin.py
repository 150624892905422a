#!/usr/bin/env python3
"""How far rounding of the Gram alone moves the GPSSM engines at full width.

Run from the root of the repository (CPU by default):

    python3 scripts/gpssm_rounding_twin.py [--device cpu] [--seed 0]

It runs ``chip_smoke.py`` phase 12's comparisons (``chip_smoke.gp_routes``:
2 hyperparameter epochs of the pendulum runner, then the Jacobi,
Gauss–Seidel, parallel-in-time and controlled engines and the filter at
T = 300, M = 48, float32) with a "twin" of the plain Gram in place of the
CUDA kernel: the plain Gram with every entry multiplied by 1 + s·2⁻²⁴, s
∈ {−1, 0, 1} from a generator seeded by the Gram's shape, a perturbation of
about one float32 ulp, the size of the rounding by which the kernel and the
plain Gram may differ. Then the float64 comparison of phase 12
(``chip_smoke.gp_f64_pair``: one sweep of each engine, the free energy and
the filter from one state) with a float64 twin (s·2⁻⁵³) against the plain
Gram, the size of the rounding by which the card and the host may differ.
It prints each comparison's differences (x-means: max absolute; the rest
relative to the plain result's largest entry) and last one JSON line.

What it shows: on the pendulum's grid (inducing pairs 9e-5 apart) the
in-message's Ψ2 contraction ½tr(W̄)·Kuu⁻¹ amplifies one ulp of the Gram to
percent-level differences of the moment-matched marginals within one
sweep, in float32 and (by κ(Kuu) ≈ 3e13) to ~1e-4 in float64, so phase 12
holds those schedules to the JAX package's own float32 limits and the
float64 sweeps to 1e-3; the steps that do not contract Kuu⁻¹ (the PIT
sweep's smoothed moments, the filters) and the controlled chain on its
regular grid move by ~1e-6 and are held to 1e-4.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel  # noqa: E402


@dataclasses.dataclass(frozen=True)
class RoundingTwin(Kernel):
    """The plain Gram, each entry moved by −1, 0 or +1 unit of 2^-bits."""

    bits: int = 24

    def __call__(self, theta, X, Z):
        K = super().__call__(theta, X, Z)
        g = torch.Generator().manual_seed(K.shape[0] * 100003 + K.shape[1])
        s = (torch.randint(0, 3, K.shape, generator=g) - 1).to(K.dtype).to(K.device)
        return K * (1 + s * 2.0 ** -self.bits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    plain = Kernel("se", "softplus")
    r = cs.gp_routes(RoundingTwin("se", "softplus", bits=24), plain, args.device, args.seed)
    for name, v in r["diffs"].items():
        print(f"float32 twin {name}: " + (f"{v:.3e}" if isinstance(v, float) else
              ", ".join(f"{k} {x:.3e}" for k, x in v.items())), flush=True)
    d64, _ = cs.gp_f64_pair(r["setup"], r["prior"], r["theta"], r["state"],
                            (args.device, RoundingTwin("se", "softplus", bits=53)),
                            (args.device, plain))
    print("float64 twin: " + ", ".join(f"{k} {v:.3e}" for k, v in d64.items()), flush=True)
    print(json.dumps({"device": args.device, "seed": args.seed, "float32": r["diffs"],
                      "float64": d64}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
