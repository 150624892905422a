#!/usr/bin/env python3
"""How far float32 rounding of the Gram alone moves the banana trainers.

Run from the root of the repository (CPU by default):

    python3 scripts/banana_rounding_sensitivity.py [--device cpu] [--twins 3] [--seed 0]

At banana width (M = 500, D = 2, 4,000 points in 20 batches of 200,
synthetic data from ``--seed``; 0 is ``chip_smoke.py``'s default) it trains ``fit_banana_fast`` for 3 epochs and
``fit_banana`` for 2 with the plain Gram, and again with "twins" of it: the
same Gram with every entry multiplied by 1 + ε₃₂·(u − ½), u uniform from a
seeded generator, a random perturbation of half an ulp, the size of the
rounding by which the CUDA kernel and the plain Gram may differ. It does
so from two starts: the cold initial carry (``init_banana_state`` at
θ0 = softplus⁻¹(1)) and the carry after one plain fast epoch. With
``--device cuda`` it also trains through the CUDA kernel, whose distance
from the plain run is the reading that ``chip_smoke.py`` phase 7 checks.
It prints, per trainer, start, epoch and run, the relative 2-norm
difference from the plain run of θ, ξ, Λ and the q(w) rate, and last one
JSON line: per trainer, start and epoch, the largest over the twins and
the kernel's, field by field.

What it shows: from the cold carry, the first statistics pass evaluates
I1 = kxx − kᵀKuu⁻¹k with the cold 40-iteration Kuu⁻¹ (entries up to
~3e4 at ℓ = 1), where I1 is float32 rounding noise (about half the points
come out negative and are floored at 0), so the q(w) rate, and through
w̄ = shape/rate the later ξ and Λ, are determined only to ~1e-4–3e-4
(on an H100: up to 9.6e-5 over 16 twins at seed 0, 2.85e-4 over 8 at seed
1); from the warm carry, Kuu⁻¹ is small and the same perturbation moves
every field by at most ~2e-5. ``chip_smoke.py`` phase 7 therefore holds the kernel and plain
routes to each other from the warm carry.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gaussianprocessnode_tpu_torch.experiments import banana as runner  # noqa: E402
from gaussianprocessnode_tpu_torch.infer.minibatch import (  # noqa: E402
    fit_banana, fit_banana_fast, init_banana_state)
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class RoundingTwin(Kernel):
    """The plain Gram, each entry moved by a seeded half-ulp factor."""

    seed: int = 0

    def __call__(self, theta, X, Z):
        K = super().__call__(theta, X, Z)
        g = torch.Generator(device=K.device).manual_seed(self.seed * 100003 + K.numel())
        u = torch.rand(K.shape, generator=g, device=K.device, dtype=K.dtype)
        return K * (1.0 + EPS32 * (u - 0.5))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--twins", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    theta0, Xu, Xb, yb, pv, pw = runner.setup(runner.load_data("synthetic", args.seed), 500,
                                              200, args.seed, args.device)
    plain = Kernel("se", "softplus")
    runs = {f"twin{s + 1}": RoundingTwin("se", "softplus", seed=s + 1)
            for s in range(args.twins)}
    if torch.device(args.device).type == "cuda":
        runs["kernel"] = Kernel("se", "softplus", use_kernel=True)
    fields = ("theta", "xi", "Lambda", "w_rate")
    cold = init_banana_state(plain, theta0, Xu, pv, pw)
    *_, warm = fit_banana_fast(plain, theta0, Xu, Xb, yb, pv, pw, 1, resume_state=cold)
    summary = {}
    for trainer, epochs in ((fit_banana_fast, 3), (fit_banana, 2)):
        for start_name, start in (("cold", cold), ("warm", warm)):
            kernels = {"plain": plain, **runs}
            carries = dict.fromkeys(kernels, start)
            for e in range(epochs):
                outs = {}
                for name, k in kernels.items():
                    th, nat, qw, carries[name] = trainer(k, theta0, Xu, Xb, yb, pv, pw, 1,
                                                         resume_state=carries[name])
                    outs[name] = (th, nat.xi, nat.prec, qw.rate)
                twins_max = dict.fromkeys(fields, 0.0)
                row = {}
                for name in runs:
                    d = dict(zip(fields, (_rel(a, b) for a, b in zip(outs[name],
                                                                      outs["plain"]))))
                    print(f"{trainer.__name__} start={start_name} epoch={e + 1} {name}: "
                          + " ".join(f"{f} {v:.2e}" for f, v in d.items()), flush=True)
                    if name == "kernel":
                        row["kernel"] = d
                    else:
                        twins_max = {f: max(twins_max[f], d[f]) for f in fields}
                row["twins_max"] = twins_max
                summary[f"{trainer.__name__} {start_name} epoch {e + 1}"] = row
    print(json.dumps({"seed": args.seed, "twins": args.twins, "device": args.device,
                      "summary": summary}), flush=True)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
