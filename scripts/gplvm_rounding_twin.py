#!/usr/bin/env python3
"""How far rounding of the Gram alone moves the GPLVM fit at full width.

Run from the root of the repository (CPU by default):

    python3 scripts/gplvm_rounding_twin.py [--device cpu] [--seeds 0 1 2] [--one-sweep]

For each seed it runs ``chip_smoke.py`` phase 13's float64 fit
(``chip_smoke.gplvm_fit``: 2 epochs of ``fit_gplvm_grad`` at N = 200, D =
12, Din = 2, M = 30 on synthetic oil-flow data) twice: with the plain Gram,
and with a float64 "twin" of it (every entry multiplied by 1 + s·2⁻⁵³, s ∈
{−1, 0, 1}, about one float64 ulp: the size of the rounding by which the
card's and the host's Grams, GEMMs and factorizations may differ), and
prints ``chip_smoke.gplvm_diff`` of the two: θ and the FE trace relative,
the rows whose x-means moved by more than 1e-3 (``GPLVM_ROW_TOL``: into
another mode) and the largest difference of the others. With
``--one-sweep`` it compares one cold float64 ``gplvm_vmp`` sweep at the
same width instead (the q(v) naturals and the covariances and free energy
relative, the x-means absolute), the case of
``tests/test_torch_gpu.py::test_gplvm_float64_sweep_on_card_matches_cpu``.
Last line: one JSON object with every seed's differences. Phase 13 and
that test hold the card against the host to limits taken from these.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from gpssm_rounding_twin import RoundingTwin  # noqa: E402
from gaussianprocessnode_tpu_torch.infer.gplvm import gplvm_vmp  # noqa: E402
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel  # noqa: E402


def one_sweep_diff(seed, device) -> dict:
    """One cold float64 sweep with the plain Gram against its twin."""
    s = cs.gplvm_setup(seed, device)
    args = (s["theta0"], s["Xu"], s["Y"], s["Xm"])
    (a, fa), (b, fb) = (gplvm_vmp(k, *args, n_iters=1) for k in (
        RoundingTwin("se", "softplus", bits=53), Kernel("se", "softplus")))
    return {"xi_v": cs._relmax(a.xi_v, b.xi_v), "prec_v": cs._relmax(a.prec_v, b.prec_v),
            "x_means_abs": float((a.x_means - b.x_means).abs().max()),
            "x_covs": cs._relmax(a.x_covs, b.x_covs), "fe": cs._relmax(fa, fb)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--one-sweep", action="store_true",
                    help="one cold gplvm_vmp sweep instead of the 2-epoch fit")
    args = ap.parse_args(argv)
    out = {}
    for seed in args.seeds:
        if args.one_sweep:
            out[seed] = one_sweep_diff(seed, args.device)
            print(f"seed {seed}, one sweep: " + ", ".join(
                f"{k} {v:.3e}" for k, v in out[seed].items()), flush=True)
            continue
        plain = cs.gplvm_fit(seed, args.device, Kernel("se", "softplus"))
        twin = cs.gplvm_fit(seed, args.device, RoundingTwin("se", "softplus", bits=53))
        out[seed] = cs.gplvm_diff(twin, plain)
        print(f"seed {seed}: " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                                           for k, v in out[seed].items()), flush=True)
    print(json.dumps({"device": args.device, "one_sweep": args.one_sweep, "diffs": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
