"""Timing and parity record of the faithful kin40k trainer from given
inducing inputs, on the card.

Counterpart of ``experiments/refxu_record.py``. It runs the spectrum-scaled
faithful float64 schedule (``experiments/kin40k.py::run(faithful=True)``,
``fit_kin40k`` at ``--budget`` Newton–Schulz iterations, 34 by default)
from the reference's inducing inputs ``Xu_kin40k``, on the card with
``warm_timing`` (the epochs run twice from the same start; the second
run's seconds are ``faithful_seconds_clean``, the first's
``first_seconds``), and checks its parity against the reference's goldens
(regression_kin40k.ipynb cells 9-10, 15): max |θ − θ*| against
``params_optimal_kin40k`` and |SMSE − SMSE*| against ``SMSE_kin40k``.

The three goldens are read from ``--save DIR``, each ``NAME.jld``
(``utils/jld.py``) or ``NAME.npy``; without them it raises
FileNotFoundError naming the path. ``--data kin40k|synthetic`` as in the
kin40k runner, kin40k by default: the goldens are the reference's fit on
kin40k, so on synthetic data (a timing run where the kin40k files are
absent) the parity fields are null and ``parity`` says why.

    python -m gaussianprocessnode_tpu_torch.experiments.refxu_record --save DIR
        [--epochs 500] [--budget 34] [--data kin40k|synthetic] [--json=PATH] [--device cpu]

prints the record as one JSON line (with the card's name and power limit);
``--json=PATH`` also writes it to PATH.
"""

import argparse
import json
import time

import numpy as np
import torch

from .kin40k import run
from .serving_bench import load_golden

__all__ = ["GOLDENS", "record", "main"]

GOLDENS = ("Xu_kin40k", "params_optimal_kin40k", "SMSE_kin40k")
DEFAULT_BUDGET = 34


def record(save, epochs=500, budget=DEFAULT_BUDGET, data="kin40k", device="cuda",
           **run_kwargs) -> dict:
    """Train from the golden Xu, time it and check parity; returns the
    record. ``run_kwargs`` go to ``kin40k.run`` (sizes, seed)."""
    xu, theta_star, smse_ref = (load_golden(save, name) for name in GOLDENS)
    xu = np.asarray(xu, np.float64)
    theta_star = np.asarray(theta_star, np.float64).ravel()
    smse_ref = float(np.asarray(smse_ref))
    warm = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    res = run(epochs=epochs, faithful=True, xu=xu, data=data, device=device,
              warm_timing=warm, ns_budget=budget, **run_kwargs)
    total = time.perf_counter() - t0
    theta = np.asarray(res["theta"])
    if data == "kin40k":
        held = {"parity": "against the goldens",
                "max_abs_theta_diff": float(np.abs(theta - theta_star).max()),
                "abs_smse_diff": abs(res["smse"] - smse_ref)}
    else:
        held = {"parity": f"not applicable: {data} data, and the goldens are the "
                          "reference's fit on kin40k",
                "max_abs_theta_diff": None, "abs_smse_diff": None}
    return {
        "description": (
            "The spectrum-scaled faithful float64 kin40k trainer (fit_kin40k) "
            "from the reference's Xu_kin40k. faithful_seconds_clean: the "
            "epochs' seconds (with warm_timing, a second run from the same "
            "start, the kernel built and the memory allocated); "
            "first_seconds: the first run's. Parity against "
            "params_optimal_kin40k and SMSE_kin40k."),
        "ns_budget": f"scaled {budget}",
        "epochs": epochs,
        "data": data,
        "warm_timing": warm,
        "warm_equals_first": res["warm_equals_first"],
        "faithful_seconds_clean": res["value"],
        "first_seconds": res["first_seconds"],
        "total_wall_seconds": total,
        "smse": res["smse"],
        "smse_ref": smse_ref,
        "theta": theta.tolist(),
        "theta_star_ref": theta_star.tolist(),
        **held,
        "m_inducing": res["m_inducing"],
        "device": res["device"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", metavar="DIR", required=True,
                    help="directory of Xu_kin40k, params_optimal_kin40k, SMSE_kin40k")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--budget", type=int, default=DEFAULT_BUDGET)
    ap.add_argument("--data", choices=("kin40k", "synthetic"), default="kin40k")
    ap.add_argument("--json", metavar="PATH", help="also write the record to PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = record(args.save, args.epochs, args.budget, args.data, args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
