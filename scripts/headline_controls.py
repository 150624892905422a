#!/usr/bin/env python3
"""Negative controls for the bounds that ``chip_smoke.py`` phase 17 holds
the headline runners to.

Phase 17 runs the kin40k runner (float32 and float64) and the banana runner
for 100 epochs and the collapsed-VSGP runner for 400 steps, at full width
on the card, and holds each figure (SMSE or test errors) and θ (softplus)
to the JAX package's on the same data (``scripts/headline_jax_figures.json``)
within the bounds that the JAX package's rounding twins set. A bound that
no wrong run fails checks nothing, so this script runs each runner made
wrong in one small way that a fault of the port could cause, and holds it
to the same figures at phase 17's depth:

- one epoch (collapsed: one step) short, an off-by-one in the chunked loop;
- kin40k float32 also 5 epochs short, banana 10, 50 and 90 short (its
  runner takes no learning rate);
- the learning rate off by a relative 1e-3 and 1e-2 (float32) or 1e-8
  (float64), a wrong constant or a step that rounds differently.

It prints a line per control, the card's name and power limit, and as its
last line one JSON object. It exits 1 unless each of phase 17's gating
bounds (every figure and θ but banana's errors, ``AGREEMENT_ONLY``) is
failed by at least one control of its trainer, and 2 when there is no CUDA
card. On the card, ~4 minutes:

    python3 scripts/headline_controls.py
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gaussianprocessnode_tpu_torch.experiments import banana, headline, kin40k  # noqa: E402
from gaussianprocessnode_tpu_torch.experiments import vsgp_baselines as vb  # noqa: E402
from gaussianprocessnode_tpu_torch.utils.profiling import card_info  # noqa: E402

LR_KIN40K, LR_COLLAPSED = 1e-3, 0.05  # the runners' learning rates
# Bounds that show agreement and gate nothing. Banana's test errors, a
# count on 1,300 points, are flat in training depth on this data (123
# after 10 and 100 epochs, 125 after 50, on an H100 by this script), so no
# run one to 90 epochs short moves them past their ± 2; θ gates banana.
AGREEMENT_ONLY = (("banana", "figure"),)


def controls(depth):
    """(trainer, name, thunk) per control; ``depth``: phase 17's depths."""
    k32, k64, ban, col = (depth[t] for t in headline.TRAINERS)
    f64 = torch.float64
    return [
        ("kin40k_f32", "1 epoch short", lambda: kin40k.run(epochs=k32 - 1)),
        ("kin40k_f32", "5 epochs short", lambda: kin40k.run(epochs=k32 - 5)),
        ("kin40k_f32", "lr x (1 + 1e-3)",
         lambda: kin40k.run(epochs=k32, learning_rate=LR_KIN40K * (1 + 1e-3))),
        ("kin40k_f32", "lr x (1 + 1e-2)",
         lambda: kin40k.run(epochs=k32, learning_rate=LR_KIN40K * (1 + 1e-2))),
        ("kin40k_f64", "1 epoch short", lambda: kin40k.run(epochs=k64 - 1, dtype=f64)),
        ("kin40k_f64", "lr x (1 + 1e-8)",
         lambda: kin40k.run(epochs=k64, dtype=f64, learning_rate=LR_KIN40K * (1 + 1e-8))),
        ("banana", "1 epoch short", lambda: banana.run(epochs=ban - 1)),
        ("banana", "10 epochs short", lambda: banana.run(epochs=ban - 10)),
        ("banana", "50 epochs short", lambda: banana.run(epochs=ban - 50)),
        ("banana", "90 epochs short", lambda: banana.run(epochs=ban - 90)),
        ("collapsed", "1 step short", lambda: vb.run_kin40k_collapsed(steps=col - 1)),
        ("collapsed", "lr x (1 + 1e-3)",
         lambda: vb.run_kin40k_collapsed(steps=col, learning_rate=LR_COLLAPSED * (1 + 1e-3))),
        ("collapsed", "lr x (1 + 1e-2)",
         lambda: vb.run_kin40k_collapsed(steps=col, learning_rate=LR_COLLAPSED * (1 + 1e-2))),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    card = card_info()
    figs = headline.load()
    depth = figs["smoke_depth"]
    rows, failed = [], {(t, q): [] for t in headline.TRAINERS for q in ("figure", "theta")}
    for trainer, name, thunk in controls(depth):
        t0 = time.perf_counter()
        held = headline.hold(trainer, thunk(), figs, depth=depth[trainer])
        for q in ("figure", "theta"):
            if not held[f"{q}_within"]:
                failed[(trainer, q)].append(name)
        rows.append({"trainer": trainer, "control": name, "seconds": time.perf_counter() - t0,
                     **{k: v for k, v in held.items()
                        if k not in ("theta_softplus_port", "theta_softplus_jax")}})
        print(f"{trainer} {name}: {held['figure']} {held['port']} against JAX {held['jax']} "
              f"({held['kind'][0]}diff {held['diff']:.3e}, bound {held['bound']:.3e}: "
              f"{'within' if held['figure_within'] else 'fails'}); theta rel "
              f"{held['theta_softplus_rel']:.3e} (bound {held['theta_softplus_rtol']:.3e}: "
              f"{'within' if held['theta_within'] else 'fails'})", flush=True)
    toothless = [f"{t} {q}" for (t, q), names in failed.items()
                 if not names and (t, q) not in AGREEMENT_ONLY]
    print(f"card: {card['name']}, {card['power_limit']}", flush=True)
    print(json.dumps({"ok": not toothless, "card": card, "no_control_fails": toothless,
                      "agreement_only": [f"{t} {q}" for t, q in AGREEMENT_ONLY],
                      "failed_by": {f"{t} {q}": n for (t, q), n in failed.items()},
                      "controls": rows}), flush=True)
    return 0 if not toothless else 1


if __name__ == "__main__":
    raise SystemExit(main())
