"""The headline runners' result lines held to the JAX package's figures.

``scripts/headline_jax_parity.py`` runs the JAX package's trainers on the
CPU, on the arrays that the kin40k, banana and collapsed-VSGP runners of
this package build, and writes their figures into ``FIGURES``: per trainer
the figure's spec (``figure``: its name, the key of the runner's result
line that holds it, the key that holds the depth, and whether its bound is
relative or absolute) and, per depth, the JAX figure, θ (softplus) and the
bounds that the JAX package's rounding twins set. ``hold`` reads nothing
but that file and a runner's line, so it needs neither JAX nor a card.
"""

import json
from pathlib import Path

import numpy as np

FIGURES = Path(__file__).resolve().parents[2] / "scripts" / "headline_jax_figures.json"
TRAINERS = ("kin40k_f32", "kin40k_f64", "banana", "collapsed")


def load(path=FIGURES) -> dict:
    return json.loads(Path(path).read_text())


def hold(trainer, line, figs, depth=None) -> dict:
    """``line`` (a runner's result) against the JAX figures of ``trainer``
    at ``depth`` (default: the line's own): the figure's distance from
    JAX's (relative or absolute, as the file says) and θ's largest
    relative distance, each beside its bound."""
    entry = figs[trainer]
    spec = entry["figure"]
    depth = line[spec["depth_key"]] if depth is None else depth
    f = entry["depths"][str(depth)]
    port, ref = float(line[spec["line_key"]]), float(f[spec["name"]])
    diff = abs(port - ref) / (abs(ref) if spec["bound"] == "rtol" else 1.0)
    bound = f[f"{spec['name']}_{spec['bound']}"]
    port_sp = np.asarray(line["theta_softplus"], np.float64)
    jax_sp = np.asarray(f["theta_softplus"], np.float64)
    theta_rel = float(np.max(np.abs(port_sp - jax_sp) / np.abs(jax_sp)))
    theta_bound = f["theta_softplus_rtol"]
    return {"depth": depth, "figure": spec["name"], "kind": spec["bound"], "port": port,
            "jax": ref, "diff": diff, "bound": bound, "figure_within": diff <= bound,
            "theta_softplus_port": port_sp.tolist(), "theta_softplus_jax": jax_sp.tolist(),
            "theta_softplus_rel": theta_rel, "theta_softplus_rtol": theta_bound,
            "theta_within": theta_rel <= theta_bound,
            "within": bool(diff <= bound and theta_rel <= theta_bound)}
