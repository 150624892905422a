"""The comparison that decides ``correct``: each number the program's
outputs give against the reference's, beside the cell's limit for it
(``workloads/<cell>.json``). A number that is not finite reads as the
largest float, and fails."""

import math
import sys

import torch


def _finite(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def _norm_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """|‖p‖ − ‖r‖| / ‖r‖."""
    rn = float(torch.linalg.vector_norm(r))
    return _finite(abs(float(torch.linalg.vector_norm(p)) - rn) / rn)


def training_gaps(prog: dict, ref: dict) -> dict:
    """The first steps of a training against the reference's:

    - ``loss_gap``: the worst step's |L_p − L_r| / |L_r|;
    - ``grad_gap``: the first gradient's norm gap, relative;
    - ``change_gap``: the norm gap of θ's change after the steps, relative.

    θ is one leaf, so the worst leaf is θ and the median leaf's norm is its
    own."""
    lp, lr = prog["losses"].to(torch.float64), ref["losses"]
    loss = float(torch.max(torch.abs(lp - lr) / torch.abs(lr)))
    return {"loss_gap": _finite(loss),
            "grad_gap": _norm_gap(prog["grad"].to(torch.float64), ref["grad"]),
            "change_gap": _norm_gap(prog["change"].to(torch.float64), ref["change"])}


def mean_gap(mean_p, mean_r, scale) -> float:
    """max |m_p − m_r| over the rows, over the largest |K|ᵀ|μ_v| among them."""
    d = torch.max(torch.abs(mean_p.to(torch.float64) - mean_r))
    return _finite(float(d / torch.max(scale)))


def var_gap(var_p, var_r) -> float:
    """max |v_p − v_r| / v_r with the reference's 1/w̄ rounded to the served
    dtype: the variance is a constant fill, held exactly (limit 0)."""
    exact = var_r.to(var_p.dtype).to(torch.float64)
    return _finite(float(torch.max(torch.abs(var_p.to(torch.float64) - exact) / var_r)))


def prob_gap(prob_p, prob_r) -> float:
    return _finite(float(torch.max(torch.abs(prob_p.to(torch.float64) - prob_r))))


def judge(gaps: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a number without a
    limit, or a limit without a number, is an error of the cell's files."""
    if set(gaps) != set(limits):
        raise KeyError(f"compared {sorted(gaps)} but limits are set for {sorted(limits)}")
    return {k: {"value": gaps[k], "limit": limits[k]} for k in sorted(limits)}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
