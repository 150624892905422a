"""Optimizer wrappers (reference: Flux AdaMax, Optim LBFGS and NelderMead).

Counterpart of ``gaussianprocessnode_tpu/utils/optim.py``:

- ``adamax``: bare ``optax.adamax`` at Flux's defaults (η = 0.002, β =
  (0.9, 0.999)), as ``infer/minibatch.py::AdaMaxChain`` without its
  ``zero_nans`` and clipping links: a NaN gradient reaches the parameters
  as NaN, as in JAX. An optional ``exponential_decay`` of the rate is the
  pendulum M-step's schedule;
- ``lbfgs_minimize``: scipy's L-BFGS-B on the host over a torch
  value-and-grad, the reference's Optim.LBFGS run to convergence;
- ``nelder_mead``: scipy's Nelder–Mead on the host over a torch objective,
  the reference's GPLVM hyperparameter search (GPLVM.ipynb cell 16).

Both scipy routines read the objective on the host at every evaluation.
"""

import numpy as np
import torch

from ..infer.minibatch import AdaMaxChain

__all__ = ["adamax", "lbfgs_minimize", "nelder_mead"]


def adamax(learning_rate: float = 0.002, decay_rate: float = 1.0,
           transition_steps: int = 1) -> AdaMaxChain:
    """``optax.adamax(learning_rate, b1=0.9, b2=0.999)`` (Flux.AdaMax's
    defaults), its rate an ``optax.exponential_decay(learning_rate,
    transition_steps, decay_rate)`` where ``decay_rate`` ≠ 1. Its state
    maps onto optax's ScaleByAdamState (``count``, ``mu``, ``nu``), plus
    ScaleByScheduleState (``lr_count``) when the rate decays."""
    return AdaMaxChain(learning_rate=learning_rate, decay_rate=decay_rate,
                       transition_steps=transition_steps, max_norm=None, zero_nans=False)


def lbfgs_minimize(value_and_grad_fn, x0, args=(), maxiter: int = 200):
    """Minimise with scipy L-BFGS-B given ``value_and_grad_fn(x, *args) ->
    (value, grad)`` on tensors; x is a float64 tensor on x0's device.
    Returns (x, value)."""
    from scipy.optimize import minimize

    x0 = torch.as_tensor(x0)
    dev = x0.device

    def f_np(x):
        v, g = value_and_grad_fn(torch.as_tensor(x, dtype=torch.float64, device=dev), *args)
        return float(v), np.asarray(g.detach().cpu().numpy(), dtype=np.float64)

    res = minimize(f_np, x0.detach().cpu().numpy().astype(np.float64), jac=True,
                   method="L-BFGS-B", options={"maxiter": maxiter})
    return torch.as_tensor(res.x, device=dev), float(res.fun)


def nelder_mead(fun, x0, maxiter: int = 25):
    """Minimise a (possibly non-smooth) scalar objective of a float64 tensor
    by Nelder–Mead. Returns (x, value, the value of every evaluation)."""
    from scipy.optimize import minimize

    x0 = torch.as_tensor(x0)
    dev = x0.device
    history = []

    def f_np(x):
        v = float(fun(torch.as_tensor(x, dtype=torch.float64, device=dev)))
        history.append(v)
        return v

    res = minimize(f_np, x0.detach().cpu().numpy().astype(np.float64), method="Nelder-Mead",
                   options={"maxiter": maxiter, "xatol": 1e-8, "fatol": 1e-10})
    return torch.as_tensor(res.x, device=dev), float(res.fun), history
