"""Optimizer wrappers (reference: Flux AdaMax, Optim LBFGS and NelderMead).

Counterpart of ``gaussianprocessnode_tpu/utils/optim.py``:

- ``adamax``: bare ``optax.adamax`` at Flux's defaults (η = 0.002, β =
  (0.9, 0.999)), as ``infer/minibatch.py::AdaMaxChain`` without its
  ``zero_nans`` and clipping links: a NaN gradient reaches the parameters
  as NaN, as in JAX. An optional ``exponential_decay`` of the rate is the
  pendulum M-step's schedule;
- ``Adam``: ``optax.adam`` written out by hand (b1 = 0.9, b2 = 0.999,
  eps = 1e-8 outside the square root, eps_root = 0, bias-corrected), the
  EP-EM trainers' optimizer (``infer/pad_learn.py``);
- ``lbfgs_minimize``: scipy's L-BFGS-B on the host over a torch
  value-and-grad, the reference's Optim.LBFGS run to convergence;
- ``nelder_mead``: scipy's Nelder–Mead on the host over a torch objective,
  the reference's GPLVM hyperparameter search (GPLVM.ipynb cell 16).

Both scipy routines read the objective on the host at every evaluation.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import config
from ..infer.minibatch import AdaMaxChain

__all__ = ["adamax", "Adam", "lbfgs_minimize", "nelder_mead"]

_INT32_MAX = 2**31 - 1


def adamax(learning_rate: float = 0.002, decay_rate: float = 1.0,
           transition_steps: int = 1) -> AdaMaxChain:
    """``optax.adamax(learning_rate, b1=0.9, b2=0.999)`` (Flux.AdaMax's
    defaults), its rate an ``optax.exponential_decay(learning_rate,
    transition_steps, decay_rate)`` where ``decay_rate`` ≠ 1. Its state
    maps onto optax's ScaleByAdamState (``count``, ``mu``, ``nu``), plus
    ScaleByScheduleState (``lr_count``) when the rate decays."""
    return AdaMaxChain(learning_rate=learning_rate, decay_rate=decay_rate,
                       transition_steps=transition_steps, max_norm=None, zero_nans=False)


@dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate)`` over one tensor of parameters. Its
    state is a dict that maps one to one onto optax's ScaleByAdamState:
    ``count`` (int32, incremented up to its maximum), ``mu`` and ``nu``.
    As in optax, 1 − bᶜᵒᵘⁿᵗ is formed in the default float dtype
    (``config.default_dtype()``) and cast to the parameters' dtype; the
    step count stays on the device, so a step reads nothing on the host."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> dict:
        return {"count": torch.zeros((), dtype=torch.int32, device=params.device),
                "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)}

    def update_(self, grads: torch.Tensor, state: dict) -> torch.Tensor:
        """One step on ``grads``: writes the new state into ``state``'s
        tensors and returns the update to add to the parameters."""
        mu, nu, count = state["mu"], state["nu"], state["count"]
        mu.copy_((1 - self.b1) * grads + self.b1 * mu)
        nu.copy_((1 - self.b2) * (grads * grads) + self.b2 * nu)
        count.copy_(torch.where(count < _INT32_MAX, count + 1, count))
        c = count.to(config.default_dtype())
        mu_hat = mu / (1 - torch.pow(self.b1, c)).to(mu.dtype)
        nu_hat = nu / (1 - torch.pow(self.b2, c)).to(nu.dtype)
        return -self.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + self.eps))


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
