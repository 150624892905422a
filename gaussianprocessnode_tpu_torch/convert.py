"""Carry a trained model's parameters, or a trainer's state, from the JAX
package into the port.

The JAX package keeps a trained sparse-GP regression model as θ (raw, before
the kernel's transform), the inducing inputs Xu, the natural parameters
(ξ, Λ) of q(v) and the noise precision w̄. Given those as numpy arrays (as
``np.asarray`` of the JAX arrays, or as saved in an ``.npz``),
:func:`serving_state_from_jax` builds the port's serving handle, so the JAX
and the torch handle compute the same predictions from one set of arrays.
:func:`fast_state_from_jax` turns the carry of the JAX ``fit_kin40k_fast``
into the port's, so the port resumes a JAX run and both compute the same
next epoch.
"""

import numpy as np
import torch

from .dists import MvGaussianNat
from .infer.minibatch import FastCarry
from .ops.kernels import Kernel
from .serve import SGPRegressor

__all__ = ["serving_state_from_jax", "fast_state_from_jax"]


def serving_state_from_jax(theta, Xu, xi, prec, w_mean, *, kind="se",
                           transform="softplus", dtype=torch.float32,
                           device="cuda") -> SGPRegressor:
    """An :class:`SGPRegressor` on ``device`` whose Kernel is ``Kernel(kind,
    transform, use_kernel=True)``. μ_v is recovered from (ξ, Λ) in float64;
    θ, Xu and μ_v are then held in ``dtype``."""
    kernel = Kernel(kind, transform, use_kernel=True)
    nat = MvGaussianNat(torch.as_tensor(np.asarray(xi, np.float64)),
                        torch.as_tensor(np.asarray(prec, np.float64)))
    return SGPRegressor.from_natural(
        kernel, torch.as_tensor(np.asarray(theta, np.float64)),
        torch.as_tensor(np.asarray(Xu, np.float64)), nat,
        float(w_mean), dtype=dtype, device=device)


def fast_state_from_jax(carry, device="cuda") -> FastCarry:
    """The port's ``fit_kin40k_fast`` carry from the JAX one, ``(ξ, Λ,
    covs64, θ, opt_state, kuu_inv)``, with numpy arrays for leaves (as
    ``jax.tree.map(np.asarray, carry)`` gives it). ``opt_state`` is the
    optax state of ``fast_optimizer``'s chain, ``(ZeroNansState,
    EmptyState, (ScaleByAdamState, EmptyState | ScaleByScheduleState))``;
    its leaves become the port's optimizer dict. Dtypes are kept."""
    xi, prec, covs64, theta, opt_state, kuu_inv = carry
    zero_nans, _, (adam, lr_state) = opt_state

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    opt = {"found_nan": t(zero_nans.found_nan), "count": t(adam.count),
           "mu": t(adam.mu), "nu": t(adam.nu)}
    if "count" in getattr(lr_state, "_fields", ()):  # a decaying schedule
        opt["lr_count"] = t(lr_state.count)
    return FastCarry(t(xi), t(prec), t(covs64), t(theta), opt, t(kuu_inv))
