"""Carry a trained model's parameters, or a trainer's state, from the JAX
package into the port.

The JAX package keeps a trained sparse-GP model as θ (raw, before the
kernel's transform), the inducing inputs Xu, the natural parameters (ξ, Λ)
of q(v), and the noise precision w̄ (regression) or the Gamma q(w)'s shape
and rate (probit classification). Given those as numpy arrays (as
``np.asarray`` of the JAX arrays, or as saved in an ``.npz``),
:func:`serving_state_from_jax` and :func:`classifier_state_from_jax` build
the port's serving handles, so the JAX and the torch handle compute the
same predictions from one set of arrays. :func:`fast_state_from_jax` and
:func:`banana_state_from_jax` turn a JAX trainer's carry into the port's,
so the port resumes a JAX run and both compute the same next epoch;
:func:`fast_dp_state_from_jax` does so for the data-parallel kin40k
trainer's carry (``parallel/sharding.py::fit_kin40k_fast_dp``).
:func:`vmp_state_from_jax` does the same for a batch VMP result and θ of
the toy trainers. :func:`svgp_params_from_jax`, :func:`sparse_gp_params_from_jax`
and :func:`adamax_state_from_jax` carry the VSGP and FITC trainers'
parameters and their ``optax.chain(zero_nans(), adamax(lr))`` state, so a
collapsed chunk resumes from a JAX chunk. :func:`gpssm_state_from_jax` and
:func:`ut_state_from_jax` carry a GPSSM chain smoother's and a UT
smoother's state, so a JAX state warm-starts the port's engines and a
trained JAX chain serves through the port's ``serve.GPSSMFilter``.
:func:`gplvm_state_from_jax` carries a GPLVM mean-field state, so a JAX
state warm-starts ``gplvm_vmp`` or ``fit_gplvm_grad``, or is embedded
against by ``gplvm_embed``. :func:`pad_state_from_jax` carries a GP-PAD
state (white or colored carrier), whose sites warm-start ``gppad_infer``
or ``gppad_colored_infer`` through ``sites0``; :func:`fullcov_state_from_jax`
carries a full-covariance GP's mean-field state to ``fullcov_gp_predict``.
"""

import numpy as np
import torch

from .dists import GammaShapeRate, Gaussian, MvGaussian, MvGaussianNat
from .infer.batch_vmp import VMPResult
from .infer.chain_smoother import GPSSMState
from .infer.fitc import SparseGPParams
from .infer.fullcov_gp import FullCovState
from .infer.gppad import ColoredPADState, PADState
from .infer.gplvm import GPLVMState
from .infer.minibatch import FastCarry, MinibatchCarry
from .infer.svgp import SVGPParams
from .infer.ut_smoother import UTSmootherState
from .ops.kernels import Kernel
from .serve import SGPClassifier, SGPRegressor

__all__ = ["serving_state_from_jax", "classifier_state_from_jax", "fast_state_from_jax",
           "fast_dp_state_from_jax", "banana_state_from_jax", "vmp_state_from_jax", "svgp_params_from_jax",
           "sparse_gp_params_from_jax", "adamax_state_from_jax", "gpssm_state_from_jax",
           "ut_state_from_jax", "gplvm_state_from_jax", "pad_state_from_jax",
           "fullcov_state_from_jax"]


def _nat(xi, prec):
    return MvGaussianNat(torch.as_tensor(np.asarray(xi, np.float64)),
                         torch.as_tensor(np.asarray(prec, np.float64)))


def serving_state_from_jax(theta, Xu, xi, prec, w_mean, *, kind="se",
                           transform="softplus", dtype=torch.float32,
                           device="cuda") -> SGPRegressor:
    """An :class:`SGPRegressor` on ``device`` whose Kernel is ``Kernel(kind,
    transform, use_kernel=True)``. μ_v is recovered from (ξ, Λ) in float64;
    θ, Xu and μ_v are then held in ``dtype``."""
    return SGPRegressor.from_natural(
        Kernel(kind, transform, use_kernel=True),
        torch.as_tensor(np.asarray(theta, np.float64)),
        torch.as_tensor(np.asarray(Xu, np.float64)), _nat(xi, prec),
        float(w_mean), dtype=dtype, device=device)


def classifier_state_from_jax(theta, Xu, xi, prec, w_shape, w_rate, *, kind="se",
                              transform="softplus", dtype=torch.float32,
                              device="cuda") -> SGPClassifier:
    """An :class:`SGPClassifier` on ``device`` whose Kernel is
    ``Kernel(kind, transform, use_kernel=True)``: μ_v recovered from (ξ, Λ)
    in float64, w̄ = w_shape/w_rate in their own dtype; θ, Xu and μ_v then
    held in ``dtype``."""
    return SGPClassifier.from_natural(
        Kernel(kind, transform, use_kernel=True),
        torch.as_tensor(np.asarray(theta, np.float64)),
        torch.as_tensor(np.asarray(Xu, np.float64)), _nat(xi, prec),
        GammaShapeRate(np.asarray(w_shape), np.asarray(w_rate)),
        dtype=dtype, device=device)


def _tensor(device):
    def t(a):
        return torch.as_tensor(np.array(a), device=device)
    return t


def _optimizer_state(opt_state, t, mesh_size=1) -> dict:
    """The port's optimizer dict from the optax state of the trainers'
    chain, ``(ZeroNansState, EmptyState, (ScaleByAdamState, EmptyState |
    ScaleByScheduleState))``; the AdaMax moments divided by ``mesh_size``
    (see :func:`fast_dp_state_from_jax`)."""
    zero_nans, _, (adam, lr_state) = opt_state
    opt = {"found_nan": t(zero_nans.found_nan), "count": t(adam.count),
           "mu": t(adam.mu) / mesh_size, "nu": t(adam.nu) / mesh_size}
    if "count" in getattr(lr_state, "_fields", ()):  # a decaying schedule
        opt["lr_count"] = t(lr_state.count)
    return opt


def fast_state_from_jax(carry, device="cuda") -> FastCarry:
    """The port's ``fit_kin40k_fast`` carry from the JAX one, ``(ξ, Λ,
    covs64, θ, opt_state, kuu_inv)``, with numpy arrays for leaves (as
    ``jax.tree.map(np.asarray, carry)`` gives it); ``opt_state`` becomes
    the port's optimizer dict. Dtypes are kept."""
    xi, prec, covs64, theta, opt_state, kuu_inv = carry
    t = _tensor(device)
    return FastCarry(t(xi), t(prec), t(covs64), t(theta), _optimizer_state(opt_state, t),
                     t(kuu_inv))


def fast_dp_state_from_jax(carry, device="cuda", mesh_size=1) -> FastCarry:
    """The port's ``fit_kin40k_fast_dp`` carry from the JAX one (the 6-tuple
    of ``init_kin40k_fast_dp_state``: ``(ξ, Λ, cov64, θ, opt_state,
    kuu_inv)``, numpy leaves): the one-group :class:`FastCarry` of
    ``fit_kin40k_fast``, the (M, M) warm inverse as its one group,
    ``opt_state`` as the port's optimizer dict; replicated, so every rank
    takes the same. Dtypes are kept.

    ``mesh_size``: the devices of the JAX mesh that made the carry. The JAX
    data-parallel trainers psum a θ-gradient that ``jax.grad`` has already
    summed over the mesh (the cotangent of a replicated θ), so their AdaMax
    moments are ``mesh_size`` times the full-batch ones (θ's path is the
    same: AdaMax's step is invariant to the gradient's scale, up to its
    eps). The port all-reduces the local gradients once; the moments are
    divided back here."""
    xi, prec, cov64, theta, opt_state, kuu_inv = carry
    t = _tensor(device)
    return FastCarry(t(xi), t(prec), t(np.asarray(cov64)[None]), t(theta),
                     _optimizer_state(opt_state, t, mesh_size), t(kuu_inv))


def banana_state_from_jax(carry, device="cuda", mesh_size=1) -> MinibatchCarry:
    """The port's :class:`MinibatchCarry` from the JAX ``MinibatchCarry``
    (of ``fit_banana_fast``, ``fit_banana`` or ``fit_kin40k``), with numpy
    arrays for leaves: field for field, ``opt_state`` (``default_optimizer``'s
    chain, ``(ZeroNansState, EmptyState, (ScaleByAdamState, EmptyState))``)
    as the port's optimizer dict. Dtypes are kept. For a carry of
    ``fit_banana_fast_dp`` on a JAX mesh of ``mesh_size`` devices, the AdaMax
    moments are divided by it, as in :func:`fast_dp_state_from_jax`."""
    xi, prec, cov, kuu_inv, theta, opt_state, w_shape, w_rate = carry
    t = _tensor(device)
    return MinibatchCarry(t(xi), t(prec), t(cov), t(kuu_inv), t(theta),
                          _optimizer_state(opt_state, t, mesh_size), t(w_shape), t(w_rate))


def vmp_state_from_jax(result, theta, device="cuda"):
    """(θ, the port's :class:`VMPResult`) from the JAX package's
    ``VMPResult`` of ``regression_vmp`` / ``classification_vmp`` and θ, with
    numpy arrays for leaves (as ``jax.tree.map(np.asarray, …)`` gives them):
    field for field, ``qf`` kept as None where the JAX result has none.
    Dtypes are kept."""
    t = _tensor(device)
    qf = None if result.qf is None else Gaussian(t(result.qf.mean), t(result.qf.var))
    res = VMPResult(MvGaussian(t(result.qv.mean), t(result.qv.cov)),
                    MvGaussianNat(t(result.qv_nat.xi), t(result.qv_nat.prec)),
                    GammaShapeRate(t(result.qw.shape), t(result.qw.rate)),
                    t(result.Uv), t(result.free_energy), qf)
    return t(theta), res


def _params(cls, params, t):
    """The port's NamedTuple ``cls`` from a JAX one, leaf for leaf through ``t``."""
    return cls(*(t(leaf) for leaf in params))


def svgp_params_from_jax(params, device="cuda") -> SVGPParams:
    """The port's :class:`SVGPParams` from the JAX ones (numpy leaves, as
    ``jax.tree.map(np.asarray, params)`` gives them), dtypes kept."""
    return _params(SVGPParams, params, _tensor(device))


def sparse_gp_params_from_jax(params, device="cuda") -> SparseGPParams:
    """The port's :class:`SparseGPParams` from the JAX ones, dtypes kept."""
    return _params(SparseGPParams, params, _tensor(device))


def adamax_state_from_jax(opt_state, params_type=None, device="cuda") -> dict:
    """The port's optimizer dict (``vsgp_optimizer``'s ``AdaMaxChain``
    without clipping) from the state of ``optax.chain(zero_nans(),
    adamax(lr))``, ``(ZeroNansState, (ScaleByAdamState, EmptyState))``,
    with numpy leaves: ``found_nan`` per leaf, ``count``, ``mu`` and ``nu``
    in the parameters' structure. ``params_type`` is the port's NamedTuple
    (``SVGPParams`` or ``SparseGPParams``) where the chain ran over one,
    None where it ran over one array (the collapsed θ). Dtypes are kept."""
    zero_nans, (adam, _) = opt_state
    t = _tensor(device)
    tree = t if params_type is None else lambda x: _params(params_type, x, t)
    return {"found_nan": tree(zero_nans.found_nan), "count": t(adam.count),
            "mu": tree(adam.mu), "nu": tree(adam.nu)}


def gpssm_state_from_jax(state, device="cuda") -> GPSSMState:
    """The port's :class:`GPSSMState` from the JAX ``GPSSMState`` (of
    ``gpssm_vmp``, ``gpssm_vmp_sequential``, ``gpssm_vmp_pit`` or
    ``gpssm_control_vmp``), with numpy arrays for leaves: field for field,
    dtypes kept."""
    return _params(GPSSMState, state, _tensor(device))


def ut_state_from_jax(state, device="cuda") -> UTSmootherState:
    """The port's :class:`UTSmootherState` from the JAX one (numpy leaves),
    field for field, dtypes kept."""
    return _params(UTSmootherState, state, _tensor(device))


def gplvm_state_from_jax(state, device="cuda") -> GPLVMState:
    """The port's :class:`GPLVMState` from the JAX ``GPLVMState`` (numpy
    leaves): the latents' means and covariances in the model's dtype as
    they come, the q(v) naturals in float64 (as every GPLVM state holds
    them)."""
    t = _tensor(device)
    x_means, x_covs, xi_v, prec_v = state
    return GPLVMState(t(x_means), t(x_covs), t(xi_v).to(torch.float64),
                      t(prec_v).to(torch.float64))


def pad_state_from_jax(state, device="cuda"):
    """The port's :class:`PADState` or :class:`ColoredPADState` from the JAX
    one of the same name (numpy leaves), field for field, dtypes kept. Its
    ``(lam1, lam2)`` are the ``sites0`` warm start of the next inference."""
    cls = ColoredPADState if hasattr(state, "f_mean") else PADState
    return _params(cls, state, _tensor(device))


def fullcov_state_from_jax(state, device="cuda") -> FullCovState:
    """The port's :class:`FullCovState` from the JAX one (numpy leaves; its
    q(γ) a ``GammaShapeRate``), field for field, dtypes kept."""
    t = _tensor(device)
    return FullCovState(t(state.m_f), t(state.V_f),
                        GammaShapeRate(t(state.gamma.shape), t(state.gamma.rate)),
                        t(state.m_th), t(state.v_th), t(state.fe))
