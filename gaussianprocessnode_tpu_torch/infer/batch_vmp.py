"""Batched prediction at PointMass test inputs (L5 layer), serving subset.

Counterpart of ``gaussianprocessnode_tpu/infer/batch_vmp.py::predict_out``
and ``predict_probit``.
"""

import torch

from ..dists import Gaussian
from ..nodes.probit import out_probability

__all__ = ["predict_out", "predict_probit"]


def predict_out(kernel, theta, Xu, X_test, mu_v, w_mean):
    """Batched UniSGP :out rule at PointMass test inputs:
    N(K(Xu,x*)ᵀ μ_v, w̄⁻¹) (reference: UniSGPnode.jl:96-104).

    ``w_mean`` is a tensor (0-dim, any float dtype) on the inputs' device,
    so neither the mean nor the variance waits on the host."""
    Kut = kernel(theta, Xu, X_test)
    mean = Kut.T @ mu_v
    var = torch.empty_like(mean).copy_((1.0 / w_mean).expand(mean.shape))
    return mean, var


def predict_probit(kernel, theta, Xu, X_test, mu_v, w_mean):
    """Class probability P(y=1|x*) = Φ(m/√(1+v)) through the Probit out rule
    (reference: classification_banana.ipynb cell 13)."""
    mean, var = predict_out(kernel, theta, Xu, X_test, mu_v, w_mean)
    return out_probability(Gaussian(mean, var))
