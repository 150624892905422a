"""Hyperparameter-learning objectives (L4 layer), fast-trainer subset.

Counterpart of ``gaussianprocessnode_tpu/objectives.py``: the
factorization-free negative log backward message that the kin40k fast
trainer differentiates with respect to θ. Its gradient flows through the SE
Gram's analytic VJP (``ops/se_gram.py``) and the Newton–Schulz inverse's
(``ops/linalg.py::spd_inverse``); every contraction is a plain
``torch.matmul`` in full precision (``config`` keeps TF32 off).
"""

import torch

from .config import JITTER_KUU
from .ops.linalg import spd_inverse

__all__ = ["neg_log_backwardmess_gram"]


def neg_log_backwardmess_gram(theta, *, kernel, Xu, X, y, mu_v, Rv, w,
                              kuu_inv_warm=None, ns_iters: int = 30,
                              ns_tol: float | None = None,
                              kuu_jitter: float = JITTER_KUU):
    """Trace form of the batched known-input hyperparameter loss
    (reference: derivative_helper.jl:23-39):

        −Σᵢ llhᵢ = −[ −½w Σkxxᵢ + ½w·tr(Kuu⁻¹S) − ½w·tr(Rv·S) + w·yᵀKuxᵀμ_v ]

    with S = Kux·Kuxᵀ and Kuu⁻¹ by the warm-started Newton–Schulz inverse
    (λ_min = the jitter: Kuu = PSD Gram + jitter·I). Returns
    ``(loss, Kuu_inv)``; ``Kuu_inv`` is detached, the next call's warm
    start."""
    Kuu = kernel.kuu(theta, Xu, jitter=kuu_jitter)
    Kuu_inv = spd_inverse(Kuu, warm=kuu_inv_warm, iters=ns_iters, tol=ns_tol,
                          lambda_min=kuu_jitter)
    kxx = kernel.diag(theta, X)
    Kux = kernel(theta, Xu, X)
    S = torch.matmul(Kux, Kux.T)
    llh = (
        -0.5 * w * torch.sum(kxx)
        + 0.5 * w * torch.sum(Kuu_inv * S)
        - 0.5 * w * torch.sum(Rv * S)
        + w * torch.dot(y, torch.matmul(Kux.T, mu_v))
    )
    return -llh, Kuu_inv.detach()
