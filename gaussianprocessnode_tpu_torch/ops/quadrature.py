"""Gauss–Hermite quadrature (L2 layer), the probit node's subset.

Counterpart of ``gaussianprocessnode_tpu/ops/quadrature.py``
(``_gh_nodes_np``, ``gh_nodes``, ``gh_points_weights``). The nodes and
weights are computed once per order on the host by
``numpy.polynomial.hermite.hermgauss``; their tensors are kept per order,
dtype and device, so a call on the card copies nothing from the host after
the first.
"""

from functools import lru_cache

import numpy as np
import torch

__all__ = ["gh_nodes", "gh_points_weights"]


@lru_cache(maxsize=None)
def _gh_nodes_np(n: int):
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.sqrt(2.0) * x, w / np.sqrt(np.pi)


@lru_cache(maxsize=None)
def gh_nodes(n: int, dtype=torch.float64, device="cpu"):
    """Hermite–Gauss nodes and weights for E[f(Z)], Z ~ N(0, 1): Σ wᵢ f(zᵢ),
    as tensors of ``dtype`` on ``device``."""
    z, wn = _gh_nodes_np(n)
    return (torch.as_tensor(z, dtype=dtype, device=device),
            torch.as_tensor(wn, dtype=dtype, device=device))


def gh_points_weights(n: int, m, v):
    """The n-point GH rule for N(m, v): points m + √v·z of shape
    ``m.shape + (n,)`` (a batch of means and variances gives one row of
    points each, where the JAX package vmaps a scalar rule) and the
    weights, (n,), in m's dtype."""
    m, v = torch.as_tensor(m), torch.as_tensor(v)
    z, w = gh_nodes(n, m.dtype, m.device)
    pts = m.unsqueeze(-1) + torch.sqrt(v).unsqueeze(-1) * z
    return pts, w
