"""Probit likelihood node (non-conjugate path).

Counterpart of ``gaussianprocessnode_tpu/nodes/probit.py``: the
closed-form Gaussian–probit tilted moments (Rasmussen & Williams eq. 3.58),
the reference's 32-point Gauss–Hermite moment matching (ProbitMeta(32)) and
the average energy. The standard normal's log-cdf is
``torch.special.log_ndtr``, its log-pdf −(log 2π + z²)/2 (the form of
``jax.scipy.stats.norm``) and its cdf :func:`ndtr`. The Gauss–Hermite forms
take a batch of (m, v, y) at once, as an (N, n) grid of points, where the
JAX package vmaps a scalar rule.
"""

import math

import torch

from ..dists import Gaussian
from ..ops.quadrature import gh_points_weights

__all__ = [
    "ndtr",
    "out_probability",
    "tilted_marginal",
    "tilted_marginal_batch",
    "tilted_marginal_gh",
    "tilted_marginal_gh_batch",
    "average_energy",
    "average_energy_batch",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _norm_logpdf(z):
    return (_LOG_2PI + z * z) / -2.0


def ndtr(x):
    """Φ(x) = ½·erfc(−x/√2), accurate in both tails, as scipy's ``ndtr``.
    ``jax.scipy.special.ndtr`` takes ½(1 + erf(x/√2)) for |x| < 1 and the
    same erfc forms beyond, a few ulps from this; ``torch.special.ndtr``
    returns 0 below x ≈ −5.5 in float32 and x ≈ −8.3 in float64, where Φ is
    still a normal number, which would fire the Gauss–Hermite underflow
    guard at half the |m| it should."""
    return 0.5 * torch.special.erfc(x * (-0.5 * math.sqrt(2.0)))


def _last(t):
    """A tensor gains a trailing axis to meet the (…, n) grid of GH points;
    a Python number broadcasts as it is."""
    return t.unsqueeze(-1) if isinstance(t, torch.Tensor) else t


def out_probability(q_f: Gaussian):
    """P(y=1) = E_q[Φ(f)] = Φ(m/√(1+v)): the Probit :out rule used for
    prediction (reference: classification_banana.ipynb cell 13)."""
    return ndtr(q_f.mean / torch.sqrt(1.0 + q_f.var))


def _tilted(m, v, y):
    """Moments of N(f; m, v)·Φ(s·f), s = 2y−1 (y ∈ {0,1})."""
    s = 2.0 * y - 1.0
    denom = torch.sqrt(1.0 + v)
    z = s * m / denom
    # stable φ(z)/Φ(z)
    ratio = torch.exp(_norm_logpdf(z) - torch.special.log_ndtr(z))
    m_t = m + s * v * ratio / denom
    v_t = v - (v * v / (1.0 + v)) * ratio * (z + ratio)
    v_t = torch.clamp_min(v_t, 1e-12)
    return m_t, v_t


def tilted_marginal(q_fwd: Gaussian, y) -> Gaussian:
    """q(f) ∝ forward(f)·p(y|f): the product of the UniSGP forward message
    and the Probit backward message."""
    m, v = _tilted(q_fwd.mean, q_fwd.var, y)
    return Gaussian(m, v)


def tilted_marginal_batch(means, variances, ys) -> Gaussian:
    m, v = _tilted(means, variances, ys)
    return Gaussian(m, v)


def tilted_marginal_gh(m, v, y, n_gh: int = 32) -> Gaussian:
    """GH-quadrature moment matching of N(f; m, v)·Φ(s·f), the reference's
    ProbitMeta(32) product path, for scalars or a batch. Where every GH
    value underflows (float32 at |m| ≳ 12) Zsum is 0 and the floored Z
    would give a finite but wrong N(0, 1e-12); the guard (finite moments
    and Zsum > 0) returns the forward marginal there."""
    m, v = torch.as_tensor(m), torch.as_tensor(v)
    s = 2.0 * y - 1.0
    pts, w = gh_points_weights(n_gh, m, v)
    F = ndtr(_last(s) * pts)
    Zsum = torch.sum(w * F, dim=-1)
    Z = torch.clamp_min(Zsum, torch.finfo(Zsum.dtype).tiny)
    m_t = torch.sum(w * F * pts, dim=-1) / Z
    v_t = torch.sum(w * F * (pts - m_t.unsqueeze(-1)) ** 2, dim=-1) / Z
    v_t = torch.clamp_min(v_t, 1e-12)
    good = torch.isfinite(m_t) & torch.isfinite(v_t) & (Zsum > 0)
    return Gaussian(torch.where(good, m_t, m), torch.where(good, v_t, v))


def tilted_marginal_gh_batch(means, variances, ys, n_gh: int = 32) -> Gaussian:
    return tilted_marginal_gh(means, variances, ys, n_gh)


def average_energy(q_f: Gaussian, y, n_gh: int = 32):
    """U = −E_q(f)[log Φ(s·f)] by Gauss–Hermite (ProbitMeta(32)); one value
    per (m, v, y) of a batch."""
    s = 2.0 * y - 1.0
    pts, w = gh_points_weights(n_gh, q_f.mean, q_f.var)
    return -torch.sum(w * torch.special.log_ndtr(_last(s) * pts), dim=-1)


def average_energy_batch(means, variances, ys, n_gh: int = 32):
    return torch.sum(average_energy(Gaussian(means, variances), ys, n_gh))
