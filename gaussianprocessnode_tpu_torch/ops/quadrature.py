"""Quadrature, cubature and unscented-transform rules (L2 layer).

Counterpart of ``gaussianprocessnode_tpu/ops/quadrature.py``: Gauss–Hermite
(ReactiveMP ``ghcubature(n)``), spherical-radial (``srcubature()``), the
scaled unscented transform and the Generalized Unscented Transform of the
reference (helper_functions/ut_approx.jl), with the expectations, moment
matching and statistics propagation built on them.

Conventions:

- univariate rules take ``(m, v)`` and return points of shape
  ``m.shape + (P,)`` (a batch of means and variances gives one row of points
  each, where the JAX package vmaps a scalar rule) and weights ``(P,)``
  (GenUT: ``m.shape + (P,)``);
- multivariate rules take ``m (..., d)`` and ``V (..., d, d)`` and return
  points ``(..., P, d)`` and weights ``(P,)`` (GenUT: ``(..., P)``);
- every callable passed in (``f``, ``logf``, ``g``) takes the whole batch of
  points at once, as its first axis, and returns one value per point along
  that axis, where the JAX package vmaps a scalar function over the points;
  ``moment_match_multi_batch`` matches B products at once, where the JAX
  package vmaps ``moment_match_multi``, and its ``logf`` takes the (B, P, d)
  points of all of them; ``moment_match_uni`` and ``moment_match_uni_logz``
  take a batch of univariate products the same way (the (..., n) points of
  every site).
  The joint forms pass ``g`` one argument per marginal, each with the points
  along its first axis.

The GH nodes and weights are computed once per order on the host by
``numpy.polynomial.hermite.hermgauss``; their tensors are kept per order,
dtype and device, so a call on the card copies nothing from the host after
the first.
"""

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .linalg import chol_lower

__all__ = [
    "GaussHermite",
    "SphericalRadial",
    "Unscented",
    "GenUT",
    "gh_nodes",
    "gh_points_weights",
    "sr_points_weights",
    "ut_points_weights",
    "genut_points_weights_uni",
    "genut_points_weights_multi",
    "genut_statistics_uni",
    "genut_statistics_multi",
    "genut_expectation_uni",
    "genut_expectation_joint",
    "genut_statistics_joint",
    "points_weights_uni",
    "points_weights_multi",
    "points_weights_cov_multi",
    "expect_uni",
    "expect_multi",
    "moment_match_uni",
    "moment_match_uni_logz",
    "moment_match_multi",
    "moment_match_multi_batch",
]


# ---------------------------------------------------------------------------
# Method markers (ReactiveMP AbstractApproximationMethod)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GaussHermite:
    """Gauss–Hermite quadrature with ``n`` nodes (ReactiveMP ghcubature(n))."""

    n: int = 21


@dataclass(frozen=True)
class SphericalRadial:
    """3rd-degree spherical-radial (CKF) cubature: 2d equal-weight points
    (ReactiveMP srcubature())."""


@dataclass(frozen=True)
class Unscented:
    """Classic scaled UT (ReactiveMP UT()/Unscented() defaults)."""

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0


@dataclass(frozen=True)
class GenUT:
    """Generalized UT with skewness/kurtosis-matched asymmetric sigma points
    (reference: helper_functions/ut_approx.jl:116-151), on raw central
    moments (μ3, μ4): 0 and 3V² for a Gaussian."""


# ---------------------------------------------------------------------------
# Point/weight constructions
# ---------------------------------------------------------------------------


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
    ``m.shape + (n,)`` and the weights, (n,), in m's dtype."""
    m, v = torch.as_tensor(m), torch.as_tensor(v)
    z, w = gh_nodes(n, m.dtype, m.device)
    pts = m.unsqueeze(-1) + torch.sqrt(v).unsqueeze(-1) * z
    return pts, w


def _cholsqrt(V):
    """Lower Cholesky factor of V (..., d, d); the closed form for d ≤ 2,
    as the JAX package computes it (the GPSSM state dimension)."""
    d = V.shape[-1]
    if d == 1:
        return torch.sqrt(V)
    if d == 2:
        a = torch.sqrt(V[..., 0, 0])
        b = V[..., 1, 0] / a
        floor = 1e-300 if V.dtype == torch.float64 else 1e-30
        c = torch.sqrt(torch.clamp_min(V[..., 1, 1] - b * b, floor))
        z = torch.zeros_like(a)
        return torch.stack([torch.stack([a, z], -1), torch.stack([b, c], -1)], -2)
    return chol_lower(V)


def sr_points_weights(m, V):
    """3rd-degree spherical-radial cubature for N(m, V): 2d points
    m ± √d·L eᵢ, (..., 2d, d), with equal weights 1/(2d)."""
    m = torch.as_tensor(m)
    d = m.shape[-1]
    L = _cholsqrt(V)
    scaled = math.sqrt(d) * L.mT
    pts = torch.cat([m.unsqueeze(-2) + scaled, m.unsqueeze(-2) - scaled], dim=-2)
    w = torch.full((2 * d,), 1.0 / (2 * d), dtype=m.dtype, device=m.device)
    return pts, w


def ut_points_weights(m, V, alpha: float = 1e-3, beta: float = 2.0, kappa: float = 0.0):
    """Scaled unscented transform: 2d+1 points (..., 2d+1, d); returns
    (points, w_mean, w_cov)."""
    m = torch.as_tensor(m)
    d = m.shape[-1]
    lam = alpha * alpha * (d + kappa) - d
    L = _cholsqrt(V)
    offs = math.sqrt(d + lam) * L.mT
    mm = m.unsqueeze(-2)
    pts = torch.cat([mm, mm + offs, mm - offs], dim=-2)
    wm0 = lam / (d + lam)
    wc0 = wm0 + (1.0 - alpha * alpha + beta)
    wi = 1.0 / (2.0 * (d + lam))
    rest = torch.full((2 * d,), wi, dtype=m.dtype, device=m.device)
    w_mean = torch.cat([torch.full((1,), wm0, dtype=m.dtype, device=m.device), rest])
    w_cov = torch.cat([torch.full((1,), wc0, dtype=m.dtype, device=m.device), rest])
    return pts, w_mean, w_cov


def genut_points_weights_uni(m, V, S=None, K=None):
    """Univariate GenUT 3-point rule matching mean/var/skew/kurt
    (reference: ut_approx.jl:116-126): points and weights of shape
    ``m.shape + (3,)``. ``S``/``K`` are raw central moments μ3, μ4;
    Gaussian defaults when None."""
    m = torch.as_tensor(m)
    V = torch.as_tensor(V)
    S = torch.zeros_like(V) if S is None else torch.as_tensor(S)
    K = 3.0 * V * V if K is None else torch.as_tensor(K)
    L = torch.sqrt(V)
    invL3 = 1.0 / (L * L * L)
    u = 0.5 * (-S * invL3 + torch.sqrt(4.0 * K / (V * V) - 3.0 * (S * invL3) ** 2))
    v = u + S * invL3
    aux = 1.0 / (v * (u + v))
    pts = torch.stack([m, m - u * L, m + v * L], dim=-1)
    w = torch.stack([1.0 - aux * (v / u + 1.0), (v / u) * aux, aux], dim=-1)
    return pts, w


def genut_points_weights_multi(m, V, S=None, K=None):
    """Multivariate GenUT 2d+1 asymmetric points, (..., 2d+1, d), and
    weights, (..., 2d+1) (reference: ut_approx.jl:129-151). ``S``/``K`` are
    per-axis raw central moments; Gaussian defaults when None."""
    m = torch.as_tensor(m)
    L = _cholsqrt(V)
    diagL = torch.diagonal(L, dim1=-2, dim2=-1)
    S = torch.zeros(diagL.shape, dtype=m.dtype, device=m.device) if S is None \
        else torch.as_tensor(S)
    K = 3.0 * diagL**4 if K is None else torch.as_tensor(K)
    invL3_S = S / diagL**3
    invL4_K = K / diagL**4
    disc = 4.0 * invL4_K - 3.0 * invL3_S**2
    u = 0.5 * (-invL3_S + torch.sqrt(disc))
    v = u + invL3_S
    mm = m.unsqueeze(-2)
    pts_minus = mm - L.mT * u.unsqueeze(-1)
    pts_plus = mm + L.mT * v.unsqueeze(-1)
    pts = torch.cat([mm, pts_minus, pts_plus], dim=-2)
    w_plus = 1.0 / (v * (u + v))
    w_minus = w_plus * (v / u)
    w0 = 1.0 - torch.sum(w_plus, dim=-1) - torch.sum(w_minus, dim=-1)
    w = torch.cat([w0.unsqueeze(-1), w_minus, w_plus], dim=-1)
    return pts, w


# ---------------------------------------------------------------------------
# Uniform dispatch helpers
# ---------------------------------------------------------------------------


def points_weights_uni(method, m, v):
    """Points ``m.shape + (P,)`` and weights of ``method`` for N(m, v)."""
    if isinstance(method, GaussHermite):
        return gh_points_weights(method.n, m, v)
    if isinstance(method, GenUT):
        return genut_points_weights_uni(m, v)
    if isinstance(method, (SphericalRadial, Unscented)):
        m, v = torch.as_tensor(m), torch.as_tensor(v)
        m1, V1 = m.unsqueeze(-1), v.unsqueeze(-1).unsqueeze(-1)
        if isinstance(method, SphericalRadial):
            pts, w = sr_points_weights(m1, V1)
            return pts[..., 0], w
        pts, wm, _ = ut_points_weights(m1, V1, method.alpha, method.beta, method.kappa)
        return pts[..., 0], wm
    raise TypeError(f"unknown method {method!r}")


def points_weights_multi(method, m, V):
    """Points (..., P, d) and mean weights of ``method`` for N(m, V)."""
    if isinstance(method, SphericalRadial):
        return sr_points_weights(m, V)
    if isinstance(method, Unscented):
        pts, wm, _ = ut_points_weights(m, V, method.alpha, method.beta, method.kappa)
        return pts, wm
    if isinstance(method, GenUT):
        return genut_points_weights_multi(m, V)
    raise TypeError(f"unsupported multivariate method {method!r}")


def points_weights_cov_multi(method, m, V):
    """(points, mean weights, covariance weights). They coincide for every
    rule but the classic UT, whose centre covariance weight differs by
    1−α²+β; covariance-computing consumers (``moment_match_multi``) use
    this dispatch."""
    if isinstance(method, Unscented):
        return ut_points_weights(m, V, method.alpha, method.beta, method.kappa)
    pts, w = points_weights_multi(method, m, V)
    return pts, w, w


def expect_uni(method, f, m, v):
    """E_q[f(x)] for scalar q = N(m, v); ``f`` takes the (P,) points at once
    and returns (P, ...) (approximate_kernel_expectation,
    UniSGPnode.jl:25-33)."""
    pts, w = points_weights_uni(method, m, v)
    return torch.tensordot(w, f(pts), dims=1)


def expect_multi(method, f, m, V):
    """E_q[f(x)] for q = N(m, V); ``f`` takes the (P, d) points at once
    (approximate_kernel_expectation, MultiSGPnode.jl:26-35)."""
    pts, w = points_weights_multi(method, m, V)
    return torch.tensordot(w, f(pts), dims=1)


# ---------------------------------------------------------------------------
# Moment-matched products  q(x) ∝ N(x; m, v) · exp(logf(x))
# ---------------------------------------------------------------------------


def _stabilised_mass(logf, pts, w):
    """exp(logf − max) at the points (..., n), its weighted sum Z, the guard
    Z finite and positive, the Z safe to divide by, and the max, one each
    per row (the last axis), as the JAX package's ``vmap`` of the
    single-product rule gives each row its own. The double where on Z keeps
    the gradient free of NaN when the product has zero quadrature mass: Σ/Z
    at Z = 0 is a NaN whose derivative would reach the cotangent through
    the fallback where (0·NaN = NaN)."""
    lf = logf(pts)
    lmax = torch.amax(lf, dim=-1)
    shift = torch.where(torch.isfinite(lmax), lmax, torch.zeros_like(lmax))
    f = torch.exp(lf - shift[..., None])
    Z = torch.sum(w * f, dim=-1)
    ok_z = torch.isfinite(Z) & (Z > 0)
    Zs = torch.where(ok_z, Z, torch.ones_like(Z))
    return f, ok_z, Zs, lmax


def _tilted_moments(pts, w, f, Zs):
    """The tilted mean and variance per row from :func:`_stabilised_mass`."""
    wf = w * f
    mt = torch.sum(wf * pts, dim=-1) / Zs
    vt = torch.sum(wf * (pts - mt[..., None]) ** 2, dim=-1) / Zs
    return mt, vt


def moment_match_uni(logf, m, v, n: int = 21, var_floor: float = 0.0):
    """Moment-match N(m,v)·exp(logf) with the n-point GH rule, for one
    product or a batch of them: m, v (...), ``logf`` takes the (..., n)
    points of all of them at once and returns (..., n). Each row keeps its
    own stabilising max and its own fallback.

    ReactiveMP ``prod(GenericProd, Normal, ContinuousUnivariateLogPdf)``
    through ``approximate_meancov(ghcubature(21), …)`` (reference:
    UniSGPnode.jl:39-54). A product that is not finite falls back to
    (m, v); ``var_floor`` is the +1e-6 floor of the (Normal, LogPdf) order.
    """
    pts, w = gh_points_weights(n, m, v)
    f, ok_z, Zs, _ = _stabilised_mass(logf, pts, w)
    mt, vt = _tilted_moments(pts, w, f, Zs)
    vt = vt + var_floor
    good = ok_z & torch.isfinite(mt) & torch.isfinite(vt) & (vt > 0)
    return torch.where(good, mt, m), torch.where(good, vt, v)


def moment_match_uni_logz(logf, m, v, n: int = 21):
    """:func:`moment_match_uni` and the tilted log-normalizer
    log Z = log ∫ N(f; m, v)·exp(logf(f)) df by the same rule, per row. A
    product that is not finite falls back to (m, v, −inf)."""
    pts, w = gh_points_weights(n, m, v)
    f, ok_z, Zs, lmax = _stabilised_mass(logf, pts, w)
    log_z = torch.log(Zs) + lmax
    mt, vt = _tilted_moments(pts, w, f, Zs)
    good = ok_z & torch.isfinite(mt) & torch.isfinite(vt) & (vt > 0)
    return (torch.where(good, mt, m), torch.where(good, vt, v),
            torch.where(good & torch.isfinite(log_z), log_z,
                        torch.full_like(log_z, -float("inf"))))


def moment_match_multi(logf, m, V, method=SphericalRadial()):
    """Moment-match N(m,V)·exp(logf) by cubature (``logf`` takes the (P, d)
    points at once); ``prod(GenericProd, MvNormal,
    ContinuousMultivariateLogPdf)`` (reference: MultiSGPnode.jl:37-44).

    The matched covariance gets a floor of 1e-8·tr(V)/d and is tested by
    its Cholesky factor (NaN where it is not positive definite, no host
    sync); a result that is not finite, or whose factor's diagonal falls
    below half the floor's root, falls back to (m, V)."""
    pts, w, w_cov = points_weights_cov_multi(method, m, V)
    lf = logf(pts)
    f = torch.exp(lf - torch.amax(lf))
    Z = torch.sum(w * f)
    mt = (w * f) @ pts / Z
    diff = pts - mt.unsqueeze(0)
    Vt = torch.einsum("p,pi,pj->ij", w_cov * f, diff, diff) / Z
    d = m.shape[-1]
    floor = 1e-8 * torch.diagonal(V).sum() / d
    Vt = Vt + floor * torch.eye(d, dtype=V.dtype, device=V.device)
    L = chol_lower(Vt)
    good = (
        torch.all(torch.isfinite(mt))
        & torch.all(torch.isfinite(Vt))
        & torch.all(torch.isfinite(L))
        & (torch.amin(torch.diagonal(L)) > torch.sqrt(floor) * 0.5)
    )
    return torch.where(good, mt, m), torch.where(good, Vt, V)


def moment_match_multi_batch(logf, m, V, method=SphericalRadial()):
    """:func:`moment_match_multi` for B products at once: m (B, d), V (B, d,
    d), ``logf`` takes the (B, P, d) points of all rows (one Gram for all of
    them) and returns (B, P). Each row keeps its own max, floor, Cholesky
    test and fallback, as the JAX package's ``vmap`` of the single-product
    rule does."""
    pts, w, w_cov = points_weights_cov_multi(method, m, V)  # weights (P,) or (B, P)
    lf = logf(pts)
    f = torch.exp(lf - torch.amax(lf, dim=-1, keepdim=True))
    wf = w * f
    Z = torch.sum(wf, dim=-1)
    mt = torch.einsum("bp,bpd->bd", wf, pts) / Z.unsqueeze(-1)
    diff = pts - mt.unsqueeze(-2)
    Vt = torch.einsum("bp,bpi,bpj->bij", w_cov * f, diff, diff) / Z[:, None, None]
    d = m.shape[-1]
    floor = 1e-8 * torch.diagonal(V, dim1=-2, dim2=-1).sum(-1) / d
    Vt = Vt + floor[:, None, None] * torch.eye(d, dtype=V.dtype, device=V.device)
    L = chol_lower(Vt)
    good = (
        torch.all(torch.isfinite(mt), dim=-1)
        & torch.all(torch.isfinite(Vt), dim=(-2, -1))
        & torch.all(torch.isfinite(L), dim=(-2, -1))
        & (torch.amin(torch.diagonal(L, dim1=-2, dim2=-1), dim=-1) > torch.sqrt(floor) * 0.5)
    )
    return (torch.where(good.unsqueeze(-1), mt, m),
            torch.where(good[:, None, None], Vt, V))


# ---------------------------------------------------------------------------
# GenUT statistics propagation (reference: ut_approx.jl:40-112)
# ---------------------------------------------------------------------------


def genut_statistics_uni(g, m, v, S=None, K=None, compute_cross: bool = True):
    """Propagate a scalar distribution through ``g`` (taking the (3,)
    points at once) with GenUT points: (m̃, Ṽ, S̃, K̃, C̃), the transformed
    mean, variance, 3rd and 4th central moments and the input-output
    cross-covariance (reference: unscented_statistics, ut_approx.jl:51-69)."""
    pts, w = genut_points_weights_uni(m, v, S, K)
    gs = g(pts)
    mt = torch.sum(w * gs)
    d = gs - mt
    Vt = torch.sum(w * d**2)
    St = torch.sum(w * d**3)
    Kt = torch.sum(w * d**4)
    Ct = torch.sum(w * (pts - m) * d) if compute_cross else None
    return mt, Vt, St, Kt, Ct


def _genut_moments(pts, w, m, gs, compute_cross):
    mt = w @ gs
    d = gs - mt
    Vt = torch.einsum("p,pi,pj->ij", w, d, d)
    St = torch.einsum("p,pi->i", w, d**3)
    Kt = torch.einsum("p,pi->i", w, d**4)
    Ct = torch.einsum("p,pi,pj->ij", w, pts - m, d) if compute_cross else None
    return mt, Vt, St, Kt, Ct


def genut_statistics_multi(g, m, V, S=None, K=None, compute_cross: bool = True):
    """Multivariate GenUT propagation (reference: ut_approx.jl:72-91);
    ``g`` takes the (2d+1, d) points at once and returns (2d+1, k)."""
    pts, w = genut_points_weights_multi(m, V, S, K)
    return _genut_moments(pts, w, m, g(pts), compute_cross)


def genut_expectation_uni(g, m, v, S=None, K=None):
    """E[g(x)] under GenUT points, ``g`` taking the (3,) points at once
    (reference: approximate_expectation, ut_approx.jl:19-26)."""
    pts, w = genut_points_weights_uni(m, v, S, K)
    return torch.tensordot(w, g(pts), dims=1)


# ---------------------------------------------------------------------------
# GenUT over tuples of marginals (reference: ut_approx.jl:28-38, 93-112)
# ---------------------------------------------------------------------------


def _joint_from_marginals(marginals):
    """The block-diagonal joint of independent marginals.

    Each marginal is ``(m, V)`` or ``(m, V, S, K)`` with scalar or vector
    ``m`` (S/K raw central 3rd/4th moments; Gaussian defaults when
    omitted). Returns (m, V, S, K, sizes), ``sizes[i]`` 0 for a scalar
    marginal and its dimension otherwise (the reference's ``blockdiag``
    joint, ut_approx.jl:28-38). The default kurtosis is 3·diag(chol V)⁴,
    the Cholesky basis of ``genut_points_weights_multi``'s own default."""
    ms, Vs, Ss, Ks, sizes = [], [], [], [], []
    for q in marginals:
        if len(q) not in (2, 4):
            raise ValueError(
                f"marginal tuples must be (m, V) or (m, V, S, K); got length "
                f"{len(q)} — a 3-tuple would silently drop the skewness"
            )
        m = torch.as_tensor(q[0])
        V = torch.as_tensor(q[1])
        scalar = m.dim() == 0
        d = 1 if scalar else m.shape[0]
        m1 = m.reshape(1) if scalar else m
        V1 = V.reshape(1, 1) if V.dim() < 2 else V
        if len(q) == 4 and q[2] is not None:
            S1 = torch.as_tensor(q[2]).reshape(-1)
            K1 = torch.as_tensor(q[3]).reshape(-1)
        else:
            S1 = torch.zeros((d,), dtype=m1.dtype, device=m1.device)
            K1 = 3.0 * torch.diagonal(_cholsqrt(V1)) ** 4
        ms.append(m1)
        Vs.append(V1)
        Ss.append(S1)
        Ks.append(K1)
        sizes.append(0 if scalar else d)
    return (torch.cat(ms), torch.block_diag(*Vs), torch.cat(Ss), torch.cat(Ks),
            tuple(sizes))


def _split_point(pts, sizes):
    """Split the joint points (P, D) back into per-marginal arguments (the
    reference's ``__splitjoin``): (P,) for a scalar marginal, (P, d)
    otherwise."""
    parts = []
    off = 0
    for s in sizes:
        d = max(s, 1)
        piece = pts[..., off:off + d]
        parts.append(piece[..., 0] if s == 0 else piece)
        off += d
    return tuple(parts)


def genut_expectation_joint(g, *marginals):
    """E[g(x₁, …, x_k)] for independent marginals by GenUT points of their
    block-diagonal joint (reference: approximate_expectation tuple overload,
    ut_approx.jl:28-38). ``g`` takes one argument per marginal, each holding
    all the points along its first axis."""
    m, V, S, K, sizes = _joint_from_marginals(marginals)
    pts, w = genut_points_weights_multi(m, V, S, K)
    return torch.tensordot(w, g(*_split_point(pts, sizes)), dims=1)


def genut_statistics_joint(g, *marginals, compute_cross: bool = True):
    """Mixed-variate GenUT statistics propagation (reference:
    unscented_statistics tuple overload, ut_approx.jl:93-112): (m̃, Ṽ, S̃,
    K̃, C̃) of z = g(x₁, …, x_k) over the block-diagonal joint, C̃ the
    joint-input/output cross-covariance. ``g`` takes one argument per
    marginal, each holding all the points along its first axis, and returns
    (P,) or (P, k)."""
    m, V, S, K, sizes = _joint_from_marginals(marginals)
    pts, w = genut_points_weights_multi(m, V, S, K)
    gs = g(*_split_point(pts, sizes))
    if gs.dim() == 1:
        gs = gs.unsqueeze(-1)
    return _genut_moments(pts, w, m, gs, compute_cross)
