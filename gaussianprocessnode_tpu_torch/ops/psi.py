"""Ψ-statistics: exact and expected kernel statistics (L3 support).

Counterpart of ``gaussianprocessnode_tpu/ops/psi.py``. Per datum, under
q(x) (reference: GPnode/UniSGPnode.jl:11-33, MultiSGPnode.jl:11-35):

    Ψ0 = E_q[k(x,x)]
    Ψ1 = E_q[k(Xu,x)]            (M,)
    Ψ2 = E_q[k(Xu,x) k(x,Xu)]    (M,M)

All sigma points of all data are materialised at once and go through ONE
Gram K(Xu, points), then are contracted with the quadrature weights. With
``Kernel(use_kernel=True)`` a float32 point Gram on the card is the
hand-written SE kernel (``ops/csrc/se_gram.cu``); contractions are plain
``torch.matmul`` / ``einsum`` in full precision (``config`` keeps TF32 off,
the counterpart of ``sum_weighted_psi2``'s HIGHEST pin).
"""

import torch

from . import quadrature as quad

__all__ = [
    "psi1_exact",
    "psi_expected_uni",
    "psi_expected_multi",
    "psi1_expected_multi",
    "psi_batch_exact",
    "psi_batch_expected_uni",
    "psi_batch_expected_multi",
    "sum_weighted_psi2",
    "per_datum_psi2",
]


def psi1_exact(kernel, theta, Xu, x):
    """K(Xu, x) for a single observed input x (D,) → (M,)."""
    return kernel(theta, Xu, x.unsqueeze(0))[:, 0]


def _psi_from_points(kernel, theta, Xu, pts, w):
    """pts (P, Din), w (P,) → (ψ0, ψ1 (M,), ψ2 (M, M))."""
    K = kernel(theta, Xu, pts)  # (M, P)
    kdiag = kernel.diag(theta, pts)  # (P,)
    psi0 = torch.dot(w, kdiag)
    psi1 = K @ w
    psi2 = (K * w.unsqueeze(0)) @ K.T
    return psi0, psi1, psi2


def psi_expected_uni(kernel, theta, Xu, method, m, v):
    """Expected Ψ's under scalar q(x) = N(m, v). Xu is (M, 1)."""
    pts, w = quad.points_weights_uni(method, m, v)
    return _psi_from_points(kernel, theta, Xu, pts.unsqueeze(-1), w)


def psi_expected_multi(kernel, theta, Xu, method, m, V):
    """Expected Ψ's under q(x) = N(m, V), m (Din,). Xu is (M, Din)."""
    pts, w = quad.points_weights_multi(method, m, V)
    return _psi_from_points(kernel, theta, Xu, pts, w)


def psi1_expected_multi(kernel, theta, Xu, method, m, V):
    """Ψ1 only (M,), for consumers of the forward mean alone."""
    pts, w = quad.points_weights_multi(method, m, V)
    return kernel(theta, Xu, pts) @ w


def psi_batch_exact(kernel, theta, Xu, X):
    """Observed inputs X (N, Din) → (kxx (N,), Kux (M, N)). Per-datum
    Ψ2ᵢ = Kux[:,i] Kux[:,i]ᵀ is never materialised."""
    Kux = kernel(theta, Xu, X)
    kxx = kernel.diag(theta, X)
    return kxx, Kux


def psi_batch_expected_uni(kernel, theta, Xu, method, m, v):
    """Batched expected Ψ's for N univariate Gaussians m (N,), v (N,).

    Returns (ψ0 (N,), ψ1 (M, N), Kp (M, N, P), w (P,)) where per-datum
    Ψ2ᵢ = Σₚ wₚ Kp[:,i,p] Kp[:,i,p]ᵀ; the Gram over all N·P points is one
    call of the kernel."""
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    z, w = quad.points_weights_uni(method, zero, torch.ones_like(zero))  # standard points
    pts = m.unsqueeze(-1) + torch.sqrt(v).unsqueeze(-1) * z.unsqueeze(0)  # (N, P)
    N, P = pts.shape
    K = kernel(theta, Xu, pts.reshape(N * P, 1))  # (M, N·P)
    Kp = K.reshape(-1, N, P)
    kdiag = kernel.diag(theta, pts.reshape(N * P, 1)).reshape(N, P)
    psi0 = kdiag @ w
    psi1 = torch.einsum("mnp,p->mn", Kp, w)
    return psi0, psi1, Kp, w


def psi_batch_expected_multi(kernel, theta, Xu, method, means, covs):
    """Batched expected Ψ's for N multivariate Gaussians means (N, Din),
    covs (N, Din, Din): (ψ0 (N,), ψ1 (M, N), Kp (M, N, P), w (P,)). The
    rule runs on the whole batch at once; the weights are the same for
    every datum (SR, UT, GenUT of a Gaussian), so the first row is kept."""
    pts, w = quad.points_weights_multi(method, means, covs)
    if w.dim() > 1:
        w = w[0]
    N, P, Din = pts.shape
    K = kernel(theta, Xu, pts.reshape(N * P, Din))
    Kp = K.reshape(-1, N, P)
    kdiag = kernel.diag(theta, pts.reshape(N * P, Din)).reshape(N, P)
    psi0 = kdiag @ w
    psi1 = torch.einsum("mnp,p->mn", Kp, w)
    return psi0, psi1, Kp, w


def sum_weighted_psi2(Kp, w, c):
    """Σᵢ cᵢ Ψ2ᵢ from the point Gram Kp (M, N, P): one reshaped GEMM, in
    full precision (the JAX package pins HIGHEST here: a reduced-precision
    product left the chain's Λ_v indefinite on its device)."""
    M, N, P = Kp.shape
    A = Kp.reshape(M, N * P)
    scale = (c.unsqueeze(-1) * w.unsqueeze(0)).reshape(N * P)
    return (A * scale.unsqueeze(0)) @ A.T


def per_datum_psi2(Kp, w):
    """Ψ2ᵢ for every datum: (N, M, M). Use only for small N (e.g. tests)."""
    return torch.einsum("mnp,p,qnp->nmq", Kp, w, Kp)
