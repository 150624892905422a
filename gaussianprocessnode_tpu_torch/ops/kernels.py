"""Stationary kernels and Gram-matrix construction (L0 layer).

Counterpart of ``gaussianprocessnode_tpu/ops/kernels.py``:
- inputs are dense ``(N, D)`` tensors; 1-D inputs go through
  ``torch.atleast_2d`` exactly as the JAX package uses ``jnp.atleast_2d``;
- the squared distance is the expanded form ``|x|² + |z|² − 2 x·z`` with the
  cross term as one matmul, clamped at 0;
- hyperparameters are a flat vector ``θ = [variance, lengthscales…]``.
"""

import math
from dataclasses import dataclass

import torch

from ..utils import tracing

__all__ = [
    "sqdist",
    "se_gram",
    "matern12_gram",
    "matern32_gram",
    "matern52_gram",
    "gram",
    "gram_diag",
    "Kernel",
    "softplus",
    "invsoftplus",
]


def softplus(x):
    """log(1 + eˣ) written as ``logaddexp(x, 0)``, the form of
    ``jax.nn.softplus`` (``torch.nn.functional.softplus`` switches to the
    identity above x = 20, which differs from it by ~1e-9 there)."""
    x = torch.as_tensor(x)
    return torch.logaddexp(x, torch.zeros_like(x))


def invsoftplus(x):
    """Inverse softplus: log(exp(x) − 1)."""
    x = torch.as_tensor(x)
    return x + torch.log(-torch.expm1(-x))


def sqdist(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances ``|x_i|² + |z_j|² − 2 x_i·z_j``,
    clamped at 0 to kill negative round-off. The cross term runs in full
    precision: ``config`` keeps TF32 off. X (..., N, D) and Z (..., M, D)
    may carry broadcasting batch dimensions (one Gram per lengthscale)."""
    xx = torch.sum(X * X, dim=-1)[..., :, None]
    zz = torch.sum(Z * Z, dim=-1)[..., None, :]
    cross = torch.matmul(X, Z.mT)
    return torch.clamp_min(xx + zz - 2.0 * cross, 0.0)


def se_gram(X, Z, variance, lengthscales):
    """Squared-exponential (RBF) Gram matrix σ²·exp(−d²/2ℓ²)."""
    d2 = sqdist(X / lengthscales, Z / lengthscales)
    return variance * torch.exp(-0.5 * d2)


def _dist(X, Z, lengthscales):
    return torch.sqrt(sqdist(X / lengthscales, Z / lengthscales) + 1e-36)


def matern12_gram(X, Z, variance, lengthscales):
    return variance * torch.exp(-_dist(X, Z, lengthscales))


def matern32_gram(X, Z, variance, lengthscales):
    s = math.sqrt(3.0) * _dist(X, Z, lengthscales)
    return variance * (1.0 + s) * torch.exp(-s)


def matern52_gram(X, Z, variance, lengthscales):
    s = math.sqrt(5.0) * _dist(X, Z, lengthscales)
    return variance * (1.0 + s + s * s / 3.0) * torch.exp(-s)


_GRAMS = {
    "se": se_gram,
    "matern12": matern12_gram,
    "matern32": matern32_gram,
    "matern52": matern52_gram,
}


def gram(kind: str, X, Z, variance, lengthscales):
    return _GRAMS[kind](X, Z, variance, lengthscales)


def gram_diag(kind: str, X, variance):
    """Diagonal of K(X,X). All supported kernels are stationary: k(x,x)=σ²."""
    del kind
    return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * variance


@dataclass(frozen=True)
class Kernel:
    """A kernel family with a θ-parameterization.

    ``theta`` layout: ``[variance, ℓ…]`` with one shared lengthscale or one
    per input dimension (ARD). ``transform='softplus'`` applies softplus to
    θ first; ``'identity'`` takes θ as it is.

    ``use_kernel=True`` (the counterpart of ``use_pallas``) routes SE Grams
    through ``ops/se_gram.py::se_gram_auto``: the hand-written CUDA kernel
    for float32 CUDA tensors, the plain Gram for CPU tensors and any other
    dtype.
    """

    kind: str = "se"
    transform: str = "identity"
    use_kernel: bool = False

    @tracing.traced("kernel.params")
    def params(self, theta):
        theta = torch.as_tensor(theta)
        if self.transform == "softplus":
            theta = softplus(theta)
        return theta[0], theta[1:]

    def __call__(self, theta, X, Z) -> torch.Tensor:
        var, ls = self.params(theta)
        X2, Z2 = torch.atleast_2d(X), torch.atleast_2d(Z)
        if self.use_kernel and self.kind == "se":
            from .se_gram import se_gram_fused

            return se_gram_fused(X2, Z2, var, ls)
        return gram(self.kind, X2, Z2, var, ls)

    def diag(self, theta, X) -> torch.Tensor:
        var, _ = self.params(theta)
        return gram_diag(self.kind, torch.atleast_2d(X), var)

    def kxx(self, theta, x) -> torch.Tensor:
        """Scalar k(x,x) for a single input point."""
        var, _ = self.params(theta)
        return var

    def kuu(self, theta, Xu, jitter: float = 0.0) -> torch.Tensor:
        K = self(theta, Xu, Xu)
        if jitter:
            K = K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        return K
