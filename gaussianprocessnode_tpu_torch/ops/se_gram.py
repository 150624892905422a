"""The squared-exponential Gram as a hand-written CUDA kernel.

Counterpart of ``gaussianprocessnode_tpu/ops/pallas_gram.py``: its Pallas
kernel ``_gram_kernel`` and the wrappers ``se_gram_pallas`` /
``se_gram_auto`` / ``se_gram_fused`` become

- ``se_gram_cuda``: launches ``ops/csrc/se_gram.cu`` for CUDA tensors (the
  kernel or an error, never a fallback), and takes the plain version for
  CPU tensors;
- ``se_gram_reference``: the plain PyTorch version, the same expanded-form
  arithmetic; the CPU path, and the yardstick of correctness on the card;
- ``se_gram_auto``: the kernel when Z and X are both float32 on the card
  (σ² and ℓ cast to float32, Z and X made contiguous), the plain
  ``ops.kernels.se_gram`` for CPU tensors and any other dtype pair, chosen
  before the call (``se_gram_route``), as ``pallas_gram.se_gram_auto``
  keeps every other dtype off its Pallas kernel;
- ``se_gram_fused``: a ``torch.autograd.Function`` with ``se_gram_auto`` as
  forward and the analytic matmul-only VJP of ``_se_gram_bwd``.

At the serving shape 600 × 30000 the kernel writes 72 MB and does 8 FMAs
and an exp per output; ``se_gram.cu`` says what bounds it and what its
design does about that.
"""

import contextlib
import ctypes

import torch

from ..utils import tracing
from . import kernels as _k

__all__ = ["SE_GRAM_MAX_D", "se_gram_cuda", "se_gram_reference", "se_gram_route",
           "se_gram_auto", "se_gram_fused"]

# widest input the kernel takes (se_gram.cu: kMaxD); the chip check holds the
# kernel against its plain version at this width
SE_GRAM_MAX_D = 256

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from ._build import load_library

        lib = load_library()
        f = lib.se_gram_f32
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.se_gram_error_string.argtypes = [ctypes.c_int]
        lib.se_gram_error_string.restype = ctypes.c_char_p
        lib.se_gram_max_d.argtypes = []
        lib.se_gram_max_d.restype = ctypes.c_int
        if lib.se_gram_max_d() != SE_GRAM_MAX_D:
            raise RuntimeError("se_gram.cu kMaxD and SE_GRAM_MAX_D disagree")
        _fn = (f, lib.se_gram_error_string)
    return _fn


def se_gram_reference(Z, X, variance, lengthscales):
    """σ²·exp(−½·max(‖z/ℓ‖² + ‖x/ℓ‖² − 2 (z/ℓ)·(x/ℓ), 0)) in plain PyTorch,
    in the inputs' dtype. Z (M, D), X (N, D) → (M, N)."""
    return _k.se_gram(Z, X, variance, lengthscales)


def _check_cuda(Z, X, variance, lengthscales):
    dev = Z.device
    for name, t in (("Z", Z), ("X", X), ("variance", variance),
                    ("lengthscales", lengthscales)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"se_gram_cuda: {name} must be a tensor on {dev}")
        if t.device != dev:
            raise ValueError(f"se_gram_cuda: {name} is on {t.device}, Z on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"se_gram_cuda: {name} is {t.dtype}; the kernel "
                            "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"se_gram_cuda: {name} must be contiguous")
    if Z.dim() != 2 or X.dim() != 2 or Z.shape[1] != X.shape[1]:
        raise ValueError(f"se_gram_cuda: Z {tuple(Z.shape)} and X "
                         f"{tuple(X.shape)} must be (M, D) and (N, D)")
    D = Z.shape[1]
    if not 1 <= D <= SE_GRAM_MAX_D:
        raise ValueError(f"se_gram_cuda: D={D} outside 1..{SE_GRAM_MAX_D}")
    if variance.numel() != 1:
        raise ValueError("se_gram_cuda: variance must hold one value")
    if lengthscales.numel() not in (1, D):
        raise ValueError(f"se_gram_cuda: {lengthscales.numel()} lengthscales "
                         f"for D={D}")


def se_gram_cuda(Z, X, variance, lengthscales):
    """SE Gram K(Z, X), (M, N). On CUDA tensors: one launch of the kernel on
    the current stream, float32, ℓ and σ² read from device memory (no host
    sync). On CPU tensors: ``se_gram_reference``. Counts its launches in
    ``se_gram_cuda.launches``."""
    if Z.device.type == "cpu":
        return se_gram_reference(Z, X, variance, lengthscales)
    if Z.device.type != "cuda":
        raise ValueError(f"se_gram_cuda: no kernel for device {Z.device}")
    _check_cuda(Z, X, variance, lengthscales)
    fn, err_str = _kernel_fn()
    M, N = Z.shape[0], X.shape[0]
    K = torch.empty((M, N), dtype=torch.float32, device=Z.device)
    if M == 0 or N == 0:
        return K
    # the library launches on the calling thread's current device: make it
    # Z's (entering the context only when needed keeps the per-launch host
    # cost down)
    with tracing.span("se_gram.launch"):
        on_current = Z.device.index == torch.cuda.current_device()
        with contextlib.nullcontext() if on_current else torch.cuda.device(Z.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(Z.data_ptr(), X.data_ptr(), lengthscales.data_ptr(),
                    lengthscales.numel(), variance.data_ptr(), K.data_ptr(),
                    M, N, Z.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"se_gram_cuda: launch failed ({rc}): "
                           f"{err_str(rc).decode()}")
    se_gram_cuda.launches += 1
    return K


se_gram_cuda.launches = 0


def se_gram_route(device, z_dtype, x_dtype=None) -> str:
    """Where ``se_gram_auto`` sends a Gram of Z and X of these dtypes on
    ``device``: ``"kernel"`` (the CUDA kernel) when both are float32 on a
    CUDA card, as ``pallas_gram.se_gram_auto`` checks both; ``"plain"``
    (``ops.kernels.se_gram``) for CPU tensors and for any other dtype pair.
    ``x_dtype`` defaults to ``z_dtype``. A float32 Gram on another device
    has no route and raises."""
    device = torch.device(device)
    x_dtype = z_dtype if x_dtype is None else x_dtype
    if z_dtype != torch.float32 or x_dtype != torch.float32:
        return "plain"
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"se_gram_route: no kernel for device {device}")


def se_gram_auto(Z, X, variance, lengthscales):
    """SE Gram K(Z, X) by ``se_gram_route``, decided before the call.
    Float32 Z and X on a CUDA card go to the kernel (``se_gram_cuda``)
    with σ² and ℓ cast to float32 and Z and X made contiguous, so the
    result differs from the JAX kernel path, which rounds Z/ℓ and X/ℓ to
    float32, by at most one float32 rounding of ℓ. Anything else takes the
    plain ``ops.kernels.se_gram`` in its own promoted dtype."""
    if se_gram_route(Z.device, Z.dtype, X.dtype) == "kernel":
        f32 = torch.float32
        return se_gram_cuda(Z.contiguous(), X.contiguous(),
                            variance.to(f32),
                            lengthscales.to(f32).contiguous())
    return _k.se_gram(Z, X, variance, lengthscales)


class _SEGramFused(torch.autograd.Function):
    """Kernel forward, analytic VJP. For K = σ²·exp(−½ Σ_k (z_k−x_k)²/ℓ_k²)
    and W = Ḡ ⊙ K (r, c its row and column sums):

        σ̄²   = ⟨Ḡ, K⟩/σ²
        ℓ̄_k  = (1/ℓ_k³)·[⟨r, z_k²⟩ + ⟨c, x_k²⟩ − 2 z_kᵀ W x_k]
        Z̄_mk = −(z_mk r_m − (W X)_mk)/ℓ_k²,   X̄ symmetric

    (``pallas_gram.py::_se_gram_bwd``), as torch.matmul GEMMs. Each
    cotangent comes back in its own input's dtype; Z̄ and X̄ are computed
    only when Z or X needs a gradient (the θ-steps differentiate σ² and ℓ
    alone). The backward is differentiable again: K is saved as this
    Function's output, so under ``create_graph`` it unpacks with its
    grad_fn and a second derivative (a Hessian by reverse over reverse)
    holds K's dependence on the inputs."""

    @staticmethod
    def forward(ctx, Z, X, variance, lengthscales):
        K = se_gram_auto(Z, X, variance, lengthscales)
        ctx.save_for_backward(Z, X, variance, lengthscales, K)
        return K

    @staticmethod
    def backward(ctx, G):
        Z, X, variance, lengthscales, K = ctx.saved_tensors
        need_z, need_x = ctx.needs_input_grad[:2]
        ls = lengthscales.to(Z.dtype).reshape(-1).expand(Z.shape[1])
        W = G * K
        # products in the promoted dtype, as jnp.matmul promotes its operands
        dt = torch.promote_types(W.dtype, Z.dtype)
        W = W.to(dt)
        r = torch.sum(W, dim=1)
        c = torch.sum(W, dim=0)
        var_bar = torch.sum(W) / variance
        WX = torch.matmul(W, X.to(dt))
        cross = torch.sum(Z * WX, dim=0)
        ls_bar = (r @ (Z * Z).to(dt) + c @ (X * X).to(dt) - 2.0 * cross) / ls**3
        Z_bar = X_bar = None
        if need_z:
            Z_bar = (-(Z * r[:, None] - WX) / ls**2).to(Z.dtype)
        if need_x:
            WtZ = torch.matmul(W.T, Z.to(dt))
            X_bar = (-(X * c[:, None] - WtZ) / ls**2).to(X.dtype)
        if ls_bar.shape != lengthscales.shape:
            ls_bar = torch.sum(ls_bar).reshape(lengthscales.shape)
        return (Z_bar, X_bar, var_bar.reshape(variance.shape).to(variance.dtype),
                ls_bar.to(lengthscales.dtype))


@tracing.traced("se_gram.dispatch")
def se_gram_fused(Z, X, variance, lengthscales):
    """Differentiable SE Gram: ``se_gram_auto`` forward, analytic matmul-only
    VJP. Drop-in for ``ops.kernels.se_gram`` (argument order (Z, X, σ², ℓ))."""
    return _SEGramFused.apply(Z, X, variance, lengthscales)
