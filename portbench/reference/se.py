"""The squared-exponential Gram in plain PyTorch, and TF32 rounding.

``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the control:
float32 storage, every matrix product's operands rounded to TF32's 10-bit
mantissa and accumulated in float32, as the card's tensor cores do when
``torch.backends.cuda.matmul.allow_tf32`` is on). The rounding is written
out, so the control reads the same on the card and on a CPU.
"""

import torch

# torch.backends.cuda.matmul.allow_tf32 is False for the reference's own
# float32 products; the control's TF32 is the explicit rounding below
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPES = {"float64": torch.float64, "tf32": torch.float32}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (1 sign, 8 exponent, 10 mantissa
    bits; ties away from zero), kept in float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's two
    products rounded the same way."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).mT, round_tf32(a).mT @ g


def mm(a, b, precision: str = "float64"):
    """Matrix product (a vector operand allowed on the right) at ``precision``."""
    if precision != "tf32":
        return a @ b
    if b.dim() == 1:
        return _TF32MatMul.apply(a, b[:, None])[:, 0]
    return _TF32MatMul.apply(a, b)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def se_gram(Z, X, variance, lengthscales, precision: str = "float64"):
    """σ²·exp(−½‖(z − x)/ℓ‖²) for Z (M, D), X (N, D) → (M, N), the squared
    distance in the expanded form with the cross term as one product."""
    a, b = Z / lengthscales, X / lengthscales
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * mm(a, b.T, precision)
    return variance * torch.exp(-0.5 * torch.clamp_min(d2, 0.0))
