"""The whitened SVGP's predictive mean and variance from its Gram, as one
hand-written CUDA kernel.

From the Gram K = K(Xu, X) (M, B), the lower Cholesky factor Lu of Kuu, the
lower-triangular q(u) factor Ã, the whitened mean m̃ and k(x, x), column by
column:

    Y = Lu⁻¹K,   mean = Yᵀm̃,   var = max(k(x, x) − ‖y‖² + ‖Ãᵀy‖², 1e-12)

- ``svgp_var_cuda``: launches ``ops/csrc/svgp_var.cu`` (through
  ``ops/_build.py``) for CUDA tensors: the kernel or an error, never a
  fallback;
- ``svgp_var_reference``: the plain version: a triangular solve, the mean as
  a mat-vec, a product with Ãᵀ and the sums of squares, each a PyTorch
  call and differentiable; the CPU path, and the yardstick of correctness
  on the card;
- ``svgp_var_route``: where ``infer/svgp.py::svgp_predict_batch`` sends a
  call, decided before it from what the call can observe.

The JAX package has no kernel here (its ``infer/svgp.py`` leaves the solve
and the product to XLA); ``svgp_var.cu`` says what bounds the kernel and
what its design does about that.
"""

from ctypes import c_int, c_void_p

import torch

from ..utils import tracing
from . import _build
from .linalg import tri_solve_lower

__all__ = ["SVGP_VAR_MAX_M", "svgp_var_cuda", "svgp_var_reference", "svgp_var_route"]

# the most inducing inputs the kernel takes (svgp_var.cu: kMaxM)
SVGP_VAR_MAX_M = 1024


def svgp_var_reference(Kux, Lu, A, m_white, kxx):
    """(mean, var) in plain PyTorch, in the inputs' dtype: Y = Lu⁻¹K by a
    triangular solve (span ``svgp.solve``), mean = Yᵀm̃, and
    var = k(x, x) − ‖y‖² + ‖Ãᵀy‖² per column (span ``svgp.var``), floored at
    1e-12 by ``torch.maximum``, which splits the gradient at a tie as
    ``jnp.maximum`` does; the floor is made on the device."""
    with tracing.span("svgp.solve"):
        Akx = tri_solve_lower(Lu, Kux)  # Lu⁻¹ Kux
    mean = Akx.T @ m_white
    with tracing.span("svgp.var"):
        SAk = A.T @ Akx
        var = kxx - torch.sum(Akx * Akx, dim=0) + torch.sum(SAk * SAk, dim=0)
        return mean, torch.maximum(var, var.new_full((), 1e-12))


def svgp_var_route(Kux, Lu, A, m_white, kxx) -> str:
    """Where a call with these operands goes: ``"kernel"`` where every one
    is a float32 tensor on a CUDA card, gradients are off (a serving
    handle's call, which ``serve._served`` makes under ``no_grad``) and
    M ≤ ``SVGP_VAR_MAX_M``; ``"plain"`` (:func:`svgp_var_reference`) for
    anything else: CPU tensors, float64 (or any operand in another dtype),
    a call with gradients on (the trainers' ELBO) and a larger M. Reads
    only the operands' metadata."""
    ops = (Kux, Lu, A, m_white, kxx)
    if (not torch.is_grad_enabled() and Kux.dim() == 2 and Kux.shape[0] <= SVGP_VAR_MAX_M
            and all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                    and t.dtype == torch.float32 for t in ops)):
        return "kernel"
    return "plain"


def _column_major(t) -> bool:
    """A square matrix laid out column by column (``torch.linalg.cholesky``'s
    factor on a CUDA card is), and not also row by row."""
    return not t.is_contiguous() and t.mT.is_contiguous()


def _laid_out(t, column_major: bool):
    """``(t, ld)``: the (M, M) matrix t as the kernel reads it, column-major
    (Lu) or row-major (Ã), ld floats from one column (row) to the next, ld
    a multiple of 4 and the data 16-byte aligned, as its tensor maps need.
    t itself where it already lies so (Lu from ``torch.linalg.cholesky`` on
    the card and Ã as ``_A_tril`` forms it, at M % 4 = 0); else a copy with
    ld = M rounded up to a multiple of 4 (the other layout, a ragged M)."""
    M = t.shape[0]
    rows = t.mT if column_major else t  # its rows lie along memory in the kernel's layout
    if (rows.stride(1) == 1 and rows.stride(0) % 4 == 0 and rows.stride(0) >= M
            and t.data_ptr() % 16 == 0):
        return t, rows.stride(0)
    ld = -(-M // 4) * 4
    buf = t.new_empty((M, ld))[:, :M]
    buf.copy_(rows)
    return (buf.mT if column_major else buf), ld


def _check(Kux, Lu, A, m_white, kxx):
    """Raise unless the inputs are what the kernel takes: float32 on one
    device, Kux (M, B), m̃ (M,) and k(x, x) (B,) contiguous, Lu and Ã (M, M)
    each row- or column-major, 1 ≤ M ≤ ``SVGP_VAR_MAX_M``."""
    dev = Kux.device
    for name, t in (("Kux", Kux), ("Lu", Lu), ("A", A), ("m_white", m_white), ("kxx", kxx)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"svgp_var_cuda: {name} must be a tensor on {dev}")
        if t.device != dev:
            raise ValueError(f"svgp_var_cuda: {name} is on {t.device}, Kux on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"svgp_var_cuda: {name} is {t.dtype}; the kernel takes float32")
        if not (t.is_contiguous() or (name in ("Lu", "A") and _column_major(t))):
            raise ValueError(f"svgp_var_cuda: {name} must be contiguous"
                             + (" (row- or column-major)" if name in ("Lu", "A") else ""))
    if Kux.dim() != 2:
        raise ValueError(f"svgp_var_cuda: Kux {tuple(Kux.shape)} must be (M, B)")
    M, B = Kux.shape
    want = {"Lu": (M, M), "A": (M, M), "m_white": (M,), "kxx": (B,)}
    for name, t in (("Lu", Lu), ("A", A), ("m_white", m_white), ("kxx", kxx)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"svgp_var_cuda: {name} {tuple(t.shape)} for Kux {(M, B)}: "
                             f"want {want[name]}")
    if not 1 <= M <= SVGP_VAR_MAX_M:
        raise ValueError(f"svgp_var_cuda: M={M} outside 1..{SVGP_VAR_MAX_M}")


def svgp_var_cuda(Kux, Lu, A, m_white, kxx):
    """(mean, var), each (B,), of CUDA tensors: one launch of the kernel on
    the current stream, float32, reading Kux as the Gram kernel writes it
    ((M, B), row-major) and the lower triangles of Lu and Ã, Lu column-major
    and Ã row-major (:func:`_laid_out`: no copy for the handle's factors
    at M % 4 = 0); nothing but the two outputs is written, and no host
    sync; any other device raises. Counts its launches in
    ``svgp_var_cuda.launches`` (``ops/_build.py``)."""
    if Kux.device.type != "cuda":
        raise ValueError(f"svgp_var_cuda: no kernel for device {Kux.device}")
    _check(Kux, Lu, A, m_white, kxx)
    M, B = Kux.shape
    mean = torch.empty(B, dtype=torch.float32, device=Kux.device)
    var = torch.empty(B, dtype=torch.float32, device=Kux.device)
    if B == 0:
        return mean, var
    (Lu, ld_l), (A, ld_a) = _laid_out(Lu, True), _laid_out(A, False)
    _launch(Kux.device, Kux.data_ptr(), Lu.data_ptr(), A.data_ptr(), m_white.data_ptr(),
            kxx.data_ptr(), mean.data_ptr(), var.data_ptr(), M, B, ld_l, ld_a)
    return mean, var


_launch = _build.EntryPoint("svgp_var", [c_void_p] * 7 + [c_int] * 4, svgp_var_cuda,
                            ("max_m", SVGP_VAR_MAX_M))
