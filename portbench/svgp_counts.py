"""Operations and bytes of an SVGP serving call (``serve.SVGPRegressor``),
counted from shapes by ``counts.py``'s conventions: a multiply-add is 2
FLOPs; a triangular solve with B right-hand sides is M²B, a triangular
product with B columns M²B; each input byte is read once and each output
byte written once, whatever a kernel reads again or keeps between stages."""

from .counts import F32


def var_flops(M: int, B: int) -> int:
    """The predictive variance of B rows from their Gram: the solve
    Y = Lu⁻¹K (M²B), the product Ãᵀ·Y (M²B), the two sums of squares
    (2MB each) and k(x, x) − ‖y‖² + ‖Ãᵀy‖² (2B)."""
    return 2 * M * M * B + 4 * M * B + 2 * B


def var_bytes(M: int, B: int, itemsize: int = F32) -> int:
    """The Gram (M, B), Lu and Ã (M, M each) read once; the B variances
    written once."""
    return itemsize * (M * B + 2 * M * M + B)


def var_least_seconds(M: int, B: int, peaks: dict) -> float:
    """The least time of the variance stage: the larger of its FLOPs at the
    float32 peak and its bytes at the HBM peak."""
    return max(var_flops(M, B) / peaks["fp32_flop_per_s"],
               var_bytes(M, B) / peaks["hbm_bytes_per_s"])


def flops_per_prediction(M: int, D: int) -> float:
    """One prediction of a call: its column of the Gram (as
    ``counts.serve_flops_per_prediction`` counts it: M(2D + 5) and its
    row's norm 2D; Xu's norms, shared by the batch, left out), its variance
    (``var_flops`` per row) and its mean yᵀm̃ (2M)."""
    return M * (2 * D + 5) + 2 * D + var_flops(M, 1) + 2 * M
