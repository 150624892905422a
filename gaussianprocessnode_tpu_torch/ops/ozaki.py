"""f64-accurate GEMM from error-free int8 products (the Ozaki scheme).

Counterpart of ``gaussianprocessnode_tpu/ops/ozaki.py``, with the same
arithmetic, bit for bit on the CPU. The scheme (Ozaki et al. 2012; its int8
variant after ozIMMU, Ootomo et al. 2024) rebuilds an f64 product from
int8×int8→int32 products, which on the H100 run on the integer tensor
cores (``torch._int_mm``, cuBLASLt's IMMA path, exact in int32):

    A = diag(2^eA) · Σ_t At · 2^-7(t+1)   (row-wise power-of-2 scaling,
                                            At int8-valued, |At| ≤ 64)
    A@B = diag(2^eA) · [ Σ_{t+u=s} At@Bu · 2^-7(s+2) ] · diag(2^eB)

The products are grouped by s = t+u into ``n_slices`` K-concatenated int8
GEMMs, [A0 | … | As] @ [Bs ; … ; B0], of inner length (s+1)·k: 36 unit
passes at 8 slices. Each group's sum is exact in int32 while
|sum| ≤ 64·64·n_slices·k < 2³¹, i.e. n_slices·k < 2¹⁹ (k < 65,536 at 8
slices); ``ozaki_matmul`` raises above that. At 8 slices (56 ≥ 53 mantissa
bits) the split is exact and the only error is the dropped tail s ≥ 8,
~2^-60 relative: more accurate than a rounding f64 accumulation.

No trainer calls it, as in the JAX package: on the H100, which has f64
tensor cores, it is an open measurement (``chip_smoke.py`` phase 16 holds
it against cuBLAS's f64 product at the trainers' shapes).
"""

import torch

__all__ = ["ozaki_matmul", "OZAKI_SLICES"]

# 8 slices × 7 bits = 56 ≥ 53 mantissa bits: the split captures the f64
# mantissa exactly; dropped cross terms are ≤ 2^-63 relative.
OZAKI_SLICES = 8
_BITS = 7
# exact powers of two 2^-1022 .. 2^1022 (python floats, so bit-exact)
_EMAX = 1022
_POW2 = [2.0 ** i for i in range(-_EMAX, _EMAX + 1)]
_POW2_TABLES: dict = {}
# int32 headroom: each group sums n_slices·k products of |q| ≤ 64
_MAX_INNER = 1 << 19
# torch._int_mm's shape rules on CUDA: more than 16 rows of A, and k and n
# multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _pow2_table(device) -> torch.Tensor:
    """The table of exact powers of two on ``device``, built once per device
    (a copy to the card inside a CUDA graph capture is not allowed)."""
    key = str(torch.device(device))
    if key not in _POW2_TABLES:
        _POW2_TABLES[key] = torch.tensor(_POW2, dtype=torch.float64, device=device)
    return _POW2_TABLES[key]


def _split_int8(X, n_slices, axis):
    """Row- (axis=1) or column- (axis=0) scale X to [1/4, 1/2) and peel
    n_slices 7-bit mantissa chunks. Returns (chunks int8 (n_slices, m, k),
    scale halves (s1, s2) with s1·s2 = 2^e, each (m, 1) or (1, k) f64)."""
    absmax = torch.amax(torch.abs(X), dim=axis, keepdim=True)
    # floor(log2)+2 puts |X̂| in [1/4, 1/2), so every peeled chunk satisfies
    # |q| ≤ 64 and fits int8
    e = torch.where(absmax > 0.0, torch.floor(torch.log2(absmax)) + 2.0,
                    torch.zeros_like(absmax))
    # exact 2^e from a table of python floats, applied in two power-of-2
    # halves so e up to 1025 (absmax near the f64 maximum, where 2^e itself
    # overflows) still divides exactly
    e1 = torch.floor(e / 2.0)
    table = _pow2_table(X.device)
    s1 = torch.take(table, e1.to(torch.int64) + _EMAX)
    s2 = torch.take(table, (e - e1).to(torch.int64) + _EMAX)
    # |r| < 1/2, exact (power-of-2 divisors); the two divisions stay two:
    # 1/(s1·s2) over- or underflows in the extreme-exponent cases
    r = (X / s1) / s2
    chunks = []
    for _ in range(n_slices):
        r = r * (2.0 ** _BITS)
        q = torch.round(r)  # half to even, as jnp.round; |q| ≤ 64
        chunks.append(q.to(torch.int8))
        r = r - q  # |r| ≤ 1/2, exact
    return torch.stack(chunks), (s1, s2)


def _padded(A, B):
    """A and B padded by zero rows and columns to the shapes ``torch._int_mm``
    takes on CUDA: more than 16 rows of A, k and n multiples of 8. A zero row
    of A or column of B scales by 1 and splits into zero chunks, and zero
    columns of A and rows of B change no row's or column's maximum, so the
    product's first m rows and n columns keep their bits."""
    m, k = A.shape
    n = B.shape[1]
    mul = _INT_MM_MULTIPLE
    mp, kp, np_ = max(m, _INT_MM_MIN_ROWS), -(-k // mul) * mul, -(-n // mul) * mul
    if (mp, kp, np_) == (m, k, n):
        return A, B
    Ap = torch.zeros((mp, kp), dtype=A.dtype, device=A.device)
    Ap[:m, :k] = A
    Bp = torch.zeros((kp, np_), dtype=B.dtype, device=B.device)
    Bp[:k, :n] = B
    return Ap, Bp


def _operands(A, B, S):
    """Split A by rows and B by columns into S chunks each; return the two
    concatenations [A0 | … | A(S-1)] (m, S·k) and [B(S-1) | … | B0]ᵀ
    (n, S·k), int8, and the scale halves (sA1, sA2, sB1, sB2)."""
    Ac, (sA1, sA2) = _split_int8(A, S, axis=1)  # (S, m, k), 2×(m, 1)
    # B's columns split as the rows of Bᵀ (the same arithmetic, element by
    # element), so that each group's right operand is column-major,
    # cuBLASLt's native int8 layout
    BcT, (sB1, sB2) = _split_int8(B.T, S, axis=1)  # (S, n, k), 2×(n, 1)
    k = A.shape[1]
    Aall = Ac.permute(1, 0, 2).reshape(A.shape[0], S * k)
    BallT = BcT.flip(0).permute(1, 0, 2).reshape(B.shape[1], S * k)
    return Aall, BallT, (sA1, sA2, sB1.T, sB2.T)


def _group(Aall, BallT, k, S, s):
    """The int8 operands of diagonal group s, views with leading dimension
    S·k: Σ_{t+u=s} At@Bu = [A0 | … | As] @ [Bs ; … ; B0]."""
    return Aall[:, : (s + 1) * k], BallT[:, (S - 1 - s) * k:].T


def ozaki_matmul(A, B, n_slices: int = OZAKI_SLICES) -> torch.Tensor:
    """A @ B for f64 A (m, k), B (k, n) from error-free int8 products.

    n_slices=8 reproduces f64 to ≤ ~2^-60 relative of the exact product
    (better than a rounding f64 accumulation); 6 slices ≈ 2^-49 relative
    at 21/36 the integer work. Raises TypeError for other dtypes, and
    ValueError when n_slices·k ≥ 2^19 (k after padding), where a group's
    int32 sum could overflow. Each group's product is one ``torch._int_mm``:
    on CUDA cuBLASLt's int8 tensor-core GEMM, with the operands zero-padded
    to the shapes it takes (:func:`_padded`, on every device, so the CPU runs
    the same arithmetic). There is no f64 fallback."""
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError("ozaki_matmul is the f64 path; cast inputs to f64")
    m, n = A.shape[0], B.shape[1]
    A, B = _padded(A, B)
    k = A.shape[1]
    if n_slices * k >= _MAX_INNER:
        raise ValueError(f"ozaki_matmul: n_slices·k = {n_slices * k} ≥ 2^19 would "
                         "overflow the int32 group sums")
    Aall, BallT, (sA1, sA2, sB1, sB2) = _operands(A, B, n_slices)
    out = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float64, device=A.device)
    for s in range(n_slices):
        P = torch._int_mm(*_group(Aall, BallT, k, n_slices, s))
        out = out + P.to(torch.float64) * (2.0 ** (-_BITS * (s + 2)))
    # scale halves applied interleaved, left to right, so intermediates track
    # ~sqrt of the total rescaling (a single sA·sB product could overflow)
    return (out * sA1 * sB1 * sA2 * sB2)[:m, :n]
