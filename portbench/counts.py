"""Operations and bytes of the work the cells do, counted from shapes.

Conventions: a multiply-add is 2 FLOPs; an exp, erfc or square root is 1;
each input byte is read once and each output byte written once, whatever a
kernel reads again. Products are counted at what the algorithm needs
(a symmetric product AAᵀ at its M²N, a triangular solve with N right-hand
sides at M²N, a Cholesky factor at M³/3), not at what a library call may do.
"""

F32 = 4


def se_gram_flops(M: int, N: int, D: int) -> int:
    """K(Z, X) for Z (M, D), X (N, D): the scaled squared norms of the rows
    (2D per row), and per entry the cross term (2D), the two norms added (2),
    −½ (1), exp (1) and σ² (1)."""
    return M * N * (2 * D + 5) + 2 * D * (M + N)


def se_gram_bytes(M: int, N: int, D: int, itemsize: int = F32) -> int:
    """Z, X, ℓ (D) and σ² read once; the (M, N) Gram written once."""
    return itemsize * (M * D + N * D + D + 1 + M * N)


def gram_least_seconds(M: int, N: int, D: int, peaks: dict) -> float:
    """The least time for one Gram: the larger of its FLOPs at the float32
    peak and its bytes at the HBM peak."""
    return max(se_gram_flops(M, N, D) / peaks["fp32_flop_per_s"],
               se_gram_bytes(M, N, D) / peaks["hbm_bytes_per_s"])


PHI_FLOPS = 6  # m/√(1+v): add, sqrt, divide; ½·erfc(−z/√2): 2 multiplies, erfc


def serve_flops_per_prediction(M: int, D: int, classifier: bool) -> float:
    """One prediction of a handle call: its column of the Gram, its entry
    of Kᵀμ_v (2M), the variance fill (a store, 0 FLOPs) and, for a
    classifier, the Φ epilogue. The Gram's per-row norms of Xu are shared
    by the batch and left out."""
    return M * (2 * D + 5) + 2 * D + 2 * M + (PHI_FLOPS if classifier else 0)


def collapsed_step_flops(M: int, N: int, D: int) -> float:
    """One AdaMax step on the collapsed bound, forward and backward.

    Forward: the Grams Kuu (M, M) and Kux (M, N); chol(Kuu) M³/3;
    A = L⁻¹Kux M²N; AAᵀ M²N; chol(B) M³/3; Ay 2MN; c = L_B⁻¹(Ay) M²;
    Σ A² 2MN.
    Backward, by the standard adjoints: c's solve 2M²; Ay 2MN; chol(B)
    7M³/3 (the product LᵀL̄ M³/3 and two triangular solves with M
    right-hand sides, 2M³); AAᵀ 2M²N ((Ḡ + Ḡᵀ)A); Σ A² 2MN; A = L⁻¹Kux:
    M²N for K̄ = L⁻ᵀĀ and M²N for the lower triangle of L̄ = −K̄Aᵀ;
    chol(Kuu) 7M³/3; each Gram's VJP for σ² and ℓ, per entry Ḡ⊙K, its row
    and column sums and ⟨W⟩ (4), and W·X (2D per entry).
    The AdaMax update, O(D), is left out."""
    fwd = (se_gram_flops(M, M, D) + se_gram_flops(M, N, D) + 2 * M ** 3 / 3
           + 2 * M * M * N + 4 * M * N + M * M)
    bwd = (2 * M * M + 4 * M * N + 14 * M ** 3 / 3 + 4 * M * M * N
           + (4 + 2 * D) * (M * M + M * N))
    return fwd + bwd
