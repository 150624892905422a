"""Dense linear-algebra primitives (L0 layer).

Counterpart of ``gaussianprocessnode_tpu/ops/linalg.py``: jitter, Cholesky
factors and the solves and inverses built on them, the dtype-aware jitter,
the eigenvalue clamp of symmetric matrices, the block contractions of the
multi-output node (a (DM, DM) matrix as a D×D grid of M×M blocks), the
matmul-only Newton–Schulz SPD inverse (plain, and as an autograd Function
with the analytic VJP) and mixed-precision iterative refinement.
Every product is a plain ``torch.matmul``, as the JAX package leaves them
to XLA; ``config`` keeps TF32 off so float32 products are full precision.
Every guard is branchless (``torch.where`` on tensors), so the fixed-count
loops never wait on the host; only the ``tol`` early exit reads its
residual on the host.

The Cholesky factor of a matrix that is not positive definite is NaN, as
``jnp.linalg.cholesky`` returns it: ``torch.linalg.cholesky`` would raise,
which on the card is a host sync, and the L-BFGS linesearch relies on a NaN
objective at such points (``infer/training.py``).
"""

import torch

from ..config import JITTER_KUU

__all__ = ["jittered", "chol_lower", "chol_upper", "tri_solve_lower", "tri_solve_upper",
           "chol_solve", "solve_psd", "cholinv", "logdet_from_chol", "jdot",
           "rv_chol_upper", "effective_jitter", "sym", "block_trace_products",
           "sum_blocks_weighted", "sum_diagonal_blocks", "trace_blocks",
           "spd_clamp", "gershgorin_lambda_min", "spd_inverse_ns", "spd_inverse",
           "ir_solve"]


def jittered(A: torch.Tensor, jitter: float = JITTER_KUU) -> torch.Tensor:
    """A + jitter·I (reference: the ``Kuu + 1e-8*I`` pattern)."""
    return A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def chol_lower(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor, optionally with added jitter; NaN where A is
    not positive definite (``torch.linalg.cholesky_ex``, no error check, so
    no host sync)."""
    if jitter:
        A = jittered(A, jitter)
    L, info = torch.linalg.cholesky_ex(A)
    n = A.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=A.device).tril()
    bad = (info > 0)[..., None, None] & lower  # NaN on and below the diagonal, as jnp
    return L + torch.where(bad, float("nan"), 0.0).to(L.dtype)


def chol_upper(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Upper Cholesky factor (the reference's ``cholesky(Rv).U``)."""
    return chol_lower(A, jitter).mT


def _solve_triangular(T, B, upper):
    if B.dim() == T.dim() - 1:  # a vector right-hand side, as jnp accepts one
        return torch.linalg.solve_triangular(T, B.unsqueeze(-1), upper=upper).squeeze(-1)
    return torch.linalg.solve_triangular(T, B, upper=upper)


def tri_solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L lower triangular (reference: ``KuuL \\ B``); B
    is a matrix or a vector."""
    return _solve_triangular(L, B, upper=False)


def tri_solve_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B with U upper triangular; B is a matrix or a vector."""
    return _solve_triangular(U, B, upper=True)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B given the lower Cholesky factor L of A, as two
    triangular solves (reference: ``KuuL' \\ (KuuL \\ B)``)."""
    return tri_solve_upper(L.mT, tri_solve_lower(L, B))


def solve_psd(A: torch.Tensor, B: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve A X = B for symmetric positive-definite A through its Cholesky
    factor (NaN where A is not positive definite)."""
    return chol_solve(chol_lower(A, jitter), B)


def cholinv(A: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Inverse through the Cholesky factor (ReactiveMP ``cholinv``); A may
    carry batch dimensions."""
    L = chol_lower(A, jitter)
    return chol_solve(L, torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape))


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log det(A) from the lower Cholesky factor of A."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def jdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flat dot product (``jnp.vdot`` of real tensors; the reference's
    ``jdotavx``)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def rv_chol_upper(mu_v: torch.Tensor, Sigma_v: torch.Tensor) -> torch.Tensor:
    """Uv = chol(Σ_v + μ_v μ_vᵀ).U, the reference's amortized statistic
    (GPnode/UniSGPnode.jl:62-73)."""
    Rv = Sigma_v + torch.outer(mu_v, mu_v)
    return chol_upper(sym(Rv))


def effective_jitter(dtype, base: float = JITTER_KUU) -> float:
    """Dtype-aware jitter: max(base, 300·ε), so 3.58e-5 in float32, where
    the reference's 1e-8 is below the resolution and would leave Kuu of
    near-duplicate inducing inputs exactly singular."""
    return max(base, 300.0 * float(torch.finfo(dtype).eps))


def sym(A: torch.Tensor) -> torch.Tensor:
    """Symmetrize: (A + Aᵀ)/2."""
    return 0.5 * (A + A.mT)


def spd_clamp(S: torch.Tensor, floor) -> torch.Tensor:
    """Eigenvalue-clamp a (batched) symmetric matrix to λ ≥ ``floor`` (a
    number or a tensor that broadcasts over the batch dimensions): unlike a
    diagonal lift S + εI, it repairs an arbitrarily indefinite S.

    D = 2 takes the closed-form symmetric eigensystem (S = m·I + r·U with
    U² = I): clamp the two eigenvalues and rebuild, branchless, as the JAX
    package computes it. Other D use ``torch.linalg.eigh``."""
    D = S.shape[-1]
    floor = torch.as_tensor(floor, dtype=S.dtype, device=S.device)
    if D == 2:
        a = S[..., 0, 0]
        b = 0.5 * (S[..., 0, 1] + S[..., 1, 0])
        c = S[..., 1, 1]
        m = 0.5 * (a + c)
        d = 0.5 * (a - c)
        r = torch.sqrt(d * d + b * b)
        lo = torch.maximum(m - r, floor)
        hi = torch.maximum(m + r, floor)
        m_c, r_c = 0.5 * (hi + lo), 0.5 * (hi - lo)
        # U = [[d, b], [b, -d]]/r; at r = 0 the correction r_c·U vanishes too,
        # so the division is guarded and the isotropic part carries the clamp
        safe_r = torch.where(r > 0, r, torch.ones_like(r))
        scale = torch.where(r > 0, r_c / safe_r, torch.zeros_like(r))
        return torch.stack([
            torch.stack([m_c + scale * d, scale * b], -1),
            torch.stack([scale * b, m_c - scale * d], -1),
        ], -2)
    w, V = torch.linalg.eigh(sym(S))
    w = torch.maximum(w, floor.unsqueeze(-1) if floor.dim() else floor)
    return torch.einsum("...ij,...j,...kj->...ik", V, w, V)


def block_trace_products(Rv: torch.Tensor, S: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Ψ4[i,j] = ⟨Rv_block[i,j], Sᵀ⟩ for a (DM, DM) matrix seen as a D×D
    grid of M×M blocks (reference: ``sum(Rv_i .* Ψ2')``,
    MultiSGPnode.jl:397)."""
    return torch.einsum("imjn,mn->ij", Rv.reshape(D, M, D, M), S)


def sum_blocks_weighted(Rv: torch.Tensor, W: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Σ_{ij} W[i,j]·Rv_block[i,j], an (M, M) matrix (reference:
    ``sum(create_blockmatrix(Σ_v,D,M) .* W)``, MultiSGPnode.jl:180)."""
    return torch.einsum("imjn,ij->mn", Rv.reshape(D, M, D, M), W)


def sum_diagonal_blocks(V: torch.Tensor, M: int) -> torch.Tensor:
    """Σ_i V[block i of rows, column i], an (M,) vector (reference:
    sum_diagonal_M, derivative_helper.jl:119-122)."""
    D = V.shape[1]
    return torch.einsum("imi->m", V.reshape(D, M, D))


def trace_blocks(Rv: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """(D, D) matrix of block traces, out[i,j] = tr(Rv_block[i,j])
    (reference: trace_blkmatrix, derivative_helper.jl:125-127)."""
    return torch.einsum("imjm->ij", Rv.reshape(D, M, D, M))


def gershgorin_lambda_min(A: torch.Tensor) -> torch.Tensor:
    """Gershgorin lower bound on λ_min of a symmetric matrix:
    min_i (A_ii − Σ_{j≠i} |A_ij|)."""
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    off = torch.sum(torch.abs(A), dim=-1) - torch.abs(d)
    return torch.amin(d - off, dim=-1)


def spd_inverse_ns(
    A: torch.Tensor,
    warm: torch.Tensor | None = None,
    iters: int = 30,
    tol: float | None = None,
    lambda_min=None,
) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix by (optionally
    spectrum-scaled) Newton–Schulz iteration, X ← γX(2I − γAX).

    - Cold start X₀ = I/‖A‖∞.
    - ``lambda_min``: a lower bound on λ_min(A). In float64 and when it is
      positive, the iteration carries a spectrum enclosure [a, b] ⊇
      spec(AX) and uses γ = 2/(a+b) (the optimally scaled iteration);
      otherwise γ ≡ 1, the classic iteration. Float32 never scales: its
      rounding can push an eigenvalue past the divergence threshold 2.
    - ``warm``: a previous estimate of A⁻¹, taken only when
      r = ‖I − A·warm‖_F < 0.5 (with scaling, the enclosure starts at
      [1−r, 1+r]).
    - An iterate that is not finite restarts from the cold start.
    - ``tol``: stop once ‖I − A X‖_F < tol, with ``iters`` as the cap; a NaN
      residual keeps iterating.

    Returns sym(X).
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    norm_inf = torch.amax(torch.sum(torch.abs(A), dim=-1))
    one = torch.ones((), dtype=A.dtype, device=A.device)
    f64_ok = torch.finfo(A.dtype).eps < 1e-9
    if lambda_min is None or not f64_ok:
        scale_on = None
        a_cold = b_cold = one
    else:
        lm = torch.as_tensor(lambda_min, dtype=A.dtype, device=A.device)
        # vacuous bound (≤ 0) → enclosure (1, 1) → the unscaled iteration
        scale_on = lm > 0
        a_cold = torch.where(scale_on, lm / norm_inf, one)
        b_cold = one
    X0_cold = eye / norm_inf
    X0, a0, b0 = X0_cold, a_cold, b_cold
    if warm is not None:
        R = eye - torch.matmul(A, warm)
        r = torch.sqrt(torch.sum(R * R))
        ok = r < 0.5
        X0 = torch.where(ok, warm, X0)
        if scale_on is not None:
            # ‖I − A·warm‖_F ≥ spectral radius → spec(A·warm) ⊆ [1−r, 1+r]
            ok_s = torch.logical_and(ok, scale_on)
            a0 = torch.where(ok_s, one - r, a0)
            b0 = torch.where(ok_s, one + r, b0)

    def step(X, a, b):
        gamma = 2.0 / (a + b)
        R = eye - torch.matmul(A, X)
        rnorm = torch.sqrt(torch.sum(R * R))
        # γX(2I − γAX) = γ((2−γ)X + γ·XR); γ = 1 → the classic X + XR
        Xn = gamma * ((2.0 - gamma) * X + gamma * torch.matmul(X, R))
        an = 4.0 * a * b / (a + b) ** 2
        # rounding can kick an eigenvalue of AX past 2, after which the
        # iteration explodes: restart cold
        ok = torch.isfinite(torch.sum(Xn))
        return (torch.where(ok, Xn, X0_cold), rnorm,
                torch.where(ok, an, a_cold), torch.where(ok, one, b_cold))

    X, a, b = X0, a0, b0
    if tol is None:
        for _ in range(iters):
            X, _, a, b = step(X, a, b)
    else:
        k = 0
        rnorm = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
        # NOT(rnorm < tol) so a NaN residual keeps iterating
        while k < iters and not bool(rnorm < tol):
            X, rnorm, a, b = step(X, a, b)
            k += 1
    return sym(X)


class _SPDInverse(torch.autograd.Function):
    """``spd_inverse_ns`` forward; the inverse-function VJP on the primal
    output, Ā = −X·Ḡ·X (two matmuls, no differentiation through the
    iteration), and no gradient for the warm start or the λ_min bound."""

    @staticmethod
    def forward(ctx, A, warm, lam, iters, tol):
        X = spd_inverse_ns(A, warm, iters, tol=tol, lambda_min=lam)
        ctx.save_for_backward(X)
        return X

    @staticmethod
    def backward(ctx, G):
        (X,) = ctx.saved_tensors
        return -torch.matmul(torch.matmul(X, G), X), None, None, None, None


def spd_inverse(A: torch.Tensor, warm: torch.Tensor | None = None,
                iters: int = 30, tol: float | None = None,
                lambda_min=None) -> torch.Tensor:
    """Differentiable SPD inverse: Newton–Schulz forward (optimally scaled
    when a rigorous ``lambda_min`` bound is given), analytic VJP. As in the
    JAX package, ``warm=None`` becomes zeros, which the warm-start guard
    rejects, and ``lambda_min=None`` the −1 sentinel, which turns scaling
    off; both are made on A's device without a host copy."""
    if warm is None:
        warm = torch.zeros_like(A)
    if lambda_min is None:
        lambda_min = -1.0
    if isinstance(lambda_min, torch.Tensor):
        lam = lambda_min.to(A.dtype)
    else:
        lam = torch.full((), lambda_min, dtype=A.dtype, device=A.device)
    return _SPDInverse.apply(A, warm, lam, iters, tol)


def ir_solve(A64: torch.Tensor, b64: torch.Tensor, M32: torch.Tensor,
             rounds: int = 3) -> torch.Tensor:
    """Mixed-precision iterative refinement for A x = b.

    ``M32`` is an approximate inverse of A, possibly in a lower precision.
    Each round costs one mat-vec in b's precision, x ← x + M·(b − A x), and
    keeps the previous iterate when the candidate's residual does not
    shrink (a poor preconditioner makes the refinement diverge)."""
    x = torch.matmul(M32, b64.to(M32.dtype)).to(b64.dtype)

    def resid(x):
        return b64 - torch.matmul(A64, x)

    r = resid(x)
    rnorm = torch.sum(r * r)
    for _ in range(rounds):
        dx = torch.matmul(M32, r.to(M32.dtype))
        x_new = x + dx.to(b64.dtype)
        r_new = resid(x_new)
        rn_new = torch.sum(r_new * r_new)
        ok = rn_new < rnorm
        x = torch.where(ok, x_new, x)
        r = torch.where(ok, r_new, r)
        rnorm = torch.minimum(rn_new, rnorm)
    return x
