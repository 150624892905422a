"""Tensor-parallel (inducing-dimension) sparse-GP inference over ranks.

Counterpart of ``gaussianprocessnode_tpu/parallel/tensor_parallel.py``:
the model dimension M (the inducing set) is sharded. Every M-dimensional
object lives row-sharded over the group: each rank holds ``Xu`` as its
(M/P, D) block (:func:`shard_inducing`), ξ as (M/P,) and Λ, Σ, Kuu as
(M/P, M) row blocks. No rank materialises an unsharded matrix except the
one (M, M) gather of the final symmetrisation: a matrix product runs as a
ring over the right operand's row blocks (each step one local tile product
and one ``ring_shift``), so memory per rank stays O(M²/P) in the solve and
O(M·N/P) in the Gram stage. Collectives:

    ring_shift       the right operand's row blocks around the ring
    all_gather_rows  vectors in the iterative refinement, and one (m, M)
                     gather per solve for the symmetrisation
    all_reduce_max   ‖A‖∞
    all_reduce_sum   the divergence guard's Σ X, the prediction's
                     M-contraction, and in the 2-D layout the dp sums

The ring keeps JAX's block order j = (rank − s) mod P, so each output
element sums its P partial products in JAX's order. Products run in the
accumulation dtype (:func:`_acc_dtype`: float64 unless
``config.default_dtype()`` is float32), with TF32 off as ``config`` pins
it. The functions return this rank's rows; ``comm.all_gather_rows``
assembles a whole vector or matrix where a caller needs one.
"""

import functools

import torch

from .. import config
from .comm import (all_gather_rows, all_reduce_max, all_reduce_sum, rank, rank_slice, ring_shift,
                   world_size)

__all__ = ["shard_inducing", "tp_regression_sweep", "dp_tp_regression_sweep", "tp_predict"]


def shard_inducing(*arrays, group=None):
    """This rank's block of rows of each array's leading (inducing, M)
    dimension, which must divide evenly over the group's ranks (the
    row-block identity below assumes equal blocks). One array gives one
    tensor, several a tuple."""
    out = tuple(rank_slice(a, 0, group, "leading dim {size} does not shard evenly over {n} "
                                        "ranks") for a in arrays)
    return out[0] if len(out) == 1 else out


def _acc_dtype(*dtypes):
    """The trainers' accumulation-dtype policy: promote to float64 unless
    ``config.default_dtype()`` is float32 (an f32 Newton–Schulz chain at
    sparse-GP conditioning stalls at κ·ε₃₂)."""
    dt = functools.reduce(torch.promote_types, dtypes)
    if config.default_dtype() == torch.float64:
        dt = torch.promote_types(dt, torch.float64)
    return dt


def _w_dtype(w_val, dt):
    return w_val.dtype if isinstance(w_val, torch.Tensor) else dt


def _eye_rows(M: int, m: int, group, dtype, device) -> torch.Tensor:
    """This rank's m rows of I_M (row offset from the rank)."""
    rows = rank(group) * m + torch.arange(m, device=device)
    return (rows[:, None] == torch.arange(M, device=device)[None, :]).to(dtype)


def _ring_matmul(A_loc, B_loc, group):
    """This rank's rows of A @ B with both operands row-sharded: B's row
    blocks circulate around the ring and step s contracts the matching
    (m, M/P) column slice of A_loc; B is never gathered."""
    P, r = world_size(group), rank(group)
    mb = B_loc.shape[0]
    B_cur = B_loc
    out = torch.zeros((A_loc.shape[0], B_loc.shape[1]),
                      dtype=torch.promote_types(A_loc.dtype, B_loc.dtype), device=A_loc.device)
    for s in range(P):
        j = (r - s) % P  # which row block of B this rank holds at step s
        out = out + torch.matmul(A_loc[:, j * mb:(j + 1) * mb], B_cur)
        if s < P - 1:
            B_cur = ring_shift(B_cur, group)
    return out


def _ring_gram_cols(K_loc, group, w_val):
    """This rank's rows of w·K Kᵀ from the row-sharded Gram factor K: step s
    writes the (m, m) tile against the circulating block j into columns
    [j·m, (j+1)·m); each element is one dot product, as in the dense
    product, and K is never gathered."""
    P, r = world_size(group), rank(group)
    m = K_loc.shape[0]
    K_cur = K_loc
    prec = torch.zeros((m, m * P), dtype=K_loc.dtype, device=K_loc.device)
    for s in range(P):
        j = (r - s) % P
        prec[:, j * m:(j + 1) * m] = w_val * torch.matmul(K_loc, K_cur.T)
        if s < P - 1:
            K_cur = ring_shift(K_cur, group)
    return prec


def _sym_rows(X_loc, group):
    """½(X + Xᵀ) on a row-sharded square matrix: one gather to read this
    rank's column block (once per solve, not per iteration)."""
    m = X_loc.shape[0]
    X_full = all_gather_rows(X_loc, group)
    i0 = rank(group) * m
    return 0.5 * (X_loc + X_full[:, i0:i0 + m].T)


def _ns_inverse_rows(A_loc, group, iters: int, lambda_min=None):
    """Distributed Newton–Schulz inverse of a row-sharded SPD matrix: the
    arithmetic of ``ops.linalg.spd_inverse_ns`` from the cold start
    (spectrum-scaled when a positive ``lambda_min`` bound is given and the
    dtype is float64), each product ring-distributed; the iterate stays
    row-sharded. The divergence guard (restart cold on a non-finite
    iterate) is global and stays on the device. Returns this rank's rows
    of the symmetrised inverse."""
    m, M = A_loc.shape
    dt, dev = A_loc.dtype, A_loc.device
    eye_loc = _eye_rows(M, m, group, dt, dev)
    one = torch.ones((), dtype=dt, device=dev)
    norm_inf = all_reduce_max(torch.amax(torch.sum(torch.abs(A_loc), dim=-1)), group)
    f64_ok = torch.finfo(dt).eps < 1e-9
    if lambda_min is None or not f64_ok:
        a_cold = b_cold = one
    else:
        lm = torch.as_tensor(lambda_min, dtype=dt, device=dev)
        a_cold = torch.where(lm > 0, lm / norm_inf, one)
        b_cold = one
    X0_loc = eye_loc / norm_inf
    X_loc, a, b = X0_loc, a_cold, b_cold
    for _ in range(iters):
        gamma = 2.0 / (a + b)
        R_loc = eye_loc - _ring_matmul(A_loc, X_loc, group)
        XR_loc = _ring_matmul(X_loc, R_loc, group)
        Xn_loc = gamma * ((2.0 - gamma) * X_loc + gamma * XR_loc)
        an = 4.0 * a * b / (a + b) ** 2
        ok = torch.isfinite(all_reduce_sum(torch.sum(Xn_loc), group))
        X_loc = torch.where(ok, Xn_loc, X0_loc)
        a = torch.where(ok, an, a_cold)
        b = torch.where(ok, one, b_cold)
    return _sym_rows(X_loc, group)


def _tp_solve(prec_loc, xi_loc, group, ns_iters: int, lambda_min, ir_rounds: int):
    """The shared row-sharded solve: symmetrise Λ across ranks, invert by
    the distributed Newton–Schulz, recover μ by iterative refinement
    (vector gathers only). Both sweeps use it, so their numerics cannot
    fork."""
    prec_loc = _sym_rows(prec_loc, group)
    cov_loc = _ns_inverse_rows(prec_loc, group, ns_iters, lambda_min)
    mu_loc = torch.matmul(cov_loc, all_gather_rows(xi_loc, group))
    for _ in range(ir_rounds):
        r_loc = xi_loc - torch.matmul(prec_loc, all_gather_rows(mu_loc, group))
        mu_loc = mu_loc + torch.matmul(cov_loc, all_gather_rows(r_loc, group))
    return mu_loc, cov_loc, prec_loc


@torch.no_grad()
def tp_regression_sweep(kernel, theta, Xu, X, y, prior_var: float, w_val, group=None,
                        ns_iters: int = 40, lambda_min=None, ir_rounds: int = 2):
    """One tensor-parallel VMP sweep for the conjugate regression model.

    ``Xu`` is this rank's row block (:func:`shard_inducing`); ``X`` (N, D),
    ``y`` (N,) and θ are whole on every rank. The prior is the reference's
    isotropic MvN(0, prior_var·I) on v. Returns this rank's rows of
    ``(μ_v, Σ_v, ξ, Λ)``:

      1. the Gram rows K_loc = K(Xu_loc, X), local;
      2. ξ_loc = w·K_loc y; Λ rows = the ring's w·K Kᵀ tiles + the prior's
         rows (the full Gram is never gathered);
      3. the shared row-sharded solve."""
    m = Xu.shape[0]
    M = m * world_size(group)
    dt = _acc_dtype(X.dtype, _w_dtype(w_val, X.dtype))
    K_loc = kernel(theta, Xu, X).to(dt)
    xi_loc = w_val * torch.matmul(K_loc, y.to(dt))
    prec_loc = (_ring_gram_cols(K_loc, group, w_val)
                + _eye_rows(M, m, group, dt, X.device) / prior_var)
    mu_loc, cov_loc, prec_loc = _tp_solve(prec_loc, xi_loc, group, ns_iters, lambda_min,
                                          ir_rounds)
    return mu_loc, cov_loc, xi_loc, prec_loc


@torch.no_grad()
def dp_tp_regression_sweep(kernel, theta, Xu, X, y, prior_var: float, w_val, mesh,
                           ns_iters: int = 40, lambda_min=None, ir_rounds: int = 2):
    """The 2-D composition: data and inducing dimensions sharded at once.

    ``mesh`` is this rank's ``comm.Mesh2D`` (``comm.make_mesh((dp, tp))``);
    ``Xu`` is its row block over ``mesh.tp``, ``X``/``y`` its slice over
    ``mesh.dp`` (``sharding.shard_data(..., group=mesh.dp)``). Each rank
    computes the Gram tile K(Xu_loc, X_loc) and the increments

        ξ_rows = all_reduce_sum_dp( w · K_tile y_loc )
        Λ_rows = all_reduce_sum_dp( w · ring_tp(K_tile tiles) )

    then the tp-only solve; the dp replicas do the same work on the same
    reduced rows. Returns this rank's tp rows of ``(μ_v, Σ_v, ξ, Λ)``."""
    m = Xu.shape[0]
    M = m * world_size(mesh.tp)
    dt = _acc_dtype(X.dtype, _w_dtype(w_val, X.dtype))
    K_tile = kernel(theta, Xu, X).to(dt)
    xi_loc = all_reduce_sum(w_val * torch.matmul(K_tile, y.to(dt)), mesh.dp)
    prec_loc = (all_reduce_sum(_ring_gram_cols(K_tile, mesh.tp, w_val), mesh.dp)
                + _eye_rows(M, m, mesh.tp, dt, X.device) / prior_var)
    mu_loc, cov_loc, prec_loc = _tp_solve(prec_loc, xi_loc, mesh.tp, ns_iters, lambda_min,
                                          ir_rounds)
    return mu_loc, cov_loc, xi_loc, prec_loc


@torch.no_grad()
def tp_predict(kernel, theta, Xu, mu_v, w_mean, X_test, group=None):
    """UniSGP :out prediction with the M-contraction all-reduced: ``Xu``
    and ``mu_v`` are this rank's rows; returns the whole (mean (N*,), var
    (N*,)) on every rank, N(K(Xu, x*)ᵀμ_v, w̄⁻¹) (UniSGPnode.jl:96-104),
    each rank contributing its m-row partial product. The per-point
    variance matches ``batch_vmp.predict_out``'s signature."""
    Kst = kernel(theta, Xu, X_test)
    dt = torch.promote_types(Kst.dtype, mu_v.dtype)
    mean = all_reduce_sum(torch.matmul(Kst.T.to(dt), mu_v.to(dt)), group)
    return mean, torch.full_like(mean, 1.0 / w_mean)
