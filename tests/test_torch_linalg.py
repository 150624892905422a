"""Parity of the port's ops/linalg.py with the JAX package's, on the CPU.

The Newton–Schulz iterates are compared at every count 1…28, for the cold
start, the spectrum-scaled iteration, the warm start and the ``tol`` early
exit. Tolerance: the two packages' BLAS sum in different orders, and the
iteration carries such a perturbation of X with a gain of at most κ(A), so
iterates agree to ‖ΔX‖/‖X‖ ≤ 10·κ(A)·ε (κ = 1e6 here: 2.2e-9 in f64;
measured up to 5e-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.ops import linalg as jl
from gaussianprocessnode_tpu_torch.ops import linalg as tl

N = 24
KAPPA = 1e6
LAM = 0.02  # the prior-precision floor, as the trainers' I/50


def _spd(seed, n=N, logk=6.0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0.0, logk, n)) @ Q.T + LAM * np.eye(n)
    return (0.5 * (A + A.T)).astype(dtype)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _both(A, **kw):
    """JAX and torch spd_inverse_ns on the same arguments (numpy in)."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    want = np.asarray(jl.spd_inverse_ns(jnp.asarray(A), **jkw))
    got = tl.spd_inverse_ns(torch.as_tensor(A), **tkw).numpy()
    return got, want


def test_sym_and_gershgorin_match_jax():
    A = np.random.default_rng(0).standard_normal((7, 7))
    np.testing.assert_array_equal(tl.sym(torch.as_tensor(A)).numpy(),
                                  np.asarray(jl.sym(jnp.asarray(A))))
    S = _spd(1, n=7, logk=1.0)
    assert float(tl.gershgorin_lambda_min(torch.as_tensor(S))) == pytest.approx(
        float(jl.gershgorin_lambda_min(jnp.asarray(S))), rel=1e-14)
    assert float(tl.gershgorin_lambda_min(torch.eye(5, dtype=torch.float64) * LAM)) == LAM


@pytest.mark.parametrize("lambda_min", [None, LAM, -1.0],
                         ids=["cold", "scaled", "vacuous_bound"])
def test_newton_schulz_iterates_match_jax_at_every_count(lambda_min):
    A = _spd(2)
    tol = 10 * KAPPA * np.finfo(np.float64).eps
    for k in range(1, 29):
        got, want = _both(A, iters=k, lambda_min=lambda_min)
        assert _rel(got, want) <= tol, (k, _rel(got, want))
    # and the 28-iteration result is the inverse
    assert np.linalg.norm(np.eye(N) - A @ got) < 1e-5


@pytest.mark.parametrize("lambda_min", [None, LAM], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("accepted", [True, False], ids=["warm", "warm_rejected"])
def test_warm_start_matches_jax(accepted, lambda_min):
    """An accepted warm start (‖I − A·warm‖_F < 0.5) starts from it (and,
    scaled, from the enclosure [1−r, 1+r]); a rejected one starts cold."""
    A = _spd(3)
    near = np.linalg.inv(A + 1e-3 * _spd(4, logk=0.0))
    warm = near if accepted else 3.0 * near
    r = np.linalg.norm(np.eye(N) - A @ warm)
    assert (r < 0.5) == accepted
    tol = 10 * KAPPA * np.finfo(np.float64).eps
    for k in (1, 2, 3, 5, 8, 13, 21, 28):
        got, want = _both(A, warm=warm, iters=k, lambda_min=lambda_min)
        assert _rel(got, want) <= tol, (k, _rel(got, want))
    if accepted:  # a good warm start converges in a handful of steps
        got, _ = _both(A, warm=warm, iters=3, lambda_min=lambda_min)
        assert np.linalg.norm(np.eye(N) - A @ got) < 1e-5


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("tol_exit,iters", [(1e-3, 60), (1e-30, 28), (1e-3, 5)],
                         ids=["exits_early", "never_meets_tol", "capped"])
def test_tol_early_exit_matches_jax(tol_exit, iters, warm):
    A = _spd(5)
    kw = dict(iters=iters, tol=tol_exit)
    if warm:
        kw["warm"] = np.linalg.inv(A + 1e-3 * _spd(6, logk=0.0))
    got, want = _both(A, **kw)
    assert _rel(got, want) <= 10 * KAPPA * np.finfo(np.float64).eps


def test_float32_never_scales_and_matches_jax():
    """In f32 a λ_min bound is ignored (the scaled iteration needs f64);
    κ = 1e3 here, so 10·κ·ε₃₂ = 1.2e-3."""
    A = _spd(7, n=16, logk=3.0, dtype=np.float32)
    for k in (1, 4, 9, 16, 20):
        got, want = _both(A, iters=k, lambda_min=LAM)
        got_unscaled, _ = _both(A, iters=k)
        np.testing.assert_array_equal(got, got_unscaled)
        assert got.dtype == np.float32
        assert _rel(got, want) <= 10 * 1e3 * np.finfo(np.float32).eps


@pytest.mark.parametrize("good", [True, False], ids=["refines", "keeps_previous"])
def test_ir_solve_matches_jax(good):
    """A float32 approximate inverse refines to f64 accuracy; a
    preconditioner that makes refinement diverge (I − A·M = −1.5·I) leaves
    the first iterate in place. Both against JAX, to 10·κ·ε relative."""
    A = _spd(8)
    b = np.random.default_rng(9).standard_normal(N)
    if good:
        M = np.linalg.inv(A).astype(np.float32)
    else:
        M = 2.5 * np.linalg.inv(A)
    want = np.asarray(jl.ir_solve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(M), rounds=4))
    got = tl.ir_solve(torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(M), rounds=4)
    assert got.dtype == torch.float64
    got = got.numpy()
    assert _rel(got, want) <= 10 * KAPPA * np.finfo(np.float64).eps
    x0 = (M @ b.astype(M.dtype)).astype(np.float64)
    if good:
        assert np.linalg.norm(A @ got - b) < 1e-3 * np.linalg.norm(A @ x0 - b)
    else:
        np.testing.assert_allclose(got, x0, rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("lambda_min", [None, LAM], ids=["unscaled", "scaled"])
def test_spd_inverse_forward_and_gradient_match_jax(lambda_min, warm, dtype):
    """The autograd Function's forward is spd_inverse_ns exactly (zeros for
    a missing warm start, the −1 sentinel for a missing bound); its VJP
    Ā = −X·Ḡ·X matches jax.grad through the JAX spd_inverse. κ = 1e3 here,
    so the forwards agree to 10·κ·ε (as above) and the gradient, two more
    products of X, to 30·κ·ε; no gradient reaches the warm start."""
    import jax

    A = _spd(10, n=16, logk=3.0, dtype=dtype)
    G = np.random.default_rng(11).standard_normal((16, 16)).astype(dtype)
    w = np.linalg.inv(A + 1e-3 * _spd(12, n=16, logk=0.0)).astype(dtype) if warm else None
    iters = 6 if warm else 28

    def jloss(a):
        X = jl.spd_inverse(a, warm=None if w is None else jnp.asarray(w), iters=iters,
                           lambda_min=lambda_min)
        return jnp.sum(jnp.asarray(G) * X), X

    (_, jX), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    wt = None if w is None else torch.tensor(w, requires_grad=True)
    X = tl.spd_inverse(At, warm=wt, iters=iters, lambda_min=lambda_min)
    ns = tl.spd_inverse_ns(torch.as_tensor(A), warm=None if w is None else torch.as_tensor(w),
                           iters=iters,
                           lambda_min=-1.0 if lambda_min is None else lambda_min)
    assert torch.equal(X.detach(), ns)
    torch.sum(torch.as_tensor(G) * X).backward()
    assert wt is None or wt.grad is None
    eps = np.finfo(dtype).eps
    assert X.dtype == At.grad.dtype == torch.from_numpy(A).dtype
    assert _rel(X.detach().numpy(), np.asarray(jX)) <= 10 * 1e3 * eps
    assert _rel(At.grad.numpy(), np.asarray(jg)) <= 30 * 1e3 * eps
