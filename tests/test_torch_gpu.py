"""The port's CUDA kernel, its route, and the serving and training paths
(kin40k regression, banana classification, the toy workloads, the VSGP
collapsed bound, the pendulum objective's Grams, the GPSSM chain smoother,
its streaming filter and the associative scan, the GPLVM sweep, the
data-parallel kin40k trainer over NCCL at world size 1), the Ozaki f64
product's int8 groups and the flagship forward step (``entry.py``) on a
CUDA card.

Every test here carries the ``gpu`` marker and skips itself, inside the
test, where there is no card. The module imports no JAX, so it also runs on
a machine with PyTorch and no JAX; the repository's conftest imports JAX, so
there run it without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu_torch import convert, serve
from gaussianprocessnode_tpu_torch.ops import se_gram as sg

NPZ = Path(__file__).resolve().parent.parent / "benchmarks" / "kin40k_refxu_trained.npz"
EPS32 = float(np.finfo(np.float32).eps)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _case(seed, M, N, D, ard):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    X = rng.standard_normal((N, D)).astype(np.float32)
    ls = (rng.uniform(0.7, 2.5, D) if ard else np.array(1.3)).astype(np.float32)
    if D > 8:
        ls = ls * 8  # keeps d² of order 1 at wide D
    return Z, X, np.float32(0.8), ls


def _gram_tol(Z, X, var, ls):
    """Each side's f32 d² carries at most (D+2)·ε·(‖z‖²+‖x‖²) of rounding,
    K moves by σ²/2 per unit of d², exp and the σ² product add a few ulp."""
    norms = [float(np.max(np.sum((a / ls) ** 2, axis=1))) for a in (Z, X)]
    return float(var) * EPS32 * (4 + (Z.shape[1] + 2) * sum(norms))


# every edge of the kernel's design (40-row × 256-column tiles walked by
# persistent blocks strip by strip; 16-byte stores when N % 4 = 0, 4-byte
# stores otherwise; 8 input dimensions per pass); kuu: X is Z
@pytest.mark.gpu
@pytest.mark.parametrize("M,N,D,ard,kuu", [
    (600, 10000, 8, True, False),             # N not a multiple of 256
    (37, 1001, 3, False, False),              # fewer tiles than SMs, N % 4 != 0
    (70, 300, sg.SE_GRAM_MAX_D, True, False),  # widest D, 32 passes
    (1, 1, 1, False, False),
    (600, 30000, 8, True, False),             # serving: far more tiles than blocks
    (600, 9999, 8, True, False),              # N % 4 != 0: 4-byte stores
    (600, 600, 8, True, True),                # training Kuu
    (601, 2052, 8, True, False),              # M % 40 != 0, a 4-column last strip
    (1, 30000, 8, True, False),               # M = 1
    (300, 5000, 1, False, False),             # D = 1
    (129, 1300, 20, True, False),             # D = 20: 3 passes, the last partial
    (500, 4000, 2, True, False),              # banana Kux of all points: M % 40 != 0
    (500, 500, 2, True, True),                # banana Kuu
    (500, 200, 2, True, False),               # banana Kux of a batch: N < one tile
    (500, 30000, 2, True, False),             # classifier serving
])
def test_kernel_matches_plain_version_on_card(M, N, D, ard, kuu):
    _need_card()
    Z, X, var, ls = _case(5, M, N, D, ard)
    if kuu:
        X = Z
    args = [torch.as_tensor(a).cuda() for a in (Z, X, var, ls)]
    before = sg.se_gram_cuda.launches
    K = sg.se_gram_cuda(*args)
    assert sg.se_gram_cuda.launches == before + 1
    K_ref = sg.se_gram_reference(*args)
    torch.cuda.synchronize()
    assert K.dtype == torch.float32 and tuple(K.shape) == (M, N)
    np.testing.assert_allclose(K.cpu().numpy(), K_ref.cpu().numpy(), rtol=0,
                               atol=_gram_tol(Z, X, var, ls))


@pytest.mark.gpu
def test_back_to_back_grams_on_one_stream_on_card():
    """Two launches queued on one stream into different outputs, checked
    after both ran: a staged buffer refilled while still read, or one
    launch's stores racing the next launch, would show in either."""
    _need_card()
    Z, X1, var, ls = _case(8, 600, 30000, 8, True)
    X2 = np.random.default_rng(9).standard_normal((10000, 8)).astype(np.float32)
    Zc, X1c, X2c, vc, lc = (torch.as_tensor(a).cuda() for a in (Z, X1, X2, var, ls))
    K1 = sg.se_gram_cuda(Zc, X1c, vc, lc)
    K2 = sg.se_gram_cuda(Zc, X2c, vc, lc)
    refs = [sg.se_gram_reference(Zc, Xc, vc, lc) for Xc in (X1c, X2c)]
    torch.cuda.synchronize()
    for K, K_ref, X in zip((K1, K2), refs, (X1, X2)):
        np.testing.assert_allclose(K.cpu().numpy(), K_ref.cpu().numpy(), rtol=0,
                                   atol=_gram_tol(Z, X, var, ls))


@pytest.mark.gpu
def test_float64_kernel_gram_takes_plain_route_on_card():
    """Kernel(use_kernel=True) on float64 CUDA tensors computes the plain f64
    Gram (1e-12 relative: the same f64 operations, other summation orders
    on the card) without launching the f32 kernel, as the JAX package's
    se_gram_auto keeps f64 off its Pallas kernel; its θ-gradient matches
    the CPU's to 1e-10 relative."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel, se_gram, softplus

    rng = np.random.default_rng(10)
    theta = np.array([0.3, 0.8, 1.1, 0.6])
    Z, X = rng.standard_normal((40, 3)), rng.standard_normal((70, 3))
    G = rng.standard_normal((40, 70))
    kern = Kernel("se", "softplus", use_kernel=True)
    grads, grams = [], []
    for dev in ("cpu", "cuda"):
        th = torch.tensor(theta, device=dev, requires_grad=True)
        Zd, Xd = torch.as_tensor(Z, device=dev), torch.as_tensor(X, device=dev)
        before = sg.se_gram_cuda.launches
        K = kern(th, Zd, Xd)
        assert sg.se_gram_cuda.launches == before
        assert K.dtype == torch.float64 and K.device.type == dev
        torch.sum(torch.as_tensor(G, device=dev) * K).backward()
        sp = softplus(th.detach())
        plain = se_gram(Zd, Xd, sp[0], sp[1:])
        np.testing.assert_allclose(K.detach().cpu().numpy(), plain.cpu().numpy(),
                                   rtol=1e-12, atol=1e-15)
        grads.append(th.grad.cpu().numpy())
        grams.append(K.detach().cpu().numpy())
    np.testing.assert_allclose(grams[1], grams[0], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-10, atol=1e-13)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take_on_card():
    _need_card()
    Z = torch.ones((4, 3), device="cuda")
    var, ls = torch.ones((), device="cuda"), torch.ones((3,), device="cuda")
    with pytest.raises(TypeError):
        sg.se_gram_cuda(Z.double(), Z.double(), var.double(), ls.double())
    with pytest.raises(ValueError):
        sg.se_gram_cuda(Z, Z, var.cpu(), ls)


@pytest.mark.gpu
def test_fused_vjp_on_card_matches_cpu():
    """The same f32 VJP formulas on the card and on the CPU: 1e-4 relative
    (f32 sums over 70 terms in other orders)."""
    _need_card()
    Z, X, var, ls = _case(6, 50, 70, 4, True)
    G = np.random.default_rng(7).standard_normal((50, 70)).astype(np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        args = [torch.tensor(a, device=dev, requires_grad=True) for a in (Z, X, var, ls)]
        torch.sum(torch.as_tensor(G, device=dev) * sg.se_gram_fused(*args)).backward()
        grads.append([a.grad.cpu().numpy() for a in args])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


@pytest.mark.gpu
def test_serving_on_card_goes_through_kernel_and_matches_cpu():
    """The kin40k handle on the card against the same handle on the CPU
    (plain version): means to 1e-5 of |K|ᵀ|μ| (f32 Gram and mat-vec over
    600 terms on both sides)."""
    _need_card()
    z = np.load(NPZ, allow_pickle=False)
    rng = np.random.default_rng(0)
    Xu, X = rng.standard_normal((600, 8)), rng.standard_normal((4, 2000, 8))
    handles = {dev: convert.serving_state_from_jax(
        z["theta"], Xu, z["xi"], z["prec"], 1e4, dtype=torch.float32, device=dev)
        for dev in ("cpu", "cuda")}
    sg.se_gram_cuda.launches = 0
    m_gpu, v_gpu = serve.serve_fused(handles["cuda"], X)
    torch.cuda.synchronize()
    assert sg.se_gram_cuda.launches == 4
    m_cpu, v_cpu = serve.serve_fused(handles["cpu"], X)
    h = handles["cpu"]
    scale = torch.stack([h.kernel(h.theta, h.Xu, torch.as_tensor(Xb, dtype=torch.float32)).abs().T
                         @ h.mu_v.abs() for Xb in X])
    assert float(((m_gpu.cpu() - m_cpu).abs() / scale).max()) <= 1e-5
    assert torch.equal(v_gpu.cpu(), v_cpu)


# the kernel route's inputs (se_gram_auto): what it takes, casts and refuses


@pytest.mark.gpu
def test_f32_inputs_with_f64_hyperparameters_take_the_kernel_on_card():
    """σ² and ℓ in f64 (an f64 θ) beside f32 Z and X: the kernel, with σ²
    and ℓ rounded to f32 first, equal to the plain f32 Gram on those
    rounded values within the Gram tolerance."""
    _need_card()
    Z, X, var, ls = _case(14, 600, 500, 8, True)
    Zc, Xc = torch.as_tensor(Z).cuda(), torch.as_tensor(X).cuda()
    v64 = torch.tensor(float(var), dtype=torch.float64, device="cuda")
    l64 = torch.as_tensor(ls.astype(np.float64)).cuda()
    before = sg.se_gram_cuda.launches
    K = sg.se_gram_auto(Zc, Xc, v64, l64)
    assert sg.se_gram_cuda.launches == before + 1
    K_ref = sg.se_gram_reference(Zc, Xc, v64.float(), l64.float())
    assert K.dtype == torch.float32
    np.testing.assert_allclose(K.cpu().numpy(), K_ref.cpu().numpy(), rtol=0,
                               atol=_gram_tol(Z, X, var, ls))


@pytest.mark.gpu
@pytest.mark.parametrize("half", [torch.float16, torch.bfloat16])
def test_half_beside_f32_takes_the_plain_gram_on_card(half):
    """A float16 or bfloat16 Z beside a float32 X takes the plain Gram in
    the promoted dtype, bit for bit, with no kernel launch."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops.kernels import se_gram

    Z, X, var, ls = _case(15, 64, 300, 8, True)
    Zh = torch.as_tensor(Z).cuda().to(half)
    args = (torch.as_tensor(X).cuda(), torch.tensor(var).cuda(), torch.as_tensor(ls).cuda())
    before = sg.se_gram_cuda.launches
    K = sg.se_gram_auto(Zh, *args)
    assert sg.se_gram_cuda.launches == before
    assert K.dtype == torch.float32
    assert torch.equal(K, se_gram(Zh, *args))


@pytest.mark.gpu
def test_sliced_and_transposed_inputs_take_the_kernel_on_card():
    """A column slice of a wider X and a transposed Z (neither contiguous)
    go through the kernel, made contiguous by the route, and equal the
    plain Gram within the Gram tolerance."""
    _need_card()
    Z, X, var, ls = _case(16, 600, 10000, 8, True)
    wide = np.concatenate([X, np.ones((X.shape[0], 3), np.float32)], axis=1)
    Xs = torch.as_tensor(wide).cuda()[:, :8]
    Zt = torch.as_tensor(np.ascontiguousarray(Z.T)).cuda().T
    assert not Xs.is_contiguous() and not Zt.is_contiguous()
    vc, lc = torch.tensor(var).cuda(), torch.as_tensor(ls).cuda()
    before = sg.se_gram_cuda.launches
    K = sg.se_gram_auto(Zt, Xs, vc, lc)
    assert sg.se_gram_cuda.launches == before + 1
    K_ref = sg.se_gram_reference(Zt.contiguous(), Xs.contiguous(), vc, lc)
    np.testing.assert_allclose(K.cpu().numpy(), K_ref.cpu().numpy(), rtol=0,
                               atol=_gram_tol(Z, X, var, ls))


# the fast trainer on the card


def _trainer_inputs(device, M=600, n_train=10000, batch=500, seed=1):
    from gaussianprocessnode_tpu_torch.experiments import kin40k as runner

    ds = runner.load_data("synthetic", seed, n_test=10)
    return runner.setup(ds, M, batch, n_train, seed, device)


def _objective_grad(use_kernel, theta, Xu, X, y, mu_v, Rv):
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.linalg import effective_jitter
    from gaussianprocessnode_tpu_torch.objectives import neg_log_backwardmess_gram

    th = theta.clone().requires_grad_(True)
    loss, kinv = neg_log_backwardmess_gram(
        th, kernel=Kernel("se", "softplus", use_kernel=use_kernel), Xu=Xu, X=X, y=y,
        mu_v=mu_v, Rv=Rv, w=1e4, ns_iters=12, kuu_jitter=effective_jitter(torch.float32))
    (g,) = torch.autograd.grad(loss, th)
    return loss.detach(), kinv, g


@pytest.mark.gpu
@pytest.mark.parametrize("theta_from", ["theta0", "trained"])
def test_theta_gradient_with_kernel_matches_plain_gram_on_card(theta_from):
    """The objective at the trainer's shapes (Kuu 600×600, Kux 600×500, f32)
    with the kernel against the same with the plain Gram, on the card, at θ0
    and at the committed trained θ: two launches per gradient; the loss,
    Kuu⁻¹ and the θ-gradient to 1e-3 relative (both sides round the Gram
    differently by the Gram tolerance, and the 12-iteration f32 inverse
    carries that with a gain of up to κ(Kuu))."""
    _need_card()
    theta0, Xu, Xb, yb, _ = _trainer_inputs("cuda")
    theta = theta0 if theta_from == "theta0" else torch.as_tensor(
        np.load(NPZ)["theta"], dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(17)
    mu_v = torch.as_tensor(rng.standard_normal(600) * 0.1, dtype=torch.float32, device="cuda")
    A = torch.as_tensor(rng.standard_normal((600, 600)) * 0.01, dtype=torch.float32,
                        device="cuda")
    Rv = A @ A.T + torch.outer(mu_v, mu_v)
    before = sg.se_gram_cuda.launches
    lk, kk, gk = _objective_grad(True, theta, Xu, Xb[0], yb[0], mu_v, Rv)
    assert sg.se_gram_cuda.launches == before + 2
    lp, kp, gp = _objective_grad(False, theta, Xu, Xb[0], yb[0], mu_v, Rv)
    assert sg.se_gram_cuda.launches == before + 2
    assert float(abs(lk - lp)) <= 1e-3 * float(abs(lp))
    assert float(torch.linalg.norm(kk - kp) / torch.linalg.norm(kp)) <= 1e-3
    assert float(torch.linalg.norm(gk - gp) / torch.linalg.norm(gp)) <= 1e-3


@pytest.mark.gpu
def test_full_width_epoch_on_card_matches_cpu():
    """One epoch at kin40k width (M = 600, 20 batches of 500, f32 θ, f64
    statistics) on the card, through the kernel (41 launches), against the
    same epoch on the CPU with the plain Gram: θ, ξ and Λ to 1e-4 relative
    (f32 Grams that differ by the Gram tolerance, carried through the f64
    refresh and 20 AdaMax steps of size ≤ 1e-3)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.minibatch import fit_kin40k_fast
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    out = {}
    for dev in ("cuda", "cpu"):
        theta0, Xu, Xb, yb, prior = _trainer_inputs(dev)
        sg.se_gram_cuda.launches = 0
        th, nat, _, _ = fit_kin40k_fast(Kernel("se", "softplus", use_kernel=True), theta0,
                                        Xu, Xb, yb, prior, 1e4, 1)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sg.se_gram_cuda.launches == 41
        else:
            assert sg.se_gram_cuda.launches == 0
        out[dev] = [t.cpu() for t in (th, nat.xi, nat.prec)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float(torch.linalg.norm(a.double() - b.double())
                     / torch.linalg.norm(b.double())) <= 1e-4


@pytest.mark.gpu
def test_trainer_epoch_makes_no_host_sync_on_card():
    """An epoch after the first runs under set_sync_debug_mode("error"): no
    .item(), no host-side branch on a device value, no pageable copy."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.minibatch import fit_kin40k_fast
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    theta0, Xu, Xb, yb, prior = _trainer_inputs("cuda", M=64, n_train=1000, batch=250)
    kern = Kernel("se", "softplus", use_kernel=True)
    _, _, _, carry = fit_kin40k_fast(kern, theta0, Xu, Xb, yb, prior, 1e4, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th, _, _, _ = fit_kin40k_fast(kern, theta0, Xu, Xb, yb, prior, 1e4, 2,
                                      resume_state=carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(th).all())


# the banana trainers and the classifier on the card


def _banana_inputs(device, M=500, batch=200, seed=1):
    from gaussianprocessnode_tpu_torch.experiments import banana as runner

    return runner.setup(runner.load_data("synthetic", seed), M, batch, seed, device)


@pytest.mark.gpu
def test_full_width_banana_epoch_on_card_matches_cpu():
    """One fit_banana_fast epoch at banana width (M = 500, D = 2, 20 batches
    of 200, f32 θ, f64 statistics) on the card through the kernel (41
    launches: 1 at 500×4000, 20 at 500×500, 20 at 500×200), against the
    same epoch on the CPU with the plain Gram, from the same carry (built on
    the CPU: the initial carry after one epoch; from the cold initial carry
    the q(w) rate is float32 rounding noise to ~1e-4, see
    scripts/banana_rounding_sensitivity.py): θ, ξ, Λ, w_shape, w_rate to
    1e-4 relative (f32 Grams that differ by the Gram tolerance, carried
    through the probit moments, the f64 refresh and 20 AdaMax steps of size
    ≤ 1e-3; a half-ulp perturbation of the Gram moves them by ≤ 6e-6)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.minibatch import (MinibatchCarry, fit_banana_fast,
                                                               init_banana_state)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    kern = Kernel("se", "softplus", use_kernel=True)
    theta0, Xu, Xb, yb, pv, pw = _banana_inputs("cpu")
    *_, c0 = fit_banana_fast(kern, theta0, Xu, Xb, yb, pv, pw, 1,
                             resume_state=init_banana_state(kern, theta0, Xu, pv, pw))
    out = {}
    for dev in ("cuda", "cpu"):
        args = [t.to(dev) for t in (theta0, Xu, Xb, yb)]
        pv_d = type(pv)(*(t.to(dev) for t in pv))
        pw_d = type(pw)(*(t.to(dev) for t in pw))
        carry = MinibatchCarry(*(t.to(dev) for t in c0[:5]),
                               {k: v.to(dev) for k, v in c0.opt_state.items()},
                               c0.w_shape.to(dev), c0.w_rate.to(dev))
        sg.se_gram_cuda.launches = 0
        th, nat, qw, _ = fit_banana_fast(kern, *args, pv_d, pw_d, 1, resume_state=carry)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sg.se_gram_cuda.launches == 41
        else:
            assert sg.se_gram_cuda.launches == 0
        out[dev] = [t.cpu() for t in (th, nat.xi, nat.prec, qw.shape, qw.rate)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float(torch.linalg.norm(a.double() - b.double())
                     / torch.linalg.norm(b.double())) <= 1e-4


@pytest.mark.gpu
def test_banana_epochs_make_no_host_sync_on_card():
    """Banana epochs 2–3 of fit_banana_fast run under
    set_sync_debug_mode("error"): the probit moments, q(w) and w̄ stay on the
    device."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.minibatch import fit_banana_fast
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    theta0, Xu, Xb, yb, pv, pw = _banana_inputs("cuda", M=64, batch=500)
    kern = Kernel("se", "softplus", use_kernel=True)
    *_, carry = fit_banana_fast(kern, theta0, Xu, Xb, yb, pv, pw, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th, _, qw, _ = fit_banana_fast(kern, theta0, Xu, Xb, yb, pv, pw, 2, resume_state=carry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(th).all()) and float(qw.rate) > 0


@pytest.mark.gpu
def test_classifier_on_card_goes_through_kernel_and_matches_cpu():
    """The banana classifier (benchmarks/banana_refxu_trained.npz, Xu drawn
    N(0, I₂)) on the card against the same arrays on the CPU (plain
    version), both with the μ_v recovered on the CPU: probabilities to
    0.4·1e-5 of |K|ᵀ|μ| plus 4ε (f32 Gram and mat-vec over 500 terms on
    both sides; Φ moves by at most 0.4 per unit of the mean); one launch
    per batch."""
    _need_card()
    import dataclasses

    z = np.load(NPZ.parent / "banana_refxu_trained.npz", allow_pickle=False)
    rng = np.random.default_rng(0)
    Xu, X = rng.standard_normal((500, 2)), rng.standard_normal((4, 3000, 2)) * 0.5
    cpu = convert.classifier_state_from_jax(z["theta"], Xu, z["xi"], z["prec"], z["w_shape"],
                                            z["w_rate"], dtype=torch.float32, device="cpu")
    gpu = dataclasses.replace(cpu, theta=cpu.theta.cuda(), Xu=cpu.Xu.cuda(),
                              mu_v=cpu.mu_v.cuda(), w_mean=cpu.w_mean.cuda())
    sg.se_gram_cuda.launches = 0
    p_gpu = serve.serve_fused(gpu, X)
    torch.cuda.synchronize()
    assert sg.se_gram_cuda.launches == 4
    p_cpu = serve.serve_fused(cpu, X)
    scale = torch.stack([cpu.kernel(cpu.theta, cpu.Xu, torch.as_tensor(Xb, dtype=torch.float32))
                         .abs().T @ cpu.mu_v.abs() for Xb in X])
    tol = 0.4 * 1e-5 * scale + 4 * EPS32
    assert bool(((p_gpu.cpu() - p_cpu).abs() <= tol).all())


@pytest.mark.gpu
def test_toy_regression_epochs_on_card_match_cpu_and_sync_once_per_linesearch_step():
    """Two float64 toy-regression epochs on the card (plain Grams by dtype)
    against the same epochs on the CPU (θ to 1e-6, free energies to 1e-8:
    the L-BFGS fixed point is fixed to ~1e-8), run under
    set_sync_debug_mode("warn") after a warm-up epoch: the only
    synchronising operations are the linesearch's host reads, one per
    iteration."""
    _need_card()
    from gaussianprocessnode_tpu_torch.experiments import toy_regression as treg
    from gaussianprocessnode_tpu_torch.infer.training import fit_regression
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.utils.datasets import toy_sinc
    from gaussianprocessnode_tpu_torch.utils.profiling import count_syncs

    kern = Kernel("se", "softplus", use_kernel=True)
    counts = {}
    args = treg.setup(toy_sinc(), device="cuda")  # its host-to-card copies are not counted
    # a warm-up epoch first: a process's first cuSOLVER/cuBLAS calls create
    # their handles and workspaces, which may synchronise once
    fit_regression(kern, *args, epochs=1)
    (th, fe, _), syncs = count_syncs(lambda: fit_regression(kern, *args, epochs=2,
                                                            counts=counts))
    th_c, fe_c, _ = fit_regression(kern, *treg.setup(toy_sinc(), device="cpu"), epochs=2)
    assert syncs == counts["host_reads"] > 0
    assert float(torch.max(torch.abs(th.cpu() - th_c) / torch.abs(th_c))) <= 1e-6
    assert float(torch.max(torch.abs(fe.cpu() - fe_c) / torch.abs(fe_c))) <= 1e-8


@pytest.mark.gpu
def test_toy_float32_epoch_goes_through_the_kernel_on_card():
    """One float32 toy-classification epoch through the kernel, none on the
    plain route. The wrapper counts two launches per VMP pass and, for the
    epoch's CUDA graph of the objective (Kuu and Kux), two in its eager
    warm-up and two captured; the profiler's trace records the kernel two
    times per VMP pass, per warm-up and per replayed evaluation, less at
    most 1 in 200 that the trace can miss (chip_smoke.py TOY_TRACE_LOSS).
    Held to the plain float32 Gram's epoch at 3× the card's readings
    (chip_smoke.py TOY_F32_LIMITS)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.experiments import toy_classification as tcls
    from gaussianprocessnode_tpu_torch.infer.training import fit_classification
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.utils.datasets import toy_classification
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_kernel_times

    args = tcls.setup(toy_classification(), device="cuda", dtype=torch.float32)
    ck, got = {}, []
    sg.se_gram_cuda.launches = 0
    _, kernels = cuda_kernel_times(lambda: got.append(fit_classification(
        Kernel("se", "softplus", use_kernel=True), *args, epochs=1, counts=ck)), warmup=0)
    launches = sg.se_gram_cuda.launches
    th_k, fe_k, _ = got[0]
    th_p, fe_p, _ = fit_classification(Kernel("se", "softplus"), *args, epochs=1)
    records = sum(n for name, (n, _) in kernels.items() if "se_gram" in name)
    assert sg.se_gram_cuda.launches == launches == 4 + 4 * ck["graph_captures"]
    want = 4 + 2 * (ck["graph_captures"] + ck["evaluations"])
    assert 0 <= want - records <= want // 200
    assert float(torch.max(torch.abs(fe_k - fe_p) / torch.abs(fe_p))) <= 6e-6
    assert float(torch.max(torch.abs(th_k - th_p) / torch.abs(th_p))) <= 1.5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_points", [1200, 48], ids=["48x1200x2", "48x48x2"])
def test_kernel_matches_plain_at_the_pendulum_objective_shapes_on_card(n_points):
    """The pendulum M-step's Grams (its 48-point inducing grid at θ0 =
    softplus⁻¹(1)): the spherical-radial points of 300 states, and Kuu.
    One launch each, within the f32 rounding bound of the plain Gram."""
    _need_card()
    from gaussianprocessnode_tpu_torch.utils.datasets import pendulum_inducing

    Z = pendulum_inducing().astype(np.float32)
    X = Z if n_points == 48 else np.random.default_rng(9).uniform(
        -2.0, 2.0, (n_points, 2)).astype(np.float32)
    var, ls = np.float32(1.0), np.ones(2, np.float32)
    Zc, Xc = torch.as_tensor(Z, device="cuda"), torch.as_tensor(X, device="cuda")
    before = sg.se_gram_cuda.launches
    K = sg.se_gram_cuda(Zc, Xc, torch.tensor(var, device="cuda"), torch.as_tensor(ls).cuda())
    assert sg.se_gram_cuda.launches == before + 1
    K_ref = sg.se_gram_reference(Zc, Xc, torch.tensor(var, device="cuda"),
                                 torch.as_tensor(ls).cuda())
    assert K.shape == (48, n_points)
    assert float((K - K_ref).abs().max()) <= _gram_tol(Z, X, var, ls)


@pytest.mark.gpu
def test_collapsed_step_through_the_kernel_matches_the_plain_route_on_card():
    """One AdaMax step of the collapsed bound at kin40k width (M = 600,
    N = 10,000, f32; noise 0.01, jitter 1e-5, lr 0.05): two launches (Kuu
    and Kux), and the −ELBO and θ after the step within 1e-4 relative of
    the plain Gram's (the Grams differ by f32 rounding, ~1e-7 of σ²; the
    first AdaMax step moves each θ entry by ±lr whatever the gradient's
    size)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.svgp import (collapsed_opt_init, collapsed_step,
                                                          vsgp_optimizer)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    theta0, Xu, Xb, yb, _ = _trainer_inputs("cuda")
    X, y = Xb.reshape(-1, 8), yb.reshape(-1)
    out = {}
    for use_kernel in (True, False):
        th, st = theta0.clone(), collapsed_opt_init(theta0, 0.05)
        before = sg.se_gram_cuda.launches
        v = collapsed_step(Kernel("se", "softplus", use_kernel=use_kernel),
                           vsgp_optimizer(0.05), th, st, Xu, X, y, 0.01, 1e-5)
        assert sg.se_gram_cuda.launches == before + (2 if use_kernel else 0)
        out[use_kernel] = (v, th)
    (vk, tk), (vp, tp) = out[True], out[False]
    assert bool(torch.isfinite(vk)) and bool(torch.isfinite(tk).all())
    assert float(abs(vk - vp)) <= 1e-4 * float(abs(vp))
    assert float(torch.linalg.norm(tk - tp) / torch.linalg.norm(tp)) <= 1e-4
    assert not torch.equal(tk, theta0)


def _gpssm_setup():
    """The pendulum runner's setup in float32 on the card, and a state after
    3 cold Jacobi sweeps through the plain Gram at θ0."""
    from gaussianprocessnode_tpu_torch.experiments import pendulum as runner
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    s = runner.setup("cuda", torch.float32)
    state, _ = runner.vmp(dict(s, kernel=Kernel("se", "softplus")), s["theta0"], 3)
    return runner, s, state


@pytest.mark.gpu
def test_gpssm_jacobi_sweep_through_the_kernel_at_full_width_on_card():
    """One Jacobi sweep (T = 300, M = 48 on the pendulum grid, float32) from
    one state, through the kernel and through the plain Gram: 3 + 1 + 2
    launches (the sweep's three Grams, Kuu, the free energy's two), the
    x-means within 0.1 and the free energy within 15 % (the JAX package's own
    float32 limits: on this grid each refinement's log-density carries ~1
    nat of float32 rounding, chip_smoke.py phase 12)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    runner, s, state = _gpssm_setup()
    out = {}
    for use_kernel in (True, False):
        before = sg.se_gram_cuda.launches
        st, fe = runner.vmp(dict(s, kernel=Kernel("se", "softplus", use_kernel=use_kernel)),
                            s["theta0"], 1, init_state=state)
        assert sg.se_gram_cuda.launches == before + (6 if use_kernel else 0)
        out[use_kernel] = (st, fe)
    (sk, fk), (sp, fp) = out[True], out[False]
    assert all(bool(torch.isfinite(t).all()) for t in sk)
    assert float((sk.x_means - sp.x_means).abs().max()) <= 0.1
    assert float(abs(fk - fp)) <= 0.15 * float(abs(fp))


@pytest.mark.gpu
def test_gpssm_filter_windows_chain_on_card():
    """serve.GPSSMFilter on the card: two chained windows equal one window
    bit for bit, one launch per filtered step, and the predictions within
    1e-4 of the plain Gram's (no Kuu⁻¹ in the filter: the Gram's rounding
    alone)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.serve import GPSSMFilter

    _, s, state = _gpssm_setup()
    yt = s["y_test"][:60]
    hk = GPSSMFilter.from_state(Kernel("se", "softplus", use_kernel=True), s["theta0"], s["Xu"],
                                state, s["P"])
    before = sg.se_gram_cuda.launches
    m_one, _, end = hk(yt)
    assert sg.se_gram_cuda.launches == before + 60
    m1, _, mid = hk(yt[:25])
    m2, _, end2 = hk(yt[25:], mid)
    assert torch.equal(torch.cat([m1, m2]), m_one) and torch.equal(end[1], end2[1])
    hp = GPSSMFilter.from_state(Kernel("se", "softplus"), s["theta0"], s["Xu"], state, s["P"])
    m_p, _, _ = hp(yt)
    assert float((m_one - m_p).abs().max()) <= 1e-4 * float(m_p.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_on_card_matches_a_sequential_fold(reverse):
    """ops/scan.py on CUDA tensors, T + 1 = 301 affine elements (3×3), float64:
    within 1e-11 of a sequential fold on the host."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops.scan import associative_scan

    rng = np.random.default_rng(301)
    A = 0.6 * rng.standard_normal((301, 3, 3))
    c = rng.standard_normal((301, 3))

    def fn(a, b):
        return b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1]

    out = associative_scan(fn, (torch.as_tensor(A, device="cuda"),
                                torch.as_tensor(c, device="cuda")), reverse=reverse)
    acc, fold = None, []
    for k in (range(300, -1, -1) if reverse else range(301)):
        acc = (A[k], c[k]) if acc is None else fn(acc, (A[k], c[k]))
        fold.append(acc)
    fold = fold[::-1] if reverse else fold
    for i in range(2):
        want = np.stack([f[i] for f in fold])
        got = out[i].cpu().numpy()
        assert np.max(np.abs(got - want)) <= 1e-11 * np.max(np.abs(want))


def _gplvm_setup(device, dtype):
    """The GPLVM runner's inputs at full width (N = 200, D = 12, Din = 2, M =
    30; synthetic oil-flow data of seed 0) on ``device``."""
    from gaussianprocessnode_tpu_torch.experiments import gplvm as runner

    Y, _ = runner.load_data("synthetic", 0)
    _, theta0, Xu, Y, Xm, _ = runner.setup(Y, device=device, dtype=dtype)
    return theta0, Xu, Y, Xm


@pytest.mark.gpu
def test_gplvm_psi_statistics_float32_through_the_kernel_on_card():
    """The GPLVM sweep's Ψ-statistics at 30×800×2 (the 200 cold marginals'
    spherical-radial points): one launch, Ψ1 within the Gram's f32 bound
    (the weights sum to 1) and ΣΨ2 within N·(2σ²·bound) plus both GEMMs'
    rounding; Ψ0 takes no Gram."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops import psi as psiops
    from gaussianprocessnode_tpu_torch.ops import quadrature as quad
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    theta, Xu, _, Xm = _gplvm_setup("cuda", torch.float32)
    covs = torch.eye(2, device="cuda").expand(200, 2, 2)
    sr = quad.SphericalRadial()
    ones = torch.ones(200, device="cuda")
    out = {}
    for use_kernel in (True, False):
        k = Kernel("se", "softplus", use_kernel=use_kernel)
        before = sg.se_gram_cuda.launches
        p0, p1, Kp, w = psiops.psi_batch_expected_multi(k, theta, Xu, sr, Xm, covs)
        assert sg.se_gram_cuda.launches == before + (1 if use_kernel else 0)
        out[use_kernel] = (p0, p1, psiops.sum_weighted_psi2(Kp, w, ones))
    var, ls = Kernel("se", "softplus").params(theta)
    pts, _ = quad.points_weights_multi(sr, Xm, covs)
    tol = _gram_tol(Xu.cpu().numpy(), pts.reshape(-1, 2).cpu().numpy(), float(var),
                    ls.cpu().numpy())
    v = float(var)
    (k0, k1, k2), (q0, q1, q2) = out[True], out[False]
    assert torch.equal(k0, q0)
    assert float((k1 - q1).abs().max()) <= tol + 8 * EPS32 * v
    assert float((k2 - q2).abs().max()) <= 200 * (2 * v * tol + tol ** 2) + 2 * 800 * EPS32 * 200 * v * v


@pytest.mark.gpu
def test_gplvm_float64_sweep_on_card_matches_cpu():
    """One cold float64 ``gplvm_vmp`` sweep at full width, card against
    host: the q(v) naturals (no Laplace step before them) to 1e-12; the
    latents, whose Laplace in-message carries Kuu⁻¹ at the 1e-12 jitter,
    to 1e-4 (means, absolute) and 3e-3 (covariances), the free energy to
    2e-6: ten times and more what one float64 ulp of the Gram alone moves
    them on the host (``scripts/gplvm_rounding_twin.py --one-sweep``, seeds
    0-2: ≤ 1.9e-7, 1.1e-5, 1.4e-9). No kernel launches."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.gplvm import gplvm_vmp
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    k = Kernel("se", "softplus", use_kernel=True)
    before = sg.se_gram_cuda.launches
    card, fe_card = gplvm_vmp(k, *_gplvm_setup("cuda", torch.float64), n_iters=1)
    assert sg.se_gram_cuda.launches == before
    host, fe_host = gplvm_vmp(k, *_gplvm_setup("cpu", torch.float64), n_iters=1)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    assert rel(card.xi_v, host.xi_v) <= 1e-12 and rel(card.prec_v, host.prec_v) <= 1e-12
    assert float((card.x_means.cpu() - host.x_means).abs().max()) <= 1e-4
    assert rel(card.x_covs, host.x_covs) <= 3e-3
    assert abs(float(fe_card) - float(fe_host)) <= 2e-6 * abs(float(fe_host))


def _relmax(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _legacy_chain(dev, T, seed=11):
    from gaussianprocessnode_tpu_torch.experiments.legacy_gp import padscale_data

    return tuple(torch.as_tensor(a, device=dev) for a in padscale_data(T))


@pytest.mark.gpu
@pytest.mark.parametrize("parallel", [False, True])
def test_sde_smoother_float64_on_card_matches_cpu(parallel):
    """The SDE-GP smoother (T = 1,000, a third of the sites masked,
    heteroscedastic R) and its NLML gradient in float64, card against host:
    1e-10 (the same recursion; cuBLAS and the host's BLAS round its 3×3
    products in other orders). No kernel launches."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer.sde_gp import sde_gp_nlml, sde_gp_smooth

    out = {}
    before = sg.se_gram_cuda.launches
    for dev in ("cuda", "cpu"):
        t, z, mask, r = _legacy_chain(dev, 1000)
        th = torch.tensor([1.0, 0.9], dtype=torch.float64, device=dev, requires_grad=True)
        res = sde_gp_smooth(th, t, z, mask, r, parallel=parallel)
        (g,) = torch.autograd.grad(sde_gp_nlml(th, t, z, mask, r, parallel=parallel), th)
        out[dev] = (res.mean, res.var, res.log_lik, g)
    assert sg.se_gram_cuda.launches == before
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _relmax(a, b) <= 1e-10


@pytest.mark.gpu
def test_gppad_float64_on_card_matches_cpu():
    """GP-PAD (8 EP sweeps, a 3-model bank) and one colored sweep's
    implicit gradient in float64, card against host: 1e-9 (the EP loop
    carries each sweep's rounding into the next tilt)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.infer import gppad as tg
    from gaussianprocessnode_tpu_torch.infer import pad_learn as tl

    def run(dev):
        t = torch.linspace(0.0, 4.0, 200, dtype=torch.float64, device=dev)
        gen = np.random.default_rng(3)
        y = torch.as_tensor(0.2 * gen.normal(size=200) * np.exp(0.8 * np.sin(1.5 * t.cpu().numpy())),
                            device=dev)
        ths = torch.tensor([[1.0, 0.9], [1.0, 0.2], [1.0, 3.0]], dtype=torch.float64, device=dev)
        st = tg.gppad_infer(ths, t, y, carrier_var=0.04, iters=8)
        ell = torch.tensor([0.3, 0.1], dtype=torch.float64, device=dev)
        fit = tl.fit_gppad_colored_theta(t, y, ell, var_f=0.4, var_c=1.0, epochs=1, ep_iters=6,
                                         adjoint_iters=3)
        return st.mean, st.lam2, fit.theta, fit.evidence

    before = sg.se_gram_cuda.launches
    card = run("cuda")
    assert sg.se_gram_cuda.launches == before
    for a, b in zip(card, run("cpu")):
        assert torch.isfinite(a).all()
        assert _relmax(a, b) <= 1e-9


@pytest.mark.gpu
def test_kin40k_dp_trainer_over_nccl_at_world_size_1_kernel_matches_plain_on_card():
    """``fit_kin40k_fast_dp`` at full width on a one-rank NCCL group, two
    epochs through the kernel (41 launches each) and through the plain
    Gram, held to each other as chip_smoke.py phase 6 holds the
    single-device trainer (1e-4 relative; measured ~2e-7)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.parallel import comm
    from gaussianprocessnode_tpu_torch.parallel.sharding import (fit_kin40k_fast_dp,
                                                                 shard_batched_data)

    theta0, Xu, Xb, yb, prior = runner.setup(runner.load_data("synthetic", 0, n_test=10),
                                             device="cuda")
    with comm.single_rank_group("cuda"):
        assert torch.distributed.get_backend() == "nccl"
        Xs, ys = shard_batched_data(Xb, yb)
        before = sg.se_gram_cuda.launches
        th_k, nat_k, _, _ = fit_kin40k_fast_dp(Kernel("se", "softplus", use_kernel=True), theta0,
                                               Xu, Xs, ys, prior, runner.W_VAL, 2)
        launches = sg.se_gram_cuda.launches - before
        th_p, nat_p, _, _ = fit_kin40k_fast_dp(Kernel("se", "softplus", use_kernel=False),
                                               theta0, Xu, Xs, ys, prior, runner.W_VAL, 2)
    assert launches == 2 * (1 + 2 * Xb.shape[0])
    for a, b in ((th_k, th_p), (nat_k.xi, nat_p.xi), (nat_k.prec, nat_p.prec)):
        a, b = a.double(), b.double()
        assert bool(torch.isfinite(a).all())
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-4


@pytest.mark.gpu
def test_ozaki_groups_are_exact_in_int32_at_k10000_on_card():
    """Each diagonal group's torch._int_mm (cuBLASLt's int8 GEMM) equals the
    exact integer product of the same chunks at K = 10,000 (inner lengths up
    to 80,000), and ozaki_matmul holds the host's f64 product to 1e-14
    relative (tests/test_ozaki.py's limit)."""
    _need_card()
    from gaussianprocessnode_tpu_torch.ops import ozaki

    rng = np.random.default_rng(11)
    k, S = 10_000, ozaki.OZAKI_SLICES
    x = rng.standard_normal((64, k))
    X = torch.as_tensor(x, device="cuda")
    Aall, BallT, _ = ozaki._operands(X, X.T, S)
    for s in range(S):
        Aop, Bop = ozaki._group(Aall, BallT, k, S, s)
        P = torch._int_mm(Aop, Bop).cpu().numpy().astype(np.int64)
        # integer partial sums ≤ 64·64·8·K < 2^53: the f64 product is exact
        ref = Aop.cpu().numpy().astype(np.float64) @ Bop.cpu().numpy().astype(np.float64)
        assert np.array_equal(P, ref.astype(np.int64)), s
    C = ozaki.ozaki_matmul(X, X.T).cpu().numpy()
    C_ref = x @ x.T
    assert np.abs(C - C_ref).max() / np.abs(C_ref).max() < 1e-14
    # shapes that need padding for torch._int_mm's rules
    a, b = rng.standard_normal((5, 13)), rng.standard_normal((13, 7))
    C = ozaki.ozaki_matmul(torch.as_tensor(a, device="cuda"),
                           torch.as_tensor(b, device="cuda")).cpu().numpy()
    assert np.abs(C - a @ b).max() / np.abs(a @ b).max() < 1e-14


@pytest.mark.gpu
def test_entry_float32_kernel_matches_float64_plain_on_card():
    """entry()'s forward step in float32 goes through the kernel (one
    launch) and holds the float64 plain route to the Gram's rounding bound
    carried through |K|ᵀ|μ_v|."""
    _need_card()
    from gaussianprocessnode_tpu_torch.entry import entry
    from gaussianprocessnode_tpu_torch.experiments.serving_bench import means_bound
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    fwd, args32 = entry(dtype=torch.float32)
    _, args64 = entry()
    before = sg.se_gram_cuda.launches
    m32 = fwd(*args32)
    assert sg.se_gram_cuda.launches == before + 1
    m64 = fwd(*args64)
    assert sg.se_gram_cuda.launches == before + 1
    theta, Xu, X, mu = args64
    scale, limit = means_bound(Kernel("se", transform="softplus"), theta, Xu, mu, X)
    assert float(((m32.double() - m64).abs() / scale).max()) <= limit
