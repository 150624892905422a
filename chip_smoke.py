#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaussianprocessnode_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernel with nvcc, holds it against its plain
PyTorch version on the card at every shape edge of its design, serves
kin40k-shaped requests through the port's serving path (the trained θ, ξ,
Λ of benchmarks/kin40k_refxu_trained.npz, inducing inputs and requests
drawn from --seed), checks the answers, times the kernel, trains the kin40k
fast trainer for three epochs at full width on synthetic data from --seed
(through the kernel, and again through the plain Gram, checked against each
other; epochs 2–3 under set_sync_debug_mode("error")), times a θ-step and a
statistics refresh, and prints

- a progress line, with elapsed seconds, before and after every phase;
- the card's name and power limit as nvidia-smi reports them;
- per timed Gram shape (serving 600×30000×8, training 600×10000×8,
  600×600×8 and 600×500×8): the kernel's device time (its launches replayed from a CUDA
  graph), its time in a Python loop of launches between CUDA events (host
  cost included), the time of ``fill_`` on an output of the same size (the
  store ceiling any store-bound kernel meets on this card), the bound, and
  the plain version's time;
- the training epochs' kernel launches, their agreement with the plain
  Gram's epochs, and a θ-step's and a refresh's device and host times;
- one JSON line {"kernels": [...]} with each kernel's launches on the
  serving path and per training epoch, its disagreement with the plain
  version and those times;
- as the last line, {"ok": true, "device": {...}}.

It exits non-zero, with no result line, when there is no CUDA card, when a
phase fails, or when it is run outside the repository. It imports nothing
of JAX.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
NPZ = ROOT / "benchmarks" / "kin40k_refxu_trained.npz"

# H100 SXM data sheet at its 700 W limit: HBM rate and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
EPS32 = float(np.finfo(np.float32).eps)

M_IND, D_IN = 600, 8          # kin40k: 600 inducing inputs, 8-D inputs
R_BATCHES, B_REQ = 64, 30000  # serving: 64 request batches of 30,000
W_MEAN = 1e4                  # noise precision of the golden kin40k state


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def gram_tolerance(Zs, Xs, variance) -> float:
    """Worst-case rounding bound on |K_kernel − K_plain| for the expanded
    form: each side's d² carries at most (D+2)·ε·(‖z‖² + ‖x‖²) of rounding
    (the D-term dot products and the two norms), K moves by at most σ²/2
    per unit of d², and exp and the σ² product add a few ulp of σ²."""
    D = Zs.shape[1]
    zz = float(torch.sum(Zs * Zs, dim=1).max())
    xx = float(torch.sum(Xs * Xs, dim=1).max())
    return float(variance) * EPS32 * (4.0 + (D + 2) * (zz + xx))


def gram_bound_ms(M: int, N: int, D: int) -> tuple[float, str, float, float]:
    """The least time the card could take: inputs read once (Z, X, ℓ, σ²),
    the output written once; operations 2·M·N·D for the cross term,
    2·(M+N)·D for the norms, 6·M·N for the epilogue (add, fma, clamp, scale,
    exp, product), all float32."""
    nbytes = 4.0 * (M * D + N * D + D + 1 + M * N)
    flops = 2.0 * M * N * D + 2.0 * (M + N) * D + 6.0 * M * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes, flops
    return t_ops * 1e3, "operations", nbytes, flops


def phase_device():
    say("phase 1/6 device: start")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "test needs an NVIDIA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}", flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    say("phase 1/6 device: done")
    return name, count, card


def phase_build():
    say("phase 2/6 build: start")
    from gaussianprocessnode_tpu_torch.ops import _build, se_gram

    se_gram._kernel_fn()
    info = _build.build_log()
    ptxas = " | ".join(line.strip() for line in info["ptxas"].splitlines()
                       if "ptxas" in line)
    print(f"build: built={info['built']} seconds={info['seconds']:.2f} "
          f"flags={' '.join(_build.NVCC_FLAGS)}", flush=True)
    print(f"ptxas -v: {ptxas or '(no report)'}", flush=True)
    say("phase 2/6 build: done")


def _held_to_plain(label, Z, X, var, ls, K):
    """max |K − plain| on the card, checked against gram_tolerance."""
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_reference

    K_ref = se_gram_reference(Z, X, var, ls)
    torch.cuda.synchronize()
    diff = (K - K_ref).abs()
    max_abs = float(diff.max())
    big = K_ref.abs() >= 1e-6 * float(var)
    max_rel = float((diff[big] / K_ref.abs()[big]).max()) if bool(big.any()) else 0.0
    tol = gram_tolerance(Z / ls, X / ls, var)
    ok = (tuple(K.shape) == (Z.shape[0], X.shape[0]) and
          bool(torch.isfinite(K).all()) and max_abs <= tol)
    print(f"kernel {label}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"(rel over |K|>=1e-6*var) tol={tol:.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"se_gram kernel disagrees with its plain version at {label}")
    return max_abs


def phase_kernel(theta):
    """Kernel against its plain version, both on the card, at every edge of
    the kernel's design: 40-row × 256-column tiles walked by persistent
    blocks strip by strip, 16-byte stores when N % 4 = 0 and 4-byte stores
    otherwise, 8 input dimensions per pass, Z rows in a window of 1,024."""
    say("phase 3/6 kernel vs plain: start")
    from gaussianprocessnode_tpu_torch.ops.kernels import softplus
    from gaussianprocessnode_tpu_torch.ops.se_gram import SE_GRAM_MAX_D, se_gram_cuda

    sp = softplus(torch.as_tensor(theta)).float()
    rng = np.random.default_rng(1234)

    def wide(D):  # lengthscales that keep d² of order 1 at wide D
        return torch.as_tensor(rng.uniform(8.0, 24.0, D), dtype=torch.float32)

    # (label, M, N, D, ℓ, σ², Kuu: X is Z)
    cases = [
        ("600x30000x8 ARD (serving; many more tiles than resident blocks)",
         600, 30000, 8, sp[1:], sp[0], False),
        ("600x10000x8 ARD (training Kux; N not a multiple of 256)",
         600, 10000, 8, sp[1:], sp[0], False),
        ("600x9999x8 ARD (N % 4 != 0: 4-byte stores)",
         600, 9999, 8, sp[1:], sp[0], False),
        ("600x600x8 ARD (training Kuu, K(Xu, Xu))", 600, 600, 8, sp[1:], sp[0], True),
        ("600x500x8 ARD (training Kux of a batch; fewer tiles than SMs)",
         600, 500, 8, sp[1:], sp[0], False),
        ("601x2052x8 ARD (M not a multiple of 40; a 4-column last strip)",
         601, 2052, 8, sp[1:], sp[0], False),
        ("1x30000x8 ARD (M = 1; fewer tiles than SMs)", 1, 30000, 8, sp[1:], sp[0], False),
        ("37x1001x3 scalar-l (fewer tiles than SMs; N % 4 != 0)",
         37, 1001, 3, torch.tensor(1.3), torch.tensor(0.9), False),
        ("300x5000x1 (D = 1)", 300, 5000, 1, torch.tensor(0.8), torch.tensor(1.1), False),
        ("129x1300x20 ARD (D = 20: 3 passes, the last partial)",
         129, 1300, 20, wide(20) / 4, torch.tensor(0.6), False),
        (f"70x300x{SE_GRAM_MAX_D} ARD (widest D)", 70, 300, SE_GRAM_MAX_D,
         wide(SE_GRAM_MAX_D), torch.tensor(1.7), False),
    ]
    results = {}
    for label, M, N, D, ls, var, kuu in cases:
        Z = torch.as_tensor(rng.standard_normal((M, D)), dtype=torch.float32).cuda()
        X = Z if kuu else torch.as_tensor(rng.standard_normal((N, D)),
                                          dtype=torch.float32).cuda()
        ls, var = ls.cuda().contiguous(), var.cuda()
        K = se_gram_cuda(Z, X, var, ls)
        results[label] = _held_to_plain(label, Z, X, var, ls, K)

    # two Grams back to back on one stream into different outputs, checked
    # after both ran: a staged buffer refilled while still read, or one
    # launch's stores racing the next launch, would show in either
    ls, var = sp[1:].cuda().contiguous(), sp[0].cuda()
    Z = torch.as_tensor(rng.standard_normal((600, 8)), dtype=torch.float32).cuda()
    X1 = torch.as_tensor(rng.standard_normal((30000, 8)), dtype=torch.float32).cuda()
    X2 = torch.as_tensor(rng.standard_normal((10000, 8)), dtype=torch.float32).cuda()
    K1 = se_gram_cuda(Z, X1, var, ls)
    K2 = se_gram_cuda(Z, X2, var, ls)
    _held_to_plain("back to back, first (600x30000x8)", Z, X1, var, ls, K1)
    _held_to_plain("back to back, second (600x10000x8)", Z, X2, var, ls, K2)
    say("phase 3/6 kernel vs plain: done")
    return results


def phase_serve(seed, z):
    say("phase 4/6 serving: start")
    from gaussianprocessnode_tpu_torch import MvGaussianNat, convert, serve
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    rng = np.random.default_rng(seed)
    Xu = rng.standard_normal((M_IND, D_IN))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((R_BATCHES, B_REQ, D_IN), generator=gen, device="cuda")

    handle = convert.serving_state_from_jax(
        z["theta"], Xu, z["xi"], z["prec"], W_MEAN,
        dtype=torch.float32, device="cuda")

    # f64 recovery on the card, held to the residual and to a host solve
    prec = torch.as_tensor(z["prec"], device="cuda")
    xi = torch.as_tensor(z["xi"], device="cuda")
    mu64 = serve._recover_mu_v(MvGaussianNat(xi, prec))
    resid = float(torch.linalg.norm(prec @ mu64 - xi) / torch.linalg.norm(xi))
    mu_np = np.linalg.solve(z["prec"], z["xi"])
    mu_rel = float(np.linalg.norm(mu64.cpu().numpy() - mu_np) / np.linalg.norm(mu_np))
    print(f"recovery (f64): |L mu - xi|/|xi| = {resid:.3e} (limit 1e-10); "
          f"|mu - solve|/|solve| = {mu_rel:.3e} (limit 1e-7)", flush=True)
    check(resid <= 1e-10 and mu_rel <= 1e-7, "mu_v recovery off")

    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    t = time.perf_counter()
    means, vars_ = serve.serve_fused(handle, X)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = se_gram_cuda.launches
    print(f"serve_fused: R={R_BATCHES} B={B_REQ} in {serve_s:.3f} s (first "
          f"call, host clock); se_gram launches = {launches}", flush=True)
    check(launches >= R_BATCHES, f"se_gram launched {launches} times, "
          f"expected at least {R_BATCHES}")
    check(tuple(means.shape) == (R_BATCHES, B_REQ) and
          tuple(vars_.shape) == (R_BATCHES, B_REQ), "output shapes")
    check(bool(torch.isfinite(means).all()), "non-finite means")
    check(bool((vars_ == torch.tensor(1.0 / W_MEAN, dtype=torch.float32)).all()),
          "predictive variances are not 1/w")

    # one batch against the same handle's plain path on the card; the bound
    # is the Gram's per-entry relative rounding bound carried through
    # |K|ᵀ|μ|, plus M·ε for each side's f32 mat-vec
    plain = dataclasses.replace(handle, kernel=Kernel("se", "softplus", use_kernel=False))
    m_plain, _ = plain(X[0])
    var, ls = plain.kernel.params(handle.theta)
    K0 = plain.kernel(handle.theta, handle.Xu, X[0])
    scale = K0.abs().T @ handle.mu_v.abs()
    gtol = gram_tolerance(handle.Xu / ls, X[0] / ls, var) / float(var)
    rel = float(((means[0] - m_plain).abs() / scale).max())
    lim = gtol + 2 * M_IND * EPS32
    print(f"means vs plain path (batch 0, f32, card): max |d|/(|K|^T|mu|) = "
          f"{rel:.3e} (limit {lim:.3e})", flush=True)
    check(rel <= lim, "served means disagree with the plain path")

    # a small input against float64 on the host: rounding θ, Xu and μ to
    # f32 moves each K entry by at most ε·(1 + d²) ≤ ε·(1 + 2(‖z‖²+‖x‖²))
    # relative, inside the Gram bound above, so the same limit holds
    n_small = 256
    h64 = dataclasses.replace(
        handle, kernel=Kernel("se", "softplus", use_kernel=False),
        theta=torch.as_tensor(z["theta"]), Xu=torch.as_tensor(Xu),
        mu_v=mu64.cpu(), w_mean=handle.w_mean.cpu())
    m64, _ = h64(X[0, :n_small].cpu().double())
    rel64 = float(((means[0, :n_small].cpu().double() - m64).abs()
                   / scale[:n_small].cpu().double()).max())
    print(f"means vs float64 host reference ({n_small} requests): "
          f"max |d|/(|K|^T|mu|) = {rel64:.3e} (limit {lim:.3e})", flush=True)
    check(rel64 <= lim, "served means disagree with the float64 reference")
    say("phase 4/6 serving: done")
    return handle, X, launches


# the Gram shapes timed: serving K(Xu, x*) per batch; the trainer's Kux of
# all training points (once per epoch), Kuu and a batch's Kux (20 times each
# per epoch)
TIMED_N = ((B_REQ, "serving"), (10000, "training Kux"), (M_IND, "training Kuu"),
           (500, "training Kux of a batch"))
L2_BYTES = 50e6  # H100 L2


def phase_times(handle, X, card):
    """Each Gram shape timed four ways on the card: the kernel's device time
    (a CUDA graph of 200 launches, replayed), the same launches from a
    Python loop between CUDA events (host cost included), ``fill_`` of an
    output of the same size (the store ceiling), and the plain version (a
    CUDA graph of 20 calls)."""
    say("phase 5/6 times: start")
    from gaussianprocessnode_tpu_torch import serve
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda, se_gram_reference
    from gaussianprocessnode_tpu_torch.utils.profiling import (cuda_graph_time_ms,
                                                                cuda_time_ms)

    # serving first, before any CUDA graph: after a graph's pool is
    # released, the first allocations read slower
    pps = serve.throughput_fused(handle, X[0], n_batches=R_BATCHES, iters=3)
    batch_ms = B_REQ / pps * 1e3
    # the host's own time to queue the 64 batches (no sync inside): when it
    # matches the time per batch, the host, not the card, sets the rate
    torch.cuda.synchronize()
    t = time.perf_counter()
    serve.serve_fused(handle, X)
    enqueue_ms = (time.perf_counter() - t) * 1e3 / R_BATCHES
    torch.cuda.synchronize()
    var, ls = handle.kernel.params(handle.theta)
    shapes = []
    for N, role in TIMED_N:
        Xn = handle.Xu if N == M_IND else X[0, :N].contiguous()
        out = torch.empty((M_IND, N), dtype=torch.float32, device="cuda")
        gram = lambda: se_gram_cuda(handle.Xu, Xn, var, ls)
        device_ms = cuda_graph_time_ms(gram, iters=200, warmup=5)
        store_ms = cuda_graph_time_ms(lambda: out.fill_(1.0), iters=200, warmup=5)
        device_ms_2 = cuda_graph_time_ms(gram, iters=200, warmup=5)
        host_ms = cuda_time_ms(gram, iters=200, warmup=10)
        plain_ms = cuda_graph_time_ms(lambda: se_gram_reference(handle.Xu, Xn, var, ls),
                                      iters=20, warmup=3)
        bound_ms, bound_by, nbytes, flops = gram_bound_ms(M_IND, N, D_IN)
        l2 = "fits in" if 4.0 * M_IND * N < L2_BYTES else "exceeds"
        row = dict(shape=[M_IND, N, D_IN], role=role, device_ms=device_ms,
                   device_ms_repeat=device_ms_2, host_loop_ms=host_ms,
                   store_ceiling_ms=store_ms, bound_ms=bound_ms, bound_by=bound_by,
                   roofline_share=bound_ms / device_ms, plain_ms=plain_ms,
                   library_ms=None, output_vs_l2=f"output {l2} the 50 MB L2")
        shapes.append(row)
        print(f"se_gram {M_IND}x{N}x{D_IN} ({role}): device {device_ms:.5f} ms "
              f"(again {device_ms_2:.5f}), host loop {host_ms:.5f} ms, fill_ store "
              f"ceiling {store_ms:.5f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), roofline share "
              f"{bound_ms / device_ms:.3f}, share of fill_ {store_ms / device_ms:.3f}, "
              f"plain version {plain_ms:.5f} ms (no yardstick: same arithmetic, "
              f"unfused), library none; output {l2} L2 [{card}]", flush=True)
    K = se_gram_cuda(handle.Xu, X[0], var, ls)
    mv_ms = cuda_graph_time_ms(lambda: K.T @ handle.mu_v, iters=50, warmup=3)
    gram_ms = shapes[0]["device_ms"]
    print(f"serve_fused: {pps:.6e} predictions/s (R={R_BATCHES}, B={B_REQ}, "
          f"host clock between synchronisations) = {batch_ms:.5f} ms per batch: "
          f"Gram kernel {gram_ms:.5f} ms, mat-vec K^T mu {mv_ms:.5f} ms (device "
          f"time, CUDA graph), rest {batch_ms - gram_ms - mv_ms:.5f} ms; host time "
          f"to queue one batch {enqueue_ms:.5f} ms [{card}]", flush=True)
    say("phase 5/6 times: done")
    return shapes, dict(pps=pps, batch_ms=batch_ms, matvec_ms=mv_ms,
                        enqueue_ms=enqueue_ms)


N_TRAIN, BATCH, EPOCHS = 10000, 500, 3   # kin40k training: 20 batches of 500
LAUNCHES_PER_EPOCH = 1 + 2 * (N_TRAIN // BATCH)  # K(Xu, X); Kuu and Kux per θ-step
# kernel-trained against plain-trained epochs, relative 2-norm on θ, ξ, Λ:
# the two Grams differ by the f32 rounding bound above (~1e-6 of σ²); the
# 20 AdaMax steps of an epoch move θ by at most lr = 1e-3 each, scaled by
# the gradient's relative change, and ξ, Λ follow θ through the Gram. The
# JAX and torch trainers, which differ by such rounding, agree to 2.3e-6
# over three epochs (tests/test_torch_minibatch.py); 1e-4 leaves room for
# κ(Kuu) at M = 600.
TRAIN_RTOL = 1e-4


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_train(seed, card):
    """The kin40k fast trainer at full width (M = 600, D = 8, N = 10,000 in
    20 batches of 500, one statistics refresh per epoch) on synthetic data
    from ``seed``: three epochs through the kernel and three through the
    plain Gram from the same start, held to each other after each epoch;
    41 kernel launches per epoch; epochs 2 and 3 under
    ``set_sync_debug_mode("error")``. Then a θ-step and a statistics refresh
    timed on a copy of the carry: device time from a CUDA graph of the step
    (a step with a host sync could not be captured), and host time eager;
    and one eager epoch's device time by kernel group from a profiler
    trace."""
    say("phase 6/6 training: start")
    from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
    from gaussianprocessnode_tpu_torch.infer.minibatch import (FastCarry, fast_epoch_steps,
                                                               fast_optimizer,
                                                               fit_kin40k_fast)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.metrics import smse
    from gaussianprocessnode_tpu_torch.utils.profiling import (cuda_graph_time_ms,
                                                                cuda_kernel_times)

    ds = runner.load_data("synthetic", seed)
    theta0, Xu, Xb, yb, prior = runner.setup(ds, M_IND, BATCH, N_TRAIN, seed, "cuda")
    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)

    def epoch(kernel, carry):
        return fit_kin40k_fast(kernel, theta0, Xu, Xb, yb, prior, runner.W_VAL, 1,
                               resume_state=carry)

    carry_k = carry_p = None
    launches, epoch_ms, diffs = [], [], []
    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    for e in range(EPOCHS):
        before = se_gram_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if e > 0 else "default")
        try:
            th_k, nat_k, cov_k, carry_k = epoch(kern, carry_k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(se_gram_cuda.launches - before)
        th_p, nat_p, _, carry_p = epoch(plain, carry_p)
        check(se_gram_cuda.launches - before == launches[-1], "the plain Gram launched the kernel")
        d = dict(theta=_rel(th_k, th_p), xi=_rel(nat_k.xi, nat_p.xi),
                 prec=_rel(nat_k.prec, nat_p.prec))
        diffs.append(d)
        finite = all(bool(torch.isfinite(t_).all())
                     for t_ in (th_k, nat_k.xi, nat_k.prec, cov_k, th_p, nat_p.prec))
        print(f"epoch {e + 1}: kernel route {epoch_ms[-1]:.1f} ms (host clock, "
              f"{'sync debug mode error' if e > 0 else 'first epoch'}), se_gram "
              f"launches {launches[-1]}; kernel vs plain relative: theta "
              f"{d['theta']:.3e}, xi {d['xi']:.3e}, Lambda {d['prec']:.3e} (limit "
              f"{TRAIN_RTOL:.0e}); finite {finite}", flush=True)
        check(finite, f"non-finite trainer state after epoch {e + 1}")
        check(launches[-1] == LAUNCHES_PER_EPOCH,
              f"{launches[-1]} kernel launches in epoch {e + 1}, expected {LAUNCHES_PER_EPOCH}")
        check(max(d.values()) <= TRAIN_RTOL,
              f"kernel-trained and plain-trained epoch {e + 1} disagree: {d}")
    total = se_gram_cuda.launches

    X_test = torch.as_tensor(ds.x_test, dtype=torch.float32, device=Xu.device)
    mean = runner.predict(kern, th_k, Xu, nat_k, cov_k, X_test)
    score = float(smse(torch.as_tensor(ds.y_test), mean.cpu().double()))
    print(f"SMSE after {EPOCHS} epochs on {X_test.shape[0]} synthetic test points: "
          f"{score:.6f} (a zero predictor scores ~1)", flush=True)
    check(score == score and score < 1.0, f"SMSE {score} after {EPOCHS} epochs")

    # one θ-step and one refresh on a copy of the carry
    c = FastCarry(*(t_.clone() for t_ in carry_k[:4]),
                  {k: v.clone() for k, v in carry_k.opt_state.items()},
                  carry_k.kuu_inv.clone())
    refresh, theta_step = fast_epoch_steps(kern, Xu, prior, runner.W_VAL,
                                           fast_optimizer(1e-3), torch.float32)
    xi0, prec0 = prior.xi.double(), prior.prec.double()
    Xall, yall = Xb.reshape(-1, D_IN), yb.reshape(-1)
    _, _, _, mu_v, Rv = refresh(c.theta, xi0, prec0, c.covs64[0], Xall, yall)

    def step():
        theta_step(c.theta, c.opt_state, c.kuu_inv, (Xb[0], yb[0], mu_v, Rv))

    def refresh_once():
        refresh(c.theta, xi0, prec0, c.covs64[0], Xall, yall)

    def eager_ms(fn, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        queued = time.perf_counter() - t
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n, queued * 1e3 / n

    def one_epoch():
        _, _, cov, mu, R = refresh(c.theta, xi0, prec0, c.covs64[0], Xall, yall)
        c.covs64[0].copy_(cov)
        for b in range(N_TRAIN // BATCH):
            theta_step(c.theta, c.opt_state, c.kuu_inv, (Xb[b], yb[b], mu, R))

    # one eager epoch under torch.profiler: device time by kernel group
    prof_wall, kernels = cuda_kernel_times(one_epoch)
    groups = {"se_gram kernel": [0, 0.0], "GEMM (cuBLAS)": [0, 0.0], "other": [0, 0.0]}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        g = ("se_gram kernel" if "se_gram" in low else
             "GEMM (cuBLAS)" if any(k in low for k in ("gemm", "cutlass", "xmma")) else
             "other")
        groups[g][0] += n
        groups[g][1] += ms
    prof_dev = sum(ms for _, ms in groups.values())
    if kernels:
        print(f"profiled eager epoch: wall {prof_wall:.2f} ms (profiler on), device "
              f"{prof_dev:.2f} ms, busy share {prof_dev / prof_wall:.3f}; " +
              "; ".join(f"{g} {ms:.3f} ms in {n} launches" for g, (n, ms) in groups.items())
              + f" [{card}]", flush=True)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (n, ms) in top:
            print(f"  {ms:8.3f} ms {n:6d} x {name[:110]}", flush=True)
    else:
        print("profiled eager epoch: the profiler recorded no device time "
              "(not measured)", flush=True)

    step_eager, step_queue = eager_ms(step, 20)
    ref_eager, ref_queue = eager_ms(refresh_once, 5)
    step_dev = cuda_graph_time_ms(step, iters=20, warmup=3)
    ref_dev = cuda_graph_time_ms(refresh_once, iters=5, warmup=2)
    step_eager_2, _ = eager_ms(step, 20)
    epoch_host = sum(epoch_ms[1:]) / (EPOCHS - 1)
    busy = (N_TRAIN // BATCH) * step_dev + ref_dev
    print(f"theta-step: device {step_dev:.4f} ms (CUDA graph of 20 steps), eager "
          f"{step_eager:.4f} ms (again {step_eager_2:.4f}; host clock, 20 steps "
          f"between synchronisations), host time to queue one {step_queue:.4f} ms "
          f"[{card}]", flush=True)
    print(f"statistics refresh: device {ref_dev:.4f} ms (CUDA graph of 5), eager "
          f"{ref_eager:.4f} ms, host time to queue one {ref_queue:.4f} ms [{card}]",
          flush=True)
    print(f"epoch: host {epoch_host:.2f} ms (mean of epochs 2-{EPOCHS}); device work "
          f"{busy:.2f} ms (20 steps + 1 refresh by graph) -> card idle "
          f"{1.0 - busy / epoch_host:.3f} of the epoch [{card}]", flush=True)
    say("phase 6/6 training: done")
    return dict(launches_per_epoch=launches, launches=total, epoch_host_ms=epoch_ms,
                kernel_vs_plain=diffs, smse_3_epochs=score,
                theta_step_device_ms=step_dev, theta_step_eager_ms=step_eager,
                theta_step_eager_ms_again=step_eager_2, theta_step_queue_ms=step_queue,
                refresh_device_ms=ref_dev, refresh_eager_ms=ref_eager,
                refresh_queue_ms=ref_queue, epoch_device_ms=busy,
                idle_share=1.0 - busy / epoch_host,
                profiled_epoch={"wall_ms": prof_wall, "device_ms": prof_dev,
                                "by_group": {g: {"launches": n, "ms": ms}
                                             for g, (n, ms) in groups.items()}}
                if kernels else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        name, count, card = phase_device()
        if not NPZ.is_file():
            raise SmokeFailure(f"{NPZ} missing: run from a checkout of the repository")
        try:
            import gaussianprocessnode_tpu_torch  # noqa: F401
        except ImportError as e:
            raise SmokeFailure(f"the port is not importable ({e}): run from "
                               "the root of the repository") from e
        phase_build()
        z = dict(np.load(NPZ, allow_pickle=False))
        diffs = phase_kernel(z["theta"])
        handle, X, launches = phase_serve(args.seed, z)
        shapes, serving = phase_times(handle, X, card)
        train = phase_train(args.seed, card)
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    t30, t10, t600, t500 = shapes
    max_abs = diffs["600x30000x8 ARD (serving; many more tiles than resident blocks)"]
    kernel = {
        "name": "se_gram",
        "route": "cuda",
        "source": "gaussianprocessnode_tpu_torch/ops/csrc/se_gram.cu",
        "replaces": "gaussianprocessnode_tpu/ops/pallas_gram.py:34",
        "tpu_kernel": "ops/pallas_gram.py::_gram_kernel",
        "launches": launches + train["launches"],
        "launches_by_path": {"serving": launches, "training": train["launches"]},
        "launches_training_per_epoch": train["launches_per_epoch"],
        "max_abs_err": max_abs,
        "max_abs_diff": max_abs,
        "ms": t30["device_ms"],
        "device_ms": t30["device_ms"],
        "host_loop_ms": t30["host_loop_ms"],
        "store_ceiling_ms": t30["store_ceiling_ms"],
        "plain_ms": t30["plain_ms"],
        "bound_ms": t30["bound_ms"],
        "bound_us": t30["bound_ms"] * 1e3,
        "bound_by": t30["bound_by"],
        "library_ms": None,
        "shape": t30["shape"],
        "shapes": shapes,
        "ms_600x10000": t10["device_ms"],
        "plain_ms_600x10000": t10["plain_ms"],
        "bound_ms_600x10000": t10["bound_ms"],
        "ms_600x600": t600["device_ms"],
        "plain_ms_600x600": t600["plain_ms"],
        "bound_ms_600x600": t600["bound_ms"],
        "ms_600x500": t500["device_ms"],
        "host_loop_ms_600x500": t500["host_loop_ms"],
        "store_ceiling_ms_600x500": t500["store_ceiling_ms"],
        "plain_ms_600x500": t500["plain_ms"],
        "bound_ms_600x500": t500["bound_ms"],
        "training": train,
        "serve_fused_preds_per_s": serving["pps"],
        "serve_batch_ms": serving["batch_ms"],
        "serve_enqueue_ms": serving["enqueue_ms"],
        "matvec_ms": serving["matvec_ms"],
        "card": card,
    }
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    say("all phases passed")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
