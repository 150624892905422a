#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaussianprocessnode_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernel with nvcc, holds it against its plain
PyTorch version on the card at every shape edge of its design and at every
shape the main paths launch, serves kin40k-shaped requests through the
port's serving path (the trained θ, ξ, Λ of
benchmarks/kin40k_refxu_trained.npz, inducing inputs and requests drawn
from --seed), checks the answers, times the kernel, trains the kin40k
fast trainer for three epochs at full width on synthetic data from --seed
(through the kernel, and again through the plain Gram, checked against each
other; epochs 2–3 under set_sync_debug_mode("error")), times a θ-step and a
statistics refresh; then trains the banana probit classifier at full width
(M = 500, D = 2, 4,000 points in 20 batches of 200; synthetic data from
--seed) for three fast epochs, two per-batch (``fit_banana``) epochs, and
two float32 epochs of the per-batch kin40k trainer (``fit_kin40k``), each
through the kernel and through the plain Gram, held to each other; and
serves the banana classifier (benchmarks/banana_refxu_trained.npz, inducing
inputs and 64 batches of 30,000 requests from --seed), checked against its
plain path and a float64 host reference; and trains the two toy workloads
(toy regression 3 epochs, toy classification 2, in float64, held to the
same epochs on the host, their syncs counted; one float32 epoch of each
through the kernel held to the plain Gram; the expected-Ψ point Grams
kernel against plain); trains the VSGP baselines at kin40k width (50
collapsed-bound steps, two minibatch ``fit_svgp`` epochs and 20 FITC
steps, each through the kernel and through the plain Gram, held to each
other; the collapsed θ scored in float64 on the card and held to the host);
evaluates the pendulum GPSSM's M-step objective and its gradient in
float32 (kernel against plain) and the MultiSGP node's rules in float64
(card against host); and runs the pendulum GPSSM family at the runner's
full width (T = 300 / 400, M = 48, D = 2): the runner itself for 2
epochs, then its epochs, the Jacobi, Gauss-Seidel, parallel-in-time and
controlled smoothers and the streaming filter through the kernel and
through the plain Gram, held to each other, with float64 sweeps and the UT
smoother held card against host; and runs the GPLVM at the runner's
width (N = 200, D = 12, Din = 2, M = 30, synthetic oil-flow data from
--seed): 2 epochs of ``fit_gplvm_grad`` in float64 on the card and on the
host, held to each other, the embedding of the training rows (a fixed
point) and of 40 held-out rows, the float32 Ψ-statistics and one sweep
through the kernel against the plain Gram, and each model front-end class
against its direct call; and runs the legacy-notebook families in float64
(the main path: padscale's sequential and parallel-in-time smoothers at
T = 2^17, held to each other by the JAX runner's cross-check; the parallel
smoother at T = 2^13 and the runner's tprocess, sde, fullcov, pad, pad2,
control and a cut padlearn on the card against the host; a profiled
smoother call and colored-EM epoch; no kernel launches); and runs the
parallel layer at world size 1 over NCCL (one card: NCCL refuses two ranks
on one device), at full width: the data-parallel kin40k and banana
trainers (3 epochs each, through the kernel; epochs 2-3 under
set_sync_debug_mode("error")) held bit for bit to the single-device
trainers and the kin40k one to its plain-Gram route, the tensor-parallel
sweep (M = 600) and prediction held to the dense sweep, and the
sequence-parallel GPSSM smoother (T = 300, M = 48, 25 sweeps, float32)
held to the Jacobi smoother; and, last, runs the Ozaki f64 product
(``ops/ozaki.py``, int8 groups on cuBLASLt through ``torch._int_mm``, a
library route and not a ported kernel): ``torch._int_mm``'s shape rules and
layouts, each group's int32 product at K = 10,000 against the exact
integer product, the result against the host's f64 product at 600^3, at
the 600×10000 SYRK and at a κ = 1e12 SPD 96^3 case, device times against
cuBLAS's f64 product there and in a 28-iteration Newton–Schulz chain on
the trained Λ; the serving record (``experiments/serving_bench.py``: its
gate, then 1024- and 30,000-request batches one call each and 64 batches
of 30,000 queued back to back) and the flagship forward step
(``entry.py``) in float32 through the kernel against float64. It prints

- a progress line, with elapsed seconds, before and after every phase;
- the card's name and power limit as nvidia-smi reports them;
- per timed Gram shape (serving 600×30000×8, training 600×10000×8,
  600×600×8 and 600×500×8; banana 500×4000×2, 500×500×2, 500×200×2 and
  the test predictions 500×1300×2; classifier serving 500×30000×2; the toy
  workloads' Kuu, Kux, test rows and expected-Ψ point Grams; the pendulum
  objective's 48×1200×2 and 48×48×2; the GPSSM chain's 48×1200×2, its
  filter step's 48×4×2 and the controlled chain's Ψ Gram 48×1800×3; the
  GPLVM's 30×800×2 and 30×30×2): the
  kernel's device time (its launches replayed from a CUDA graph), its time
  in a Python loop of launches between CUDA events (host cost included),
  the time of ``fill_`` on an output of the same size (the store ceiling
  any store-bound kernel meets on this card), the bound, and the plain
  version's time;
- the training epochs' kernel launches, their agreement with the plain
  Gram's epochs, and a θ-step's and a statistics pass's device and host
  times, for kin40k and banana; a collapsed VSGP step's device and host
  times;
- phase 16's readings, and one JSON line {"library_routes": [...]} with
  the Ozaki product's (a cuBLASLt route, not a ported kernel);
- one JSON line {"kernels": [...]} with each kernel's launches on every
  path (``launches_by_path``), its disagreement with the plain version and
  those times;
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
    say("phase 1/16 device: start")
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
    say("phase 1/16 device: done")
    return name, count, card


def phase_build():
    say("phase 2/16 build: start")
    from gaussianprocessnode_tpu_torch.ops import _build, se_gram

    se_gram._kernel_fn()
    info = _build.build_log()
    ptxas = " | ".join(line.strip() for line in info["ptxas"].splitlines()
                       if "ptxas" in line)
    print(f"build: built={info['built']} seconds={info['seconds']:.2f} "
          f"flags={' '.join(_build.NVCC_FLAGS)}", flush=True)
    print(f"ptxas -v: {ptxas or '(no report)'}", flush=True)
    say("phase 2/16 build: done")


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


def phase_kernel(theta, theta_banana):
    """Kernel against its plain version, both on the card, at every edge of
    the kernel's design (40-row × 256-column tiles walked by persistent
    blocks strip by strip, 16-byte stores when N % 4 = 0 and 4-byte stores
    otherwise, 8 input dimensions per pass, Z rows in a window of 1,024)
    and at every shape the main paths launch: kin40k's at its trained θ,
    banana's and the classifier's (M = 500, D = 2) at θ0 = softplus⁻¹(1)
    where training starts and at the trained banana θ."""
    say("phase 3/16 kernel vs plain: start")
    from gaussianprocessnode_tpu_torch.ops.kernels import softplus
    from gaussianprocessnode_tpu_torch.ops.se_gram import SE_GRAM_MAX_D, se_gram_cuda

    sp = softplus(torch.as_tensor(theta)).float()
    sp_ban = softplus(torch.as_tensor(theta_banana)).float()
    one, one_2 = torch.tensor(1.0), torch.ones(D_BAN)  # softplus(θ0) of the banana runner
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
        # banana training at θ0 (M = 500: 12.5 tiles of 40 rows)
        ("500x4000x2 ARD theta0 (banana Kux of all points)",
         500, 4000, 2, one_2, one, False),
        ("500x500x2 ARD theta0 (banana Kuu, K(Xu, Xu))", 500, 500, 2, one_2, one, True),
        ("500x200x2 ARD theta0 (banana Kux of a batch; N < one 256-wide tile)",
         500, 200, 2, one_2, one, False),
        # the same at the trained banana θ, with the test and serving shapes
        ("500x4000x2 ARD trained (banana Kux of all points)",
         500, 4000, 2, sp_ban[1:], sp_ban[0], False),
        ("500x500x2 ARD trained (banana Kuu, K(Xu, Xu))",
         500, 500, 2, sp_ban[1:], sp_ban[0], True),
        ("500x200x2 ARD trained (banana Kux of a batch)",
         500, 200, 2, sp_ban[1:], sp_ban[0], False),
        ("500x1300x2 ARD trained (banana test predictions)",
         500, 1300, 2, sp_ban[1:], sp_ban[0], False),
        ("500x30000x2 ARD trained (classifier serving)",
         500, 30000, 2, sp_ban[1:], sp_ban[0], False),
    ] + [
        # the toy workloads' float32 route at θ0 = softplus⁻¹(1): Kuu, Kux,
        # test rows and the expected-Ψ point Grams (GH-21 and GenUT points)
        (f"{M}x{N}x1 theta0 ({role})", M, N, 1, one, one, N == M)
        for M, N, role in TOY_GRAM_SHAPES
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
    say("phase 3/16 kernel vs plain: done")
    return results


def phase_serve(seed, z):
    say("phase 4/16 serving: start")
    from gaussianprocessnode_tpu_torch import MvGaussianNat, convert, serve
    from gaussianprocessnode_tpu_torch.experiments import serving_bench
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
    scale, lim = serving_bench.means_bound(plain.kernel, handle.theta, handle.Xu,
                                           handle.mu_v, X[0])
    rel = float(((means[0] - m_plain).abs() / scale).max())
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
    say("phase 4/16 serving: done")
    return handle, X, launches


# the Gram shapes timed: serving K(Xu, x*) per batch; the trainer's Kux of
# all training points (once per epoch), Kuu and a batch's Kux (20 times each
# per epoch)
TIMED_N = ((B_REQ, "serving"), (10000, "training Kux"), (M_IND, "training Kuu"),
           (500, "training Kux of a batch"))
L2_BYTES = 50e6  # H100 L2


def time_gram(Z, X, var, ls, role, card) -> dict:
    """One Gram shape K(Z, X) timed four ways on the card: the kernel's
    device time (a CUDA graph of 200 launches, replayed; twice), the same
    launches from a Python loop between CUDA events (host cost included),
    ``fill_`` of an output of the same size (the store ceiling), and the
    plain version (a CUDA graph of 20 calls); with the bound. Launches made
    here are not counted on any path."""
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda, se_gram_reference
    from gaussianprocessnode_tpu_torch.utils.profiling import (cuda_graph_time_ms,
                                                                cuda_time_ms)

    M, N, D = Z.shape[0], X.shape[0], Z.shape[1]
    launches = se_gram_cuda.launches
    out = torch.empty((M, N), dtype=torch.float32, device="cuda")
    gram = lambda: se_gram_cuda(Z, X, var, ls)  # noqa: E731
    device_ms = cuda_graph_time_ms(gram, iters=200, warmup=5)
    store_ms = cuda_graph_time_ms(lambda: out.fill_(1.0), iters=200, warmup=5)
    device_ms_2 = cuda_graph_time_ms(gram, iters=200, warmup=5)
    host_ms = cuda_time_ms(gram, iters=200, warmup=10)
    plain_ms = cuda_graph_time_ms(lambda: se_gram_reference(Z, X, var, ls), iters=20, warmup=3)
    se_gram_cuda.launches = launches
    bound_ms, bound_by, nbytes, flops = gram_bound_ms(M, N, D)
    l2 = "fits in" if 4.0 * M * N < L2_BYTES else "exceeds"
    print(f"se_gram {M}x{N}x{D} ({role}): device {device_ms:.5f} ms "
          f"(again {device_ms_2:.5f}), host loop {host_ms:.5f} ms, fill_ store "
          f"ceiling {store_ms:.5f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP), roofline share "
          f"{bound_ms / device_ms:.3f}, share of fill_ {store_ms / device_ms:.3f}, "
          f"plain version {plain_ms:.5f} ms (no yardstick: same arithmetic, "
          f"unfused), library none; output {l2} L2 [{card}]", flush=True)
    return dict(shape=[M, N, D], role=role, device_ms=device_ms,
                device_ms_repeat=device_ms_2, host_loop_ms=host_ms,
                store_ceiling_ms=store_ms, bound_ms=bound_ms, bound_by=bound_by,
                roofline_share=bound_ms / device_ms, plain_ms=plain_ms,
                library_ms=None, output_vs_l2=f"output {l2} the 50 MB L2")


def serving_rate(handle, X):
    """``serve_fused`` of R copies of the batch X[0]: predictions per second
    and ms per batch (host clock between synchronisations, 3 calls after a
    warm-up), and the host's own time to queue one batch of X (no sync
    inside: when it matches the time per batch, the host, not the card,
    sets the rate). Launches made here are not counted on any path."""
    from gaussianprocessnode_tpu_torch import serve
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    launches = se_gram_cuda.launches
    R, B = X.shape[0], X.shape[1]
    pps = serve.throughput_fused(handle, X[0], n_batches=R, iters=3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    serve.serve_fused(handle, X)
    enqueue_ms = (time.perf_counter() - t) * 1e3 / R
    torch.cuda.synchronize()
    se_gram_cuda.launches = launches
    return pps, B / pps * 1e3, enqueue_ms


def phase_times(handle, X, card):
    """Each Gram shape timed four ways on the card: the kernel's device time
    (a CUDA graph of 200 launches, replayed), the same launches from a
    Python loop between CUDA events (host cost included), ``fill_`` of an
    output of the same size (the store ceiling), and the plain version (a
    CUDA graph of 20 calls)."""
    say("phase 5/16 times: start")
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

    # serving first, before any CUDA graph: after a graph's pool is
    # released, the first allocations read slower
    pps, batch_ms, enqueue_ms = serving_rate(handle, X)
    var, ls = handle.kernel.params(handle.theta)
    shapes = [time_gram(handle.Xu, handle.Xu if N == M_IND else X[0, :N].contiguous(),
                        var, ls, role, card) for N, role in TIMED_N]
    K = se_gram_cuda(handle.Xu, X[0], var, ls)
    mv_ms = cuda_graph_time_ms(lambda: K.T @ handle.mu_v, iters=50, warmup=3)
    gram_ms = shapes[0]["device_ms"]
    print(f"serve_fused: {pps:.6e} predictions/s (R={R_BATCHES}, B={B_REQ}, "
          f"host clock between synchronisations) = {batch_ms:.5f} ms per batch: "
          f"Gram kernel {gram_ms:.5f} ms, mat-vec K^T mu {mv_ms:.5f} ms (device "
          f"time, CUDA graph), rest {batch_ms - gram_ms - mv_ms:.5f} ms; host time "
          f"to queue one batch {enqueue_ms:.5f} ms [{card}]", flush=True)
    say("phase 5/16 times: done")
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


def eager_ms(fn, n):
    """Mean host ms per call of ``fn()`` over ``n`` calls between two
    synchronisations, and the host's ms per call to queue them."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    queued = time.perf_counter() - t
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n, queued * 1e3 / n


def profile_epoch(fn, label, card):
    """One call of ``fn`` (an eager epoch) under torch.profiler: its wall
    time (profiler on), its device time by kernel group (the se_gram
    kernel, cuBLAS GEMMs, the rest) and the six longest kernels, printed;
    None where the profiler records no device time."""
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_kernel_times

    wall, kernels = cuda_kernel_times(fn)
    if not kernels:
        print(f"{label}: the profiler recorded no device time (not measured)", flush=True)
        return None
    groups = {"se_gram kernel": [0, 0.0], "GEMM (cuBLAS)": [0, 0.0], "other": [0, 0.0]}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        g = ("se_gram kernel" if "se_gram" in low else
             "GEMM (cuBLAS)" if any(k in low for k in ("gemm", "cutlass", "xmma")) else
             "other")
        groups[g][0] += n
        groups[g][1] += ms
    device = sum(ms for _, ms in groups.values())
    print(f"{label}: wall {wall:.2f} ms (profiler on), device {device:.2f} ms, busy share "
          f"{device / wall:.3f}; "
          + "; ".join(f"{g} {ms:.3f} ms in {n} launches" for g, (n, ms) in groups.items())
          + f" [{card}]", flush=True)
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"  {ms:8.3f} ms {n:6d} x {name[:110]}", flush=True)
    return {"wall_ms": wall, "device_ms": device,
            "by_group": {g: {"launches": n, "ms": ms} for g, (n, ms) in groups.items()}}


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
    say("phase 6/16 training: start")
    from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
    from gaussianprocessnode_tpu_torch.infer.minibatch import (FastCarry, fast_epoch_steps,
                                                               fast_optimizer,
                                                               fit_kin40k_fast)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.metrics import smse
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

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

    def one_epoch():
        _, _, cov, mu, R = refresh(c.theta, xi0, prec0, c.covs64[0], Xall, yall)
        c.covs64[0].copy_(cov)
        for b in range(N_TRAIN // BATCH):
            theta_step(c.theta, c.opt_state, c.kuu_inv, (Xb[b], yb[b], mu, R))

    # one eager epoch under torch.profiler: device time by kernel group
    profiled = profile_epoch(one_epoch, "profiled eager epoch", card)

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
    say("phase 6/16 training: done")
    return dict(launches_per_epoch=launches, launches=total, epoch_host_ms=epoch_ms,
                kernel_vs_plain=diffs, smse_3_epochs=score,
                theta_step_device_ms=step_dev, theta_step_eager_ms=step_eager,
                theta_step_eager_ms_again=step_eager_2, theta_step_queue_ms=step_queue,
                refresh_device_ms=ref_dev, refresh_eager_ms=ref_eager,
                refresh_queue_ms=ref_queue, epoch_device_ms=busy,
                idle_share=1.0 - busy / epoch_host,
                profiled_epoch=profiled)


M_BAN, D_BAN = 500, 2                  # banana: 500 inducing inputs, 2-D inputs
N_BAN, BATCH_BAN = 4000, 200           # banana training: 20 batches of 200
BAN_BATCHES = N_BAN // BATCH_BAN
# fast epoch: K(Xu, X) once, Kuu and Kux per θ-step; per-batch schedules:
# the batch's Kux, then Kuu and Kux in its θ-step
BANANA_LAUNCHES_PER_EPOCH = 1 + 2 * BAN_BATCHES
FAITHFUL_LAUNCHES_PER_BATCH = 3
FAITHFUL_EPOCHS = 2
BANANA_NPZ = ROOT / "benchmarks" / "banana_refxu_trained.npz"
# The first statistics pass from the cold carry evaluates the q(w) term
# I1 = kxx − kᵀKuu⁻¹k with the cold Kuu⁻¹ (entries up to ~3e4 at θ0), where
# it is float32 rounding noise: on an H100, half-ulp random perturbations of
# the plain Gram moved the q(w) rate after that epoch by up to 9.6e-5 (16
# twins, seed 0) and 2.85e-4 (8 twins, seed 1), and the kernel route by
# 1.8e-4 and 6.5e-5; from the carry after one epoch every field moved by at
# most 1.9e-5, kernel and twins alike (scripts/banana_rounding_sensitivity.py
# --device cuda). So the cold epoch holds the rate to COLD_RATE_RTOL, three
# times the largest twin, and the other fields to TRAIN_RTOL; the compared
# runs then start from the plain route's carry after that epoch, where
# TRAIN_RTOL holds every field with a margin.
COLD_RATE_RTOL = 9e-4


def _held(label, kern_out, plain_out, names, limits=None):
    """Relative 2-norm differences, kernel route against plain route, of
    matching outputs; each checked against its limit (TRAIN_RTOL unless
    ``limits`` names another)."""
    limits = limits or {}
    d = {n: _rel(a, b) for n, a, b in zip(names, kern_out, plain_out)}
    finite = all(bool(torch.isfinite(t_).all()) for t_ in (*kern_out, *plain_out))
    print(f"{label}: kernel vs plain relative: "
          + ", ".join(f"{n} {v:.3e} (limit {limits.get(n, TRAIN_RTOL):.0e})"
                      for n, v in d.items()) + f"; finite {finite}", flush=True)
    check(finite, f"{label}: non-finite state")
    check(all(v <= limits.get(n, TRAIN_RTOL) for n, v in d.items()),
          f"{label}: kernel and plain routes disagree: {d}")
    return d


def phase_banana(seed, card):
    """Banana probit classification at full width (M = 500, D = 2, N = 4,000
    in 20 batches of 200) on synthetic data from ``seed``:

    - ``fit_banana_fast``, the first (cold) epoch through the kernel and
      through the plain Gram from one initial carry, then three epochs of
      each from the plain route's carry after it, held to each other after
      each epoch (θ, ξ, Λ, w_shape, w_rate; see COLD_RATE_RTOL); 41 launches
      per epoch; the three later epochs under
      ``set_sync_debug_mode("error")``; the test error after them;
    - ``fit_banana`` (per batch), two epochs from that carry, kernel against
      plain;
    - ``fit_kin40k`` (per batch) in float32 at kin40k width (M = 600, D = 8,
      20 batches of 500), two epochs, kernel against plain;
    - a fast epoch's θ-step and statistics pass timed: device time by CUDA
      graph, host time eager; and the Gram at the banana shapes.

    Each path's launch count is set to 0 just before it and read just
    after."""
    say("phase 7/16 banana training: start")
    from gaussianprocessnode_tpu_torch.experiments import banana as brunner
    from gaussianprocessnode_tpu_torch.experiments import kin40k as krunner
    from gaussianprocessnode_tpu_torch.infer.minibatch import (
        MinibatchCarry, banana_epoch_steps, default_optimizer, fit_banana, fit_banana_fast,
        fit_kin40k, init_banana_state)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.metrics import error_rate
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

    ds = brunner.load_data("synthetic", seed)
    theta0, Xu, Xb, yb, pv, pw = brunner.setup(ds, M_BAN, BATCH_BAN, seed, "cuda")
    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    # one initial carry for both routes (its Kuu⁻¹ from the plain Gram)
    c0 = init_banana_state(plain, theta0, Xu, pv, pw)
    names = ("theta", "xi", "Lambda", "w_shape", "w_rate")

    def fast(kernel, carry):
        return fit_banana_fast(kernel, theta0, Xu, Xb, yb, pv, pw, 1, resume_state=carry)

    # the fast path: counts at 0 just before, read just after; epoch 0 is
    # the cold one, epochs 1-3 start from the plain route's carry after it
    carry_k = carry_p = c0
    launches, epoch_ms, diffs = [], [], []
    se_gram_cuda.launches = 0
    for e in range(EPOCHS + 1):
        before = se_gram_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if e > 0 else "default")
        try:
            th_k, nat_k, qw_k, carry_k = fast(kern, carry_k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(se_gram_cuda.launches - before)
        th_p, nat_p, qw_p, carry_p = fast(plain, carry_p)
        check(se_gram_cuda.launches - before == launches[-1],
              "the plain Gram launched the kernel")
        label = f"banana fast epoch {e}" if e else "banana fast epoch 0 (cold)"
        print(f"{label}: kernel route {epoch_ms[-1]:.1f} ms (host clock, "
              f"{'sync debug mode error' if e > 0 else 'first epoch'}), se_gram "
              f"launches {launches[-1]}", flush=True)
        diffs.append(_held(label, (th_k, nat_k.xi, nat_k.prec, qw_k.shape, qw_k.rate),
                           (th_p, nat_p.xi, nat_p.prec, qw_p.shape, qw_p.rate), names,
                           None if e else {"w_rate": COLD_RATE_RTOL}))
        check(launches[-1] == BANANA_LAUNCHES_PER_EPOCH,
              f"{launches[-1]} kernel launches in banana epoch {e}, expected "
              f"{BANANA_LAUNCHES_PER_EPOCH}")
        if e == 0:
            warm = carry_k = carry_p
    fast_launches = se_gram_cuda.launches
    fast_carry = carry_k

    X_test = torch.as_tensor(ds.x_test, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        probs = brunner.predict(kern, th_k, Xu, nat_k, qw_k, X_test)
    err = float(error_rate(torch.as_tensor(ds.y_test), (probs >= 0.5).double().cpu()))
    w_bar = float(qw_k.shape / qw_k.rate)
    print(f"banana after {EPOCHS + 1} fast epochs: test error rate {err:.4f} on "
          f"{X_test.shape[0]} synthetic points (chance 0.5), w_bar {w_bar:.4f}", flush=True)
    check(err < 0.35, f"banana test error rate {err} after {EPOCHS + 1} epochs")

    # the per-batch banana schedule
    def faithful(kernel, carry):
        return fit_banana(kernel, theta0, Xu, Xb, yb, pv, pw, 1, resume_state=carry)

    carry_k = carry_p = warm
    faithful_ms, faithful_diffs = [], []
    se_gram_cuda.launches = 0
    for e in range(FAITHFUL_EPOCHS):
        before = se_gram_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        th_k, nat_k, qw_k, carry_k = faithful(kern, carry_k)
        torch.cuda.synchronize()
        faithful_ms.append((time.perf_counter() - t) * 1e3)
        n = se_gram_cuda.launches - before
        th_p, nat_p, qw_p, carry_p = faithful(plain, carry_p)
        print(f"banana faithful epoch {e + 1}: kernel route {faithful_ms[-1]:.1f} ms "
              f"(host clock), se_gram launches {n}", flush=True)
        faithful_diffs.append(_held(f"banana faithful epoch {e + 1}",
                                    (th_k, nat_k.xi, nat_k.prec, qw_k.shape, qw_k.rate),
                                    (th_p, nat_p.xi, nat_p.prec, qw_p.shape, qw_p.rate),
                                    names))
        check(n == FAITHFUL_LAUNCHES_PER_BATCH * BAN_BATCHES,
              f"{n} kernel launches in faithful banana epoch {e + 1}")
    faithful_launches = se_gram_cuda.launches

    # the per-batch kin40k schedule, float32 (its float64 default takes the
    # plain Gram by dtype, by design)
    kds = krunner.load_data("synthetic", seed, n_test=10)
    k_theta0, k_Xu, k_Xb, k_yb, k_prior = krunner.setup(kds, M_IND, BATCH, N_TRAIN, seed,
                                                        "cuda")

    def kin40k(kernel, carry):
        return fit_kin40k(kernel, k_theta0, k_Xu, k_Xb, k_yb, k_prior, krunner.W_VAL, 1,
                          resume_state=carry)

    carry_k = carry_p = None
    kin40k_ms, kin40k_diffs = [], []
    se_gram_cuda.launches = 0
    for e in range(FAITHFUL_EPOCHS):
        before = se_gram_cuda.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        th_k, nat_k, carry_k = kin40k(kern, carry_k)
        torch.cuda.synchronize()
        kin40k_ms.append((time.perf_counter() - t) * 1e3)
        n = se_gram_cuda.launches - before
        th_p, nat_p, carry_p = kin40k(plain, carry_p)
        print(f"kin40k faithful f32 epoch {e + 1}: kernel route {kin40k_ms[-1]:.1f} ms "
              f"(host clock), se_gram launches {n}", flush=True)
        kin40k_diffs.append(_held(f"kin40k faithful f32 epoch {e + 1}",
                                  (th_k, nat_k.xi, nat_k.prec), (th_p, nat_p.xi, nat_p.prec),
                                  ("theta", "xi", "Lambda")))
        check(n == FAITHFUL_LAUNCHES_PER_BATCH * (N_TRAIN // BATCH),
              f"{n} kernel launches in faithful kin40k epoch {e + 1}")
    kin40k_launches = se_gram_cuda.launches

    # one fast epoch's two steps, timed on a copy of the fast carry
    c = MinibatchCarry(*(t_.clone() for t_ in fast_carry[:5]),
                       {k: v.clone() for k, v in fast_carry.opt_state.items()},
                       fast_carry.w_shape.clone(), fast_carry.w_rate.clone())
    X_all, y_all = Xb.reshape(-1, D_BAN), yb.reshape(-1)
    statistics, theta_step = banana_epoch_steps(kern, Xu, X_all, y_all, pv,
                                                default_optimizer(), torch.float32)
    qf, _, _, _, mu_v, Rv, w_shape, w_rate = statistics(c)
    f_b = qf.mean.reshape(yb.shape)
    w_step = (w_shape / w_rate).float()

    def step():
        theta_step(c.theta, c.opt_state, c.kuu_inv, (Xb[0], f_b[0], mu_v, Rv, w_step))

    def stats_once():
        statistics(c)

    def one_epoch():
        qf_, _, _, _, mu_, R_, ws_, wr_ = statistics(c)
        f_ = qf_.mean.reshape(yb.shape)
        w_ = (ws_ / wr_).float()
        for b in range(BAN_BATCHES):
            theta_step(c.theta, c.opt_state, c.kuu_inv, (Xb[b], f_[b], mu_, R_, w_))

    profiled = profile_epoch(one_epoch, "profiled eager banana epoch", card)
    step_eager, step_queue = eager_ms(step, 20)
    stats_eager, stats_queue = eager_ms(stats_once, 5)
    step_dev = cuda_graph_time_ms(step, iters=20, warmup=3)
    stats_dev = cuda_graph_time_ms(stats_once, iters=5, warmup=2)
    epoch_host = sum(epoch_ms[1:]) / EPOCHS
    busy = BAN_BATCHES * step_dev + stats_dev
    print(f"banana theta-step: device {step_dev:.4f} ms (CUDA graph of 20 steps), eager "
          f"{step_eager:.4f} ms (host clock, 20 steps between synchronisations), host "
          f"time to queue one {step_queue:.4f} ms [{card}]", flush=True)
    print(f"banana statistics pass: device {stats_dev:.4f} ms (CUDA graph of 5), eager "
          f"{stats_eager:.4f} ms, host time to queue one {stats_queue:.4f} ms [{card}]",
          flush=True)
    print(f"banana fast epoch: host {epoch_host:.2f} ms (mean of epochs 1-{EPOCHS}); "
          f"device work {busy:.2f} ms ({BAN_BATCHES} steps + 1 statistics pass by graph) "
          f"-> card idle {1.0 - busy / epoch_host:.3f} of the epoch; faithful banana "
          f"epoch host {sum(faithful_ms) / len(faithful_ms):.2f} ms [{card}]", flush=True)
    var, ls = kern.params(c.theta)
    shapes = [time_gram(Xu, X_all, var, ls, "banana Kux of all points", card),
              time_gram(Xu, Xu, var, ls, "banana Kuu", card),
              time_gram(Xu, Xb[0], var, ls, "banana Kux of a batch", card),
              time_gram(Xu, X_test, var, ls, "banana test predictions", card)]
    say("phase 7/16 banana training: done")
    return dict(launches_per_epoch=launches, launches=fast_launches, epoch_host_ms=epoch_ms,
                kernel_vs_plain=diffs, test_error_rate_4_epochs=err, w_bar_4_epochs=w_bar,
                theta_step_device_ms=step_dev, theta_step_eager_ms=step_eager,
                theta_step_queue_ms=step_queue, stats_device_ms=stats_dev,
                stats_eager_ms=stats_eager, stats_queue_ms=stats_queue,
                epoch_device_ms=busy, idle_share=1.0 - busy / epoch_host, shapes=shapes,
                profiled_epoch=profiled,
                faithful=dict(launches=faithful_launches, epoch_host_ms=faithful_ms,
                              kernel_vs_plain=faithful_diffs),
                kin40k_faithful=dict(launches=kin40k_launches, epoch_host_ms=kin40k_ms,
                                     kernel_vs_plain=kin40k_diffs))


# μ_v recovered from the banana state: ‖Λ‖∞/λ_min ≈ 2.8e10, and the 60
# Newton–Schulz iterations of the recovery leave ‖I − ΛΣ‖_F ≈ 4.8e3 in the
# JAX package and the port alike (tests/test_torch_classifier.py), so μ_v
# is only as good as the refined residual, 2.8e-5 (JAX) and 3.2e-5 (port)
# on the CPU; held to 1e-3 here, where the sums run in another order
BANANA_RESID_LIMIT = 1e-3


def phase_classifier(seed, card):
    """The probit classifier of benchmarks/banana_refxu_trained.npz (θ, ξ, Λ,
    w_shape, w_rate; Xu drawn N(0, I₂) from ``seed``: the npz holds none)
    through ``convert.classifier_state_from_jax`` and ``serve_fused`` of
    R = 64 batches of B = 30,000 two-dimensional requests; probabilities
    held against the same handle's plain path on the card and against a
    float64 host reference on 256 requests; then the time per batch, the
    host's queue time and the Gram at 500×30000×2."""
    say("phase 8/16 classifier serving: start")
    import dataclasses

    from gaussianprocessnode_tpu_torch import MvGaussianNat, convert, serve
    from gaussianprocessnode_tpu_torch.experiments import serving_bench
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

    z = dict(np.load(BANANA_NPZ, allow_pickle=False))
    rng = np.random.default_rng(seed)
    Xu = rng.standard_normal((M_BAN, D_BAN))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((R_BATCHES, B_REQ, D_BAN), generator=gen, device="cuda")
    handle = convert.classifier_state_from_jax(z["theta"], Xu, z["xi"], z["prec"],
                                               z["w_shape"], z["w_rate"],
                                               dtype=torch.float32, device="cuda")
    mu64 = serve._recover_mu_v(MvGaussianNat(torch.as_tensor(z["xi"], device="cuda"),
                                             torch.as_tensor(z["prec"], device="cuda")))
    resid = float(np.linalg.norm(z["prec"] @ mu64.cpu().numpy() - z["xi"])
                  / np.linalg.norm(z["xi"]))
    print(f"banana recovery (f64, card): |L mu - xi|/|xi| = {resid:.3e} (limit "
          f"{BANANA_RESID_LIMIT:.0e}); w_bar = {float(handle.w_mean):.6f}", flush=True)
    check(resid <= BANANA_RESID_LIMIT, "banana mu_v recovery off")

    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    t = time.perf_counter()
    P = serve.serve_fused(handle, X)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = se_gram_cuda.launches
    print(f"serve_fused (classifier): R={R_BATCHES} B={B_REQ} D={D_BAN} in {serve_s:.3f} s "
          f"(first call, host clock); se_gram launches = {launches}", flush=True)
    check(launches == R_BATCHES, f"se_gram launched {launches} times, expected {R_BATCHES}")
    check(tuple(P.shape) == (R_BATCHES, B_REQ), "output shape")
    check(bool(((P >= 0) & (P <= 1)).all()), "probabilities outside [0, 1]")
    check(torch.equal(P[0], handle.probabilities(X[0])), "serve_fused row 0 is not "
          "probabilities(X[0])")

    # the pre-Φ means m = Kᵀμ_v of each route's float32 Gram, the mat-vec
    # in float64 so that only the Grams differ: every entry of the two
    # Grams differs by at most gram_tolerance, so |Δm| ≤ that · ‖μ_v‖₁
    plain = dataclasses.replace(handle, kernel=Kernel("se", "softplus", use_kernel=False))
    var, ls = plain.kernel.params(handle.theta)
    mu64_f = handle.mu_v.double()
    K0 = plain.kernel(handle.theta, handle.Xu, X[0])
    m_plain = K0.double().T @ mu64_f
    m_kern = se_gram_cuda(handle.Xu, X[0], var, ls).double().T @ mu64_f
    se_gram_cuda.launches = launches
    m_bound = gram_tolerance(handle.Xu / ls, X[0] / ls, var) * float(mu64_f.abs().sum())
    m_excess = float((m_kern - m_plain).abs().max()) / m_bound
    # a negative control: the plain Gram at ℓ·(1 + 1e-3), a fault far
    # smaller than a wrong index or a lost term, must fail the same check
    m_off = (plain.kernel(handle.theta, handle.Xu, X[0] / (1.0 + 1e-3)).double().T @ mu64_f)
    off_excess = float((m_off - m_plain).abs().max()) / m_bound
    print(f"means m = K^T mu vs plain path (batch 0, f32 Grams, f64 mat-vec, card): max "
          f"|dm| / bound = {m_excess:.3e} (bound = gram_tolerance * |mu|_1 = {m_bound:.3e}; "
          f"median |m| {float(m_plain.abs().median()):.3e}; limit 1); negative control "
          f"(l * (1 + 1e-3)): {off_excess:.3e} (must exceed 1)", flush=True)
    check(m_excess <= 1.0, "classifier means disagree with the plain path")
    check(off_excess > 1.0, "the means check cannot tell a Gram at l*(1+1e-3) from the "
          "right one")

    # P = Φ(z), z = m/√(1+v): the served m (float32 mat-vec) moves by at most
    # δm = (Gram bound + M·ε per side's mat-vec)·|K|ᵀ|μ|, z by δz = δm/√(1+v),
    # and P by at most φ(max(|z| − δz, 0))·δz, plus 4 ε for Φ's own rounding
    scale, lim = serving_bench.means_bound(plain.kernel, handle.theta, handle.Xu,
                                           handle.mu_v, X[0])
    scale = scale.double()
    s1v = torch.sqrt(1.0 + 1.0 / handle.w_mean)
    z_plain = (K0.T @ handle.mu_v).double() / s1v
    dz = lim * scale / s1v
    gap = torch.clamp_min(z_plain.abs() - dz, 0.0)
    tol = torch.exp(-0.5 * gap**2) / np.sqrt(2 * np.pi) * dz + 4 * EPS32
    p_plain = plain.probabilities(X[0])
    excess = float(((P[0] - p_plain).abs() / tol).max())
    print(f"probabilities vs plain path (batch 0, f32, card): max |dP|/tol = {excess:.3e} "
          f"(tol = phi(max(|z| - dz, 0)) * dz + 4 eps, dz = {lim:.3e} * |K|^T|mu| / "
          f"sqrt(1+v); tol median {float(tol.median()):.3e}, max {float(tol.max()):.3e}; "
          f"limit 1); share of P in (0.01, 0.99) "
          f"{float(((P[0] > 0.01) & (P[0] < 0.99)).float().mean()):.3f}", flush=True)
    check(excess <= 1.0, "classifier probabilities disagree with the plain path")
    n_small = 256
    h64 = dataclasses.replace(plain, theta=torch.as_tensor(z["theta"]),
                              Xu=torch.as_tensor(Xu), mu_v=mu64.cpu(),
                              w_mean=handle.w_mean.cpu())
    p64 = h64.probabilities(X[0, :n_small].cpu().double())
    excess64 = float(((P[0, :n_small].cpu().double() - p64).abs()
                      / tol[:n_small].cpu()).max())
    print(f"probabilities vs float64 host reference ({n_small} requests): max |dP|/tol = "
          f"{excess64:.3e} (limit 1)", flush=True)
    check(excess64 <= 1.0, "classifier probabilities disagree with the float64 reference")

    pps, batch_ms, enqueue_ms = serving_rate(handle, X)
    row = time_gram(handle.Xu, X[0], var, ls, "classifier serving", card)
    K = se_gram_cuda(handle.Xu, X[0], var, ls)
    mv_ms = cuda_graph_time_ms(lambda: K.T @ handle.mu_v, iters=50, warmup=3)
    print(f"serve_fused (classifier): {pps:.6e} predictions/s (R={R_BATCHES}, B={B_REQ}, "
          f"host clock between synchronisations) = {batch_ms:.5f} ms per batch: Gram "
          f"kernel {row['device_ms']:.5f} ms, mat-vec K^T mu {mv_ms:.5f} ms (device time, "
          f"CUDA graph); host time to queue one batch {enqueue_ms:.5f} ms [{card}]",
          flush=True)
    say("phase 8/16 classifier serving: done")
    return dict(launches=launches, max_abs_dm_vs_plain_over_bound=m_excess,
                negative_control_over_bound=off_excess,
                max_abs_dp_vs_plain_over_tol=excess,
                max_abs_dp_vs_f64_over_tol=excess64, tol_median=float(tol.median()),
                tol_max=float(tol.max()), recovery_residual=resid, pps=pps,
                batch_ms=batch_ms, enqueue_ms=enqueue_ms, matvec_ms=mv_ms, shape=row)


# the toy workloads (experiments/toy_regression.py, toy_classification.py):
# M = 20 inducing inputs and N = 50 points, M = 15 and N = 100; GH-21 and
# GenUT (3 points) put N·21 and N·3 points through one Gram
# (3 and 2 epochs: the card-against-host check needs a few epochs, not
# ten; the host's own float64 epochs were most of this phase's time)
TOY_REG_EPOCHS, TOY_CLS_EPOCHS = 3, 2
TOY_GRAM_SHAPES = [
    (20, 20, "toy regression Kuu"), (20, 50, "toy regression Kux"),
    (20, 600, "toy regression test rows"), (20, 50 * 21, "toy regression GH-21 points"),
    (20, 50 * 3, "toy regression GenUT points"),
    (15, 15, "toy classification Kuu"), (15, 100, "toy classification Kux"),
    (15, 400, "toy classification test rows"),
    (15, 100 * 21, "toy classification GH-21 points"),
    (15, 100 * 3, "toy classification GenUT points"),
]
# float64 epochs on the card against the same epochs on the host: the two
# differ by the order of their BLAS and LAPACK sums (~1e-15 relative), and
# each epoch's L-BFGS ends at the objective's rounding floor, where θ is
# fixed to ~1e-8 (tests/test_torch_training.py); the alternation carries
# that from epoch to epoch
TOY_THETA_RTOL = 1e-6
TOY_FE_RTOL = 1e-8
# one float32 epoch through the kernel against the plain float32 Gram, each
# workload's (free energy, θ) limit at ~3× its reading on an H100 80GB HBM3 at
# 700 W (the same in three calls): regression 4.6e-4 and 3.4e-3 (its float32
# L-BFGS stops where the rounding floor hides the slope, which amplifies the
# Grams' 1e-7 differences), classification 1.9e-6 and 4.1e-6. Phase 3 holds
# the kernel itself at these shapes; this check holds the route
TOY_F32_LIMITS = {"toy_regression": (1.5e-3, 1e-2), "toy_classification": (6e-6, 1.5e-5)}
# the profiler's trace can miss a kernel record: it held one se_gram record
# fewer than the epoch launched in two of five profiled float32 toy epochs on
# an H100 80GB HBM3 (1,557 of 1,558; 2,077 of 2,078) and all of them in the
# other three. The trace's count is held to [expected − expected/200,
# expected]; replays that skipped the kernel would leave 6
TOY_TRACE_LOSS = 200


def phase_toy(card):
    """The toy workloads at their reference configurations:

    - toy regression (3 epochs) and toy classification (2 epochs) in
      float64 on the card, under set_sync_debug_mode("warn") after an
      uncounted warm-up epoch, held to the same epochs on the host (θ,
      every epoch's free energy); their syncs counted and held to the
      linesearch's own host reads;
    - one float32 epoch of each through the kernel, under torch.profiler,
      held to the plain float32 Gram on the card. The wrapper's count (set
      to 0 just before, read just after) holds two launches per VMP pass
      and, for the epoch's CUDA graph of the objective (Kuu and Kux), two
      in its eager warm-up and two captured; the trace's kernel records
      hold two per VMP pass, per warm-up and per replayed evaluation;
    - one float64 toy-regression epoch under torch.profiler: device time
      by kernel group against the epoch's wall time;
    - the expected-Ψ point Gram with GH-21 and GenUT at the toy sizes in
      float32, kernel against plain;
    - the toy Gram shapes timed as phase 5 times the others."""
    say("phase 9/16 toy workloads: start")
    from gaussianprocessnode_tpu_torch.experiments import toy_classification as tcls
    from gaussianprocessnode_tpu_torch.experiments import toy_regression as treg
    from gaussianprocessnode_tpu_torch.infer.training import fit_classification, fit_regression
    from gaussianprocessnode_tpu_torch.ops import psi as psiops
    from gaussianprocessnode_tpu_torch.ops import quadrature as quad
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.datasets import toy_classification, toy_sinc
    from gaussianprocessnode_tpu_torch.utils.profiling import count_syncs, cuda_kernel_times

    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    out = {}
    for name, module, data, fit, epochs in (
            ("toy_regression", treg, toy_sinc, fit_regression, TOY_REG_EPOCHS),
            ("toy_classification", tcls, toy_classification, fit_classification,
             TOY_CLS_EPOCHS)):
        # float64 on the card (plain Grams by dtype) against the host. An
        # uncounted warm-up epoch first: it makes the cached host-to-card
        # copy of the GH-32 table (the probit energy's) and the process's
        # first cuBLAS/cuSOLVER handles and workspaces, so that the counted
        # epochs' syncs are the linesearch's host reads alone
        counts = {}
        args = module.setup(data(), device="cuda", dtype=torch.float64)
        fit(kern, *args, epochs=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        (th, fe, _), syncs = count_syncs(lambda: fit(kern, *args, epochs=epochs,
                                                     counts=counts))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        counts_cpu = {}
        t = time.perf_counter()
        th_cpu, fe_cpu, _ = fit(kern, *module.setup(data(), device="cpu", dtype=torch.float64),
                                epochs=epochs, counts=counts_cpu)
        cpu_s = time.perf_counter() - t
        d_th = float(torch.max(torch.abs(th.cpu() - th_cpu) / torch.abs(th_cpu)))
        d_fe = float(torch.max(torch.abs(fe.cpu() - fe_cpu) / torch.abs(fe_cpu)))
        steps = epochs * module.LBFGS_STEPS
        ls = counts["linesearch_steps"] / steps
        print(f"{name} float64, {epochs} epochs: card {card_s:.3f} s ({card_s / epochs * 1e3:.1f} "
              f"ms per epoch, host clock), host CPU {cpu_s:.3f} s; theta card vs CPU "
              f"{d_th:.3e} (limit {TOY_THETA_RTOL:.0e}), free energy {d_fe:.3e} (limit "
              f"{TOY_FE_RTOL:.0e}); fe {float(fe_cpu[0]):.6f} -> {float(fe_cpu[-1]):.6f}; "
              f"linesearch iterations per L-BFGS step {ls:.3f} (CPU "
              f"{counts_cpu['linesearch_steps'] / steps:.3f}); syncs {syncs} = "
              f"{syncs / epochs:.1f} per epoch (linesearch host reads "
              f"{counts['host_reads']}) [{card}]", flush=True)
        check(bool(torch.isfinite(th).all()) and bool(torch.isfinite(fe).all()),
              f"{name}: non-finite float64 result on the card")
        check(d_th <= TOY_THETA_RTOL and d_fe <= TOY_FE_RTOL,
              f"{name}: card and host float64 epochs disagree")
        check(syncs == counts["host_reads"],
              f"{name}: {syncs} synchronising operations, {counts['host_reads']} expected "
              "(one per linesearch iteration)")
        row = dict(epochs=epochs, card_s=card_s, cpu_s=cpu_s, card_ms_per_epoch=card_s / epochs
                   * 1e3, theta_card_vs_cpu=d_th, fe_card_vs_cpu=d_fe,
                   linesearch_per_step=ls, syncs=syncs, syncs_per_epoch=syncs / epochs,
                   theta_softplus=torch.logaddexp(th.cpu(), torch.zeros(2,
                                                  dtype=th.dtype)).tolist(),
                   fe_first=float(fe_cpu[0]), fe_last=float(fe_cpu[-1]))

        # one float32 epoch: the kernel path under the profiler (the count at
        # 0 just before, read just after), then the plain Gram
        args32 = module.setup(data(), device="cuda", dtype=torch.float32)
        ck, got = {}, []
        se_gram_cuda.launches = 0
        f32_ms, kernels = cuda_kernel_times(
            lambda: got.append(fit(kern, *args32, epochs=1, counts=ck)), warmup=0)
        launches = se_gram_cuda.launches
        th_k, fe_k, _ = got[0]
        records = sum(n for k, (n, _) in kernels.items() if "se_gram" in k)
        th_p, fe_p, _ = fit(plain, *args32, epochs=1)
        check(se_gram_cuda.launches == launches, f"{name}: the plain Gram launched the kernel")
        want = 4 + 4 * ck["graph_captures"]
        want_records = 4 + 2 * (ck["graph_captures"] + ck["evaluations"])
        fe_lim, th_lim = TOY_F32_LIMITS[name]
        d32_th = float(torch.max(torch.abs(th_k - th_p) / torch.abs(th_p)))
        d32_fe = float(torch.max(torch.abs(fe_k - fe_p) / torch.abs(fe_p)))
        print(f"{name} float32, 1 epoch through the kernel: {f32_ms:.1f} ms (host clock, "
              f"profiler on); se_gram launches counted by its wrapper {launches} (expected "
              f"{want}: 2 per VMP pass, 2 eager and 2 captured per CUDA graph, "
              f"{ck['graph_captures']} graph); se_gram kernel records in the profiler trace "
              f"{records} (expected {want_records}, less at most {want_records // TOY_TRACE_LOSS} "
              f"lost by the trace: 2 per VMP pass, 2 per eager warm-up, 2 per evaluation, "
              f"{ck['evaluations']} replayed); kernel vs plain relative: theta "
              f"{d32_th:.3e} (limit {th_lim:.1e}), free energy {d32_fe:.3e} "
              f"(limit {fe_lim:.1e}) [{card}]", flush=True)
        check(bool(torch.isfinite(th_k).all()) and bool(torch.isfinite(fe_k).all()),
              f"{name}: non-finite float32 result through the kernel")
        check(launches == want, f"{name}: the wrapper counted {launches} launches, "
              f"expected {want}")
        check(0 <= want_records - records <= want_records // TOY_TRACE_LOSS,
              f"{name}: {records} se_gram kernel records in the profiler trace, expected "
              f"{want_records} (at most {want_records // TOY_TRACE_LOSS} lost by the trace)")
        check(d32_th <= th_lim and d32_fe <= fe_lim,
              f"{name}: float32 kernel and plain epochs disagree")
        row.update(f32_launches=launches, f32_kernel_records_profiled=records,
                   f32_evaluations=ck["evaluations"], f32_graph_captures=ck["graph_captures"],
                   f32_ms_profiler_on=f32_ms, f32_theta_kernel_vs_plain=d32_th,
                   f32_fe_kernel_vs_plain=d32_fe)
        if name == "toy_regression":
            row["profiled_epoch"] = profile_epoch(
                lambda: fit(kern, *args, epochs=1), "profiled float64 toy regression epoch",
                card)
        out[name] = row

    # the expected-Ψ point Gram, kernel against plain (launches not counted)
    before = se_gram_cuda.launches
    rng = np.random.default_rng(5)
    theta0 = torch.full((2,), float(np.log(np.expm1(1.0))), dtype=torch.float32, device="cuda")
    psi_err = {}
    for M, N, lim in ((20, 50, 4.0), (15, 100, 5.0)):
        Xu = torch.linspace(-lim, lim, M, dtype=torch.float32, device="cuda")[:, None]
        m = torch.as_tensor(rng.uniform(-lim, lim, N), dtype=torch.float32, device="cuda")
        v = torch.as_tensor(rng.uniform(0.01, 0.5, N), dtype=torch.float32, device="cuda")
        for method in (quad.GaussHermite(21), quad.GenUT()):
            got = psiops.psi_batch_expected_uni(kern, theta0, Xu, method, m, v)
            ref = psiops.psi_batch_expected_uni(plain, theta0, Xu, method, m, v)
            pts = (m[:, None] + torch.sqrt(v)[:, None] * quad.points_weights_uni(
                method, torch.zeros((), device="cuda"), torch.ones((), device="cuda"))[0])
            tol = gram_tolerance(Xu, pts.reshape(-1, 1), 1.0)
            wsum = float(torch.sum(torch.abs(ref[3])))
            e_kp = float(torch.max(torch.abs(got[2] - ref[2])))
            e_p1 = float(torch.max(torch.abs(got[1] - ref[1])))
            label = f"{M}x{N * ref[3].shape[0]}x1 {type(method).__name__}"
            print(f"expected-Psi point Gram {label}: Kp max_abs {e_kp:.3e} (tol {tol:.3e}), "
                  f"psi1 max_abs {e_p1:.3e} (tol {tol * wsum:.3e})", flush=True)
            check(e_kp <= tol and e_p1 <= tol * wsum * (1 + 1e-6),
                  f"expected-Psi point Gram {label}: kernel and plain disagree")
            psi_err[label] = e_kp
    se_gram_cuda.launches = before

    shapes = []
    for M, N, role in TOY_GRAM_SHAPES:
        Z = torch.linspace(-4.0, 4.0, M, dtype=torch.float32, device="cuda")[:, None]
        X = Z if N == M else torch.as_tensor(rng.uniform(-4.0, 4.0, (N, 1)),
                                             dtype=torch.float32, device="cuda")
        one = torch.ones((), dtype=torch.float32, device="cuda")
        shapes.append(time_gram(Z, X, one, one.reshape(1), role, card))
    say("phase 9/16 toy workloads: done")
    return dict(out, psi_point_gram_max_abs=psi_err, shapes=shapes,
                launches=out["toy_regression"]["f32_launches"]
                + out["toy_classification"]["f32_launches"])


# the VSGP / FITC baselines (experiments/vsgp_baselines.py) at kin40k width
VSGP_STEPS, VSGP_CHUNK = 50, 25        # collapsed steps through each route
VSGP_LR = 0.05                         # run_kin40k_collapsed's learning rate
SVGP_EPOCHS, FITC_STEPS = 2, 20
# collapsed, minibatch SVGP and FITC steps each launch Kuu and Kux
LAUNCHES_PER_VSGP_STEP = 2
# kernel-trained against plain-trained θ (relative 2-norm) and the −ELBO /
# NLML traces (largest step-by-step difference over the plain trace's
# largest magnitude: the collapsed −ELBO crosses zero in a longer run, so a
# step's own value is no scale): the two routes' Grams differ by float32
# rounding (~1e-7 of σ²), which the Cholesky of B = I + AAᵀ/σ² (σ² = 0.01)
# amplifies in the −ELBO; AdaMax's first steps move θ by ±lr whatever the
# gradient's size, so θ follows closely. On an H100 80GB HBM3 at 700 W the
# readings were: collapsed θ 3.6e-7 and trace 1.9e-5 (then relative step by
# step, which is never smaller); fit_svgp 3.7e-7 (m_white, A_raw) and
# 3.4e-8 (θ); FITC θ 2.3e-7, noise 1.3e-7, trace 6.9e-7. The limits are
# ~5-30× those readings
VSGP_RTOL = {"collapsed_theta": 1e-5, "collapsed_trace": 1e-4,
             "svgp": 1e-5, "fitc_theta": 1e-5, "fitc_trace": 1e-5}
# float64 collapsed prediction on the card against the same call on the
# host: cuBLAS and MKL sum in other orders (read 4.9e-11 on the card)
VSGP_F64_RTOL = 1e-9


def _trace_rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def phase_vsgp(seed, card):
    """The VSGP and FITC baselines at kin40k width (M = 600, N = 10,000,
    D = 8; synthetic data from ``seed``, inducing inputs 600 training rows):

    - the collapsed bound (``vsgp_baselines.run_kin40k_collapsed``'s
      settings: noise 0.01, jitter 1e-5, lr 0.05) for 50 steps in float32
      through the kernel, in chunks (step 1; steps 2–25 and 26–50 under
      ``set_sync_debug_mode("error")``, one host read between chunks), then
      the same 50 steps through the plain Gram, held to each other; 2
      launches per step; the trained θ scored by ``collapsed_predict`` in
      float64 on the card and held to the same call on the host;
    - the entry point ``run_kin40k_collapsed`` itself for the same 50
      steps in chunks of 25 (its chunk loop, its float64 scoring of each
      snapshot on the card, its profiled chunk): 2 launches per step, a
      falling −ELBO, finite SMSE and the library run's θ;
    - a collapsed step timed: device time from a CUDA graph of 20 steps,
      host time eager, and one chunk profiled;
    - two float32 ``fit_svgp`` epochs (20 batches of 500, fixed noise 0.01)
      and 20 float32 FITC steps, each kernel against plain.

    Each path's launch count is set to 0 just before it and read just
    after."""
    say("phase 10/16 VSGP and FITC baselines: start")
    from gaussianprocessnode_tpu_torch.experiments import vsgp_baselines as vb
    from gaussianprocessnode_tpu_torch.infer.fitc import fit_sparse_gp, init_sparse_gp
    from gaussianprocessnode_tpu_torch.infer.svgp import (collapsed_opt_init,
                                                          collapsed_predict, collapsed_step,
                                                          fit_svgp,
                                                          fit_svgp_collapsed_resumable,
                                                          init_svgp, vsgp_optimizer)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel, softplus
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.metrics import smse
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

    noise, jitter = vb.COLLAPSED_NOISE, vb.COLLAPSED_JITTER
    ds, theta0, Xu, Xb, yb = vb._kin40k("synthetic", seed, M_IND, N_TRAIN, 30_000, BATCH,
                                        torch.device("cuda"), torch.float32)
    X, y = Xb.reshape(-1, D_IN), yb.reshape(-1)
    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    out = {}

    def collapsed(kernel, chunks, debug):
        th, st = theta0.clone(), collapsed_opt_init(theta0, VSGP_LR)
        traces = []
        for i, n in enumerate(chunks):
            torch.cuda.set_sync_debug_mode("error" if debug and i > 0 else "default")
            try:
                th, st, tr = fit_svgp_collapsed_resumable(
                    kernel, th, st, Xu, X, y, noise, steps=n, learning_rate=VSGP_LR,
                    jitter=jitter)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            float(tr[-1])  # the chunk's one host read, as the runner's
            traces.append(tr)
        return th, st, torch.cat(traces)

    chunks = (1, VSGP_CHUNK - 1, VSGP_STEPS - VSGP_CHUNK)
    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    th_k, st_k, tr_k = collapsed(kern, chunks, True)
    torch.cuda.synchronize()
    coll_s = time.perf_counter() - t
    launches = se_gram_cuda.launches
    th_p, _, tr_p = collapsed(plain, chunks, False)
    check(se_gram_cuda.launches == launches, "the plain Gram launched the kernel")
    d_th, d_tr = _rel(th_k, th_p), _trace_rel(tr_k, tr_p)
    finite = bool(torch.isfinite(th_k).all()) and bool(torch.isfinite(tr_k).all())
    print(f"collapsed bound, {VSGP_STEPS} steps (chunks {chunks}; steps 2-{VSGP_STEPS} under "
          f"sync debug mode error): {coll_s * 1e3:.1f} ms (host clock, first call), se_gram "
          f"launches {launches} ({launches / VSGP_STEPS:.0f} per step); -elbo "
          f"{float(tr_k[0]):.2f} -> {float(tr_k[-1]):.2f}; kernel vs plain relative: theta "
          f"{d_th:.3e} (limit {VSGP_RTOL['collapsed_theta']:.0e}), -elbo trace {d_tr:.3e} "
          f"(limit {VSGP_RTOL['collapsed_trace']:.0e}); finite {finite} [{card}]", flush=True)
    check(finite, "collapsed bound: non-finite θ or −ELBO")
    check(launches == LAUNCHES_PER_VSGP_STEP * VSGP_STEPS,
          f"collapsed bound: {launches} launches, expected {LAUNCHES_PER_VSGP_STEP * VSGP_STEPS}")
    check(float(tr_k[-1]) < float(tr_k[0]), "collapsed bound: −ELBO did not fall")
    check(d_th <= VSGP_RTOL["collapsed_theta"] and d_tr <= VSGP_RTOL["collapsed_trace"],
          "collapsed bound: kernel and plain routes disagree")

    # float64 scoring on the card against the same call on the host
    f64 = torch.float64
    args64 = (th_k.to(f64), Xu.to(f64), torch.as_tensor(ds.x_test, dtype=f64, device="cuda"),
              X.to(f64), y.to(f64), noise)
    t = time.perf_counter()
    pred = collapsed_predict(kern, *args64, jitter=jitter)
    torch.cuda.synchronize()
    pred_ms = (time.perf_counter() - t) * 1e3
    pred_cpu = collapsed_predict(kern, *(a.cpu() if isinstance(a, torch.Tensor) else a
                                         for a in args64), jitter=jitter)
    d_pred = _rel(pred.cpu(), pred_cpu)
    score = float(smse(torch.as_tensor(ds.y_test), pred.cpu()))
    score_cpu = float(smse(torch.as_tensor(ds.y_test), pred_cpu))
    print(f"collapsed_predict float64 on the card ({pred_ms:.1f} ms, host clock, 30,000 test "
          f"points): SMSE after {VSGP_STEPS} steps {score:.6f} (host {score_cpu:.6f}); means "
          f"card vs host relative {d_pred:.3e} (limit {VSGP_F64_RTOL:.0e}) [{card}]", flush=True)
    check(score == score and score < 1.0, f"collapsed SMSE {score}")
    check(d_pred <= VSGP_F64_RTOL, "collapsed_predict: card and host float64 disagree")

    # the entry point on the same data and steps. It zeroes the count itself
    # just before its timed chunks (after its 2 warm-up steps) and reports
    # it; the count read here adds the chunk it profiles after training
    se_gram_cuda.launches = 0
    t = time.perf_counter()
    run = vb.run_kin40k_collapsed(steps=VSGP_STEPS, eval_every=VSGP_CHUNK, seed=seed)
    run_s = time.perf_counter() - t
    run_launches = se_gram_cuda.launches
    hist = run["history"]
    d_run = _rel(torch.tensor(run["theta_softplus"]), softplus(th_k).cpu())
    want = LAUNCHES_PER_VSGP_STEP * VSGP_STEPS
    print(f"run_kin40k_collapsed, {VSGP_STEPS} steps in chunks of {VSGP_CHUNK}: {run_s:.2f} s "
          f"(host clock, scoring included), training {run['train_wall_s'] * 1e3:.1f} ms; "
          f"step device {run['step_device_ms']:.4f} ms (profiled chunk), host "
          f"{run['step_host_ms']:.4f} ms, idle {run['idle_share']:.3f}; se_gram launches "
          f"{run['gram_launches']} in training (expected {want}), {run_launches} with its "
          f"profiled chunk; -elbo {hist[0]['neg_elbo_chunk_start']:.2f} -> "
          f"{hist[-1]['neg_elbo']:.2f}; SMSE by snapshot "
          f"{[(h['step'], round(h['smse'], 6)) for h in hist]}; theta vs the library run "
          f"relative {d_run:.3e} (limit {VSGP_RTOL['collapsed_theta']:.0e}) [{card}]",
          flush=True)
    check(run["gram_launches"] == want,
          f"run_kin40k_collapsed: {run['gram_launches']} launches, expected {want}")
    check(run_launches == want + LAUNCHES_PER_VSGP_STEP * VSGP_CHUNK,
          f"run_kin40k_collapsed: {run_launches} launches with its profiled chunk")
    check([h["step"] for h in hist] == list(range(VSGP_CHUNK, VSGP_STEPS + 1, VSGP_CHUNK)),
          "run_kin40k_collapsed: snapshots")
    check(all(0.0 < h["smse"] < 1.0 for h in hist), "run_kin40k_collapsed: SMSE")
    check(hist[-1]["neg_elbo"] < hist[0]["neg_elbo_chunk_start"],
          "run_kin40k_collapsed: −ELBO did not fall")
    check(run["step_device_ms"] > 0.0 and 0.0 <= run["idle_share"] < 1.0,
          "run_kin40k_collapsed: no device time")
    check(d_run <= VSGP_RTOL["collapsed_theta"],
          "run_kin40k_collapsed and the library run disagree")
    out["runner"] = dict(launches=run_launches, train_launches=run["gram_launches"],
                         seconds=run_s, theta_vs_library=d_run,
                         **{k: run[k] for k in ("train_wall_s", "step_device_ms",
                                                "step_host_ms", "idle_share", "history")})

    # one collapsed step on a copy: device time by CUDA graph, host time eager
    th_c, st_c = th_k.clone(), {k: v.clone() for k, v in st_k.items()}
    opt = vsgp_optimizer(VSGP_LR)

    def step():
        collapsed_step(kern, opt, th_c, st_c, Xu, X, y, noise, jitter)

    before = se_gram_cuda.launches
    profiled = profile_epoch(lambda: [step() for _ in range(VSGP_CHUNK)],
                             f"profiled eager chunk of {VSGP_CHUNK} collapsed steps", card)
    step_eager, step_queue = eager_ms(step, 20)
    step_dev = cuda_graph_time_ms(step, iters=20, warmup=3)
    se_gram_cuda.launches = before
    print(f"collapsed step: device {step_dev:.4f} ms (CUDA graph of 20 steps), eager "
          f"{step_eager:.4f} ms (host clock, 20 steps between synchronisations), host time "
          f"to queue one {step_queue:.4f} ms -> card idle {1.0 - step_dev / step_eager:.3f} "
          f"of an eager step [{card}]", flush=True)
    out["collapsed"] = dict(launches=launches, steps=VSGP_STEPS, first_call_ms=coll_s * 1e3,
                            neg_elbo_first=float(tr_k[0]), neg_elbo_last=float(tr_k[-1]),
                            theta_kernel_vs_plain=d_th, trace_kernel_vs_plain=d_tr,
                            smse=score, smse_host=score_cpu, predict_card_vs_host=d_pred,
                            predict_f64_ms=pred_ms, step_device_ms=step_dev,
                            step_eager_ms=step_eager, step_queue_ms=step_queue,
                            idle_share=1.0 - step_dev / step_eager, profiled_chunk=profiled)

    # two float32 fit_svgp epochs at kin40k width (batches of 500)
    p0 = init_svgp(theta0, M_IND, torch.float32, noise=noise)
    se_gram_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    pk = fit_svgp(kern, p0, Xu, Xb, yb, N_TRAIN, epochs=SVGP_EPOCHS, learn_noise=False)
    torch.cuda.synchronize()
    svgp_ms = (time.perf_counter() - t) * 1e3 / SVGP_EPOCHS
    svgp_launches = se_gram_cuda.launches
    pp = fit_svgp(plain, p0, Xu, Xb, yb, N_TRAIN, epochs=SVGP_EPOCHS, learn_noise=False)
    check(se_gram_cuda.launches == svgp_launches, "the plain Gram launched the kernel")
    want = LAUNCHES_PER_VSGP_STEP * SVGP_EPOCHS * (N_TRAIN // BATCH)
    d_svgp = _held(f"fit_svgp float32, {SVGP_EPOCHS} epochs of {N_TRAIN // BATCH} batches",
                   tuple(pk[:3]), tuple(pp[:3]), ("theta", "m_white", "A_raw"),
                   {n: VSGP_RTOL["svgp"] for n in ("theta", "m_white", "A_raw")})
    print(f"fit_svgp float32: {svgp_ms:.1f} ms per epoch (host clock), se_gram launches "
          f"{svgp_launches} (expected {want}); theta moved by "
          f"{_rel(pk.theta, theta0):.3e} [{card}]", flush=True)
    check(svgp_launches == want, f"fit_svgp: {svgp_launches} launches, expected {want}")
    check(torch.equal(pk.log_noise, p0.log_noise), "fit_svgp moved the fixed noise")
    check(_rel(pk.theta, theta0) > 1e-4, "fit_svgp: θ did not move")
    out["svgp"] = dict(launches=svgp_launches, epochs=SVGP_EPOCHS, epoch_ms=svgp_ms,
                       kernel_vs_plain=d_svgp)

    # 20 float32 FITC steps at kin40k width
    q0 = init_sparse_gp(theta0)
    se_gram_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    qk, fk = fit_sparse_gp(kern, q0, Xu, X, y, method="fitc", steps=FITC_STEPS,
                           jitter=jitter)
    torch.cuda.synchronize()
    fitc_ms = (time.perf_counter() - t) * 1e3 / FITC_STEPS
    fitc_launches = se_gram_cuda.launches
    qp, fp = fit_sparse_gp(plain, q0, Xu, X, y, method="fitc", steps=FITC_STEPS,
                           jitter=jitter)
    check(se_gram_cuda.launches == fitc_launches, "the plain Gram launched the kernel")
    d_f = dict(theta=_rel(qk.theta, qp.theta), log_noise=_rel(qk.log_noise, qp.log_noise),
               trace=_trace_rel(fk, fp))
    finite = bool(torch.isfinite(qk.theta).all()) and bool(torch.isfinite(fk).all())
    print(f"FITC float32, {FITC_STEPS} steps: {fitc_ms:.2f} ms per step (host clock), "
          f"se_gram launches {fitc_launches}; nlml {float(fk[0]):.2f} -> {float(fk[-1]):.2f}; "
          f"kernel vs plain relative: theta {d_f['theta']:.3e}, log noise "
          f"{d_f['log_noise']:.3e} (limit {VSGP_RTOL['fitc_theta']:.0e}), nlml trace "
          f"{d_f['trace']:.3e} (limit {VSGP_RTOL['fitc_trace']:.0e}); finite {finite} "
          f"[{card}]", flush=True)
    check(finite, "FITC: non-finite θ or NLML")
    check(fitc_launches == LAUNCHES_PER_VSGP_STEP * FITC_STEPS,
          f"FITC: {fitc_launches} launches, expected {LAUNCHES_PER_VSGP_STEP * FITC_STEPS}")
    check(float(fk[-1]) < float(fk[0]), "FITC: the NLML did not fall")
    check(max(d_f["theta"], d_f["log_noise"]) <= VSGP_RTOL["fitc_theta"]
          and d_f["trace"] <= VSGP_RTOL["fitc_trace"], "FITC: kernel and plain disagree")
    out["fitc"] = dict(launches=fitc_launches, steps=FITC_STEPS, step_ms=fitc_ms,
                       kernel_vs_plain=d_f)
    say("phase 10/16 VSGP and FITC baselines: done")
    return out


# the pendulum GPSSM's M-step objective (experiments/pendulum.py): M = 48
# inducing inputs on its structured grid, D = Din = 2, N = 300 states under
# spherical-radial cubature (4 points each): point Gram 48×1200×2, Kuu 48×48×2
PEND_M, PEND_N, PEND_D = 48, 300, 2
PEND_SHAPES = ((PEND_M, PEND_N * 2 * PEND_D, "pendulum M-step point Gram"),
               (PEND_M, PEND_M, "pendulum Kuu"))
# float32 objective and gradient through the kernel against the plain Gram:
# the point Grams differ by float32 rounding, carried through the solve
# against Kuu (near-duplicate inducing pairs, jittered by 3.6e-5 in float32);
# read 7.7e-8 (value) and 2.1e-6 (gradient) on an H100 80GB HBM3 at 700 W
MULTI_F32_RTOL = 2e-5
# float64 card against host: cuBLAS/cuSOLVER and MKL sum in other orders.
# The objective keeps the pendulum grid, whose inducing pairs 9e-5 apart
# give κ(Kuu) ≈ 3e13 at θ0, so its solves carry up to ~κ·ε of rounding
# (read 1.4e-7); the node's rules run on a regular 8×6 grid over
# [−2, 2]×[−4, 4] (κ(Kuu) ≈ 4e4 at θ0; read ≤ 2.3e-13, the θ rule's
# gradient and the Laplace rule's L-BFGS minimiser)
MULTI_F64_OBJ_RTOL = 1e-6
MULTI_F64_RTOL = 1e-10


def _multi_inputs(seed, dtype, device):
    """The M-step objective's inputs at pendulum width, from ``seed``: q(x)
    means along a damped pendulum orbit with small SPD covariances, the next
    states as μ_y, random μ_v and Σ_v, W̄ = 100·I (E[Wishart(1e2, I)])."""
    from gaussianprocessnode_tpu_torch.ops.linalg import sum_blocks_weighted
    from gaussianprocessnode_tpu_torch.utils.datasets import pendulum_inducing

    rng = np.random.default_rng(seed)
    t = np.arange(PEND_N + 1) * 0.1
    orbit = np.stack([1.6 * np.cos(t) * np.exp(-0.01 * t),
                      -1.6 * np.sin(t) * np.exp(-0.01 * t)], axis=1)
    orbit = orbit + 0.05 * rng.standard_normal(orbit.shape)
    A = 0.05 * rng.standard_normal((PEND_N, PEND_D, PEND_D))
    covs = A @ np.swapaxes(A, 1, 2) + 1e-3 * np.eye(PEND_D)
    mu_v = 0.3 * rng.standard_normal(PEND_M * PEND_D)
    B = 0.05 * rng.standard_normal((PEND_M * PEND_D, PEND_M * PEND_D))
    Sigma_v = B @ B.T + 1e-3 * np.eye(PEND_M * PEND_D)
    W = 100.0 * np.eye(PEND_D)
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    Rv = T(Sigma_v + np.outer(mu_v, mu_v))
    return dict(Xu=T(pendulum_inducing()), y_means=T(orbit[1:]), qx_means=T(orbit[:-1]),
                qx_covs=T(covs), sumRv_W=sum_blocks_weighted(Rv, T(W), PEND_D, PEND_M),
                mu_v=T(mu_v), W=T(W)), dict(Sigma_v=T(Sigma_v), Rv=Rv)


def phase_multi(seed, card):
    """The MultiSGP node and the pendulum M-step objective:

    - ``neg_log_backwardmess_multi`` and ``grad_multi`` at the pendulum's
      width in float32, through the kernel (the path, counted) and through
      the plain Gram, held to each other; the same in float64 on the card
      (plain Grams by dtype) held to the host;
    - every rule of the node (out, in by cubature and by Laplace, v, the
      batched v, w, θ with its gradient, the average energy) in float64 on
      the card, held to the same calls on the host in this process;
    - the Gram at 48×1200×2 and 48×48×2 held to its plain version and
      timed."""
    say("phase 11/16 MultiSGP node and M-step objective: start")
    from gaussianprocessnode_tpu_torch import dists as td
    from gaussianprocessnode_tpu_torch.nodes import multisgp as ms
    from gaussianprocessnode_tpu_torch.objectives import grad_multi, neg_log_backwardmess_multi
    from gaussianprocessnode_tpu_torch.ops import psi as psiops
    from gaussianprocessnode_tpu_torch.ops import quadrature as quad
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel, invsoftplus
    from gaussianprocessnode_tpu_torch.ops.linalg import cholinv
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    sr = quad.SphericalRadial()
    out = {}

    def objective(kernel, theta, kw):
        return (neg_log_backwardmess_multi(theta, kernel=kernel, method=sr, **kw),
                grad_multi(theta, kernel=kernel, method=sr, **kw))

    kw32, _ = _multi_inputs(seed, torch.float32, "cuda")
    theta32 = invsoftplus(torch.tensor([1.0, 1.0, 1.0], device="cuda"))
    objective(kern, theta32, kw32)  # warm-up: the libraries' handles
    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    vk, gk = objective(kern, theta32, kw32)
    torch.cuda.synchronize()
    obj_ms = (time.perf_counter() - t) * 1e3
    launches = se_gram_cuda.launches
    vp, gp = objective(plain, theta32, kw32)
    check(se_gram_cuda.launches == launches, "the plain Gram launched the kernel")
    d_v, d_g = abs(float(vk) - float(vp)) / abs(float(vp)), _rel(gk, gp)
    print(f"pendulum M-step objective float32 (M={PEND_M}, N={PEND_N}, SR): value and "
          f"gradient {obj_ms:.2f} ms (host clock), se_gram launches {launches} (Kuu and the "
          f"point Gram, once for the value, once for the gradient); value {float(vk):.4f}; "
          f"kernel vs plain relative: value {d_v:.3e}, gradient {d_g:.3e} (limit "
          f"{MULTI_F32_RTOL:.0e}) [{card}]", flush=True)
    check(bool(torch.isfinite(vk)) and bool(torch.isfinite(gk).all()),
          "M-step objective: non-finite float32 value or gradient")
    check(launches == 4, f"M-step objective: {launches} launches, expected 4")
    check(max(d_v, d_g) <= MULTI_F32_RTOL, "M-step objective: kernel and plain disagree")

    kw64, extra = _multi_inputs(seed, torch.float64, "cuda")
    theta64 = theta32.double()
    v64, g64 = objective(kern, theta64, kw64)
    v64c, g64c = objective(kern, theta64.cpu(), {k: v.cpu() for k, v in kw64.items()})
    d64 = max(abs(float(v64) - float(v64c)) / abs(float(v64c)), _rel(g64.cpu(), g64c))
    d32_64 = _rel(gk.double(), g64)
    print(f"pendulum M-step objective float64, card vs host relative {d64:.3e} (limit "
          f"{MULTI_F64_OBJ_RTOL:.0e}); float32 kernel gradient vs float64 {d32_64:.3e}",
          flush=True)
    check(d64 <= MULTI_F64_OBJ_RTOL, "M-step objective: card and host float64 disagree")
    out["objective"] = dict(launches=launches, ms=obj_ms, value_kernel_vs_plain=d_v,
                            grad_kernel_vs_plain=d_g, f64_card_vs_host=d64,
                            f32_grad_vs_f64=d32_64)

    # the node's rules in float64, card against host
    before = se_gram_cuda.launches

    g1, g2 = np.meshgrid(np.linspace(-2, 2, 8), np.linspace(-4, 4, 6), indexing="ij")
    grid = torch.as_tensor(np.stack([g1.ravel(), g2.ravel()], axis=1))

    def rules(dev):
        c = {k: v.to(dev) for k, v in kw64.items()}
        c["Xu"] = grid.to(dev)
        Sv, Rv = extra["Sigma_v"].to(dev), extra["Rv"].to(dev)
        th = theta64.to(dev)
        Kuu_inv = cholinv(kern.kuu(th, c["Xu"]), jitter=1e-12)
        args = ms.MultiSGPArgs(th, c["Xu"], Kuu_inv)
        W = c["W"] / 100.0
        q_in = td.MvGaussian(c["qx_means"][0], c["qx_covs"][0] + 0.01 * torch.eye(
            PEND_D, dtype=torch.float64, device=dev))
        mu_y, Sy = c["y_means"][0], 0.01 * torch.eye(PEND_D, dtype=torch.float64, device=dev)
        r = {}
        o = ms.out_message(kern, sr, args, q_in, c["mu_v"], W)
        r["out"] = torch.cat([o.mean, o.cov.reshape(-1)])
        m = ms.marginal_in(kern, args, mu_y, c["mu_v"], Rv, W, q_in, sr)
        r["in_cubature"] = torch.cat([m.mean, m.cov.reshape(-1)])
        lap = ms.in_message_laplace(kern, args, mu_y, c["mu_v"], Rv, W, q_in.mean)
        r["in_laplace"] = torch.cat([lap.xi, lap.prec.reshape(-1)])
        v = ms.v_message(kern, sr, args, mu_y, q_in, W)
        r["v"] = torch.cat([v.xi, v.prec.reshape(-1)])
        _, p1, Kp, w = psiops.psi_batch_expected_multi(kern, th, c["Xu"], sr, c["qx_means"],
                                                       c["qx_covs"])
        vb_ = ms.v_message_batch(p1, psiops.sum_weighted_psi2(
            Kp, w, torch.ones(PEND_N, dtype=torch.float64, device=dev)),
            c["y_means"] @ W.T, W)
        r["v_batch"] = torch.cat([vb_.xi, vb_.prec.reshape(-1)])
        wm = ms.w_message(kern, sr, args, mu_y, Sy, q_in, c["mu_v"], Sv)
        r["w"] = wm.inv_scale.reshape(-1)
        logp = ms.theta_log_message(kern, sr, c["Xu"], q_in, mu_y, c["mu_v"], Rv, W)
        x = th.clone().requires_grad_(True)
        lv = logp(x)
        (lg,) = torch.autograd.grad(lv, x)
        r["theta"] = torch.cat([lv.detach().reshape(1), lg])
        qw = td.WishartFast(torch.tensor(PEND_D + 2.0, dtype=torch.float64, device=dev),
                            wm.inv_scale)
        r["energy"] = ms.average_energy(kern, sr, args, mu_y, Sy, q_in, c["mu_v"], Sv,
                                        td.wishart_mean(qw), td.wishart_mean_logdet(qw)
                                        ).reshape(1)
        return {k: v.detach() for k, v in r.items()}

    t = time.perf_counter()
    on_card = rules("cuda")
    torch.cuda.synchronize()
    rules_ms = (time.perf_counter() - t) * 1e3
    on_host = rules("cpu")
    check(se_gram_cuda.launches == before, "float64 rules launched the float32 kernel")
    d_rules = {k: _rel(on_card[k].cpu(), on_host[k]) for k in on_card}
    finite = all(bool(torch.isfinite(v).all()) for v in on_card.values())
    print(f"MultiSGP rules float64 on the card ({rules_ms:.1f} ms, host clock, first call) "
          f"vs host, relative: " + ", ".join(f"{k} {v:.3e}" for k, v in d_rules.items())
          + f" (limit {MULTI_F64_RTOL:.0e}); finite {finite} [{card}]", flush=True)
    check(finite, "MultiSGP rules: non-finite float64 result on the card")
    check(max(d_rules.values()) <= MULTI_F64_RTOL, "MultiSGP rules: card and host disagree")
    out["rules_card_vs_host"] = d_rules

    # the Gram at the objective's shapes, held to its plain version and timed
    var, ls = plain.params(theta32)
    Xu32 = kw32["Xu"]
    pts, _ = quad.points_weights_multi(sr, kw32["qx_means"], kw32["qx_covs"])
    pts = pts.reshape(-1, PEND_D).contiguous()
    before = se_gram_cuda.launches
    errs, shapes = {}, []
    for M, N, role in PEND_SHAPES:
        Z, X = Xu32, (pts if N != M else Xu32)
        K = se_gram_cuda(Z, X, var, ls.contiguous())
        errs[f"{M}x{N}x{PEND_D}"] = _held_to_plain(f"{M}x{N}x{PEND_D} ({role})", Z, X, var,
                                                   ls, K)
        shapes.append(time_gram(Z, X, var, ls.contiguous(), role, card))
    se_gram_cuda.launches = before
    out.update(gram_max_abs=errs, shapes=shapes)
    say("phase 11/16 MultiSGP node and M-step objective: done")
    return out


# the pendulum GPSSM family (experiments/pendulum.py; infer/chain_smoother.py,
# pit_gpssm.py, gpssm_control.py, ut_smoother.py; serve.GPSSMFilter) at the
# runner's full width: T = 300 training and 400 test steps of the runner's
# draw (utils/datasets.py::pendulum, seed 69), M = 48 on pendulum_inducing(),
# D = 2, spherical-radial cubature (4 points per marginal)
GP_T, GP_T_TEST, GP_M, GP_D = 300, 400, 48, 2
GP_EPOCHS, GP_E_SWEEPS, GP_LBFGS = 2, 25, 25  # the runner's epoch: 25 sweeps, 25 L-BFGS steps
GP_JACOBI, GP_GS, GP_PIT, GP_POLISH, GP_CTRL, GP_SMOOTH = 30, 2, 4, 10, 4, 150
GP_SPLIT, GP_CTRL_TEST = 200, 50  # the filter's first window; the controlled filter's steps
# the controlled chain: Din = D + 1, its inducing inputs a 4×4×3 grid over
# [−2, 2]×[−4, 4]×[−1, 1] (κ(Kuu) moderate: its Kuu⁻¹ is factored in the
# model's dtype at jitter 1e-12, as in the JAX package), θ = softplus⁻¹(1)
GP_DC = 1
GP_SHAPES = ((GP_M, GP_T * 2 * GP_D, GP_D, "GPSSM chain Grams (in-message Psi, refinement, "
              "q(v)/q(W) Psi; 3 per Jacobi sweep)"),
             (GP_M, 2 * GP_D, GP_D, "GPSSM filter / Gauss-Seidel step Gram"),
             (GP_M, GP_T * 2 * (GP_D + GP_DC), GP_D + GP_DC,
              "controlled GPSSM chain Psi Gram (6 points per augmented marginal)"))
# Limits, kernel route against plain route (float32): maxima over the
# compared arrays relative to the plain array's largest entry (x-means: max
# absolute difference). On the pendulum's grid (inducing pairs 9e-5 apart,
# κ(Kuu) ≈ 1e6 at the f32 jitter 3.6e-5) the in-message's Ψ2 contraction
# ½tr(W̄)·Kuu⁻¹ reaches ~1e7, so each refinement's log-density carries ~1
# nat of float32 rounding: on the host, a plain Gram perturbed by ±1 ulp
# moved one Jacobi sweep from a shared state by 1.4e-2 in the x-means and
# 3.8e-2 in the x-covariances, a cold epoch's θ by 1.8e-3
# (scripts/gpssm_rounding_twin.py). Those schedules are held
# to the JAX package's own float32 limits (tests/test_e2e.py::TestF32FirstMode:
# x-means within 0.1, free energy within 15 %) and θ to 0.05. The steps
# without that contraction are held tight: the PIT sweep's smoothed moments
# (±1-ulp twin: 1.5e-6; its q(W) rate and free energy, which contract Kuu⁻¹,
# 2.8e-3 and 2.4e-3), the controlled chain on its well-conditioned grid
# (κ ≈ 48; twin ≤ 4.7e-6) and the filters (twin ≤ 1.8e-6).
GP_XMEAN_ABS = 0.1
GP_FE_RTOL = 0.15
GP_THETA_RTOL = 0.05
GP_TIGHT_RTOL = 1e-4
GP_PIT_KUU_RTOL = 2e-2    # the PIT sweep's q(W) rate and free energy
# float64 card against host, from one shared state: on this grid κ(Kuu) ≈
# 3e13 at the float64 jitter 1e-12, so the sweeps and the free energy carry
# κ·ε of rounding: on the host, a plain Gram perturbed by ±1 ulp moved one
# Jacobi sweep by 6.0e-5, one Gauss-Seidel sweep by 7.4e-5, the free energy
# by 2.9e-4, one PIT sweep by 1.9e-6 and the 400-step filter by 3.9e-15
# (scripts/gpssm_rounding_twin.py)
GP_F64_LIMITS = {"jacobi_sweep": 1e-3, "sequential_sweep": 1e-3, "free_energy": 1e-3,
                 "pit_sweep": 1e-5, "filter": 1e-10}
GP_UT_RTOL = 1e-10        # the UT smoother: no Gram, well conditioned


def jacobi_launches(n, fe=True):
    """SE Gram launches of one ``gpssm_vmp`` call: Kuu, three per sweep, two
    for the free energy (Kuu, the node energies' Ψ)."""
    return 1 + 3 * n + (2 if fe else 0)


def sequential_launches(n, T, fe=True):
    """``gpssm_vmp_sequential``: Kuu, 2T + 1 per sweep, the free energy's 2."""
    return 1 + (2 * T + 1) * n + (2 if fe else 0)


def pit_launches(n_pit, n_polish, fe=True):
    """``gpssm_vmp_pit``: Kuu and 2 per PIT sweep, then ``gpssm_vmp``'s."""
    return 1 + 2 * n_pit + (jacobi_launches(n_polish, fe) if n_polish else (2 if fe else 0))


def _relmax(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _state_diff(a, b) -> dict:
    """State a against state b: max |Δ x-mean| and the relative differences
    of the other fields."""
    d = {"x_means_abs": float((a.x_means.double() - b.x_means.double()).abs().max())}
    for f in ("x_covs", "xi_v", "prec_v", "W_rate"):
        d[f] = _relmax(getattr(a, f), getattr(b, f))
    return d


def _finite_state(s) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in s)


def _gp_hyperopt(s, kernel, theta, state, epochs, counts=None):
    """``epochs`` of the runner's epoch (experiments/pendulum.py::run) with
    ``kernel`` in place of the runner's: 25 warm Jacobi sweeps, then 25
    L-BFGS steps on the M-step objective. Returns (θ, state, FE trace)."""
    from gaussianprocessnode_tpu_torch.experiments import pendulum as runner
    from gaussianprocessnode_tpu_torch.infer.training import lbfgs_solve
    from gaussianprocessnode_tpu_torch.objectives import neg_log_backwardmess_multi
    from gaussianprocessnode_tpu_torch.ops.quadrature import SphericalRadial

    s = dict(s, kernel=kernel)
    fes = []
    for _ in range(epochs):
        state, fe = runner.vmp(s, theta, GP_E_SWEEPS, init_state=state)
        kw = dict(kernel=kernel, Xu=s["Xu"], method=SphericalRadial(),
                  **runner.mstep_stats(state, GP_M, GP_D))
        theta, _ = lbfgs_solve(lambda th, kw=kw: neg_log_backwardmess_multi(th, **kw), theta,
                               max_steps=GP_LBFGS, counts=counts)
        fes.append(fe)
    return theta, state, torch.stack(fes)


def _gp_control_problem(s, seed, dtype):
    """The controlled chain's inputs from ``seed``: the training
    observations, a smooth control u_t, the 48-point grid in D + 1 dims."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 4), np.linspace(-1, 1, 3),
                    indexing="ij")
    Xu = np.stack([a.ravel() for a in g], axis=1)
    t = np.arange(GP_T + GP_CTRL_TEST)
    us = np.sin(0.05 * t + rng.uniform(0, 2 * np.pi))[:, None] + 0.05 * rng.standard_normal(
        (t.size, 1))
    dev = s["Xu"].device
    T = lambda a: torch.as_tensor(a).to(dtype).to(dev)  # noqa: E731
    theta = T(np.log(np.expm1(np.ones(1 + GP_D + GP_DC))))
    return theta, T(Xu), T(us[:GP_T]), T(us[GP_T:])


def gp_routes(kern, plain, dev, seed):
    """Every GPSSM engine through ``kern`` and through ``plain`` on ``dev``
    in float32, from the same inputs: returns (diffs, shared θ, shared
    state, the kernel route's launches by engine, the setup)."""
    from gaussianprocessnode_tpu_torch.experiments import pendulum as runner
    from gaussianprocessnode_tpu_torch.infer import chain_smoother as tc
    from gaussianprocessnode_tpu_torch.infer import gpssm_control as tcc
    from gaussianprocessnode_tpu_torch.infer.pit_gpssm import gpssm_vmp_pit
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.serve import GPSSMFilter

    s = runner.setup(dev, torch.float32)
    prior = (s["P"], s["prior_x0_mean"], s["prior_x0_cov"], s["prior_v"], runner.PRIOR_W_DF,
             s["prior_W_scale"])
    y, yt, Xu = s["y_train"], s["y_test"], s["Xu"]
    diffs, launches = {}, {}

    def counted(name, fn):
        n0 = se_gram_cuda.launches
        r = fn(kern)
        launches[name] = se_gram_cuda.launches - n0
        n1 = se_gram_cuda.launches
        rp = fn(plain)
        if se_gram_cuda.launches != n1:
            raise SmokeFailure(f"{name}: the plain route launched the kernel")
        return r, rp

    # the hyperparameter epochs: epoch 1 from the cold start, epoch 2 from the
    # plain route's epoch-1 carry in both routes
    caps = {}
    (thk, stk, fek), (thp, stp, fep) = counted(
        "epoch_1", lambda k: _gp_hyperopt(s, k, s["theta0"], None, 1, caps))
    diffs["epoch_1"] = dict(theta=_relmax(thk, thp), fe=_relmax(fek, fep), **_state_diff(stk, stp))
    (thk, stk, fek), (thp, stp, fep) = counted(
        "epoch_2", lambda k: _gp_hyperopt(s, k, thp, stp, 1, caps))
    diffs["epoch_2"] = dict(theta=_relmax(thk, thp), fe=_relmax(fek, fep), **_state_diff(stk, stp))
    theta, S = thp, stp  # the shared θ and state from here on

    def vmp(k, **kw):
        return tc.gpssm_vmp(k, theta, Xu, y, *prior, **kw)

    # Jacobi: a cold schedule, and one sweep from the shared state
    (sk, fk), (sp, fp) = counted("jacobi", lambda k: vmp(k, n_iters=GP_JACOBI))
    diffs["jacobi_cold"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    jac_k, jac_p = sk, sp
    (sk, fk), (sp, fp) = counted("jacobi_sweep", lambda k: vmp(k, n_iters=1, init_state=S))
    diffs["jacobi_sweep"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    # Gauss-Seidel from the shared state
    (sk, fk), (sp, fp) = counted("sequential", lambda k: tc.gpssm_vmp_sequential(
        k, theta, Xu, y, *prior, n_iters=GP_GS, init_state=S))
    diffs["sequential"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    # parallel in time: a cold schedule, and one PIT sweep from the shared state
    (sk, fk), (sp, fp) = counted("pit", lambda k: gpssm_vmp_pit(
        k, theta, Xu, y, *prior, n_pit=GP_PIT, n_polish=GP_POLISH))
    diffs["pit_cold"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    (sk, fk), (sp, fp) = counted("pit_sweep", lambda k: gpssm_vmp_pit(
        k, theta, Xu, y, *prior, n_pit=1, n_polish=0, init_state=S))
    diffs["pit_sweep"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    # the controlled chain (Din = 3): a cold schedule, one sweep from the plain
    # route's state, and the controlled filter
    th_c, Xu_c, us, us_t = _gp_control_problem(s, seed, torch.float32)

    def ctrl(k, **kw):
        return tcc.gpssm_control_vmp(k, th_c, Xu_c, y, us, *prior, **kw)

    (sk, fk), (sp, fp) = counted("control", lambda k: ctrl(k, n_iters=GP_CTRL))
    diffs["control_cold"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    S_c = sp
    (sk, fk), (sp, fp) = counted("control_sweep", lambda k: ctrl(k, n_iters=1, init_state=S_c))
    diffs["control_sweep"] = dict(fe=_relmax(fk, fp), **_state_diff(sk, sp))
    (mk, _), (mp, _) = counted("control_filter", lambda k: tcc.one_step_ahead_control(
        k, th_c, Xu_c, S_c, yt[:GP_CTRL_TEST], us_t, s["P"]))
    diffs["control_filter"] = _relmax(mk, mp)
    # the filter: one window of 400 steps, the same as two chained windows,
    # kernel against plain, from the shared state
    hk = GPSSMFilter.from_state(kern, theta, Xu, S, s["P"])
    hp = GPSSMFilter.from_state(plain, theta, Xu, S, s["P"])
    n0 = se_gram_cuda.launches
    m_one, c_one, end_one = hk(yt)
    launches["filter"] = se_gram_cuda.launches - n0
    m1, _, mid = hk(yt[:GP_SPLIT])
    m2, _, end2 = hk(yt[GP_SPLIT:], mid)
    chained = (bool(torch.equal(torch.cat([m1, m2]), m_one))
               and bool(torch.equal(end2[0], end_one[0])) and bool(torch.equal(end2[1], end_one[1])))
    n1 = se_gram_cuda.launches
    m_p, _, _ = hp(yt)
    if se_gram_cuda.launches != n1:
        raise SmokeFailure("filter: the plain route launched the kernel")
    diffs["filter"] = _relmax(m_one, m_p)
    finite = (all(_finite_state(x) for x in (jac_k, jac_p, S, S_c))
              and bool(torch.isfinite(m_one).all()) and bool(torch.isfinite(mk).all()))
    return dict(diffs=diffs, theta=theta, state=S, launches=launches, setup=s, prior=prior,
                chained=chained, finite=finite, graph_captures=caps.get("graph_captures", 0),
                jacobi_state=jac_k)


def gp_f64_pair(s, prior, theta, S, first=("cuda", None), second=("cpu", None)):
    """One Jacobi sweep (with its free energy), one Gauss-Seidel sweep, one
    PIT sweep, the free energy and the 400-step filter in float64, from one
    shared state, on ``first`` = (device, kernel) against ``second`` (the
    setup's kernel where None): the card against the host. Returns the
    relative differences and whether ``first``'s results are finite."""
    from gaussianprocessnode_tpu_torch.infer import chain_smoother as tc
    from gaussianprocessnode_tpu_torch.infer.pit_gpssm import gpssm_vmp_pit

    def calls(dev, k):
        f64 = lambda t: t.to(torch.float64).to(dev)  # noqa: E731
        th, Xu, y, yt = f64(theta), f64(s["Xu"]), f64(s["y_train"]), f64(s["y_test"])
        pr = tuple(tc.MvGaussianNat(f64(p.xi), f64(p.prec)) if isinstance(p, tc.MvGaussianNat)
                   else (f64(p) if isinstance(p, torch.Tensor) else p) for p in prior)
        st = tc.GPSSMState(*(f64(t) for t in S))
        k = k or s["kernel"]
        r = {}
        a, fe = tc.gpssm_vmp(k, th, Xu, y, *pr, n_iters=1, init_state=st)
        r["jacobi_sweep"] = torch.cat([a.x_means.reshape(-1), a.x_covs.reshape(-1),
                                       a.xi_v, a.W_rate.reshape(-1), fe.reshape(1)])
        a, _ = tc.gpssm_vmp_sequential(k, th, Xu, y, *pr, n_iters=1, init_state=st,
                                       compute_fe=False)
        r["sequential_sweep"] = torch.cat([a.x_means.reshape(-1), a.x_covs.reshape(-1),
                                           a.xi_v, a.W_rate.reshape(-1)])
        a, _ = gpssm_vmp_pit(k, th, Xu, y, *pr, n_pit=1, n_polish=0, compute_fe=False,
                             init_state=st)
        r["pit_sweep"] = torch.cat([a.x_means.reshape(-1), a.x_covs.reshape(-1), a.xi_v,
                                    a.W_rate.reshape(-1)])
        r["free_energy"] = tc.gpssm_free_energy(k, th, Xu, y, *pr, st).reshape(1)
        r["filter"] = tc.one_step_ahead(k, th, Xu, st, yt, pr[0])[0].reshape(-1)
        return {key: v.detach().cpu() for key, v in r.items()}

    a, b = calls(*first), calls(*second)
    return {k: _relmax(a[k], b[k]) for k in a}, all(
        bool(torch.isfinite(v).all()) for v in a.values())


def _gp_ut_card_vs_host(s):
    """The UT smoother (150 sweeps, float64), card against host."""
    from gaussianprocessnode_tpu_torch.experiments.pendulum import PRIOR_W_DF, _pendulum_step
    from gaussianprocessnode_tpu_torch.infer.ut_smoother import ut_smoother_vmp

    def ut(dev):
        f64 = lambda t: t.to(torch.float64).to(dev)  # noqa: E731
        st = ut_smoother_vmp(_pendulum_step(s["dt"]), f64(s["y_train"]), f64(s["P"]),
                             f64(s["prior_x0_mean"]), f64(s["prior_x0_cov"]), PRIOR_W_DF,
                             f64(s["prior_W_scale"]), n_iters=GP_SMOOTH)
        return torch.cat([st.x_means.reshape(-1), st.x_covs.reshape(-1),
                          st.W_rate.reshape(-1)]).cpu()

    torch.cuda.synchronize()
    t = time.perf_counter()
    card = ut("cuda")
    card_s = time.perf_counter() - t
    return _relmax(card, ut("cpu")), card_s, bool(torch.isfinite(card).all())


def phase_gpssm(seed, card):
    """The pendulum GPSSM family at the runner's full width (T = 300 / 400,
    M = 48, D = 2, float32 through the kernel unless said):

    - the main path: ``experiments/pendulum.py::run`` itself, 2
      hyperparameter epochs, the 150-sweep final smoothing, the 400-step
      filter and the UT baseline, its Gram launches counted exactly;
    - 2 epochs of the runner's epoch through the kernel and through the
      plain Gram (epoch 2 from the plain route's epoch-1 carry in both);
      from the plain route's θ and state: 30 cold Jacobi sweeps and one
      warm, 2 Gauss-Seidel sweeps, ``gpssm_vmp_pit`` (4 PIT + 10 Jacobi
      sweeps) and one PIT sweep, 4 controlled sweeps (Din = 3, controls
      from ``seed``) and one, the controlled filter (50 steps) and the
      400-step filter as one window and as two chained windows (which
      must be equal), kernel route held to plain route, launches counted
      per engine by formula;
    - one Jacobi, Gauss-Seidel and PIT sweep, the free energy and the
      filter in float64 on the card against the host; the UT smoother
      (150 sweeps, float64) card against host;
    - a Jacobi sweep and a PIT sweep under ``set_sync_debug_mode("error")``;
      their device time (CUDA graph) and eager host time, and a filtered
      step's; the chain's Gram shapes held to the plain Gram and timed."""
    say("phase 12/16 GPSSM family: start")
    from gaussianprocessnode_tpu_torch.experiments import pendulum as runner
    from gaussianprocessnode_tpu_torch.infer import chain_smoother as tc
    from gaussianprocessnode_tpu_torch.infer import pit_gpssm as tp
    from gaussianprocessnode_tpu_torch.ops import quadrature as quad
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.profiling import cuda_graph_time_ms

    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    out = {}

    # the main path: counts at 0 just before, read just after
    se_gram_cuda.launches = 0
    res = runner.run(epochs=GP_EPOCHS, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    total = se_gram_cuda.launches
    caps = res["lbfgs_graph_captures"]
    # each M-step captures its objective once (an eager warm-up and the
    # capture: Kuu and the point Gram each); the replays launch no Python
    hyper = GP_EPOCHS * jacobi_launches(GP_E_SWEEPS) + 4 * caps
    expect = hyper + jacobi_launches(GP_SMOOTH) + GP_T_TEST
    print(f"pendulum runner float32 ({GP_EPOCHS} epochs, T={GP_T}, M={GP_M}): hyperopt "
          f"{res['hyperopt_seconds']:.3f} s ({res['host_ms_per_epoch']:.1f} ms per epoch), "
          f"smoothing {res['smoothing_seconds']:.3f} s; se_gram launches {total} (hyperopt "
          f"{res['gram_launches']}, expected {hyper} and {expect} in all); SMSE smooth "
          f"{res['smse_smooth']}, predict {res['smse_predict']}, UT {res['smse_ut_baseline']}; "
          f"theta {res['theta_softplus']} [{card}]", flush=True)
    check(res["finite"] and all(np.isfinite(res[k]).all() for k in
                                ("smse_smooth", "smse_predict", "smse_ut_baseline")),
          "pendulum runner: non-finite result")
    check(caps == GP_EPOCHS, f"pendulum runner: {caps} graph captures, expected {GP_EPOCHS}")
    check(res["gram_launches"] == hyper and total == expect,
          f"pendulum runner: {res['gram_launches']}/{total} launches, expected {hyper}/{expect}")
    out["runner"] = dict(launches=total, hyperopt_launches=hyper,
                         **{k: res[k] for k in ("hyperopt_seconds", "smoothing_seconds",
                                                "host_ms_per_epoch", "smse_smooth",
                                                "smse_predict", "smse_ut_baseline",
                                                "theta_softplus", "fe_trace")})

    t = time.perf_counter()
    r = gp_routes(kern, plain, "cuda", seed)
    torch.cuda.synchronize()
    routes_s = time.perf_counter() - t
    L, d = r["launches"], r["diffs"]
    T = GP_T
    expect = {"epoch_1": jacobi_launches(GP_E_SWEEPS) + 4, "epoch_2": jacobi_launches(GP_E_SWEEPS) + 4,
              "jacobi": jacobi_launches(GP_JACOBI), "jacobi_sweep": jacobi_launches(1),
              "sequential": sequential_launches(GP_GS, T), "pit": pit_launches(GP_PIT, GP_POLISH),
              "pit_sweep": pit_launches(1, 0), "control": jacobi_launches(GP_CTRL),
              "control_sweep": jacobi_launches(1), "control_filter": GP_CTRL_TEST,
              "filter": GP_T_TEST}
    for name, v in d.items():
        print(f"GPSSM {name} kernel vs plain: " + (f"{v:.3e}" if isinstance(v, float) else
              ", ".join(f"{k} {x:.3e}" for k, x in v.items())) + f"; launches {L.get(name)}"
              f" (expected {expect.get(name)})", flush=True)
    print(f"GPSSM routes: {routes_s:.2f} s (host clock, both routes); chained filter windows "
          f"equal one window: {r['chained']} [{card}]", flush=True)
    check(r["finite"], "GPSSM: non-finite state or prediction")
    check(r["chained"], "GPSSMFilter: two chained windows differ from one window")
    check(L == expect, f"GPSSM launches {L}, expected {expect}")
    for name in ("epoch_1", "epoch_2", "jacobi_cold", "jacobi_sweep", "sequential", "pit_cold",
                 "control_cold"):
        v = d[name]
        check(v["x_means_abs"] <= GP_XMEAN_ABS and v["fe"] <= GP_FE_RTOL,
              f"GPSSM {name}: kernel and plain disagree")
    for name in ("epoch_1", "epoch_2"):
        check(d[name]["theta"] <= GP_THETA_RTOL, f"GPSSM {name}: θ of kernel and plain disagree")
    pit = d["pit_sweep"]
    check(max(pit["x_means_abs"], pit["x_covs"], pit["xi_v"], pit["prec_v"]) <= GP_TIGHT_RTOL
          and max(pit["W_rate"], pit["fe"]) <= GP_PIT_KUU_RTOL,
          "GPSSM pit_sweep: kernel and plain disagree")
    check(max(d["control_sweep"].values()) <= GP_TIGHT_RTOL,
          "GPSSM control_sweep: kernel and plain disagree")
    check(max(d["filter"], d["control_filter"]) <= GP_TIGHT_RTOL,
          "GPSSM filter: kernel and plain disagree")
    out["routes"] = dict(diffs=d, launches=L, seconds=routes_s)

    # float64 on the card against the host, and the UT smoother
    before = se_gram_cuda.launches
    d64, fin64 = gp_f64_pair(r["setup"], r["prior"], r["theta"], r["state"])
    d_ut, ut_s, fin_ut = _gp_ut_card_vs_host(r["setup"])
    check(se_gram_cuda.launches == before, "float64 GPSSM launched the float32 kernel")
    print("GPSSM float64 card vs host: " + ", ".join(f"{k} {v:.3e}" for k, v in d64.items())
          + f" (limits {GP_F64_LIMITS}); UT smoother {GP_SMOOTH} sweeps {d_ut:.3e} (limit "
          f"{GP_UT_RTOL:.0e}), {ut_s:.3f} s on the card", flush=True)
    check(fin64 and fin_ut, "GPSSM float64: non-finite result on the card")
    check(all(d64[k] <= GP_F64_LIMITS[k] for k in d64), "GPSSM float64: card and host disagree")
    check(d_ut <= GP_UT_RTOL, "UT smoother: card and host disagree")
    out["f64_card_vs_host"], out["ut_card_vs_host"] = d64, d_ut

    # sync-free sweeps, then their device and host times (launches here are
    # not counted on any path)
    launches = se_gram_cuda.launches
    s, prior, theta, S = r["setup"], r["prior"], r["theta"], r["state"]
    y, Xu, P = s["y_train"], s["Xu"], s["P"]
    kuu_inv = tc._kuu_inv_f64(kern, theta, Xu, torch.float32)
    c = tc._chain_consts(kuu_inv, y, *prior[:3], prior[5])
    S0_inv = c.S0_inv
    jac = lambda: tc._jacobi_sweep(kern, theta, Xu, c, prior[3], prior[4], S)  # noqa: E731
    pit = lambda: tp._pit_sweep(kern, theta, Xu, kuu_inv, S0_inv, y, P, prior[1],  # noqa: E731
                                prior[2], prior[3], prior[4], S)
    frozen = tc.filter_frozen(S, P)
    carry = (S.x_means[-1], S.x_covs[-1])
    step = lambda: tc.filter_stream(kern, theta, Xu, frozen, s["y_test"][:1], carry)  # noqa: E731
    jac(), pit(), step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        jac(), pit()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    times = {}
    for name, fn in (("jacobi_sweep", jac), ("pit_sweep", pit), ("filter_step", step)):
        dev_ms = cuda_graph_time_ms(fn, iters=10, warmup=2)
        host_ms, queue_ms = eager_ms(fn, 10)
        times[name] = dict(device_ms=dev_ms, eager_host_ms=host_ms, queue_ms=queue_ms,
                           idle=1.0 - dev_ms / host_ms)
        print(f"GPSSM {name} float32: device {dev_ms:.4f} ms (CUDA graph), eager {host_ms:.4f} "
              f"ms host clock (queued in {queue_ms:.4f} ms), idle share "
              f"{1.0 - dev_ms / host_ms:.3f} [{card}]", flush=True)
    se_gram_cuda.launches = launches
    out["times"] = times

    # the chain's Gram shapes, held to the plain version and timed
    var, ls = plain.params(theta)
    sr = quad.SphericalRadial()
    pts, _ = quad.points_weights_multi(sr, S.x_means[:-1], S.x_covs[:-1])
    pts = pts.reshape(-1, GP_D).contiguous()
    th_c, Xu_c, us, _ = _gp_control_problem(s, seed, torch.float32)
    m_a, V_a = tc.augment_control(S.x_means[:-1], S.x_covs[:-1], us)
    pts_c, _ = quad.points_weights_multi(sr, m_a, V_a)
    pts_c = pts_c.reshape(-1, GP_D + GP_DC).contiguous()
    var_c, ls_c = plain.params(th_c)
    errs, shapes = {}, []
    for (M, N, Din, role), (Z, X, v_, l_) in zip(GP_SHAPES, (
            (Xu, pts, var, ls), (Xu, pts[:2 * GP_D], var, ls), (Xu_c, pts_c, var_c, ls_c))):
        l_ = l_.contiguous()
        K = se_gram_cuda(Z, X, v_, l_)
        errs[f"{M}x{N}x{Din}"] = _held_to_plain(f"{M}x{N}x{Din} ({role})", Z, X, v_, l_, K)
        shapes.append(time_gram(Z, X, v_, l_, role, card))
    se_gram_cuda.launches = launches
    out.update(gram_max_abs=errs, shapes=shapes)
    out["launches_by_path"] = {
        "pendulum_hyperopt_f32": hyper,
        "pendulum_runner_smoothing_and_filter_f32": total - hyper,
        "gpssm_jacobi_f32": L["jacobi"], "gpssm_sequential_f32": L["sequential"],
        "gpssm_pit_f32": L["pit"], "gpssm_control_f32": L["control"],
        "gpssm_filter_f32": L["filter"]}
    out["launches"] = (total + sum(L.values()))
    say("phase 12/16 GPSSM family: done")
    return out

# the GPLVM runner's configuration (experiments/gplvm.py): N = 200 rows of
# 12-D synthetic oil-flow data (40 more held out for the embedding), Din =
# 2, M = 30 inducing inputs; 2 epochs of fit_gplvm_grad (6 sweeps of 20
# Laplace L-BFGS steps each, 8 M-step L-BFGS steps), float64
GPLVM_N, GPLVM_HELD, GPLVM_M, GPLVM_DIN = 200, 40, 30, 2
GPLVM_EPOCHS, GPLVM_SWEEPS = 2, 6
GPLVM_SHAPES = ((GPLVM_M, GPLVM_N * 2 * GPLVM_DIN, "GPLVM Psi point Gram"),
                (GPLVM_M, GPLVM_M, "GPLVM Kuu"))
# float64 card against host, to limits from a measured twin
# (scripts/gplvm_rounding_twin.py: the host's fit with every Gram entry
# moved by ±1 float64 ulp against the plain one, seeds 0-3 on the CPU).
# Rounding reaches the fit through θ: one ulp of the Gram moved θ by
# 3.0e-9-8.2e-9 relative, the FE trace by 1.5e-9-7.5e-8 and the x-means
# by 1.2e-7-1.0e-6, smoothly over all rows; the limits are 100x and more
# above those (card and host differ in every GEMM and factorization, not
# in the Gram alone).
# A row counts as moved where its x-mean differs by more than
# GPLVM_ROW_TOL, another mode of its multimodal Laplace objective: none
# may. The linesearch choices that steer a row between modes compare
# values far apart early in its L-BFGS, and those at the rounding floor
# move it by rounding only; the twin moved no row in 800 row fits.
GPLVM_ROW_TOL = 1e-3
GPLVM_F64_LIMITS = {"theta": 1e-6, "fe_trace": 2e-6, "x_means_abs": 3e-4, "rows_moved": 0}
# embedding the training rows from the latents of GPLVM_POLISH_SWEEPS more
# sweeps at the trained θ, one pass: those latents are the map's fixed
# points to the convergence of its 20-step L-BFGS. Its slowest rows end
# up to 7.0e-7 from their mode in the JAX package and 2.6e-7 in the port
# on the same data (scripts/gplvm_embed_witness.py on the host, seeds 0-2,
# after 2-5 polish sweeps; the JAX package measured ≤ 4e-10 on 3PhData at
# N = 120, tests/test_embed_and_filter.py); the limit is ~14x the larger.
# Embedding from the fit's state itself, whose q(v) is one sweep behind,
# moves rows by 5.6e-3-1.1; a wrong q(v) or θ by more.
GPLVM_POLISH_SWEEPS = 2
GPLVM_FIXED_POINT = 1e-5
# launches of one float32 gplvm_vmp sweep with its free energy: the prior's
# Kuu, the sweep's point Gram and the x-update's Kuu, the free energy's Kuu
# and point Gram
GPLVM_F32_SWEEP_LAUNCHES = 5


def gplvm_setup(seed, device, dtype=torch.float64):
    """The runner's inputs at full width on ``device``:
    ``experiments/gplvm.py::setup`` of the runner's 200 synthetic oil-flow
    rows from ``seed``, and the 40 rows that follow them in a longer draw
    (the first 200 rows of any draw are the runner's), held out, their
    prior means projected on the training rows' two principal axes."""
    from gaussianprocessnode_tpu_torch.experiments import gplvm as runner
    from gaussianprocessnode_tpu_torch.utils.datasets import oil_flow_synthetic

    Y_all, labels = oil_flow_synthetic(seed, GPLVM_N + GPLVM_HELD)
    Y_np, n = Y_all[:GPLVM_N], GPLVM_N
    check(np.array_equal(Y_np, runner.load_data("synthetic", seed)[0]),
          "GPLVM: the training rows are not the runner's")
    _, theta0, Xu, Y, Xm, _ = runner.setup(Y_np, GPLVM_M, device, dtype)
    mu = Y_np.mean(axis=0)
    Vt = np.linalg.svd(Y_np - mu, full_matrices=False)[2]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    return dict(theta0=theta0, Xu=Xu, Y=Y, Xm=Xm, Y_held=t(Y_all[n:]),
                Xm_held=t((Y_all[n:] - mu) @ Vt[:2].T), labels=labels)


def gplvm_fit(seed, device, kernel=None, counts=None):
    """``fit_gplvm_grad`` for GPLVM_EPOCHS epochs on ``device`` (the plain
    float64 kernel where None). Returns (setup, θ, state, FE trace)."""
    from gaussianprocessnode_tpu_torch.infer.gplvm import fit_gplvm_grad
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel

    s = gplvm_setup(seed, device)
    kernel = kernel or Kernel("se", "softplus")
    theta, state, fe = fit_gplvm_grad(kernel, s["theta0"], s["Xu"], s["Y"], s["Xm"],
                                      epochs=GPLVM_EPOCHS, n_iters=GPLVM_SWEEPS, counts=counts)
    return s, theta, state, fe


def gplvm_diff(a, b) -> dict:
    """Two ``gplvm_fit`` results: θ and the FE trace relative, the number
    of rows whose x-means moved by more than GPLVM_ROW_TOL, the largest
    x-mean difference of the others and of all."""
    _, ta, sa, fa = a
    _, tb, sb, fb = b
    dx = (sa.x_means.double().cpu() - sb.x_means.double().cpu()).abs().amax(dim=-1)
    moved = dx > GPLVM_ROW_TOL
    return {"theta": _relmax(ta, tb), "fe_trace": _relmax(fa, fb),
            "x_means_abs": float(dx[~moved].max()) if bool((~moved).any()) else 0.0,
            "rows_moved": int(moved.sum()), "x_means_abs_all": float(dx.max())}


def _gplvm_f32(s, theta, state, kern, plain):
    """The float32 paths through the kernel against the plain Gram: the
    Ψ-statistics of the trained marginals (30×800×2) and one cold
    ``gplvm_vmp`` sweep with its free energy. Returns (differences, their
    limits, the sweep's launches, per route its free energy and the
    smallest eigenvalue of B with the x-means difference, whether the
    kernel route's state is finite, the cubature points)."""
    from gaussianprocessnode_tpu_torch.infer.gplvm import gplvm_vmp
    from gaussianprocessnode_tpu_torch.ops import psi as psiops
    from gaussianprocessnode_tpu_torch.ops import quadrature as quad
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.utils.profiling import synchronize

    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    th, Xu, Y, Xm = f32(theta), f32(s["Xu"]), f32(s["Y"]), f32(s["Xm"])
    m, V = f32(state.x_means), f32(state.x_covs)
    sr = quad.SphericalRadial()
    N, P = m.shape[0], 2 * GPLVM_DIN
    ones = torch.ones(N, device=th.device)
    psi = {}
    for name, k in (("kernel", kern), ("plain", plain)):
        p0, p1, Kp, w = psiops.psi_batch_expected_multi(k, th, Xu, sr, m, V)
        psi[name] = (p0, p1, psiops.sum_weighted_psi2(Kp, w, ones))
    var, ls = plain.params(th)
    pts, _ = quad.points_weights_multi(sr, m, V)
    tol = gram_tolerance(Xu / ls, pts.reshape(-1, GPLVM_DIN) / ls, var)
    v = float(var)
    lim_psi1 = tol + 2 * P * EPS32 * v
    lim_psi2 = N * (2 * v * tol + tol * tol) + 2 * N * P * EPS32 * N * v * v
    w_val = 100.0  # the runner's W = 100·I
    ysum = float(Y.abs().sum(dim=0).max())
    limits = {"psi0": 0.0, "psi1": lim_psi1, "psi2_sum": lim_psi2,
              "xi_v": w_val * ysum * (lim_psi1 + 2 * N * EPS32 * v),
              "prec_v": w_val * lim_psi2 + 2 * EPS32 * w_val * float(psi["plain"][2].abs().max())}
    d = {k: float((a.double() - b.double()).abs().max())
         for k, a, b in zip(("psi0", "psi1", "psi2_sum"), psi["kernel"], psi["plain"])}
    sweeps = {}
    for name, k in (("kernel", kern), ("plain", plain)):
        synchronize(th.device)
        se_gram_cuda.launches = 0  # the f32 GPLVM path: counts at 0 just before
        sweeps[name] = gplvm_vmp(k, th, Xu, Y, Xm, n_iters=1)
        synchronize(th.device)
        if name == "kernel":
            launches = se_gram_cuda.launches
    (sk, fk), (sp, fp) = sweeps["kernel"], sweeps["plain"]
    d["xi_v"] = float((sk.xi_v - sp.xi_v).abs().max())
    d["prec_v"] = float((sk.prec_v - sp.prec_v).abs().max())
    # B = Kuu + w·ΣΨ2, whose factor gives the q(v) moments: its smallest
    # eigenvalue, and the free energy, per route
    M = GPLVM_M
    info = {name: dict(fe=float(fe) if bool(torch.isfinite(fe)) else "non-finite",
                       b_min_eig=float(torch.linalg.eigvalsh(
        0.5 * (st.prec_v[:M, :M] + st.prec_v[:M, :M].T)).min()))
        for name, (st, fe) in sweeps.items()}
    info["x_means_abs"] = float((sk.x_means - sp.x_means).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in sk)
    return d, limits, launches, info, finite, pts


def _gplvm_front_end(seed, s, theta):
    """Each model class's ``infer`` on the card at a small size (the GPLVM
    at full width, one sweep), bit for bit against its direct call."""
    from gaussianprocessnode_tpu_torch.dists import GammaShapeRate, MvGaussianNat
    from gaussianprocessnode_tpu_torch.infer import batch_vmp, chain_smoother, gplvm, model
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.utils.datasets import (pendulum, toy_classification,
                                                              toy_sinc)

    k = Kernel("se", "softplus")
    f64, dev = torch.float64, theta.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    same = {}

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for v in (x or ()) for t in leaves(v)]

    def leaves_equal(a, b):
        la, lb = leaves(a), leaves(b)
        return len(la) == len(lb) > 0 and all(torch.equal(x, y) for x, y in zip(la, lb))

    same["GPLVM"] = leaves_equal(
        model.GPLVM(k, s["Xu"]).infer(theta, s["Y"], s["Xm"], iterations=1),
        gplvm.gplvm_vmp(k, theta, s["Xu"], s["Y"], s["Xm"], n_iters=1))
    ds = toy_sinc(n_train=50, n_test=10, seed=seed)
    Xu = t(np.linspace(-1.0, 1.0, 8)[:, None] * np.abs(ds.x_train).max())
    th2 = t(np.log(np.expm1(np.ones(2))))
    pv = MvGaussianNat(torch.zeros(8, dtype=f64, device=dev),
                       torch.eye(8, dtype=f64, device=dev) / 50.0)
    g = GammaShapeRate(t(1e-2), t(1e-2))
    same["SGPRegression"] = leaves_equal(
        model.SGPRegression(k, Xu).infer(th2, t(ds.x_train), t(ds.y_train), iterations=3),
        batch_vmp.regression_vmp(k, th2, Xu, t(ds.x_train), t(ds.y_train), pv, g, n_iters=3))
    dc = toy_classification(n_train=60, n_test=10, seed=seed)
    Xc = t(dc.x_train[:8])
    th3 = t(np.log(np.expm1(np.ones(1 + dc.x_train.shape[1]))))
    same["SGPClassification"] = leaves_equal(
        model.SGPClassification(k, Xc).infer(th3, t(dc.x_train), t(dc.y_train), iterations=3),
        batch_vmp.classification_vmp(k, th3, Xc, t(dc.x_train), t(dc.y_train), pv, g, g,
                                     n_iters=3))
    _, ys, _, P, _ = pendulum()
    g1, g2 = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-4, 4, 3), indexing="ij")
    Xg = t(np.stack([g1.ravel(), g2.ravel()], axis=1))
    x0, c0 = t([1.6, 0.0]), t(0.1 * np.eye(2))
    pv2 = MvGaussianNat(torch.zeros(24, dtype=f64, device=dev),
                        torch.eye(24, dtype=f64, device=dev) / 50.0)
    same["GPSSM"] = leaves_equal(
        model.GPSSM(k, Xg, t(P), x0, c0).infer(th3, t(ys[:30]), iterations=2),
        chain_smoother.gpssm_vmp(k, th3, Xg, t(ys[:30]), t(P), x0, c0, pv2, 100.0,
                                 torch.eye(2, dtype=f64, device=dev), n_iters=2))
    return same


def phase_gplvm(seed, card):
    """The GPLVM slice at the runner's full width (N = 200, D = 12, Din = 2,
    M = 30) and the model front-end:

    - ``fit_gplvm_grad`` for 2 epochs in float64 on the card and on the
      host in this process, held to each other (θ, FE trace, x-means, the
      rows that moved counted) to the limits of the rounding twin; the
      batched L-BFGS's host reads, linesearch iterations and evaluations
      per sweep; a sweep's eager host time against its device time (a
      profiler trace); no kernel launches (float64 takes the plain Gram);
    - ``gplvm_embed`` of the training rows from the latents of 2 more
      sweeps at the trained θ (a fixed point), and of 40 held-out rows
      (their 1-NN accuracy against the trained latents' labels);
    - float32 through the kernel against the plain Gram: the Ψ-statistics
      of the trained marginals at 30×800×2 and one cold ``gplvm_vmp``
      sweep (its q(v) naturals, from the marginals before any Laplace step,
      held to bounds from ``gram_tolerance``; its x-means printed, not
      held: f32 Laplace modes flip); its launches counted, counts at 0
      just before; the two GPLVM Gram shapes held to plain and timed;
    - each ``infer/model.py`` class's ``infer`` bit for bit against its
      direct call on the card."""
    say("phase 13/16 GPLVM and the model front-end: start")
    from gaussianprocessnode_tpu_torch.experiments.gplvm import knn_accuracy
    from gaussianprocessnode_tpu_torch.infer.gplvm import gplvm_embed, gplvm_vmp
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus")
    out = {}

    launches = se_gram_cuda.launches
    counts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    card_fit = gplvm_fit(seed, "cuda", kern, counts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    host_fit = gplvm_fit(seed, "cpu")
    host_s = time.perf_counter() - t
    d = gplvm_diff(card_fit, host_fit)
    s, theta, state, fe = card_fit
    sweeps = GPLVM_EPOCHS * GPLVM_SWEEPS
    per = {k: v / sweeps for k, v in counts.items()}
    print(f"GPLVM fit_gplvm_grad float64 ({GPLVM_EPOCHS} epochs x {GPLVM_SWEEPS} sweeps, "
          f"N={GPLVM_N}, M={GPLVM_M}): card {card_s:.2f} s, host {host_s:.2f} s; FE trace "
          f"{fe.tolist()}, theta (softplus) {torch.nn.functional.softplus(theta).tolist()}; "
          f"card vs host: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
          + f" (limits {GPLVM_F64_LIMITS}, rows moved beyond {GPLVM_ROW_TOL:.0e}); per sweep: "
          f"host reads {per['host_reads']:.1f}, linesearch iterations "
          f"{per['linesearch_steps']:.1f}, evaluations {per['evaluations']:.1f} [{card}]",
          flush=True)
    check(bool(torch.isfinite(fe).all()) and bool(torch.isfinite(state.x_means).all()),
          "GPLVM: non-finite fit on the card")
    check(all(d[k] <= GPLVM_F64_LIMITS[k] for k in GPLVM_F64_LIMITS),
          "GPLVM float64: card and host disagree")
    check(se_gram_cuda.launches == launches, "GPLVM float64 launched the float32 kernel")
    out["f64_card_vs_host"] = dict(diffs=d, card_seconds=card_s, host_seconds=host_s,
                                   per_sweep=per, fe_trace=fe.tolist(),
                                   theta_softplus=torch.nn.functional.softplus(theta).tolist())

    def sweep():
        return gplvm_vmp(kern, theta, s["Xu"], s["Y"], s["Xm"], n_iters=1, compute_fe=False,
                         init_state=state)

    host_ms, queue_ms = eager_ms(sweep, 1)
    prof = profile_epoch(sweep, f"GPLVM float64 sweep (N={GPLVM_N}, M={GPLVM_M})", card)
    print(f"GPLVM float64 sweep: eager {host_ms:.2f} ms host clock (queued in {queue_ms:.2f} "
          f"ms), device {prof['device_ms'] if prof else float('nan'):.2f} ms (profiler), "
          f"{per['host_reads']:.1f} host reads [{card}]", flush=True)
    out["sweep"] = dict(eager_host_ms=host_ms, queue_ms=queue_ms, profile=prof)

    # the embedding, from more sweeps at the trained θ
    polished, _ = gplvm_vmp(kern, theta, s["Xu"], s["Y"], s["Xm"],
                            n_iters=GPLVM_POLISH_SWEEPS, init_state=state, compute_fe=False)
    m, V = gplvm_embed(kern, theta, s["Xu"], s["Y"], polished, s["Xm"],
                       x_start=polished.x_means, n_iters=1)
    fixed = float((m - polished.x_means).abs().max())
    mh, Vh = gplvm_embed(kern, theta, s["Xu"], s["Y_held"], polished, s["Xm_held"])
    Z, Zh = polished.x_means.cpu().numpy(), mh.cpu().numpy()
    lab = s["labels"]
    nn = ((Zh[:, None, :] - Z[None, :, :]) ** 2).sum(-1).argmin(axis=1)
    acc_held = float((lab[:GPLVM_N][nn] == lab[GPLVM_N:]).mean())
    acc_train, acc_pca = knn_accuracy(Z, lab[:GPLVM_N]), knn_accuracy(
        s["Xm"].cpu().numpy(), lab[:GPLVM_N])
    print(f"GPLVM embedding: training rows from the trained latents move by {fixed:.3e} "
          f"(limit {GPLVM_FIXED_POINT:.0e}); {GPLVM_HELD} held-out rows 1-NN accuracy "
          f"{acc_held:.3f} against the trained latents (training latents {acc_train:.3f}, "
          f"PCA {acc_pca:.3f}) [{card}]", flush=True)
    check(fixed <= GPLVM_FIXED_POINT, "GPLVM: trained latents are not fixed points of the embed")
    check(all(bool(torch.isfinite(x).all()) for x in (m, V, mh, Vh)),
          "GPLVM embedding: non-finite result")
    check(se_gram_cuda.launches == launches, "GPLVM float64 launched the float32 kernel")
    out["embedding"] = dict(fixed_point=fixed, held_out_knn=acc_held, train_knn=acc_train,
                            pca_knn=acc_pca)

    # float32 through the kernel
    d32, lim32, l32, info32, fin32, pts = _gplvm_f32(s, theta, polished, kern, plain)
    print("GPLVM float32 kernel vs plain: " + ", ".join(
        f"{k} {v:.3e} (limit {lim32[k]:.3e})" for k, v in d32.items())
          + f"; one cold sweep: FE kernel {info32['kernel']['fe']}, plain "
          f"{info32['plain']['fe']}, smallest eigenvalue of B = Kuu + w*sum(Psi2) kernel "
          f"{info32['kernel']['b_min_eig']:.3e}, plain {info32['plain']['b_min_eig']:.3e}, "
          f"x-means differ by {info32['x_means_abs']:.3e} (not held: float32 Laplace modes "
          f"flip); sweep launches {l32} (expected {GPLVM_F32_SWEEP_LAUNCHES}) [{card}]",
          flush=True)
    check(fin32, "GPLVM float32 sweep: non-finite state")
    check(all(d32[k] <= lim32[k] for k in d32), "GPLVM float32: kernel and plain disagree")
    check(l32 == GPLVM_F32_SWEEP_LAUNCHES,
          f"GPLVM float32 sweep: {l32} launches, expected {GPLVM_F32_SWEEP_LAUNCHES}")
    out["f32_kernel_vs_plain"] = dict(diffs=d32, limits=lim32, sweep=info32)
    out["launches"] = l32

    # the two Gram shapes, held to plain and timed (not counted on any path)
    before = se_gram_cuda.launches
    th32, Xu32 = theta.float(), s["Xu"].float()
    var, ls = plain.params(th32)
    ls = ls.contiguous()
    errs, shapes = {}, []
    for (M, N, role), X in zip(GPLVM_SHAPES, (pts.reshape(-1, GPLVM_DIN).contiguous(), Xu32)):
        K = se_gram_cuda(Xu32, X, var, ls)
        errs[f"{M}x{N}x{GPLVM_DIN}"] = _held_to_plain(f"{M}x{N}x{GPLVM_DIN} ({role})", Xu32, X,
                                                      var, ls, K)
        shapes.append(time_gram(Xu32, X, var, ls, role, card))
    se_gram_cuda.launches = before
    out.update(gram_max_abs=errs, shapes=shapes)

    same = _gplvm_front_end(seed, s, theta)
    print("model front-end on the card, infer against its direct call: " + ", ".join(
        f"{k} {'equal' if v else 'DIFFERENT'}" for k, v in same.items()) + f" [{card}]",
          flush=True)
    check(all(same.values()), f"model front-end differs from its direct calls: {same}")
    check(se_gram_cuda.launches == before, "the float64 front-end launched the float32 kernel")
    out["front_end_equal"] = same
    out["launches_by_path"] = {"gplvm_f32_sweep": l32}
    say("phase 13/16 GPLVM and the model front-end: done")
    return out


# the legacy-GP families (experiments/legacy_gp.py), float64 throughout:
# the SDE GP's Matérn-5/2 chain, the t-process, the full-covariance GP,
# GP-PAD, the learning layer and the controlled GPSSM. No workload reaches
# the float32 SE Gram kernel (Matérn Grams and float64 SE Grams take the
# plain route by dtype), so this phase counts 0 launches.
LEGACY_SCALE_T = 1 << 17         # padscale's audio-scale chain, both modes
LEGACY_SCALE_REPS = 1            # timed calls per mode after the first
LEGACY_PAR_T = 1 << 13           # parallel smoother, card against host
LEGACY_PAR_RTOL = 1e-9
# padlearn's cut (the runner's configuration is 6 Bayesian sweeps of 21
# EP chains, 30 EP-EM epochs, the 3-model bank and 12 colored-EM epochs of
# 150 warm E-sweeps and 60 adjoint sweep-VJPs of two T = 400 chains; one
# full colored epoch took 126 s on an H100 80GB HBM3 at 700 W): 5 EP-EM
# epochs and one colored epoch of 30 E-sweeps and 12 adjoint VJPs, the
# Bayesian posterior and the bank uncut
LEGACY_PADLEARN_CUT = {"em_epochs": 5, "colored_epochs": 1, "colored_ep_iters": 30,
                       "adjoint_iters": 12}
# float64 card against host, figure by figure (``_legacy_rel``).
# cuBLAS/cuSOLVER and the host's BLAS/LAPACK round in other orders; the
# EP, AdaMax and L-BFGS loops carry that rounding through their
# iterations, and the full-covariance GP's θ-grid reaches Grams of κ ≈ 1e10
# (tests/test_torch_tprocess_fullcov.py). On an H100 80GB HBM3 at 700 W
# the readings were tprocess 4.4e-15, sde 8.4e-15, fullcov 7.3e-9, pad
# 2.2e-9, pad2 5.4e-14, control 1.3e-12, padlearn 2.0e-11 (one colored
# epoch of full depth); the limits are ~100× those (1e-12 at least)
LEGACY_RTOL = {"tprocess": 1e-12, "sde": 1e-12, "fullcov": 1e-6, "pad": 2e-7, "pad2": 1e-11,
               "control": 1e-10, "padlearn": 2e-9}


def _figures(res) -> np.ndarray:
    """The numbers of a workload's result dict, flattened: seconds, the
    configuration and the rounding-level diagnostics (``*_max_abs``: a
    smoother against the dense GP, sequential against parallel) left out."""
    out = []
    for k, v in res.items():
        if k == "config" or "seconds" in k or k.endswith("_max_abs"):
            continue
        if isinstance(v, bool):
            v = float(v)
        if isinstance(v, (int, float)):
            out.append(float(v))
        elif isinstance(v, list):
            out.extend(float(x) for x in v)
    return np.asarray(out)


def _legacy_rel(a, b) -> float:
    """The largest figure-by-figure difference, relative to the figure
    (figures below 1e-6 in magnitude, such as a responsibility of 1e-30,
    relative to 1e-6)."""
    fa, fb = _figures(a), _figures(b)
    return float(np.max(np.abs(fa - fb) / np.maximum(np.abs(fb), 1e-6)))


def phase_legacy(card):
    """The legacy-GP families at the runner's configurations, float64:

    - the main path: ``padscale`` at T = 2^17, the sequential and the
      parallel-in-time smoother on the card (a first call, then
      LEGACY_SCALE_REPS timed call each), held to the JAX runner's
      cross-check (max |Δmean_head| < 1e-6, |Δlog_lik| < 1e-5·max(1,
      |log_lik|)); the SE Gram's count set to 0 just before and read just
      after: 0 launches, and 0 in the rest of the phase;
    - first, the parallel and the sequential smoother at T = 2^13 on the
      card against the host (LEGACY_PAR_RTOL);
    - tprocess, sde, fullcov, pad, pad2 and control at the runner's
      configurations on the card and on the host, held to each other
      (LEGACY_RTOL);
    - padlearn at the runner's configuration but LEGACY_PADLEARN_CUT, on
      the card and on the host;
    - a profiled sequential smoother call (T = 400) and a profiled
      colored-EM epoch at reduced depth (4 E-sweeps, 2 adjoint VJPs)."""
    say("phase 14/16 legacy GP families: start")
    from gaussianprocessnode_tpu_torch.experiments import legacy_gp as lg
    from gaussianprocessnode_tpu_torch.infer.pad_learn import fit_gppad_colored_theta
    from gaussianprocessnode_tpu_torch.infer.sde_gp import sde_gp_smooth
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    out = {}
    before = se_gram_cuda.launches

    # the smoothers at 2^13, card against host (these calls also warm the card up);
    # mean, var and log_lik each on its own scale
    def smooth(dev, parallel):
        t, z, mask, r = (torch.as_tensor(a, device=dev) for a in lg.padscale_data(LEGACY_PAR_T))
        return sde_gp_smooth(torch.tensor([1.0, 0.9], dtype=torch.float64, device=dev), t, z,
                             mask, r, parallel=parallel)

    pair = {}
    for mode in ("sequential", "parallel"):
        a, b = smooth("cuda", mode == "parallel"), smooth("cpu", mode == "parallel")
        pair[mode] = {f: _relmax(getattr(a, f), getattr(b, f))
                      for f in ("mean", "var", "log_lik")}
    worst = {mode: max(d.values()) for mode, d in pair.items()}
    print(f"smoother T={LEGACY_PAR_T} float64 card vs host (each output on its own scale, "
          f"limit {LEGACY_PAR_RTOL:.0e}): "
          + "; ".join(f"{mode} " + ", ".join(f"{f} {x:.3e}" for f, x in d.items())
                      for mode, d in pair.items()) + f" [{card}]", flush=True)
    check(max(worst.values()) <= LEGACY_PAR_RTOL, "smoother: card and host disagree")
    out["smoother_card_vs_host"] = pair

    # the main path: padscale at 2^17, both modes, its launches counted
    pre = se_gram_cuda.launches - before
    se_gram_cuda.launches = 0
    row = {"T": LEGACY_SCALE_T}
    for mode in ("sequential", "parallel"):
        row[mode] = lg.run_padscale_one(LEGACY_SCALE_T, mode == "parallel",
                                        reps=LEGACY_SCALE_REPS, device="cuda")
    main_launches = se_gram_cuda.launches
    row.update(lg.crosscheck(row))
    seq, par = row["sequential"], row["parallel"]
    print(f"padscale T={LEGACY_SCALE_T}: sequential {seq['warm_ms']:.1f} ms (first call "
          f"{seq['first_call_s']:.2f} s), parallel {par['warm_ms']:.2f} ms (first call "
          f"{par['first_call_s']:.2f} s), speedup {row['speedup']:.1f}x; cross-check "
          f"{row['crosscheck']}: max|dmean_head| {row['crosscheck_dmean']:.3e}, |dlog_lik| "
          f"{row['crosscheck_dll']:.3e} (log_lik {seq['log_lik']:.6f}) [{card}]", flush=True)
    check(row["crosscheck"] == "ok", "padscale: the sequential and parallel smoothers disagree")
    check(all(np.isfinite(r["log_lik"]) and np.all(np.isfinite(r["mean_head"]))
              for r in (seq, par)), "padscale: non-finite smoother output")
    out["padscale"] = row

    # the runner's workloads, card against host
    runs = {}
    for name in ("tprocess", "sde", "fullcov", "pad", "pad2", "control", "padlearn"):
        kw = dict(LEGACY_PADLEARN_CUT) if name == "padlearn" else {}
        fn = lg.WORKLOADS[name]
        a = fn(verbose=False, device="cuda", **kw)
        b = fn(verbose=False, device="cpu", **kw)
        d = _legacy_rel(a, b)
        runs[name] = {"card": a, "host": b, "rel": d}
        figures = {k: v for k, v in a.items() if k != "config"}
        print(f"legacy {name}{' (cut: ' + json.dumps(kw) + ')' if kw else ''}: card "
              f"{a['seconds']:.2f} s, host {b['seconds']:.2f} s, card vs host {d:.3e} (limit "
              f"{LEGACY_RTOL[name]:.0e}); card figures {json.dumps(figures)} [{card}]",
              flush=True)
        check(np.all(np.isfinite(_figures(a))), f"legacy {name}: non-finite figures on the card")
        check(d <= LEGACY_RTOL[name], f"legacy {name}: card and host disagree ({d:.3e})")
    out["workloads"] = runs

    # where the time goes: one sequential smoother call, one reduced colored-EM epoch
    t, z, mask, r = (torch.as_tensor(a, device="cuda") for a in lg.padscale_data(400))
    th = torch.tensor([1.0, 0.9], dtype=torch.float64, device="cuda")
    host_ms, queue_ms = eager_ms(lambda: sde_gp_smooth(th, t, z, mask, r), 3)
    prof = profile_epoch(lambda: sde_gp_smooth(th, t, z, mask, r),
                         "sequential smoother T=400 float64", card)
    print(f"sequential smoother T=400: eager {host_ms:.2f} ms host clock (queued in "
          f"{queue_ms:.2f} ms) [{card}]", flush=True)
    t2, y2 = (torch.as_tensor(a, device="cuda") for a in lg.padlearn_colored_data())
    ell0 = torch.tensor([0.3, 0.1], dtype=torch.float64, device="cuda")

    def epoch():
        return fit_gppad_colored_theta(t2, y2, ell0, var_f=0.4, var_c=1.0, epochs=1,
                                       ep_iters=4, adjoint_iters=2)

    ep_ms, _ = eager_ms(epoch, 1)
    prof_ep = profile_epoch(epoch, "colored-EM epoch T=400 (4 E-sweeps, 2 adjoint VJPs)", card)
    print(f"colored-EM epoch at reduced depth: eager {ep_ms:.1f} ms host clock [{card}]",
          flush=True)
    out["profile"] = {"smoother_T400": {"eager_host_ms": host_ms, "queue_ms": queue_ms,
                                        "profile": prof},
                      "colored_epoch_4_2": {"eager_host_ms": ep_ms, "profile": prof_ep}}

    rest = pre + se_gram_cuda.launches - main_launches
    se_gram_cuda.launches += before + pre
    print(f"legacy GP families: SE Gram launches {main_launches} in padscale, {rest} in the "
          f"rest of the phase (float64 and Matern take the plain route)", flush=True)
    check(main_launches == 0 and rest == 0,
          "the legacy families launched the float32 SE Gram kernel")
    out["launches"] = main_launches + rest
    out["launches_by_path"] = {"legacy_padscale": main_launches, "legacy_workloads": rest}
    say("phase 14/16 legacy GP families: done")
    return out


# the parallel layer (parallel/sharding.py, tensor_parallel.py,
# seq_parallel.py) at world size 1 over NCCL: the card's machine has one
# card, and NCCL refuses two ranks on one device, so every parallel function
# runs on a one-rank group in this process. Its all-reduces and all-gathers
# go through NCCL; its point-to-point exchanges (the TP ring's shifts, the
# SP halos) post nothing at one rank. Multi-rank numerics are held on the
# CPU over gloo (tests/test_torch_{sharding,tensor_parallel,seq_parallel}.py).
# A one-rank NCCL all-reduce or all-gather returns its input, so each path
# is the single-device path op for op: its carries must be bit-equal to the
# single-device trainer's (PAR_RTOL is the ceiling if not, relative to each
# field's largest entry).
PAR_RTOL = 1e-12
TP_PRIOR_VAR, TP_NS_ITERS, TP_IR_ROUNDS = 50.0, 60, 2
SP_SWEEPS = 25                      # one runner E-step
SP_LAUNCHES = 1 + 3 * SP_SWEEPS + 1  # Kuu; 3 per sweep; the free energy's node Psi


def _field_diffs(a, b) -> dict:
    """max |a − b| / max |b| per field of two carries (dicts of tensors;
    0 where bit-equal)."""
    out = {}
    for k in b:
        x, y = a[k].double(), b[k].double()
        scale = float(y.abs().max()) or 1.0
        out[k] = float((x - y).abs().max()) / scale
    return out


def _flat_carry(c, cov, **extra):
    """A trainer carry's fields by name (its Λ⁻¹ estimate given as ``cov``)."""
    d = {"xi": c[0], "prec": c[1], "cov": cov, "theta": c.theta, "kuu_inv": c.kuu_inv, **extra}
    d.update({f"opt_{k}": v for k, v in c.opt_state.items()})
    return d


def _held_equal(label, a: dict, b: dict) -> dict:
    d = _field_diffs(a, b)
    equal = all(torch.equal(a[k], b[k]) for k in b)
    worst = max(d.values())
    print(f"{label}: bit-equal {equal}; largest relative difference {worst:.3e} "
          f"(limit {PAR_RTOL:.0e})", flush=True)
    check(worst <= PAR_RTOL, f"{label}: differs from the single-device path: {d}")
    return {"bit_equal": equal, "max_rel": worst, "by_field": d}


def phase_parallel(seed, card):
    """The parallel layer at world size 1 over NCCL, at full width:

    - ``fit_kin40k_fast_dp`` (M = 600, N = 10,000 in 20 batches of 500,
      D = 8, float32 θ, float64 statistics), 3 epochs through the kernel,
      41 launches per epoch, epochs 2–3 under ``set_sync_debug_mode("error")``;
      its carry after each epoch held to ``fit_kin40k_fast``'s on the card
      (bit-equal, PAR_RTOL at most), and to the same DP trainer through the
      plain Gram (TRAIN_RTOL, as phase 6);
    - ``fit_banana_fast_dp`` at banana width (M = 500, D = 2, 20 batches of
      200), 3 epochs from one initial carry, held to ``fit_banana_fast``
      the same way;
    - ``tp_regression_sweep`` (M = 600, the 10,000 training points; 60
      spectrum-scaled Newton–Schulz iterations, 2 refinement rounds) and
      ``tp_predict`` (the 30,000 test points) against the dense sweep;
    - ``gpssm_vmp_sp`` at pendulum width (T = 300, M = 48, float32 through
      the kernel), 25 sweeps from the cold start, held to ``gpssm_vmp`` (the
      Jacobi sweep it is op for op at world size 1) as the DP carries are.

    Each path's launch count is set to 0 just before it and read just
    after."""
    say("phase 15/16 parallel layer (world size 1 over NCCL): start")
    from gaussianprocessnode_tpu_torch.experiments import banana as brunner
    from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
    from gaussianprocessnode_tpu_torch.experiments import pendulum as prunner
    from gaussianprocessnode_tpu_torch.infer.chain_smoother import gpssm_vmp
    from gaussianprocessnode_tpu_torch.infer.minibatch import (clone_carry, fit_banana_fast,
                                                               fit_kin40k_fast, init_banana_state)
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.linalg import (gershgorin_lambda_min, ir_solve,
                                                          spd_inverse, sym)
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
    from gaussianprocessnode_tpu_torch.parallel import comm
    from gaussianprocessnode_tpu_torch.parallel.seq_parallel import (gpssm_vmp_sp,
                                                                     shard_chain_data)
    from gaussianprocessnode_tpu_torch.parallel.sharding import (fit_banana_fast_dp,
                                                                 fit_kin40k_fast_dp,
                                                                 shard_batched_data)
    from gaussianprocessnode_tpu_torch.parallel.tensor_parallel import (shard_inducing,
                                                                        tp_predict,
                                                                        tp_regression_sweep)

    kern = Kernel("se", "softplus", use_kernel=True)
    plain = Kernel("se", "softplus", use_kernel=False)
    out = {}

    def timed_epochs(label, fn, per_epoch):
        """``EPOCHS`` calls of ``fn(carry) -> carry`` from None, counted and
        timed one by one (epochs 2 on under sync debug mode "error");
        returns the carries (cloned) and the launch counts."""
        carries, launches, ms = [], [], []
        carry = None
        se_gram_cuda.launches = 0
        for e in range(EPOCHS):
            before = se_gram_cuda.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error" if e > 0 else "default")
            try:
                carry = fn(carry)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches.append(se_gram_cuda.launches - before)
            carries.append(clone_carry(carry))
            print(f"{label} epoch {e + 1}: {ms[-1]:.1f} ms (host clock, "
                  f"{'sync debug mode error' if e > 0 else 'first epoch'}), se_gram launches "
                  f"{launches[-1]} [{card}]", flush=True)
            check(launches[-1] == per_epoch,
                  f"{label}: {launches[-1]} launches in epoch {e + 1}, expected {per_epoch}")
        return carries, launches, ms

    with comm.single_rank_group("cuda"):
        backend = torch.distributed.get_backend()
        print(f"process group: backend {backend}, world size "
              f"{torch.distributed.get_world_size()}", flush=True)
        check(backend == "nccl", f"the parallel layer runs over {backend}, not NCCL")

        # --- data-parallel kin40k: the main path ---------------------------
        ds = runner.load_data("synthetic", seed)
        theta0, Xu, Xb, yb, prior = runner.setup(ds, M_IND, BATCH, N_TRAIN, seed, "cuda")
        Xs, ys = shard_batched_data(Xb, yb)
        check(Xs.shape == Xb.shape, "one rank's shard is not the whole batch")

        def dp_epoch(kernel):
            def fn(c):
                return fit_kin40k_fast_dp(kernel, theta0, Xu, Xs, ys, prior, runner.W_VAL, 1,
                                          resume_state=c)[3]
            return fn

        dp_carries, dp_launches, dp_ms = timed_epochs("kin40k DP (NCCL, 1 rank)", dp_epoch(kern),
                                                      LAUNCHES_PER_EPOCH)
        out["dp_kin40k"] = dict(launches=sum(dp_launches), launches_per_epoch=dp_launches,
                                epoch_host_ms=dp_ms)
        c_sd = c_pl = None
        eq, kp, sd_ms = [], [], []
        for e in range(EPOCHS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            *_, c_sd = fit_kin40k_fast(kern, theta0, Xu, Xb, yb, prior, runner.W_VAL, 1,
                                       resume_state=c_sd)
            torch.cuda.synchronize()
            sd_ms.append((time.perf_counter() - t) * 1e3)
            eq.append(_held_equal(f"kin40k DP epoch {e + 1} vs fit_kin40k_fast",
                                  _flat_carry(dp_carries[e], dp_carries[e].covs64[0]),
                                  _flat_carry(c_sd, c_sd.covs64[0])))
            c_pl = dp_epoch(plain)(c_pl)
            kp.append(_held(f"kin40k DP epoch {e + 1}", (dp_carries[e].theta,
                                                          dp_carries[e].xi, dp_carries[e].prec),
                            (c_pl.theta, c_pl.xi, c_pl.prec), ("theta", "xi", "Lambda")))
        print(f"kin40k epochs 2-{EPOCHS}: DP over NCCL (1 rank) {np.mean(dp_ms[1:]):.1f} ms, "
              f"fit_kin40k_fast {np.mean(sd_ms[1:]):.1f} ms (host clock, mean) [{card}]",
              flush=True)
        out["dp_kin40k"].update(vs_single_device=eq, kernel_vs_plain=kp,
                                single_device_epoch_host_ms=sd_ms)

        # --- data-parallel banana ------------------------------------------
        bds = brunner.load_data("synthetic", seed)
        btheta0, bXu, bXb, byb, pv, pw = brunner.setup(bds, M_BAN, BATCH_BAN, seed, "cuda")
        c0 = init_banana_state(plain, btheta0, bXu, pv, pw)
        bXs, bys = shard_batched_data(bXb, byb)

        def banana_dp(c):
            return fit_banana_fast_dp(kern, btheta0, bXu, bXs, bys, pv, pw, 1,
                                      resume_state=c0 if c is None else c)[3]

        b_carries, b_launches, b_ms = timed_epochs("banana DP (NCCL, 1 rank)", banana_dp,
                                                   BANANA_LAUNCHES_PER_EPOCH)
        c_sd, beq, bsd_ms = c0, [], []
        for e in range(EPOCHS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            *_, c_sd = fit_banana_fast(kern, btheta0, bXu, bXb, byb, pv, pw, 1, resume_state=c_sd)
            torch.cuda.synchronize()
            bsd_ms.append((time.perf_counter() - t) * 1e3)
            a, b = ((_flat_carry(c, c.cov_v, w_shape=c.w_shape, w_rate=c.w_rate))
                    for c in (b_carries[e], c_sd))
            beq.append(_held_equal(f"banana DP epoch {e + 1} vs fit_banana_fast", a, b))
        print(f"banana epochs 2-{EPOCHS}: DP over NCCL (1 rank) {np.mean(b_ms[1:]):.1f} ms, "
              f"fit_banana_fast {np.mean(bsd_ms[1:]):.1f} ms (host clock, mean) [{card}]",
              flush=True)
        out["dp_banana"] = dict(launches=sum(b_launches), launches_per_epoch=b_launches,
                                epoch_host_ms=b_ms, vs_single_device=beq,
                                single_device_epoch_host_ms=bsd_ms)

        # --- tensor-parallel sweep and prediction --------------------------
        X, y = Xb.reshape(-1, D_IN), yb.reshape(-1)
        X_test = torch.as_tensor(ds.x_test, dtype=torch.float32, device="cuda")
        lam = float(gershgorin_lambda_min(torch.eye(M_IND, dtype=torch.float64) / TP_PRIOR_VAR))
        Xu_loc = shard_inducing(Xu)
        se_gram_cuda.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu_t, cov_t, xi_t, prec_t = tp_regression_sweep(
            kern, theta0, Xu_loc, X, y, TP_PRIOR_VAR, runner.W_VAL, ns_iters=TP_NS_ITERS,
            lambda_min=lam, ir_rounds=TP_IR_ROUNDS)
        mean_t, var_t = tp_predict(kern, theta0, Xu_loc, mu_t, runner.W_VAL, X_test)
        torch.cuda.synchronize()
        tp_ms = (time.perf_counter() - t) * 1e3
        tp_launches = se_gram_cuda.launches
        with torch.no_grad():
            K = kern(theta0, Xu, X).double()
            xi_d = runner.W_VAL * (K @ y.double())
            prec_d = sym(torch.eye(M_IND, dtype=torch.float64, device="cuda") / TP_PRIOR_VAR
                         + runner.W_VAL * (K @ K.T))
            cov_d = spd_inverse(prec_d, iters=TP_NS_ITERS, lambda_min=lam)
            mu_d = ir_solve(prec_d, xi_d, cov_d, rounds=TP_IR_ROUNDS)
            mean_d = kern(theta0, Xu, X_test).double().T @ mu_t
        # μ: the dense solve's refinement keeps its iterate where a round
        # does not shrink the residual, the sweep's (as JAX's) does not; at
        # the f64 floor the two differ by up to κ(Λ)·ε, κ bounded by
        # ‖Λ‖∞/λ_min(prior)
        kappa = float(prec_d.abs().sum(1).max()) / lam
        mu_lim = 10.0 * kappa * float(np.finfo(np.float64).eps)
        tp_d = _field_diffs({"xi": xi_t, "prec": prec_t, "cov": cov_t, "mean": mean_t},
                            {"xi": xi_d, "prec": prec_d, "cov": cov_d, "mean": mean_d})
        tp_mu = _field_diffs({"mu": mu_t}, {"mu": mu_d})["mu"]
        print(f"TP sweep + prediction (M={M_IND}, N={X.shape[0]}, N*={X_test.shape[0]}, NCCL, "
              f"1 rank): {tp_ms:.1f} ms host clock, se_gram launches {tp_launches}; vs the dense "
              f"sweep: xi {tp_d['xi']:.3e}, Lambda {tp_d['prec']:.3e}, Sigma {tp_d['cov']:.3e}, "
              f"mean {tp_d['mean']:.3e} (limit {PAR_RTOL:.0e}), mu {tp_mu:.3e} (limit "
              f"{mu_lim:.3e} = 10·κ·ε, κ ≤ {kappa:.3e}) [{card}]", flush=True)
        check(tp_launches == 2, f"the TP sweep and prediction launched {tp_launches} Grams, not 2")
        check(max(tp_d.values()) <= PAR_RTOL and tp_mu <= mu_lim,
              f"the TP sweep disagrees with the dense sweep: {tp_d}, mu {tp_mu}")
        check(bool(torch.all(var_t == 1.0 / runner.W_VAL)), "tp_predict's variance")
        out["tp"] = dict(launches=tp_launches, host_ms=tp_ms, vs_dense=tp_d, mu_rel=tp_mu,
                         mu_limit=mu_lim)

        # --- sequence-parallel GPSSM smoothing -----------------------------
        s = prunner.setup("cuda", torch.float32)
        chain = (s["P"], s["prior_x0_mean"], s["prior_x0_cov"], s["prior_v"], prunner.PRIOR_W_DF,
                 s["prior_W_scale"])
        ys_loc = shard_chain_data(s["y_train"])
        se_gram_cuda.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        st_sp, fe_sp = gpssm_vmp_sp(kern, s["theta0"], s["Xu"], ys_loc, *chain,
                                    n_iters=SP_SWEEPS)
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t) * 1e3
        sp_launches = se_gram_cuda.launches
        st_j, fe_j = gpssm_vmp(kern, s["theta0"], s["Xu"], s["y_train"], *chain,
                               n_iters=SP_SWEEPS)
        print(f"SP smoother (T={GP_T}, M={GP_M}, {SP_SWEEPS} sweeps, float32, NCCL, 1 rank): "
              f"{sp_ms:.1f} ms host clock, se_gram launches {sp_launches} (expected "
              f"{SP_LAUNCHES}) [{card}]", flush=True)
        check(sp_launches == SP_LAUNCHES, f"the SP smoother launched {sp_launches} Grams")
        check(_finite_state(st_sp) and bool(torch.isfinite(fe_sp)), "non-finite SP state")
        # at world size 1 the SP smoother is the Jacobi sweep op for op
        sp_eq = _held_equal("SP smoother vs gpssm_vmp", {**st_sp._asdict(), "fe": fe_sp},
                            {**st_j._asdict(), "fe": fe_j})
        out["sp"] = dict(launches=sp_launches, host_ms=sp_ms, vs_single_device=sp_eq)

    out["collectives_on_nccl"] = ["all_reduce SUM", "all_reduce MAX", "all_gather"]
    out["p2p_at_world_size_1"] = "none posted (ring shifts and halos skip a ring of one)"
    out["launches"] = (out["dp_kin40k"]["launches"] + out["dp_banana"]["launches"] + tp_launches
                       + sp_launches)
    out["launches_by_path"] = {"dp_kin40k_nccl": out["dp_kin40k"]["launches"],
                               "dp_banana_nccl": out["dp_banana"]["launches"],
                               "tp_sweep_predict_nccl": tp_launches,
                               "sp_gpssm_nccl": sp_launches}
    say("phase 15/16 parallel layer (world size 1 over NCCL): done")
    return out


OZ_RTOL = 1e-14            # tests/test_ozaki.py's limit against numpy's f64 product
OZ_K_EXACT = 10000         # the inner length at which a TPU's int8 dot was not exact
OZ_SHAPES = ((600, 600, 600, "600^3 product"),
             (600, 10000, 600, "SYRK X X^T of the 600x10000 statistics"))
OZ_UNIT_PASSES = 36        # int8 unit products at 8 slices, 8·9/2
NS_CHAIN_ITERS = 28        # the Newton-Schulz chain of the trainers' refresh
# H100 SXM data sheet at its 700 W limit: f64 tensor cores, dense int8
PEAK_F64_FLOP_PER_S = 67e12
PEAK_INT8_OP_PER_S = 1979e12


def _oz_rel(C, C_ref) -> float:
    return float(np.max(np.abs(C - C_ref)) / np.max(np.abs(C_ref)))


def ozaki_bounds_ms(m, k, n, inputs_bytes) -> dict:
    """Least times for the product: cuBLAS's f64 (operations over the f64
    tensor-core peak, or the bytes: the inputs read once and the f64 output
    written once) and the Ozaki scheme's int8 passes alone (36 unit
    products over the int8 peak; the split and the f64 accumulation are not
    counted)."""
    nbytes = inputs_bytes + 8.0 * m * n
    flops = 2.0 * m * k * n
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f64 = flops / PEAK_F64_FLOP_PER_S
    t_int8 = OZ_UNIT_PASSES * flops / PEAK_INT8_OP_PER_S
    return {"f64_bound_ms": max(t_b, t_f64) * 1e3,
            "f64_bound_by": "bytes" if t_b >= t_f64 else "operations",
            "ozaki_int8_bound_ms": max(t_b, t_int8) * 1e3,
            "bytes": nbytes, "flops": flops}


def _int_mm_rules() -> dict:
    """torch._int_mm's shape rules and operand layouts on this card: each
    case's product against the exact one, or the error it raises."""
    rng = np.random.default_rng(3)
    out = {}
    for label, (m, k, n), layout in (
            ("17x16x16 row-major B", (17, 16, 16), "row"),
            ("17x16x16 column-major B", (17, 16, 16), "col"),
            ("17x16x16 column-major A", (17, 16, 16), "colA"),
            ("16 rows", (16, 16, 16), "row"),
            ("k = 12", (17, 12, 16), "row"),
            ("n = 12", (17, 16, 12), "row"),
            ("strided views, ld 48", (17, 16, 16), "strided")):
        a = rng.integers(-64, 65, (m, 3 * k)).astype(np.int8)
        b = rng.integers(-64, 65, (3 * k, n)).astype(np.int8)
        A = torch.as_tensor(a, device="cuda")
        BT = torch.as_tensor(np.ascontiguousarray(b.T), device="cuda")
        if layout == "strided":
            Aop, Bop = A[:, k:2 * k], BT[:, k:2 * k].T
            ref = a[:, k:2 * k].astype(np.int64) @ b[k:2 * k].astype(np.int64)
        else:
            Aop, Bop = A[:, :k].contiguous(), BT[:, :k].T
            if layout in ("row", "colA"):
                Bop = Bop.contiguous()
            if layout == "colA":
                Aop = Aop.T.contiguous().T
            ref = a[:, :k].astype(np.int64) @ b[:k].astype(np.int64)
        try:
            P = torch._int_mm(Aop, Bop)
            torch.cuda.synchronize()
            out[label] = "exact" if np.array_equal(P.cpu().numpy().astype(np.int64), ref) \
                else "WRONG"
        except RuntimeError as e:
            out[label] = "raises: " + str(e).splitlines()[0][:120]
    print(f"torch._int_mm on the card: {out}", flush=True)
    check(out["17x16x16 column-major B"] == "exact" and out["strided views, ld 48"] == "exact",
          "torch._int_mm is not exact in the layouts ozaki_matmul uses")
    return out


def _ns_chain(Lam, mm, iters=NS_CHAIN_ITERS):
    """The classic Newton-Schulz chain X ← X(2I − ΛX) from X₀ = I/‖Λ‖∞,
    each product by ``mm``."""
    if isinstance(Lam, np.ndarray):
        eye = np.eye(Lam.shape[0])
        X = eye / np.abs(Lam).sum(1).max()
    else:
        eye = torch.eye(Lam.shape[0], dtype=Lam.dtype, device=Lam.device)
        X = eye / Lam.abs().sum(1).max()
    two_eye = 2.0 * eye
    for _ in range(iters):
        X = mm(X, two_eye - mm(Lam, X))
    return X


def phase_ozaki(seed, z, card):
    """``ops/ozaki.py`` on the card: ``torch._int_mm``'s rules and layouts;
    each diagonal group's int32 product at K = 10,000 against the exact
    integer product on the host; ``ozaki_matmul`` against the host's f64
    product at 600^3, at the 600×10000 SYRK and at the κ = 1e12 SPD 96^3
    case (OZ_RTOL); device times of ``ozaki_matmul`` and cuBLAS's f64
    ``torch.matmul`` at 600^3 and the SYRK, and of the 28-iteration
    Newton-Schulz chain on the trained Λ (M = 600) with each product."""
    from gaussianprocessnode_tpu_torch.ops import ozaki
    from gaussianprocessnode_tpu_torch.utils.profiling import (cuda_graph_time_ms,
                                                                cuda_kernel_times)

    rng = np.random.default_rng(seed)
    out = {"int_mm_rules": _int_mm_rules()}

    # exactness: every group's int32 sum against the host's, carried in f64
    # BLAS, which is exact here (integer partial sums ≤ 64·64·8·K < 2^53)
    X = torch.as_tensor(rng.standard_normal((600, OZ_K_EXACT)), device="cuda")
    S = ozaki.OZAKI_SLICES
    Aall, BallT, _ = ozaki._operands(X, X.T, S)
    exact = []
    for s in range(S):
        Aop, Bop = ozaki._group(Aall, BallT, OZ_K_EXACT, S, s)
        P = torch._int_mm(Aop, Bop).cpu().numpy().astype(np.int64)
        ref = Aop.cpu().numpy().astype(np.float64) @ Bop.cpu().numpy().astype(np.float64)
        exact.append(bool(np.array_equal(P, ref.astype(np.int64))))
    print(f"ozaki groups at K={OZ_K_EXACT} (inner lengths {OZ_K_EXACT}..{S * OZ_K_EXACT}): "
          f"int32 equal to the exact integer product: {exact}", flush=True)
    check(all(exact), "an int8 group product is not exact in int32")
    out["groups_exact_k10000"] = exact

    # accuracy against the host's f64 product
    acc = {}
    cases = []
    for m, k, n, label in OZ_SHAPES:
        a = rng.standard_normal((m, k))
        b = a.T.copy() if "SYRK" in label else rng.standard_normal((k, n))
        cases.append((label, a, b))
    Q = rng.standard_normal((96, 96))
    Sp = (Q * 10.0 ** np.linspace(-6, 6, 96)) @ Q.T
    Sp = (Sp + Sp.T) / 2.0
    cases.append(("kappa=1e12 SPD 96^3", Sp, Sp))
    for label, a, b in cases:
        C = ozaki.ozaki_matmul(torch.as_tensor(a, device="cuda"),
                               torch.as_tensor(b, device="cuda")).cpu().numpy()
        C_ref = a @ b
        r_oz = _oz_rel(C, C_ref)
        r_cublas = _oz_rel((torch.as_tensor(a, device="cuda") @ torch.as_tensor(b, device="cuda"))
                           .cpu().numpy(), C_ref)
        acc[label] = {"ozaki_rel": r_oz, "cublas_f64_rel": r_cublas}
        print(f"ozaki {label}: max|C - host f64|/max|host| = {r_oz:.3e} (limit {OZ_RTOL:.0e}); "
              f"cuBLAS f64 {r_cublas:.3e}", flush=True)
        check(np.isfinite(C).all() and r_oz < OZ_RTOL, f"ozaki_matmul off at {label}")
    out["accuracy"] = acc

    # times: ozaki_matmul against cuBLAS's f64 product
    times = {}
    for (m, k, n, label), (_, a, b) in zip(OZ_SHAPES, cases):
        A = torch.as_tensor(a, device="cuda")
        B = A.T if "SYRK" in label else torch.as_tensor(b, device="cuda")
        oz_ms = cuda_graph_time_ms(lambda: ozaki.ozaki_matmul(A, B), iters=20, warmup=2)
        f64_ms = cuda_graph_time_ms(lambda: A @ B, iters=20, warmup=2)
        bounds = ozaki_bounds_ms(m, k, n, 8.0 * (m * k if "SYRK" in label else m * k + k * n))
        times[label] = {"ozaki_ms": oz_ms, "cublas_f64_ms": f64_ms, **bounds}
        print(f"ozaki {label}: {oz_ms:.5f} ms against cuBLAS f64 {f64_ms:.5f} ms (device "
              f"time, CUDA graph of 20 calls); bounds: f64 {bounds['f64_bound_ms'] * 1e3:.2f} us "
              f"({bounds['f64_bound_by']}), Ozaki int8 passes "
              f"{bounds['ozaki_int8_bound_ms'] * 1e3:.2f} us [{card}]", flush=True)
    out["times"] = times

    # where an Ozaki product's device time goes: the int8 GEMMs against the
    # split, the concatenations and the f64 accumulation (one traced SYRK)
    m, k, n, label = OZ_SHAPES[1]
    A = torch.as_tensor(cases[1][1], device="cuda")
    wall, kernels = cuda_kernel_times(lambda: ozaki.ozaki_matmul(A, A.T))
    check(bool(kernels), "the profiler recorded no device time for ozaki_matmul")
    gemm = {name: v for name, v in kernels.items()
            if any(t in name.lower() for t in ("gemm", "imma", "xmma", "cutlass", "matmul"))}
    gemm_ms = sum(ms for _, ms in gemm.values())
    all_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"ozaki {label} traced: {all_ms:.4f} ms of device time in "
          f"{sum(c for c, _ in kernels.values())} kernels; int8 GEMMs {gemm_ms:.4f} ms in "
          f"{sum(c for c, _ in gemm.values())}, the rest (split, copies, f64 accumulation) "
          f"{all_ms - gemm_ms:.4f} ms; largest: "
          + "; ".join(f"{name[:70]} x{c} {ms:.4f} ms" for name, (c, ms) in top)
          + f" [{card}]", flush=True)
    out["syrk_trace"] = {"device_ms": all_ms, "int8_gemm_ms": gemm_ms, "wall_ms": wall,
                         "largest": [[name, c, ms] for name, (c, ms) in top]}

    # the Newton-Schulz chain on the trained kin40k Λ, each product both ways
    lam_np = np.asarray(z["prec"], np.float64)
    Lam = torch.as_tensor(lam_np, device="cuda")
    X_oz = _ns_chain(Lam, ozaki.ozaki_matmul)
    X_f64 = _ns_chain(Lam, torch.matmul)
    X_host = _ns_chain(lam_np, np.matmul)
    check(bool(torch.isfinite(X_oz).all() and torch.isfinite(X_f64).all()),
          "non-finite Newton-Schulz chain")
    scale = float(np.abs(X_host).max())
    d_pair = float((X_oz - X_f64).abs().max())
    d_oz = float(np.abs(X_oz.cpu().numpy() - X_host).max())
    d_f64 = float(np.abs(X_f64.cpu().numpy() - X_host).max())
    eye = torch.eye(Lam.shape[0], dtype=torch.float64, device="cuda")
    res = {name: float(torch.linalg.norm(eye - Lam @ Xc)) for name, Xc in
           (("ozaki", X_oz), ("cublas_f64", X_f64))}
    oz_ms = cuda_graph_time_ms(lambda: _ns_chain(Lam, ozaki.ozaki_matmul), iters=3, warmup=1)
    f64_ms = cuda_graph_time_ms(lambda: _ns_chain(Lam, torch.matmul), iters=3, warmup=1)
    print(f"Newton-Schulz chain ({NS_CHAIN_ITERS} iterations, M={Lam.shape[0]}, trained Lambda): "
          f"Ozaki {oz_ms:.4f} ms, cuBLAS f64 {f64_ms:.4f} ms (device time, CUDA graph); "
          f"max|X_oz - X_f64| = {d_pair:.3e}, against the host chain {d_oz:.3e} / {d_f64:.3e} "
          f"(max|X| = {scale:.3e}); ||I - Lambda X||_F {res} [{card}]", flush=True)
    out["ns_chain"] = {"iters": NS_CHAIN_ITERS, "ozaki_ms": oz_ms, "cublas_f64_ms": f64_ms,
                       "max_abs_diff": d_pair, "ozaki_vs_host": d_oz, "f64_vs_host": d_f64,
                       "max_abs_x": scale, "residual_fro": res}
    return out


def phase_records(seed, card):
    """The serving record (``experiments/serving_bench.py`` at R = 64 behind
    its gate) and the flagship forward step (``entry.py``) in float32
    through the kernel against float64 through the plain Gram. Each path's
    launch count is set to 0 just before it and read just after."""
    from gaussianprocessnode_tpu_torch.entry import entry
    from gaussianprocessnode_tpu_torch.experiments import serving_bench
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
    from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda

    se_gram_cuda.launches = 0
    rec = serving_bench.record(device="cuda", seed=seed)
    rec_launches = se_gram_cuda.launches
    rates = rec["preds_per_second"]
    check(rec["gate"]["passed"] and rec_launches > 0 and
          all(np.isfinite(v) and v > 0 for v in rates.values()),
          f"serving record: {rec['gate']}, launches {rec_launches}, rates {rates}")
    held = {k: v for k, v in rec["gate"].items() if k.startswith("means_B")}
    check(set(held) == {"means_B1024", "means_B30000"} and
          all(h["passed"] for h in held.values()),
          f"serving record: the timed batch shapes are not all held: {held}")
    print("serving record: gate (float32 means against float64, max |d|/(|K|^T|mu|)) "
          + ", ".join(f"{k[6:]} {h['max_rel']:.3e} (limit {h['limit']:.3e})"
                      for k, h in held.items())
          + f"; {', '.join(f'{k} {v:.6e}' for k, v in rates.items())} "
          f"predictions/s; se_gram launches {rec_launches} [{card}]", flush=True)

    fwd, args32 = entry(device="cuda", dtype=torch.float32)
    _, args64 = entry(device="cuda")
    se_gram_cuda.launches = 0
    m32 = fwd(*args32)
    torch.cuda.synchronize()
    entry_launches = se_gram_cuda.launches
    m64 = fwd(*args64)
    check(se_gram_cuda.launches == entry_launches == 1,
          f"entry: {se_gram_cuda.launches} launches, expected 1 (float32) + 0 (float64)")
    theta, Xu, X_test, mu_v = args64
    scale, limit = serving_bench.means_bound(Kernel("se", transform="softplus"), theta, Xu,
                                             mu_v, X_test)
    rel = float(((m32.double() - m64).abs() / scale).max())
    print(f"entry(): float32 through the kernel against float64 plain: max |d|/(|K|^T|mu|) = "
          f"{rel:.3e} (limit {limit:.3e}); shape {tuple(m32.shape)}; se_gram launches "
          f"{entry_launches}", flush=True)
    check(tuple(m32.shape) == (args32[2].shape[0],) and bool(torch.isfinite(m32).all())
          and rel <= limit, "entry(): the kernel's forward step disagrees with float64")
    return {"serving_record": {k: v for k, v in rec.items() if k != "description"},
            "serving_record_launches": rec_launches,
            "entry": {"max_rel": rel, "limit": limit, "launches": entry_launches},
            "launches": rec_launches + entry_launches}


def phase_16(seed, z, card):
    say("phase 16/16 Ozaki f64 product, serving record, entry: start")
    oz = phase_ozaki(seed, z, card)
    recs = phase_records(seed, card)
    route = {"name": "ozaki_matmul", "route": "cuBLASLt int8 GEMM (torch._int_mm), a library "
             "route and not a ported kernel", "source": "gaussianprocessnode_tpu_torch/ops/ozaki.py",
             "counterpart_of": "gaussianprocessnode_tpu/ops/ozaki.py:103 (jnp.matmul int8, "
             "no Pallas kernel)", **oz}
    print(json.dumps({"library_routes": [route]}), flush=True)
    say("phase 16/16 Ozaki f64 product, serving record, entry: done")
    return recs


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
        diffs = phase_kernel(z["theta"], np.load(BANANA_NPZ, allow_pickle=False)["theta"])
        handle, X, launches = phase_serve(args.seed, z)
        shapes, serving = phase_times(handle, X, card)
        train = phase_train(args.seed, card)
        banana = phase_banana(args.seed, card)
        classifier = phase_classifier(args.seed, card)
        toy = phase_toy(card)
        vsgp = phase_vsgp(args.seed, card)
        multi = phase_multi(args.seed, card)
        gpssm = phase_gpssm(args.seed, card)
        gplvm = phase_gplvm(args.seed, card)
        legacy = phase_legacy(card)
        parallel = phase_parallel(args.seed, card)
        records = phase_16(args.seed, z, card)
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
        "launches": (launches + train["launches"] + banana["launches"]
                     + banana["faithful"]["launches"] + banana["kin40k_faithful"]["launches"]
                     + classifier["launches"] + toy["launches"]
                     + vsgp["collapsed"]["launches"] + vsgp["runner"]["launches"]
                     + vsgp["svgp"]["launches"]
                     + vsgp["fitc"]["launches"] + multi["objective"]["launches"]
                     + gpssm["launches"] + gplvm["launches"] + legacy["launches"]
                     + parallel["launches"] + records["launches"]),
        "launches_by_path": {"serving": launches, "training": train["launches"],
                             "banana_training": banana["launches"],
                             "banana_faithful": banana["faithful"]["launches"],
                             "kin40k_faithful": banana["kin40k_faithful"]["launches"],
                             "classifier_serving": classifier["launches"],
                             "toy_regression_f32": toy["toy_regression"]["f32_launches"],
                             "toy_classification_f32":
                                 toy["toy_classification"]["f32_launches"],
                             "vsgp_collapsed": vsgp["collapsed"]["launches"],
                             "kin40k_collapsed_runner": vsgp["runner"]["launches"],
                             "svgp_minibatch_f32": vsgp["svgp"]["launches"],
                             "fitc_f32": vsgp["fitc"]["launches"],
                             "multi_objective_f32": multi["objective"]["launches"],
                             **gpssm["launches_by_path"], **gplvm["launches_by_path"],
                             **legacy["launches_by_path"], **parallel["launches_by_path"],
                             "serving_record": records["serving_record_launches"],
                             "entry_f32": records["entry"]["launches"]},
        "launches_per_collapsed_step": vsgp["collapsed"]["launches"] / VSGP_STEPS,
        "launches_per_svgp_epoch": vsgp["svgp"]["launches"] / SVGP_EPOCHS,
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
        "shapes": (shapes + banana["shapes"] + [classifier["shape"]] + toy["shapes"]
                   + multi["shapes"] + gpssm["shapes"] + gplvm["shapes"]),
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
        "banana": banana,
        "classifier": classifier,
        "toy": {k: v for k, v in toy.items() if k != "shapes"},
        "vsgp": vsgp,
        "multi": {k: v for k, v in multi.items() if k != "shapes"},
        "gpssm": {k: v for k, v in gpssm.items() if k != "shapes"},
        "gplvm": {k: v for k, v in gplvm.items() if k != "shapes"},
        "legacy_gp": legacy,
        "parallel": {k: v for k, v in parallel.items() if k != "launches_by_path"},
        "records": records,
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
