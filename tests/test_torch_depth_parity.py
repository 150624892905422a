"""The port's headline runners against the JAX package's trainers, run as
a user runs them: the runners' ``run`` (chunks, setup, recovery and
prediction included) on the CPU against ``scripts/headline_jax_parity.py``'s
JAX trainer calls on the runners' own arrays, at small width.

This is the tier-1 form of that script, which holds the card's runs at full
width and depth (M = 600 / 500, 500 epochs, 400 collapsed steps). Sizes:
kin40k fast M = 64 on the first 2,000 training rows (4 batches of 500) for
20 epochs, float32 and float64, scored on 5,000 test rows; banana fast M = 32
on its 4,000 rows (20 batches of 200) for 20 epochs; the collapsed VSGP M =
64 on 2,000 rows for 50 steps (two chunks of 25). Data from the port's
synthetic generators.
"""

import functools
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu_torch.experiments import banana, kin40k, vsgp_baselines

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KIN40K = dict(m_inducing=64, n_train=2000, n_test=5000)
KIN40K_EPOCHS = 20
BANANA_M, BANANA_EPOCHS = 32, 20
COLLAPSED = dict(m_inducing=64, n_train=2000, n_test=5000)
COLLAPSED_STEPS = 50
# One case's two runs (the port's runner and the JAX trainer, compiles
# included) took 5-9 s on one thread of a busy CPU; the limit leaves room
# for a more loaded host under pytest-xdist.
CASE_SECONDS = 60.0

# Tolerances, each relative, with the reading it was set from:
# - float32: θ's gradients are f32 sums through Kuu⁻¹ that the two packages
#   round differently; AdaMax carries the difference into θ at ~lr·ε₃₂ per
#   step, and ξ, Λ, the prediction follow θ. Measured: kin40k 2.3e-7 in θ
#   and 1.7e-7 in the SMSE after 80 θ-steps (a one-ulp twin of the targets
#   moves JAX itself by 2.4e-7 in θ); banana 1.1e-5 in θ after 400
#   θ-steps from its cold epoch, which sits in f32 rounding noise (ROADMAP
#   Queue 3), and the same errors; the collapsed VSGP 1.1e-6 in θ and
#   1.9e-6 in the SMSE after 50 steps at lr 0.05. Held to 2e-5 (~170
#   ε₃₂), the limit of tests/test_torch_minibatch.py.
# - float64: every step is the same f64 arithmetic; measured 9.3e-16 in θ
#   and 4.3e-15 in the SMSE; held to 1e-11.
TOL = {"float32": 2e-5, "float64": 1e-11}


@functools.lru_cache(maxsize=None)
def _script():
    """The script, loaded once for the module's cases."""
    spec = importlib.util.spec_from_file_location(
        "headline_jax_parity", ROOT / "scripts" / "headline_jax_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def pair(case):
    """(port, jax, seconds) for one case: the port runner's figures and
    θ (softplus) beside the JAX trainer's on the same arrays."""
    h = _script()
    t0 = time.perf_counter()
    if case.startswith("kin40k"):
        dtype = torch.float32 if case == "kin40k_f32" else torch.float64
        out = kin40k.run(epochs=KIN40K_EPOCHS, device="cpu", dtype=dtype, **KIN40K)
        port = (out["smse"], out["theta_softplus"])
        ref = h.jax_kin40k(h.kin40k_arrays(dtype, **KIN40K), KIN40K_EPOCHS)[KIN40K_EPOCHS]
        jx = (ref["smse"], ref["theta_softplus"])
    elif case == "banana":
        out = banana.run(epochs=BANANA_EPOCHS, m_inducing=BANANA_M, device="cpu")
        port = (out["errors"], out["theta_softplus"])
        ref = h.jax_banana(h.banana_arrays(m_inducing=BANANA_M), BANANA_EPOCHS)[BANANA_EPOCHS]
        jx = (ref["errors"], ref["theta_softplus"], np.asarray(ref["probs"]))
    else:
        out = vsgp_baselines.run_kin40k_collapsed(steps=COLLAPSED_STEPS, device="cpu",
                                                  **COLLAPSED)
        port = (out["final_smse"], out["theta_softplus"])
        ref = h.jax_collapsed(h.collapsed_arrays(**COLLAPSED), COLLAPSED_STEPS)[COLLAPSED_STEPS]
        jx = (ref["smse"], ref["theta_softplus"])
    return port, jx, time.perf_counter() - t0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("case", ["kin40k_f32", "kin40k_f64", "banana", "collapsed"])
def test_runner_matches_jax(case):
    port, jx, seconds = pair(case)
    tol = TOL["float64" if case == "kin40k_f64" else "float32"]
    assert _rel(port[1], jx[1]) <= tol, (case, port[1], jx[1])
    if case == "banana":
        # a test point changes sides only if its probability lies within
        # the packages' rounding of ½: f32 probabilities from θ, μ_v that
        # agree to 2e-5 agree to ~1e-4
        near = int(np.sum(np.abs(jx[2] - 0.5) <= 1e-4))
        assert abs(port[0] - jx[0]) <= near, (port[0], jx[0], near)
    else:
        assert _rel(port[0], jx[0]) <= tol, (case, port[0], jx[0])
    assert seconds <= CASE_SECONDS, (case, seconds)


def test_kin40k_f32_over_f64_smse_ratio_matches_jax():
    """The float32 SMSE over the float64 one, in each package: the same
    within the sum of the two dtypes' SMSE tolerances."""
    (p32, j32, _), (p64, j64, _) = pair("kin40k_f32"), pair("kin40k_f64")
    port_ratio, jax_ratio = p32[0] / p64[0], j32[0] / j64[0]
    assert abs(port_ratio / jax_ratio - 1.0) <= TOL["float32"] + TOL["float64"], (
        port_ratio, jax_ratio)
