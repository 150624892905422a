"""The port's serving path against the JAX package, on the CPU.

The committed kin40k state (benchmarks/kin40k_refxu_trained.npz: θ, ξ, Λ of
the model trained from the reference's inducing inputs; κ(Λ) ≈ 6.8e8) goes
through both packages' posterior recovery; the whole path (convert →
handle → means/vars) is held against the JAX SGPRegressor on the same
arrays, with the JAX Gram in the Pallas interpreter where the handle is f32.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import serve as jserve
from gaussianprocessnode_tpu.dists import GammaShapeRate as JGamma
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.dists import gamma_mean as j_gamma_mean
from gaussianprocessnode_tpu.infer.batch_vmp import predict_out as j_predict_out
from gaussianprocessnode_tpu.ops import pallas_gram as pg
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.utils.metrics import smse as j_smse
from gaussianprocessnode_tpu_torch import convert, dists, serve
from gaussianprocessnode_tpu_torch.infer.batch_vmp import predict_out
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from gaussianprocessnode_tpu_torch.ops.se_gram import se_gram_cuda
from gaussianprocessnode_tpu_torch.utils.metrics import smse

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gaussianprocessnode_tpu_torch"
NPZ = ROOT / "benchmarks" / "kin40k_refxu_trained.npz"
W_MEAN = 1e4


@pytest.fixture(scope="module")
def state():
    z = np.load(NPZ, allow_pickle=False)
    return {k: z[k] for k in ("theta", "xi", "prec")}


@pytest.fixture(scope="module")
def jax_mu(state):
    return np.asarray(jserve._recover_mu_v(JNat(jnp.asarray(state["xi"]),
                                                jnp.asarray(state["prec"]))))


def _interpret(fn):
    pg._INTERPRET = True
    jax.clear_caches()  # se_gram_pallas's jit trace depends on the flag
    try:
        return fn()
    finally:
        pg._INTERPRET = False
        jax.clear_caches()


def test_recover_mu_v_on_kin40k_state_matches_jax(state, jax_mu):
    """f64 recovery at κ ≈ 6.8e8: μ_v within 1e-7 relative of JAX's (both are
    ~4e-9 from a direct solve), residual ‖Λμ−ξ‖/‖ξ‖ ≤ 1e-10."""
    nat = dists.MvGaussianNat(torch.as_tensor(state["xi"]), torch.as_tensor(state["prec"]))
    mu = serve._recover_mu_v(nat).numpy()
    assert np.linalg.norm(mu - jax_mu) / np.linalg.norm(jax_mu) <= 1e-7
    P, xi = state["prec"], state["xi"]
    assert np.linalg.norm(P @ mu - xi) / np.linalg.norm(xi) <= 1e-10


@pytest.mark.parametrize("use_kernel", [True, False])
def test_predict_out_matches_jax(use_kernel):
    """f64, small shapes: 1e-12 relative on the means (plus 1e-12 of
    |K|ᵀ|μ| for means near 0); the variance is exactly 1/w̄."""
    rng = np.random.default_rng(0)
    Xu, X, mu = rng.standard_normal((12, 3)), rng.standard_normal((30, 3)), rng.standard_normal(12)
    theta = np.array([0.2, 0.4, -0.1, 0.9])
    jm, jv = j_predict_out(JKernel("se", "softplus", use_pallas=use_kernel),
                           jnp.asarray(theta), jnp.asarray(Xu), jnp.asarray(X),
                           jnp.asarray(mu), W_MEAN)
    m, v = predict_out(Kernel("se", "softplus", use_kernel=use_kernel),
                       torch.as_tensor(theta), torch.as_tensor(Xu), torch.as_tensor(X),
                       torch.as_tensor(mu), torch.tensor(W_MEAN, dtype=torch.float64))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-12,
                               atol=1e-12 * np.abs(mu).sum())
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_whole_slice_matches_jax_handle(state, dtype):
    """convert.serving_state_from_jax → handle → (means, vars) against the
    JAX SGPRegressor built from the same arrays (Kernel('se', 'softplus',
    use_pallas=True); in f32 its Gram runs the Pallas kernel interpreted).
    Relative to |K|ᵀ|μ|, the scale the means' rounding follows: 1e-7 in f64,
    the limit μ_v is held to above (the recovery's own accuracy is
    κ(Λ)·ε ≈ 1.5e-7; measured 4e-10); 1e-5 in f32 (f32 Gram and mat-vec
    over 600 terms)."""
    rng = np.random.default_rng(11)
    Xu = rng.standard_normal((600, 8))
    X = rng.standard_normal((64, 8))
    npd = np.float64 if dtype == torch.float64 else np.float32
    jh = jserve.SGPRegressor.from_natural(
        JKernel("se", "softplus", use_pallas=True), jnp.asarray(state["theta"]),
        jnp.asarray(Xu), JNat(jnp.asarray(state["xi"]), jnp.asarray(state["prec"])),
        W_MEAN, dtype=npd)
    if dtype == torch.float32:
        jm, jv = _interpret(lambda: tuple(map(np.asarray, jh(X))))
    else:
        jm, jv = map(np.asarray, jh(X))

    th = convert.serving_state_from_jax(state["theta"], Xu, state["xi"], state["prec"],
                                        W_MEAN, dtype=dtype, device="cpu")
    assert th.kernel == Kernel("se", "softplus", use_kernel=True)
    assert th.theta.dtype == th.Xu.dtype == th.mu_v.dtype == dtype
    assert isinstance(th.w_mean, torch.Tensor)
    m, v = th(X)
    assert m.dtype == v.dtype == dtype and tuple(m.shape) == (64,)
    scale = (th.kernel(th.theta.double(), th.Xu.double(), torch.as_tensor(X)).abs().T
             @ th.mu_v.double().abs()).numpy()
    rtol = 1e-7 if dtype == torch.float64 else 1e-5
    assert np.max(np.abs(m.numpy() - jm) / scale) <= rtol
    np.testing.assert_array_equal(v.numpy(), jv)


def test_serve_fused_rows_equal_per_batch_handle(state):
    th = convert.serving_state_from_jax(state["theta"], np.random.default_rng(1).standard_normal((600, 8)),
                                        state["xi"], state["prec"], W_MEAN,
                                        dtype=torch.float32, device="cpu")
    X = np.random.default_rng(2).standard_normal((3, 50, 8))
    means, vars_ = serve.serve_fused(th, X)
    assert tuple(means.shape) == tuple(vars_.shape) == (3, 50)
    for i in range(3):
        m, v = th(X[i])
        assert torch.equal(means[i], m) and torch.equal(vars_[i], v)


def test_serve_fused_matches_jax_serve_fused():
    """f64 small model: the port's loop over batches against the JAX
    scanned program, to 1e-12 of the largest mean (same formulas, other
    summation order)."""
    rng = np.random.default_rng(3)
    Xu, X = rng.standard_normal((15, 2)), rng.standard_normal((4, 20, 2))
    A = rng.standard_normal((15, 15))
    prec, xi = A @ A.T + 15 * np.eye(15), rng.standard_normal(15)
    theta = np.array([0.5, 0.3, 0.8])
    jh = jserve.SGPRegressor.from_natural(JKernel("se", "softplus"), jnp.asarray(theta),
                                          jnp.asarray(Xu), JNat(jnp.asarray(xi), jnp.asarray(prec)),
                                          7.0)
    jm, jv = map(np.asarray, jserve.serve_fused(jh, X))
    th = serve.SGPRegressor.from_natural(Kernel("se", "softplus"), theta, Xu,
                                         dists.MvGaussianNat(xi, prec), 7.0, device="cpu")
    m, v = serve.serve_fused(th, X)
    scale = np.abs(jm).max() + 1.0
    np.testing.assert_allclose(m.numpy(), jm, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(v.numpy(), jv)


def test_throughput_counts_predictions_on_cpu(state):
    th = convert.serving_state_from_jax(state["theta"], np.zeros((600, 8)), state["xi"],
                                        state["prec"], W_MEAN, dtype=torch.float32,
                                        device="cpu")
    X = np.random.default_rng(4).standard_normal((40, 8))
    assert serve.throughput(th, X, iters=2) > 0
    assert serve.throughput_fused(th, X, n_batches=3, iters=2) > 0


def test_cpu_serving_launches_no_kernel(state):
    th = convert.serving_state_from_jax(state["theta"], np.zeros((600, 8)), state["xi"],
                                        state["prec"], W_MEAN, dtype=torch.float32,
                                        device="cpu")
    before = se_gram_cuda.launches
    serve.serve_fused(th, np.zeros((2, 5, 8)))
    assert se_gram_cuda.launches == before


def test_entry_points_default_to_the_card(state):
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        convert.serving_state_from_jax(state["theta"], np.zeros((600, 8)), state["xi"],
                                       state["prec"], W_MEAN)


def test_smse_and_dists_match_jax():
    rng = np.random.default_rng(5)
    y, yh = rng.standard_normal(40), rng.standard_normal(40)
    assert float(smse(torch.as_tensor(y), torch.as_tensor(yh))) == pytest.approx(
        float(j_smse(y, yh)), rel=1e-13)
    q = dists.GammaShapeRate(torch.tensor(3.0, dtype=torch.float64), torch.tensor(0.7, dtype=torch.float64))
    assert float(dists.gamma_mean(q)) == float(j_gamma_mean(JGamma(jnp.asarray(3.0), jnp.asarray(0.7))))
    g = dists.Gaussian(torch.tensor(1.0), torch.tensor(4.0))
    assert float(g.precision) == 0.25


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_import_no_jax():
    """The card's machine has no JAX: neither the port nor chip_smoke.py may
    import it or the JAX package (whose __init__ imports jax)."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gaussianprocessnode_tpu"), (f, name)


def test_port_imports_with_jax_unavailable():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['gaussianprocessnode_tpu'] = None; "
            "import gaussianprocessnode_tpu_torch.convert, "
            "gaussianprocessnode_tpu_torch.ops.se_gram, "
            "gaussianprocessnode_tpu_torch.utils.profiling, "
            "gaussianprocessnode_tpu_torch.utils.metrics, "
            "gaussianprocessnode_tpu_torch.utils.datasets, "
            "gaussianprocessnode_tpu_torch.objectives, "
            "gaussianprocessnode_tpu_torch.infer.minibatch, "
            "gaussianprocessnode_tpu_torch.nodes.probit, "
            "gaussianprocessnode_tpu_torch.ops.quadrature, "
            "gaussianprocessnode_tpu_torch.experiments.kin40k, "
            "gaussianprocessnode_tpu_torch.experiments.banana, "
            "gaussianprocessnode_tpu_torch.experiments.serving_bench, "
            "gaussianprocessnode_tpu_torch.experiments.refxu_record, "
            "gaussianprocessnode_tpu_torch.experiments.headline, "
            "gaussianprocessnode_tpu_torch.ops.ozaki, "
            "gaussianprocessnode_tpu_torch.entry; "
            "import chip_smoke; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
