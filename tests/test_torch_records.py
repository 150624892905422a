"""The port's record runners and entry step on the CPU, at a small size:
the kin40k runner's ``warm_timing``, ``experiments/refxu_record.py``,
``experiments/serving_bench.py`` and ``entry.py``, each against the JAX
package where it has a counterpart that runs here (the JAX record scripts
read the reference's savefiles and data, absent here, so their library
calls are held instead: ``fit_kin40k`` for the refxu record, the graft
entry's forward step for ``entry``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu.ops.kernels import invsoftplus as jinvsoftplus
from gaussianprocessnode_tpu_torch.entry import entry
from gaussianprocessnode_tpu_torch.experiments import kin40k as runner
from gaussianprocessnode_tpu_torch.experiments import refxu_record, serving_bench

torch.set_num_threads(1)

SMALL = dict(n_train=1000, batch_size=100, n_test=500, device="cpu")


def test_warm_timing_trains_twice_to_the_same_bits():
    """With warm_timing the epochs run a second time from the same start:
    ``first_seconds`` is the first run's, ``value`` the second's, and the
    second run's θ, ξ, Λ equal the first's bit for bit (and a run without
    warm_timing)."""
    warm = runner.run(epochs=2, m_inducing=32, warm_timing=True, **SMALL)
    cold = runner.run(epochs=2, m_inducing=32, **SMALL)
    assert warm["warm_timing"] and warm["warm_equals_first"] is True
    assert warm["first_seconds"] > 0 and warm["value"] > 0
    assert cold["warm_equals_first"] is None and cold["first_seconds"] == cold["value"]
    assert warm["theta"] == cold["theta"] and warm["smse"] == cold["smse"]
    assert warm["gram_launches"] == cold["gram_launches"] == 0  # the CPU launches none


def _write_goldens(path, xu, theta_star, smse_ref):
    for name, value in zip(refxu_record.GOLDENS, (xu, theta_star, smse_ref)):
        np.save(path / f"{name}.npy", np.asarray(value))


def test_refxu_record_from_npy_goldens_matches_jax_fit_kin40k(tmp_path, monkeypatch):
    """The record trains the faithful f64 schedule from the golden Xu (its
    θ held to the JAX ``fit_kin40k`` on the same data: the per-batch
    refresh's warm Newton–Schulz inverse carries other summation orders
    with a gain up to κ(Λ), ~κ·ε₆₄ ≈ 1e-8, as in
    test_torch_kin40k_faithful.py; measured 0, bit-equal) and reports its parity
    fields against θ* and the SMSE golden. kin40k's files are absent here, so
    the runner's kin40k loader is given the synthetic data of its shape."""
    rng = np.random.default_rng(4)
    xu = rng.standard_normal((32, 8))
    theta_star = rng.standard_normal(9)
    _write_goldens(tmp_path, xu, theta_star, 0.08)
    ds = runner.load_data("synthetic", 1, SMALL["n_test"])
    monkeypatch.setattr(runner, "kin40k", lambda: ds)
    rec = refxu_record.record(str(tmp_path), epochs=2, **SMALL)
    for key in ("faithful_seconds_clean", "first_seconds", "smse", "smse_ref", "abs_smse_diff",
                "theta", "theta_star_ref", "max_abs_theta_diff", "ns_budget", "device"):
        assert key in rec, key
    assert "r3_unscaled60_seconds" not in rec and "r4_contaminated_seconds" not in rec
    theta = np.asarray(rec["theta"])
    assert rec["data"] == "kin40k" and rec["parity"] == "against the goldens"
    assert rec["max_abs_theta_diff"] == float(np.abs(theta - theta_star).max())
    assert rec["abs_smse_diff"] == abs(rec["smse"] - 0.08) and rec["m_inducing"] == 32
    assert rec["ns_budget"] == "scaled 34" and not rec["warm_timing"]

    theta0, Xu, Xb, yb, prior_v = runner.setup(ds, n_train=SMALL["n_train"],
                                               batch_size=SMALL["batch_size"], device="cpu",
                                               dtype=torch.float64, xu=xu)
    jth, _, _ = jmb.fit_kin40k(JKernel("se", "softplus", use_pallas=True),
                               jnp.asarray(theta0.numpy()), jnp.asarray(Xu.numpy()),
                               jnp.asarray(Xb.numpy()), jnp.asarray(yb.numpy()),
                               JNat(jnp.asarray(prior_v.xi.numpy()),
                                    jnp.asarray(prior_v.prec.numpy())),
                               runner.W_VAL, 2, ns_budget=34)
    jth = np.asarray(jth)
    assert np.linalg.norm(theta - jth) / np.linalg.norm(jth) <= 1e-8

    # on synthetic data the goldens (a fit on kin40k) say nothing: no parity
    syn = refxu_record.record(str(tmp_path), epochs=2, data="synthetic", **SMALL)
    assert syn["theta"] == rec["theta"] and syn["data"] == "synthetic"
    assert syn["max_abs_theta_diff"] is None and syn["abs_smse_diff"] is None
    assert syn["parity"].startswith("not applicable")


def test_refxu_record_without_goldens_raises_naming_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="Xu_kin40k"):
        refxu_record.main(["--save", str(tmp_path), "--device", "cpu", "--epochs", "1"])
    _write_goldens(tmp_path, np.zeros((4, 8)), np.zeros(9), 0.1)
    (tmp_path / "SMSE_kin40k.npy").unlink()
    with pytest.raises(FileNotFoundError, match="SMSE_kin40k"):
        refxu_record.record(str(tmp_path), epochs=1, **SMALL)


def test_serving_bench_cpu_smoke_writes_its_record(tmp_path):
    """The default gate (the committed state's float32 means against its
    float64 means at both timed batch shapes, phase 4's bound; measured
    ~1.6e-7 of |K|ᵀ|μ| at 30,000 requests against a limit of ~1.7e-4), then
    the three rates at 1,024 and 30,000 requests, written to --json."""
    out = tmp_path / "serving.json"
    assert serving_bench.main(["--device", "cpu", f"--json={out}"]) == 0
    rec = json.loads(out.read_text())
    gate = rec["gate"]
    assert gate["passed"] and rec["requests"] == 30_000
    for B in (1024, 30_000):
        held = gate[f"means_B{B}"]
        assert held["passed"] and held["max_rel"] <= held["limit"]
    assert set(rec["preds_per_second"]) == {"dispatch_bound_B1024", "dispatch_bound_B30000",
                                            "fused_B30000"}
    assert all(v > 0 for v in rec["preds_per_second"].values())
    assert rec["dispatch_calls"] == [2, 2] and (rec["fused_batches"], rec["fused_calls"]) == (4, 2)
    assert rec["device"] == {"name": "cpu"} and rec["dtype"] == "float32"


def test_serving_bench_with_absent_savefiles_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="qv_kin40k"):
        serving_bench.main(["--device", "cpu", "--save", str(tmp_path)])


def test_entry_matches_the_graft_entry():
    """The same draws and the same forward step as __graft_entry__.entry()
    in float64 (measured 1e-15 relative; the two Grams round differently)."""
    fwd, args = entry(device="cpu")
    jfwd, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        assert a.dtype == torch.float64 and np.array_equal(a.numpy(), np.asarray(b))
    got, want = fwd(*args).numpy(), np.asarray(jfwd(*jargs))
    assert got.shape == want.shape == (512,)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_array_equal(np.asarray(jinvsoftplus(jnp.ones(9))), args[0].numpy())
