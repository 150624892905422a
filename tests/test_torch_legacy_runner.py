"""The port's legacy-GP runner (experiments/legacy_gp.py) against the JAX
runner (experiments/legacy_gp.py), on the CPU in float64.

Each workload runs in both runners on the same draws, at reduced depth:
the JAX runner's library calls are wrapped (``monkeypatch``) so that they
take the reduced iteration counts and record their inputs, and the port's
runner gets the same counts as arguments (``run_sde``'s fixed 200-step loop
is cut by shadowing ``range`` in the JAX runner's module). The recorded
inputs must equal the port's data functions: 1e-14 where the draws are the
same numpy streams, 1e-7 for the Matérn-5/2 GP draws of pad2 and padlearn
(the Cholesky factor of a 500-point Gram with κ ≈ 1e9+ amplifies the two
packages' 1-ulp Gram differences; measured 1.1e-8). Each workload's
returned figure must agree: the single-pass workloads to 1e-10, the EP /
L-BFGS / AdaMax loops to 1e-8 relative (their iterations carry rounding
forward; the library tests hold each loop tighter; measured ≤ 2.3e-10),
padlearn's Bayesian lengthscale to 1e-6 (its tilt exponentiates evidences
of the draw that differs by 1e-8; measured 3.7e-8), the full-covariance GP
to 1e-6 (its long-ℓ GH nodes, see tests/test_torch_tprocess_fullcov.py).
Where the JAX runner rounds a figure (co2, btc), the port's is held to
half a unit of that rounding.

``co2`` and ``btc`` run on small CSV files in the real files' format
written to ``tmp_path``, read by both packages' loaders (``root`` for the
port; the JAX runner's loader is replaced by one that reads the same file);
without their files the port's loaders raise FileNotFoundError. The
command line writes its JSON line to ``--json`` and nothing under
``benchmarks/``; ``padscale`` runs its subprocesses at T = 64.
"""

import builtins
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gaussianprocessnode_tpu.infer.fullcov_gp as jfc
import gaussianprocessnode_tpu.infer.gpssm_control as jctl
import gaussianprocessnode_tpu.infer.gppad as jg
import gaussianprocessnode_tpu.infer.pad_learn as jl
import gaussianprocessnode_tpu.infer.sde_gp as jsde
import gaussianprocessnode_tpu.infer.tprocess as jtp
import gaussianprocessnode_tpu.utils.datasets as jds
from gaussianprocessnode_tpu_torch.experiments import legacy_gp as trun
from gaussianprocessnode_tpu_torch.utils import datasets as tds

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jrun():
    """The JAX runner module; its import-time compilation-cache settings
    are put back as they were."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    import experiments.legacy_gp as mod
    for k, v in saved.items():
        jax.config.update(k, v)
    return mod


def reduce(monkeypatch, module, name, **overrides):
    """Wrap ``module.name`` so that its keyword arguments take
    ``overrides``; returns the list of (args, kwargs) of its calls."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        kwargs.update(overrides)
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def same(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=rtol, atol=0.0)


def rounded(a, b, digits):
    """a against the JAX runner's figure b, which it rounds to ``digits``."""
    np.testing.assert_allclose(a, b, rtol=0, atol=0.5 * 10.0**-digits * (1 + 1e-9))


def test_tprocess(jrun, monkeypatch):
    calls = reduce(monkeypatch, jtp, "tp_exact_posterior")
    fit = jrun.run_tprocess(verbose=False)
    out = trun.run_tprocess(verbose=False, device="cpu")
    x, y, xt = trun.tprocess_data()
    args = calls[0][0]
    same(np.asarray(args[3])[:, 0], x, 1e-14)
    same(args[4], y, 1e-14)
    same(np.asarray(args[5])[:, 0], xt, 1e-14)
    same(out["fit_scale"], fit, 1e-10)
    assert out["gp_mean_equals_tp_mean"]


def test_sde(jrun, monkeypatch):
    steps = 15
    calls = reduce(monkeypatch, jsde, "sde_gp_smooth")
    monkeypatch.setattr(jrun, "range", lambda n: builtins.range(min(n, steps)), raising=False)
    rmse1 = jrun.run_sde(verbose=False)
    out = trun.run_sde(verbose=False, device="cpu", steps=steps)
    t, y, mask, f_true, obs_var = trun.sde_data()
    args = calls[0][0]
    same(args[1], t, 0)
    same(args[2], y, 1e-14)
    assert np.array_equal(np.asarray(args[3]), mask)
    same(out["rmse_interp_learned"], rmse1, 1e-8)
    assert out["smoother_vs_dense_max_abs"] < 1e-8


def test_fullcov(jrun, monkeypatch):
    calls = reduce(monkeypatch, jfc, "fullcov_gp_vmp", iters=4)
    rmse = jrun.run_fullcov(verbose=False)
    out = trun.run_fullcov(verbose=False, device="cpu", iters=4)
    x, y, _ = trun.fullcov_data()
    same(np.asarray(calls[0][0][1])[:, 0], x, 0)
    same(calls[0][0][2], y, 1e-14)
    same(out["test_rmse"], rmse, 1e-6)


def test_pad(jrun, monkeypatch):
    calls = reduce(monkeypatch, jg, "gppad_infer", iters=4)
    corr = jrun.run_pad(verbose=False)
    out = trun.run_pad(verbose=False, device="cpu", iters=4)
    t, y, _, _ = trun.pad_data()
    same(calls[0][0][1], t, 0)
    same(calls[0][0][2], y, 1e-14)
    same(out["corr_log_envelope"], corr, 1e-8)


def test_pad2(jrun, monkeypatch):
    calls = reduce(monkeypatch, jg, "gppad_colored_infer", iters=3)
    rel = jrun.run_pad2(verbose=False)
    out = trun.run_pad2(verbose=False, device="cpu", iters=3)
    t, y, _, _, _, _ = trun.pad2_data()
    same(calls[0][0][3], y, 1e-7)
    same(out["recon_rel_rmse"], rel, 1e-8)


def test_padlearn(jrun, monkeypatch):
    bay = reduce(monkeypatch, jl, "gppad_bayes_lengthscale", iters=2, ep_iters=3)
    em = reduce(monkeypatch, jl, "fit_gppad_theta", epochs=2, ep_iters=3)
    reduce(monkeypatch, jl, "gppad_mixture", iters=3)
    cem = reduce(monkeypatch, jl, "fit_gppad_colored_theta", epochs=1, ep_iters=4,
                 adjoint_iters=2)
    m_s, ell, resp = jrun.run_padlearn(verbose=True)  # its resp exists only when verbose
    out = trun.run_padlearn(verbose=False, device="cpu", bayes_iters=2, bayes_ep_iters=3,
                            em_epochs=2, em_ep_iters=3, mix_iters=3, colored_epochs=1,
                            colored_ep_iters=4, adjoint_iters=2)
    _, y, _ = trun.padlearn_data()
    _, y2 = trun.padlearn_colored_data()
    same(bay[0][0][1], y, 1e-7)
    same(em[0][0][1], y, 1e-7)
    same(cem[0][0][1], y2, 1e-7)
    same(out["bayes_m_s"], m_s, 1e-6)
    same(out["em_theta"][1], ell, 1e-8)
    np.testing.assert_allclose(out["mix_resp"], resp, rtol=0, atol=1e-8)
    assert np.all(np.isfinite(out["colored_theta"]))


def test_control(jrun, monkeypatch):
    calls = reduce(monkeypatch, jctl, "gpssm_control_vmp", n_iters=2)
    e1, e0 = jrun.run_control(verbose=False)
    out = trun.run_control(verbose=False, device="cpu", n_iters=2)
    _, ys, us, Xu = trun.control_data()
    same(calls[0][0][2], Xu, 1e-14)
    same(calls[0][0][3], ys[:150], 1e-14)
    same(np.asarray(calls[0][0][4])[:, 0], us[:150], 1e-14)
    same(out["one_step_rmse_controls"], e1, 1e-8)
    same(out["one_step_rmse_zeroed"], e0, 1e-8)


def write_co2(root: Path, n=110, seed=0):
    """A co2data.csv in the reference's format: a header, then
    ``;year;month;decimal-date;monthly-average;de-seasonalized;…`` rows,
    one with the −99.99 missing-value sentinel."""
    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True, exist_ok=True)
    lines = [";year;month;decimal date;average;deseasonalized;ndays;sdev;unc"]
    for k in range(n):
        year, month = 1958 + (k + 2) // 12, (k + 2) % 12 + 1
        dec = year + (month - 0.5) / 12
        avg = 315.0 + 0.12 * k + 3.0 * np.sin(2 * np.pi * dec) + 0.2 * rng.normal()
        if k == 17:
            avg = -99.99
        lines.append(f";{year};{month};{dec:.4f};{avg:.2f};{avg - 1:.2f};-1;-9.99;-0.99")
    (root / "data" / "co2data.csv").write_text("\n".join(lines) + "\n")


def write_btc(root: Path, n=100, seed=1):
    """A BTC-USD.csv in the reference's format: Date, Open, High, Low,
    Close, Adj Close, Volume."""
    rng = np.random.default_rng(seed)
    close = 20000.0 * np.exp(np.cumsum(0.02 * rng.normal(size=n)))
    lines = ["Date,Open,High,Low,Close,Adj Close,Volume"]
    for k in range(n):
        o = close[k - 1] if k else close[0]
        hi, lo = max(o, close[k]) * 1.01, min(o, close[k]) * 0.99
        lines.append(f"2022-10-{k:03d},{o:.6f},{hi:.6f},{lo:.6f},{close[k]:.6f},"
                     f"{close[k]:.6f},{int(1e10 + 1e9 * k)}")
    (root / "BTC-USD.csv").write_text("\n".join(lines) + "\n")


def test_loaders_parse_like_jax(tmp_path):
    write_co2(tmp_path)
    write_btc(tmp_path)
    for a, b in zip(tds.co2(str(tmp_path)), jds.co2(str(tmp_path))):
        assert np.array_equal(a, b)
    t, y = tds.co2(str(tmp_path))
    assert t.shape == (109,) and np.all(y > 0)
    for a, b in zip(tds.btc_usd(str(tmp_path)), jds.btc_usd(str(tmp_path))):
        assert np.array_equal(a, b)
    assert tds.btc_usd(str(tmp_path))[1].shape == (100, 5)


def test_real_data_workloads_refuse_without_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="co2data.csv"):
        trun.run_co2(verbose=False, device="cpu", root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="BTC-USD.csv"):
        trun.run_btc(verbose=False, device="cpu", root=str(tmp_path))


def test_co2(jrun, monkeypatch, tmp_path):
    write_co2(tmp_path)
    real = jds.co2
    monkeypatch.setattr(jds, "co2", lambda: real(str(tmp_path)))
    ref = jrun.run_co2(verbose=False, nlml_steps=8, write_json=False)
    out = trun.run_co2(verbose=False, device="cpu", nlml_steps=8, root=str(tmp_path))
    assert out["T"] == ref["T"] and out["held_out_months"] == ref["held_out_months"]
    same(out["obs_var_learned"], ref["obs_var_learned"], 1e-8)
    rounded(out["theta_learned"], ref["theta_learned"], 4)
    rounded(out["rmse_ppm_learned"], ref["rmse_ppm_learned"], 4)
    rounded(out["rmse_ppm_theta0"], ref["rmse_ppm_theta0"], 4)
    rounded(out["log_lik_learned"], ref["log_lik_learned"], 2)
    rounded(out["log_lik_theta0"], ref["log_lik_theta0"], 2)
    assert out["seq_vs_parallel_max_abs"] < 1e-8


def test_btc(jrun, monkeypatch, tmp_path):
    write_btc(tmp_path)
    real = jds.btc_usd
    monkeypatch.setattr(jds, "btc_usd", lambda: real(str(tmp_path)))
    kw = dict(epochs=2, n_train=60, m_inducing=6, n_test=20)
    ref = jrun.run_btc(verbose=False, write_json=False, **kw)
    out = trun.run_btc(verbose=False, device="cpu", root=str(tmp_path), **kw)
    assert out["n_test"] == ref["n_test"] == 20
    rounded(out["fe_first"], ref["fe_first"], 2)
    rounded(out["fe_last"], ref["fe_last"], 2)
    rounded(out["theta_softplus"], ref["theta_softplus"], 4)
    rounded(out["one_step_rmse_logprice_gp"], ref["one_step_rmse_logprice_gp"], 6)
    rounded(out["rmse_ratio_gp_over_rw"], ref["rmse_ratio_gp_over_rw"], 4)


def test_padscale_one(jrun, capsys):
    for k, a in enumerate(trun.padscale_data(200)):
        b = np.asarray(jrun._padscale_workload(200)[k])
        assert np.array_equal(a, b)
    row = {}
    for parallel in (False, True):
        res = trun.run_padscale_one(200, parallel, reps=1, device="cpu")
        jrun.run_padscale_one(200, parallel, reps=1)
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        same(res["mean_head"], ref["mean_head"], 1e-12)
        same(res["log_lik"], ref["log_lik"], 1e-12)
        row[res["mode"]] = res
    assert trun.crosscheck(row)["crosscheck"] == "ok"


def test_command_line(tmp_path):
    bench = sorted((p.name, p.stat().st_mtime_ns) for p in (ROOT / "benchmarks").iterdir())
    path = tmp_path / "out.json"
    assert trun.main(["tprocess", "padscale", "--sizes=64", "--reps=1", "--device=cpu",
                      f"--json={path}"]) == 0
    line = json.loads(path.read_text())
    assert set(line) == {"tprocess", "padscale", "device"}
    assert line["padscale"][0]["crosscheck"] == "ok"
    assert bench == sorted((p.name, p.stat().st_mtime_ns)
                           for p in (ROOT / "benchmarks").iterdir())
