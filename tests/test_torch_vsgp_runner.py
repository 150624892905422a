"""The port's VSGP / FITC baseline runners
(gaussianprocessnode_tpu_torch/experiments/vsgp_baselines.py) at tiny sizes
on the CPU: every runner runs, its JSON line holds the fields the card's
run reports, and the collapsed runner's chunks resume AdaMax (its −ELBO
falls from chunk to chunk and equals an unchunked run's).
"""

import json

import pytest
import torch

from gaussianprocessnode_tpu_torch.experiments import vsgp_baselines as vb
from gaussianprocessnode_tpu_torch.infer.svgp import collapsed_neg_elbo, fit_svgp_collapsed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_collapsed_runner_reports_snapshots_and_chunks_resume():
    out = vb.run_kin40k_collapsed(steps=6, eval_every=2, m_inducing=16, n_train=500,
                                  n_test=100, device="cpu")
    json.dumps(out)
    assert out["runner"] == "kin40k_collapsed" and out["steps"] == 6
    assert [h["step"] for h in out["history"]] == [2, 4, 6]
    for key in ("value", "train_wall_s", "step_host_ms", "final_smse", "gram_launches",
                "launches_per_step", "device", "theta_softplus", "target_smse"):
        assert key in out
    assert out["predict_dtype"] == "float64" and out["dtype"] == "float32"
    assert out["step_device_ms"] is None and out["idle_share"] is None  # no card
    assert out["gram_launches"] == 0  # CPU tensors take the plain Gram
    assert out["history"][-1]["neg_elbo"] < out["history"][0]["neg_elbo"]
    assert all(0.0 < h["smse"] < 2.0 for h in out["history"])
    # the chunked run is the unchunked run: AdaMax resumes across chunks
    ds, theta0, Xu, Xb, yb = vb._kin40k("synthetic", 1, 16, 500, 100, 500,
                                        torch.device("cpu"), torch.float32)
    X, y = Xb.reshape(-1, 8), yb.reshape(-1)
    theta, trace = fit_svgp_collapsed(vb.KERNEL, theta0, Xu, X, y, 0.01, steps=6, jitter=1e-5)
    assert torch.allclose(torch.tensor(out["theta_softplus"]),
                          torch.logaddexp(theta, torch.zeros(())), rtol=0, atol=0)
    assert out["history"][-1]["neg_elbo"] == float(trace[-1])
    assert float(collapsed_neg_elbo(vb.KERNEL, theta, Xu, X, y, 0.01, 1e-5)) < float(trace[0])


def test_minibatch_and_fitc_kin40k_runners():
    out = vb.run_kin40k(epochs=1, m_inducing=16, batch=2500, device="cpu")
    assert out["runner"] == "kin40k" and out["dtype"] == "float64" and 0 < out["smse"] < 5
    out = vb.run_fitc_sor_kin40k(steps=3, m_inducing=16, device="cpu")
    assert set(out) >= {"sor", "fitc"}
    for method in ("sor", "fitc"):
        assert set(out[method]) >= {"smse", "mll", "train_s", "theta_softplus", "noise"}


def test_banana_and_toy_runners():
    out = vb.run_banana(epochs=1, m_inducing=16, batch=2000, device="cpu")
    assert out["runner"] == "banana" and out["n_test"] == 1300
    assert 0 <= out["errors"] <= 1300 and out["error_rate"] == out["errors"] / 1300
    out = vb.run_toy_regression(epochs=30, device="cpu")
    assert out["runner"] == "toy_regression" and 0 < out["smse"] < 2
    out = vb.run_toy_classification(epochs=30, device="cpu")
    assert out["runner"] == "toy_classification" and out["n_test"] == 400
    out = vb.run_fitc_sor_toy(steps=30, device="cpu")
    assert out["fitc"]["mll"] > -1e6 and out["sor"]["smse"] > 0


def test_command_line_prints_one_json_line_per_runner(capsys):
    assert vb.main(["fitc_sor_toy", "toy_regression", "--device", "cpu", "--steps", "5",
                    "--epochs", "5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["runner"] for line in lines] == ["fitc_sor_toy", "toy_regression"]
    assert json.loads(lines[0])["steps"] == 5 and json.loads(lines[1])["epochs"] == 5
    with pytest.raises(SystemExit):
        vb.main(["no_such_runner", "--device", "cpu"])
