"""Legacy-notebook GP families, on the card.

Counterpart of ``experiments/legacy_gp.py``: every workload of the JAX
runner at its configuration and seeds, float64 throughout (the JAX package
turns on x64, and these families need it; the Matérn-5/2 and float64 SE
Grams take the plain route by dtype, so no workload launches the float32
SE Gram kernel):

- tprocess  dense GP against the Student-t process (ν = 100) on
            sinc-with-outliers (N = 20, 60 test points);
- sde       the Matérn-5/2 SDE GP on the notebook's draw (T = 100, 38
            observed), against the dense posterior, then 200 AdaMax steps
            on the NLML through the smoother;
- fullcov   the full-covariance GP with a Gaussian q(log ℓ) and a Gamma
            noise precision (N = 100, 50 sweeps);
- pad       GP-PAD, parallel EP (T = 400, 25 sweeps);
- pad2      colored-carrier GP-PAD (T = 500, 40 outer iterations);
- padlearn  the Bayesian lengthscale posterior of the PAD model (T = 300,
            6 sweeps of 21 EP chains), EP-EM of the white-carrier θ (30
            epochs), the 3-model bank, and variational EM of the colored
            lengthscales (T = 400, 12 epochs of 150 E-sweeps and 60 adjoint
            VJPs);
- control   the controlled GPSSM (150 training, 30 test steps);
- co2, btc  the reference's two real-data files (data/co2data.csv and
            BTC-USD.csv under ``--data-root``, by default the reference
            directory of ``utils/datasets.py``): Mauna-Loa SDE-GP regression
            with learned θ, and BTC-USD log-price GPSSM filtering. Both raise
            FileNotFoundError where the files are absent;
- padscale  (opt-in) the sequential against the parallel-in-time smoother at
            T = 2¹³, 2¹⁵, 2¹⁷ (``--sizes=`` overrides), each (T, mode) in a
            subprocess of its own (``padscale-one --T= --mode=``), timed by
            the host clock between ``torch.cuda.synchronize()`` calls,
            cross-checked as the JAX runner checks them.

    python -m gaussianprocessnode_tpu_torch.experiments.legacy_gp [WORKLOAD ...]
        [--device cuda] [--json=PATH] [--sizes=8192,32768] [--reps=10]
        [--data-root DIR]

Without a workload it runs tprocess, sde, fullcov, pad, pad2, padlearn and
control. It prints one JSON line, {workload: result, ..., "device": ...},
and ``--json=PATH`` also writes it to PATH. The JAX runner's ``--tpu``
mode has no counterpart, and nothing is written under ``benchmarks/``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..dists import MvGaussianNat, gamma_mean
from ..ops.kernels import Kernel
from ..utils.datasets import REFERENCE_ROOT
from ..utils.profiling import card_info, synchronize

__all__ = ["WORKLOADS", "DEFAULT", "tprocess_data", "sde_data", "fullcov_data", "pad_data",
           "pad2_data", "padlearn_data", "padlearn_colored_data", "control_data",
           "padscale_data", "run_tprocess", "run_sde", "run_fullcov", "run_pad", "run_pad2",
           "run_padlearn", "run_control", "run_co2", "run_btc", "run_padscale_one",
           "run_padscale", "main"]

_F64 = torch.float64
MATERN = Kernel("matern52", transform="identity")
PADSCALE_SIZES = (1 << 13, 1 << 15, 1 << 17)
PADSCALE_TIMEOUT_S = 1200  # per (T, mode) subprocess
_ROOT = Path(__file__).resolve().parents[2]


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=_F64, device=dev)


def _clock(dev):
    synchronize(dev)
    return time.perf_counter()


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The workloads' data (numpy, the JAX runner's draws)
# ---------------------------------------------------------------------------

def tprocess_data():
    """Sinc with two outliers (N = 20, ℓ = log 2): x, y, test inputs."""
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(-3.0, 3.0, size=20))
    y = np.sinc(x / np.pi) + rng.normal(size=20) * 0.1
    y[9:11] += 2.0
    return x, y, np.linspace(-3.1, 3.1, 60)


def sde_data():
    """2 sin t + cos 2t on 100 grid points, 38 of the first 75 observed,
    σ² = 0.2: t, y, mask, f_true, obs_var."""
    rng = np.random.default_rng(10)
    T = 100
    t = np.linspace(0.0, 5.0, T)
    f_true = 2.0 * np.sin(t) + np.cos(2.0 * t)
    mask = np.zeros(T, bool)
    mask[np.sort(rng.permutation(75)[:38])] = True
    obs_var = 0.2
    y = f_true + np.sqrt(obs_var) * rng.normal(size=T)
    return t, y, mask, f_true, obs_var


def fullcov_data():
    """The CVI/UT notebook's draw: N = 100 sinc at precision 100, 200 test
    inputs."""
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(-3.0, 3.0, size=100))
    y = np.sinc(x) + rng.normal(size=100) * 0.1
    return x, y, np.linspace(-3.1, 3.1, 200)


def pad_data():
    """T = 400 on [0, 4], carrier σ_c = 2π/30, slow log-envelope: t, y,
    f_true, σ_c."""
    rng = np.random.default_rng(1)
    T = 400
    t = np.linspace(0.0, 4.0, T)
    f_true = 0.8 * np.sin(2.0 * np.pi * t / 4.0)
    sigma_c = 2.0 * np.pi / 30.0
    y = sigma_c * rng.normal(size=T) * np.exp(f_true)
    return t, y, f_true, sigma_c


def _matern_draw(theta, t, seed_or_rng, jitter):
    K = MATERN(torch.as_tensor(theta, dtype=_F64), torch.as_tensor(t[:, None]),
               torch.as_tensor(t[:, None])).numpy() + jitter * np.eye(len(t))
    rng = (np.random.default_rng(seed_or_rng) if isinstance(seed_or_rng, int)
           else seed_or_rng)
    return np.linalg.cholesky(K) @ rng.normal(size=len(t))


def pad2_data():
    """Colored-carrier draw (T = 500): envelope ℓ = 0.8, carrier ℓ = 0.05;
    t, y, f_true, c_true, θ_f, θ_c."""
    rng = np.random.default_rng(5)
    T = 500
    t = np.linspace(0.0, 5.0, T)
    th_f, th_c = np.array([0.4, 0.8]), np.array([1.0, 0.05])
    f_true = _matern_draw(th_f, t, rng, 1e-9)
    c_true = _matern_draw(th_c, t, rng, 1e-9)
    return t, c_true * np.exp(f_true), f_true, c_true, th_f, th_c


def padlearn_data():
    """The learning workload (T = 300, ℓ_true = 0.9, σ_c² = 0.09): t, y,
    f_true."""
    rng = np.random.default_rng(13)
    T = 300
    t = np.linspace(0.0, 4.0, T)
    f_true = _matern_draw(np.array([1.0, 0.9]), t, 14, 1e-10)
    y = 0.3 * rng.normal(size=T) * np.exp(f_true)
    return t, y, f_true


def padlearn_colored_data():
    """The colored variational-EM draw (T = 400, truth ℓ = [0.8, 0.05],
    σ_y² = 1e-3): t, y."""
    rng2 = np.random.default_rng(9)
    T2 = 400
    t2 = np.linspace(0.0, 5.0, T2)
    f2 = _matern_draw(np.array([0.4, 0.8]), t2, 21, 1e-10)
    c2 = _matern_draw(np.array([1.0, 0.05]), t2, 22, 1e-10)
    return t2, c2 * np.exp(f2) + np.sqrt(1e-3) * rng2.normal(size=T2)


def control_data():
    """The controlled pendulum (θ̈ = −4 sin θ − 0.3 θ̇ + u, u = 2 sin 0.25t):
    states X (181, 2), observations (180, 2), controls (180,), Xu (30, 3)."""
    rng = np.random.default_rng(3)
    T = 180
    us = 2.0 * np.sin(0.25 * np.arange(T))
    xs = [np.array([0.5, 0.0])]
    for k in range(T):
        th, om = xs[-1]
        xs.append(np.array([th + 0.1 * om, om + 0.1 * (-4 * np.sin(th) - 0.3 * om + us[k])]))
    X = np.stack(xs)
    ys = X[1:] + 0.05 * rng.normal(size=(T, 2))
    rng2 = np.random.default_rng(7)
    train_inputs = np.concatenate([X[:150], us[:150, None]], axis=1)
    idx = np.linspace(0, 149, 30).astype(int)
    Xu = train_inputs[idx] + 0.05 * rng2.normal(size=(30, 3))
    return X, ys, us, Xu


def padscale_data(T):
    """PAD-shaped smoother inputs: heteroscedastic pseudo-observations, a
    third of the sites inactive: t, z, mask, r."""
    rng = np.random.default_rng(11)
    t = np.linspace(0.0, 60.0, T)
    z = rng.normal(size=T) * 0.5
    r = rng.uniform(0.05, 2.0, size=T)
    mask = rng.uniform(size=T) < (2.0 / 3.0)
    return t, z, mask, r


# ---------------------------------------------------------------------------
# The workloads
# ---------------------------------------------------------------------------

def run_tprocess(verbose: bool = True, device="cuda") -> dict:
    """GP against TP(ν = 100) on sinc-with-outliers."""
    from ..infer.tprocess import gp_exact_posterior, tp_exact_posterior

    dev = torch.device(device)
    x, y, xt = tprocess_data()
    theta = _t([1.0, np.log(2.0)], dev)
    X, Y, Xt = _t(x[:, None], dev), _t(y, dev), _t(xt[:, None], dev)
    t0 = _clock(dev)
    gp = gp_exact_posterior(MATERN, theta, X, Y, Xt, 0.01)
    tp = tp_exact_posterior(MATERN, theta, 100.0, X, Y, Xt, 0.01)
    ratio = float(torch.mean(tp.var / torch.clamp_min(gp.var, 1e-12)))
    out = {"gp_mean_equals_tp_mean": bool(np.allclose(_np(gp.mean), _np(tp.mean))),
           "fit_scale": float(tp.fit_scale), "var_ratio_tp_over_gp": ratio,
           "gp_log_lik": float(gp.log_lik), "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[t-process toy] GP mean==TP mean: {out['gp_mean_equals_tp_mean']}; TP "
              f"fit_scale {out['fit_scale']:.3f} (>1: outliers widen the ribbon), mean var "
              f"ratio TP/GP {ratio:.3f}, wall {out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_sde(verbose: bool = True, device="cuda", steps: int = 200) -> dict:
    """The SDE notebook's workload smoothed in O(T), held to the dense
    Matérn-5/2 posterior, then θ learned by ``steps`` AdaMax(0.05) steps on
    the NLML through the smoother."""
    from ..infer.sde_gp import sde_gp_nlml, sde_gp_smooth
    from ..utils.optim import adamax

    dev = torch.device(device)
    t, y, mask, f_true, obs_var = sde_data()
    T = len(t)
    tj, yj, mj = _t(t, dev), _t(y, dev), torch.as_tensor(mask, device=dev)
    theta = _t([1.0, 1.0], dev)
    t0 = _clock(dev)
    res = sde_gp_smooth(theta, tj, yj, mj, obs_var)
    # observations cover the first 75 grid points: report the interpolation
    interp = np.arange(T) < 75
    rmse0 = _rmse(_np(res.mean)[interp], f_true[interp])
    to = t[mask][:, None]
    kern = lambda a, b: MATERN(theta.cpu(), torch.as_tensor(a), torch.as_tensor(b)).numpy()  # noqa: E731
    Koo = kern(to, to) + obs_var * np.eye(mask.sum())
    dense_mean = kern(t[:, None], to) @ np.linalg.solve(Koo, y[mask])
    agree = float(np.max(np.abs(dense_mean - _np(res.mean))))

    opt = adamax(0.05)
    th = theta.clone()
    state = opt.init(th)
    for _ in range(steps):
        p = th.detach().requires_grad_()
        (g,) = torch.autograd.grad(sde_gp_nlml(p, tj, yj, mj, obs_var), p)
        th = th + opt.update_(g, state)
    res_opt = sde_gp_smooth(th, tj, yj, mj, obs_var)
    rmse1 = _rmse(_np(res_opt.mean)[interp], f_true[interp])
    out = {"smoother_vs_dense_max_abs": agree, "rmse_interp_theta0": rmse0,
           "rmse_interp_learned": rmse1, "theta_learned": _np(th).tolist(),
           "log_lik_theta0": float(res.log_lik), "log_lik_learned": float(res_opt.log_lik),
           "nlml_steps": steps, "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[SDE-GP Matérn-5/2] smoother==dense to {agree:.2e}; interp RMSE vs truth "
              f"{rmse0:.4f} @θ=[1,1] → {rmse1:.4f} after {steps} NLML steps "
              f"(θ={out['theta_learned']}), log_lik {out['log_lik_theta0']:.2f} → "
              f"{out['log_lik_learned']:.2f}, wall {out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_fullcov(verbose: bool = True, device="cuda", iters: int = 50) -> dict:
    """The CVI/UT notebook's configuration: θ ~ N(log 4, 2), γ ~ Γ(0.01,
    0.01), ``iters`` VMP sweeps, the test RMSE against sinc."""
    from ..infer.fullcov_gp import fullcov_gp_predict, fullcov_gp_vmp

    dev = torch.device(device)
    x, y, xt = fullcov_data()
    X, Y, Xt = _t(x[:, None], dev), _t(y, dev), _t(xt[:, None], dev)
    t0 = _clock(dev)
    state = fullcov_gp_vmp(MATERN, X, Y, m_th0=float(np.log(4.0)), v_th0=2.0, iters=iters)
    mean, _ = fullcov_gp_predict(MATERN, state, X, Xt)
    rmse = _rmse(_np(mean), np.sinc(xt))
    ell = float(torch.exp(state.m_th))
    out = {"ell_mean": ell, "ell_sd": ell * float(torch.sqrt(state.v_th)),
           "m_th": float(state.m_th), "v_th": float(state.v_th),
           "gamma_mean": float(gamma_mean(state.gamma)), "fe_first": float(state.fe[0]),
           "fe_last": float(state.fe[-1]), "test_rmse": rmse, "sweeps": iters,
           "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[full-cov Bayes-θ GP] q(θ): ℓ = {ell:.3f} ± {out['ell_sd']:.3f} (init 4.0), "
              f"q(γ) mean = {out['gamma_mean']:.1f} (generating precision 100), FE "
              f"{out['fe_first']:.1f} → {out['fe_last']:.1f}, test RMSE {rmse:.4f}, wall "
              f"{out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_pad(verbose: bool = True, device="cuda", iters: int = 25) -> dict:
    """The PAD notebook's synthetic workload, ``iters`` EP sweeps."""
    from ..infer.gppad import gppad_infer

    dev = torch.device(device)
    t, y, f_true, sigma_c = pad_data()
    t0 = _clock(dev)
    state = gppad_infer(_t([1.0, 0.9], dev), _t(t, dev), _t(y, dev),
                        carrier_var=sigma_c**2, iters=iters)
    m = _np(state.mean)
    env_naive = np.abs(y) / (sigma_c * np.sqrt(2.0 / np.pi))
    out = {"corr_log_envelope": float(np.corrcoef(m, f_true)[0, 1]),
           "envelope_rmse": _rmse(_np(state.envelope), np.exp(f_true)),
           "envelope_rmse_naive": _rmse(env_naive, np.exp(f_true)),
           "site_delta_first": float(state.site_delta[0]),
           "site_delta_last": float(state.site_delta[-1]), "sweeps": iters,
           "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[GP-PAD] corr(log-envelope, truth) = {out['corr_log_envelope']:.3f}; envelope "
              f"RMSE {out['envelope_rmse']:.4f} vs naive |y|-rescale "
              f"{out['envelope_rmse_naive']:.4f}; site movement {out['site_delta_first']:.2f}"
              f" → {out['site_delta_last']:.2e} over {iters} EP sweeps, wall "
              f"{out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_pad2(verbose: bool = True, device="cuda", iters: int = 40) -> dict:
    """Colored-carrier PAD on its notebook's draw, ``iters`` outer
    iterations."""
    from ..infer.gppad import gppad_colored_infer

    dev = torch.device(device)
    t, y, f_true, c_true, th_f, th_c = pad2_data()
    t0 = _clock(dev)
    state = gppad_colored_infer(_t(th_f, dev), _t(th_c, dev), _t(t, dev), _t(y, dev),
                                obs_var=1e-3, iters=iters)
    recon = _np(state.c_mean) * _np(state.envelope)
    out = {"corr_f": float(np.corrcoef(_np(state.f_mean), f_true)[0, 1]),
           "corr_c": float(np.corrcoef(_np(state.c_mean), c_true)[0, 1]),
           "recon_rel_rmse": float(np.sqrt(np.mean((recon - y) ** 2)) / np.sqrt(np.mean(y**2))),
           "iters": iters, "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[GP-PAD colored carrier] corr(f) = {out['corr_f']:.3f}, corr(c) = "
              f"{out['corr_c']:.3f}, reconstruction rel RMSE {out['recon_rel_rmse']:.4f}, "
              f"wall {out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_padlearn(verbose: bool = True, device="cuda", bayes_iters: int = 6,
                 bayes_ep_iters: int = 15, em_epochs: int = 30, em_ep_iters: int = 10,
                 mix_iters: int = 25, colored_epochs: int = 12, colored_ep_iters: int = 150,
                 adjoint_iters: int = 60) -> dict:
    """The three learning notebooks: Bayesian q(log ℓ) on the PAD model,
    EP-EM of the white-carrier θ, the 3-model bank, and variational EM of
    the colored lengthscales. The defaults are the JAX runner's."""
    from ..infer.pad_learn import (fit_gppad_colored_theta, fit_gppad_theta,
                                   gppad_bayes_lengthscale, gppad_mixture)

    dev = torch.device(device)
    t, y, _ = padlearn_data()
    tj, yj = _t(t, dev), _t(y, dev)
    t0 = _clock(dev)
    bay = gppad_bayes_lengthscale(tj, yj, carrier_var=0.09, iters=bayes_iters,
                                  ep_iters=bayes_ep_iters)
    t1 = _clock(dev)
    em = fit_gppad_theta(tj, yj, theta0=_t([0.5, 0.35], dev), carrier_var=0.09,
                         epochs=em_epochs, ep_iters=em_ep_iters)
    t2 = _clock(dev)
    mix = gppad_mixture(_t([[1.0, 0.9], [1.0, 0.15], [1.0, 4.0]], dev), tj, yj,
                        carrier_vars=_t([0.09] * 3, dev), iters=mix_iters)
    t3 = _clock(dev)
    t2_np, y2_np = padlearn_colored_data()
    cem = fit_gppad_colored_theta(_t(t2_np, dev), _t(y2_np, dev), ell0=_t([0.3, 0.1], dev),
                                  var_f=0.4, var_c=1.0, epochs=colored_epochs,
                                  ep_iters=colored_ep_iters, adjoint_iters=adjoint_iters)
    t4 = _clock(dev)
    resp = _np(mix.resp)
    out = {
        "bayes_m_s": float(bay.m_s), "bayes_v_s": float(bay.v_s),
        "log_ell_true": float(np.log(0.9)), "bayes_seconds": t1 - t0,
        "em_theta": _np(em.theta).tolist(), "em_evidence_first": float(em.evidence[0]),
        "em_evidence_last": float(em.evidence[-1]), "em_seconds": t2 - t1,
        "mix_resp": resp.tolist(), "mix_log_evidence": _np(mix.log_evidence).tolist(),
        "mix_elbo": _np(mix.elbo).tolist(),
        "mix_rankings_agree": int(np.argmax(resp)) == int(np.argmax(_np(mix.elbo))),
        "mix_seconds": t3 - t2,
        "colored_theta": _np(cem.theta).tolist(), "colored_elbo_first": float(cem.evidence[0]),
        "colored_elbo_last": float(cem.evidence[-1]), "colored_seconds": t4 - t3,
        "colored_seconds_per_epoch": (t4 - t3) / max(colored_epochs, 1),
        "config": {"bayes_iters": bayes_iters, "bayes_ep_iters": bayes_ep_iters,
                   "em_epochs": em_epochs, "em_ep_iters": em_ep_iters, "mix_iters": mix_iters,
                   "colored_epochs": colored_epochs, "colored_ep_iters": colored_ep_iters,
                   "adjoint_iters": adjoint_iters},
        "seconds": t4 - t0,
    }
    if verbose:
        print(f"[PAD learning] Bayesian q(log ℓ) = N({out['bayes_m_s']:.3f}, "
              f"{out['bayes_v_s']:.3f}) vs log ℓ_true = {np.log(0.9):.3f}, wall "
              f"{out['bayes_seconds']:.1f}s", file=sys.stderr)
        print(f"[PAD learning] EP-EM θ: [σ², ℓ] = {out['em_theta']} from [0.5, 0.35] (truth ℓ "
              f"0.9); evidence {out['em_evidence_first']:.1f} → {out['em_evidence_last']:.1f},"
              f" wall {out['em_seconds']:.1f}s", file=sys.stderr)
        print(f"[PAD learning] colored EM ℓ = {out['colored_theta']} from [0.3, 0.1] (truth "
              f"[0.8, 0.05]); ELBO {out['colored_elbo_first']:.1f} → "
              f"{out['colored_elbo_last']:.1f}, wall {out['colored_seconds']:.1f}s",
              file=sys.stderr)
        print(f"[PAD learning] 3-model bank responsibilities {resp.round(4)} (EP-evidence and "
              f"ELBO rankings {'agree' if out['mix_rankings_agree'] else 'DISAGREE'}), wall "
              f"{out['mix_seconds']:.1f}s", file=sys.stderr)
    return out


def run_control(verbose: bool = True, device="cuda", n_iters: int = 10) -> dict:
    """The controlled GPSSM: trained on 150 steps (``n_iters`` sweeps),
    then filtered over 30 test steps with the true and with zeroed
    controls."""
    from ..infer.gpssm_control import gpssm_control_vmp, one_step_ahead_control

    dev = torch.device(device)
    X, ys, us, Xu_np = control_data()
    kernel = Kernel("se", transform="identity")
    T_train, T_test = 150, 30
    D, M = 2, 30
    theta, Xu = _t([2.0, 1.5], dev), _t(Xu_np, dev)
    eye = torch.eye(D, dtype=_F64, device=dev)
    t0 = _clock(dev)
    state, fe = gpssm_control_vmp(
        kernel, theta, Xu, _t(ys[:T_train], dev), _t(us[:T_train, None], dev), eye * 2.5e-3,
        prior_x0_mean=_t(X[0], dev), prior_x0_cov=eye * 0.1,
        prior_v=MvGaussianNat(torch.zeros(M * D, dtype=_F64, device=dev),
                              torch.eye(M * D, dtype=_F64, device=dev) / 50.0),
        prior_W_df=100.0, prior_W_scale=eye, n_iters=n_iters)
    sm = _rmse(_np(state.x_means[1:]), X[1:T_train + 1])
    args = (kernel, theta, Xu, state, _t(ys[T_train:], dev))
    pred, _ = one_step_ahead_control(*args, _t(us[T_train:, None], dev), eye * 2.5e-3)
    pred0, _ = one_step_ahead_control(*args, torch.zeros((T_test, 1), dtype=_F64, device=dev),
                                      eye * 2.5e-3)
    truth = X[T_train + 1:]
    e1, e0 = _rmse(_np(pred), truth), _rmse(_np(pred0), truth)
    out = {"smoothing_rmse": sm, "fe": float(fe), "one_step_rmse_controls": e1,
           "one_step_rmse_zeroed": e0, "ratio": e1 / e0, "sweeps": n_iters,
           "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[controlled GPSSM] smoothing RMSE {sm:.4f} (obs noise 0.05), FE "
              f"{out['fe']:.1f}; 1-step-ahead RMSE {e1:.4f} with true controls vs {e0:.4f} "
              f"zeroed ({e1 / e0:.2f}×), wall {out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_co2(verbose: bool = True, device="cuda", holdout_frac: float = 0.15,
            nlml_steps: int = 300, root: str = REFERENCE_ROOT) -> dict:
    """Mauna-Loa CO₂ (``root``/data/co2data.csv): the monthly series
    smoothed by the Matérn-5/2 SDE GP, θ and the log noise variance learned
    by ``nlml_steps`` AdaMax(0.05) steps, 15 % of the months held out;
    the held-out RMSE before and after, and sequential against parallel."""
    from ..infer.sde_gp import sde_gp_nlml, sde_gp_smooth
    from ..utils.datasets import co2
    from ..utils.optim import adamax

    dev = torch.device(device)
    t_raw, y_raw = co2(root)
    mu, sd = float(y_raw.mean()), float(y_raw.std())
    t, y = _t(t_raw - t_raw[0], dev), _t((y_raw - mu) / sd, dev)
    T = t.shape[0]
    rng = np.random.default_rng(5)
    held = np.zeros(T, bool)
    held[rng.permutation(T)[: int(holdout_frac * T)]] = True
    mask = torch.as_tensor(~held, device=dev)
    obs_var0 = 1e-3
    theta0 = _t([1.0, 1.0], dev)
    t0 = _clock(dev)
    res0 = sde_gp_smooth(theta0, t, y, mask, obs_var0)
    opt = adamax(0.05)
    p = torch.cat([theta0, torch.log(_t([obs_var0], dev))])
    state = opt.init(p)
    for _ in range(nlml_steps):
        q = p.detach().requires_grad_()
        (g,) = torch.autograd.grad(sde_gp_nlml(q[:2], t, y, mask, torch.exp(q[2])), q)
        p = p + opt.update_(g, state)
    th, obs_var = p[:2], torch.exp(p[2])
    res1 = sde_gp_smooth(th, t, y, mask, obs_var)
    res1p = sde_gp_smooth(th, t, y, mask, obs_var, parallel=True)
    agree = float(torch.max(torch.abs(res1.mean - res1p.mean)))

    def rmse_ppm(r):
        d = (_np(r.mean) - _np(y))[held] * sd
        return float(np.sqrt(np.mean(d**2)))

    out = {"T": int(T), "held_out_months": int(held.sum()),
           "rmse_ppm_theta0": rmse_ppm(res0), "rmse_ppm_learned": rmse_ppm(res1),
           "theta_learned": _np(th).tolist(), "obs_var_learned": float(obs_var),
           "log_lik_theta0": float(res0.log_lik), "log_lik_learned": float(res1.log_lik),
           "seq_vs_parallel_max_abs": agree, "nlml_steps": nlml_steps,
           "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[co2] held-out RMSE {out['rmse_ppm_theta0']:.3f} → "
              f"{out['rmse_ppm_learned']:.3f} ppm after {nlml_steps} NLML steps "
              f"(θ={out['theta_learned']}, ℓ in years); seq≡parallel to {agree:.2e}; wall "
              f"{out['seconds']:.1f}s", file=sys.stderr)
    return out


def run_btc(verbose: bool = True, device="cuda", epochs: int = 40, n_train: int = 300,
            m_inducing: int = 16, n_test: int | None = None,
            root: str = REFERENCE_ROOT) -> dict:
    """BTC-USD (``root``/BTC-USD.csv): standardised log closes as a D = 1
    GPSSM with Wishart process noise, ``epochs`` epochs of 8 warm-started
    Jacobi sweeps and 25 L-BFGS steps on the backward-message objective,
    then 1-step-ahead filtering of the held-out tail against a random
    walk."""
    from ..infer.chain_smoother import gpssm_vmp, one_step_ahead
    from ..infer.training import lbfgs_solve
    from ..objectives import neg_log_backwardmess_multi
    from ..ops.kernels import invsoftplus, softplus
    from ..ops.linalg import chol_lower, chol_solve, cholinv, sum_blocks_weighted, sym
    from ..ops.quadrature import SphericalRadial
    from ..utils.datasets import btc_usd

    dev = torch.device(device)
    _, ohlcv = btc_usd(root)
    logp = np.log(ohlcv[:, 3])
    mu, sd = logp[:n_train].mean(), logp[:n_train].std()
    z = (logp - mu) / sd
    y_train = _t(z[:n_train, None], dev)
    stop = None if n_test is None else n_train + n_test
    y_test = _t(z[n_train:stop, None], dev)
    D, M = 1, m_inducing
    kernel = Kernel("se", transform="softplus")
    theta = invsoftplus(_t([1.0, 1.0], dev))
    lo, hi = float(z[:n_train].min()), float(z[:n_train].max())
    Xu = torch.linspace(lo - 0.3, hi + 0.3, M, dtype=_F64, device=dev)[:, None]
    prior_v = MvGaussianNat(torch.zeros(M * D, dtype=_F64, device=dev),
                            torch.eye(M * D, dtype=_F64, device=dev) / 50.0)
    eye1 = torch.eye(1, dtype=_F64, device=dev)
    P = 1e-3 * eye1
    sr = SphericalRadial()

    t0 = _clock(dev)
    state, fes = None, []
    for _ in range(epochs):
        state, fe = gpssm_vmp(kernel, theta, Xu, y_train, P, _t([float(z[0])], dev),
                              0.1 * eye1, prior_v, 100.0, eye1, n_iters=8, init_state=state)
        L = chol_lower(sym(state.prec_v))
        cov_v = sym(chol_solve(L, torch.eye(M * D, dtype=_F64, device=dev)))
        mu_v = chol_solve(L, state.xi_v)
        Rv = cov_v + torch.outer(mu_v, mu_v)
        W_bar = state.W_df * cholinv(sym(state.W_rate))
        sumRv_W = sum_blocks_weighted(Rv, W_bar, D, M)

        def objective(th, st=state, sumRv_W=sumRv_W, mu_v=mu_v, W_bar=W_bar):
            return neg_log_backwardmess_multi(
                th, kernel=kernel, Xu=Xu, y_means=st.x_means[1:], qx_means=st.x_means[:-1],
                qx_covs=st.x_covs[:-1], sumRv_W=sumRv_W, mu_v=mu_v, W=W_bar, method=sr)

        theta, _ = lbfgs_solve(objective, theta, max_steps=25)
        fes.append(float(fe))
    pred_means, _ = one_step_ahead(kernel, theta, Xu, state, y_test, P)
    pred = _np(pred_means)[:, 0]
    truth = _np(y_test)[:, 0]
    rmse_gp = float(np.sqrt(np.mean((pred - truth) ** 2))) * sd
    rw = np.concatenate([[z[n_train - 1]], truth[:-1]])
    rmse_rw = float(np.sqrt(np.mean((rw - truth) ** 2))) * sd
    out = {"n_train": n_train, "n_test": int(truth.shape[0]), "epochs": epochs,
           "theta_softplus": _np(softplus(theta)).tolist(), "fe_first": fes[0],
           "fe_last": fes[-1], "one_step_rmse_logprice_gp": rmse_gp,
           "one_step_rmse_logprice_rw": rmse_rw, "rmse_ratio_gp_over_rw": rmse_gp / rmse_rw,
           "seconds": _clock(dev) - t0}
    if verbose:
        print(f"[btc] 1-step-ahead RMSE(log price): GP {rmse_gp:.5f} vs random-walk "
              f"{rmse_rw:.5f} (ratio {out['rmse_ratio_gp_over_rw']:.4f}); FE {fes[0]:.1f} → "
              f"{fes[-1]:.1f} over {epochs} epochs; wall {out['seconds']:.1f}s",
              file=sys.stderr)
    return out


def run_padscale_one(T: int, parallel: bool, reps: int = 10, device="cuda") -> dict:
    """One (T, mode) measurement: the first call's seconds, then the mean of
    ``reps`` calls in ms (host clock between synchronisations), the head of
    the posterior mean and the log-likelihood for the cross-check."""
    from ..infer.sde_gp import sde_gp_smooth

    dev = torch.device(device)
    t, z, mask, r = (torch.as_tensor(a, device=dev) for a in padscale_data(T))
    theta = _t([1.0, 0.9], dev)

    def fn():
        return sde_gp_smooth(theta, t, z, mask, r, parallel=parallel)

    c0 = _clock(dev)
    out = fn()
    first_s = _clock(dev) - c0
    c1 = _clock(dev)
    for _ in range(reps):
        fn()
    ms = (_clock(dev) - c1) / reps * 1e3
    return {"T": T, "mode": "parallel" if parallel else "sequential", "warm_ms": ms,
            "first_call_s": first_s, "reps": reps, "device": str(dev),
            "mean_head": _np(out.mean[:3]).tolist(), "log_lik": float(out.log_lik)}


def crosscheck(row) -> dict:
    """The JAX runner's cross-check of the two modes at one T: max
    |Δmean_head| < 1e-6 and |Δlog_lik| < 1e-5·max(1, |log_lik|)."""
    seq, par = row["sequential"], row["parallel"]
    dm = max(abs(a - b) for a, b in zip(seq["mean_head"], par["mean_head"]))
    dl = abs(seq["log_lik"] - par["log_lik"])
    ok = dm < 1e-6 and dl < 1e-5 * max(1.0, abs(seq["log_lik"]))
    return {"speedup": seq["warm_ms"] / par["warm_ms"], "crosscheck": "ok" if ok else "FAILED",
            "crosscheck_dmean": dm, "crosscheck_dll": dl}


def run_padscale(verbose: bool = True, device="cuda", sizes=PADSCALE_SIZES,
                 reps: int = 10) -> list:
    """Sequential against parallel-in-time smoothing at audio-scale T, each
    (T, mode) in a subprocess of its own (a failure or a timeout is
    recorded in its row, not raised); where both modes ran, their posterior
    means and log-likelihoods are cross-checked and the mismatch recorded."""
    rows = []
    for T in sizes:
        row = {"T": T}
        for mode in ("sequential", "parallel"):
            cmd = [sys.executable, "-m", __spec__.name, "padscale-one", f"--T={T}",
                   f"--mode={mode}", f"--reps={reps}", f"--device={device}"]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=PADSCALE_TIMEOUT_S, cwd=_ROOT)
                lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
                if p.returncode == 0 and lines:
                    row[mode] = json.loads(lines[-1])
                else:
                    err = (p.stderr.strip().splitlines() or ["?"])[-1]
                    row[mode] = {"T": T, "mode": mode, "error": err[:300]}
            except subprocess.TimeoutExpired:
                row[mode] = {"T": T, "mode": mode, "error": f"timeout {PADSCALE_TIMEOUT_S}s"}
            if verbose:
                r = row[mode]
                msg = (f"{r['warm_ms']:.2f} ms warm (first call {r['first_call_s']:.2f} s)"
                       if "warm_ms" in r else f"FAILED: {r['error'][:120]}")
                print(f"[pad-scale T={T} {mode}] {msg}", file=sys.stderr, flush=True)
        if all("warm_ms" in row[m] for m in ("sequential", "parallel")):
            row.update(crosscheck(row))
            if verbose:
                print(f"[pad-scale T={T}] speedup {row['speedup']:.1f}×, cross-check "
                      f"{row['crosscheck']} max|Δmean_head| {row['crosscheck_dmean']:.2e}",
                      file=sys.stderr, flush=True)
        rows.append(row)
    return rows


WORKLOADS = {"tprocess": run_tprocess, "sde": run_sde, "fullcov": run_fullcov,
             "pad": run_pad, "pad2": run_pad2, "padlearn": run_padlearn,
             "control": run_control, "co2": run_co2, "btc": run_btc,
             "padscale": run_padscale}
DEFAULT = ("tprocess", "sde", "fullcov", "pad", "pad2", "padlearn", "control")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workloads", nargs="*",
                    help=f"any of {', '.join(WORKLOADS)} (default: {' '.join(DEFAULT)}), "
                         "or padscale-one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", metavar="PATH", help="also write the result line to PATH")
    ap.add_argument("--sizes", help="padscale's T values, comma-separated")
    ap.add_argument("--reps", type=int, default=10, help="padscale's timed calls per (T, mode)")
    ap.add_argument("--T", type=int, help="padscale-one: the chain length")
    ap.add_argument("--mode", choices=("sequential", "parallel"), help="padscale-one: the form")
    ap.add_argument("--data-root", default=REFERENCE_ROOT,
                    help="the directory holding data/co2data.csv and BTC-USD.csv")
    args = ap.parse_args(argv)
    if args.workloads == ["padscale-one"]:
        print(json.dumps(run_padscale_one(args.T, args.mode == "parallel", args.reps,
                                          args.device)), flush=True)
        return 0
    which = args.workloads or list(DEFAULT)
    unknown = [w for w in which if w not in WORKLOADS]
    if unknown:
        ap.error(f"unknown workload(s) {unknown}")
    result = {}
    for w in which:
        if w == "padscale":
            sizes = (tuple(int(s) for s in args.sizes.split(",")) if args.sizes
                     else PADSCALE_SIZES)
            result[w] = run_padscale(device=args.device, sizes=sizes, reps=args.reps)
        elif w in ("co2", "btc"):
            result[w] = WORKLOADS[w](device=args.device, root=args.data_root)
        else:
            result[w] = WORKLOADS[w](device=args.device)
    result["device"] = (card_info() if torch.device(args.device).type == "cuda"
                        else {"name": args.device})
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
