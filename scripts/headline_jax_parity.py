#!/usr/bin/env python3
"""Hold the port's headline trainers to the JAX package at full width and depth.

The three trainers, each on exactly the arrays that the port's runner
builds (its ``setup`` on its synthetic data, turned into numpy):

- ``kin40k_f32`` / ``kin40k_f64``: ``fit_kin40k_fast`` (M = 600, N = 10,000
  in 20 batches of 500, w = 1e4, θ0 = softplus⁻¹(1), prior N(0, 50·I), lr
  1e-3, 500 epochs in chunks of 100), then ``ir_solve`` and
  ``predict_out`` on 30,000 test rows (``experiments/kin40k.py``'s
  ``recover_and_predict``); figure: the SMSE;
- ``banana``: ``fit_banana_fast`` from ``init_banana_state`` (M = 500, 20
  batches of 200, 500 epochs in chunks of 100), then ``predict_probit`` on
  1,300 test rows at the 0.5 threshold; figure: the test errors;
- ``collapsed``: ``fit_svgp_collapsed_resumable`` (400 AdaMax steps at lr
  0.05 in chunks of 25, noise 0.01, jitter 1e-5, θ in float32), each
  chunk's θ scored by ``collapsed_predict`` in float64; figure: the last
  SMSE.

It calls the JAX package's library functions on the CPU, never
``experiments/*.py`` (they read the reference's files and set a compilation
cache inside the repository).

Bounds. Each figure is held to JAX's by rounding twins: the same JAX run
with the training targets moved by k ulps of the training dtype, for each k
in ``TWIN_ULPS`` (±1, ±2, ±3; banana's targets are labels, so its training
inputs are moved instead). The twins' largest distance from the JAX run
(``spread``) is how far the JAX package's own figure moves under a rounding
of the data's last bits; the port rounds differently in every reduction,
not in one input only, so its distance from JAX is held to
``TWIN_MULTIPLE`` times the spread (``experiments/headline.py::hold``
applies the bounds). ``figures`` refuses a trainer whose runs lack a twin
of the set. Banana's errors are held to the count of test points whose JAX
probability lies within that multiple of the twins' largest probability
change of ½: only those can change sides. The figures are recorded at the
runners' full depth and at ``SMOKE_DEPTH``, the depth of ``chip_smoke.py``
phase 17, which is the first chunk of the full run. Only the
``SMOKE_DEPTH`` bounds gate: at full depth the trajectories spread the
twins' rounding so far (31 % on the kin40k SMSE) that the bounds show
agreement and could not catch a wrong port.

Run from the root of the repository, on the CPU:

    # one JAX run (twin 0 = as is, k = k ulps up or down); 4-90 min each at full width
    python3 scripts/headline_jax_parity.py run kin40k_f32 --twin 0 --out k32.json
    # the figures and bounds from twin 0 and every twin of TWIN_ULPS, into
    # scripts/headline_jax_figures.json
    python3 scripts/headline_jax_parity.py figures k32.json k32_p1.json k32_m1.json ... --write
    # kin40k θ every 10 epochs: JAX, its twin and the port on the CPU (M = 300)
    python3 scripts/headline_jax_parity.py trajectory float64 --m-inducing 300 --epochs 100
    # both packages' collapsed bound and gradient in float32 against float64
    python3 scripts/headline_jax_parity.py collapsed-rounding
    # the port's runner lines (on the card), side by side with the committed figures
    python3 scripts/headline_jax_parity.py compare --kin40k-f32 A.json --kin40k-f64 B.json \\
        --banana C.json --collapsed D.json

A port line is the JSON line that the runner printed:
``python -m gaussianprocessnode_tpu_torch.experiments.kin40k --epochs 500
[--f64]``, ``... .banana --epochs 500 --json=PATH`` and ``...
.vsgp_baselines kin40k_collapsed``. ``compare`` prints, per trainer, the
two packages' figures, θ (softplus) and their differences against the
bounds, and for kin40k each package's f32/f64 SMSE ratio; its last line is
one JSON object, and it exits 1 when a figure lies outside its bound.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gaussianprocessnode_tpu.dists import GammaShapeRate, MvGaussianNat, gamma_mean  # noqa: E402
from gaussianprocessnode_tpu.infer import minibatch as jmb  # noqa: E402
from gaussianprocessnode_tpu.infer import svgp as jsvgp  # noqa: E402
from gaussianprocessnode_tpu.infer.batch_vmp import predict_out, predict_probit  # noqa: E402
from gaussianprocessnode_tpu.ops.kernels import Kernel, softplus  # noqa: E402
from gaussianprocessnode_tpu.ops.linalg import ir_solve, spd_inverse_ns, sym  # noqa: E402
from gaussianprocessnode_tpu.utils.metrics import num_error, smse  # noqa: E402
from gaussianprocessnode_tpu_torch.experiments import banana as port_banana  # noqa: E402
from gaussianprocessnode_tpu_torch.experiments import headline  # noqa: E402
from gaussianprocessnode_tpu_torch.experiments import kin40k as port_kin40k  # noqa: E402
from gaussianprocessnode_tpu_torch.experiments import vsgp_baselines as port_vsgp  # noqa: E402

FIGURES, TRAINERS = headline.FIGURES, headline.TRAINERS
SEED = 1  # the runners' default, which phase 17 runs
# per trainer, which key of the runner's result line holds its figure and
# its depth, and whether the figure's bound is relative or absolute
FIGURE = {"kin40k_f32": dict(name="smse", line_key="smse", depth_key="epochs", bound="rtol"),
          "kin40k_f64": dict(name="smse", line_key="smse", depth_key="epochs", bound="rtol"),
          "banana": dict(name="errors", line_key="errors", depth_key="epochs", bound="atol"),
          "collapsed": dict(name="smse", line_key="final_smse", depth_key="steps",
                            bound="rtol")}
FULL_DEPTH = {"kin40k_f32": 500, "kin40k_f64": 500, "banana": 500, "collapsed": 400}
SMOKE_DEPTH = {"kin40k_f32": 100, "kin40k_f64": 100, "banana": 100, "collapsed": 400}
CHUNK = {"kin40k_f32": port_kin40k.FAST_CHUNK, "kin40k_f64": port_kin40k.FAST_CHUNK,
         "banana": port_banana.CHUNK, "collapsed": 25}
# The port's distance from JAX is held to this many twin spreads. A twin
# moves one input by a few ulps; the port's arithmetic differs from the
# JAX package's by about an ulp in every reduction of every step (GEMM and
# reduction orders, the kernel's expanded distance, cuBLAS against
# Eigen). Read on the CPU (``trajectory``, M = 300, every 10 of 100
# epochs) the port's θ stays within 3.3 one-ulp twin spreads of JAX's in
# float32 and float64; on the card at full width its figures lie within
# 0.62-2.53 spreads of the six twins below. The spread is the largest of
# six twins, since one twin's gap can cross zero at the depth read (the
# collapsed SMSE's +1-ulp twin: 8.1e-7, the others 2.7e-6 to 1.4e-5).
TWIN_MULTIPLE = 10.0
TWIN_ULPS = (-3, -2, -1, 1, 2, 3)
KIN40K = dict(m_inducing=600, batch_size=500, n_train=10_000, n_test=30_000)
BANANA = dict(m_inducing=500, batch_size=200)
COLLAPSED = dict(m_inducing=600, n_train=10_000, n_test=30_000)


def _np(t):
    return t.detach().cpu().numpy()


def _twin(a, ulps):
    """``a`` moved by ``ulps`` ulps of its own dtype (0: as is)."""
    a = np.array(a)
    for _ in range(abs(ulps)):
        a = np.nextafter(a, np.asarray(np.inf if ulps > 0 else -np.inf, a.dtype))
    return a


def kin40k_arrays(dtype, twin=0, **size):
    """The port runner's kin40k arrays (``experiments/kin40k.py::setup`` on
    ``kin40k_synthetic(SEED)``) in ``dtype`` (torch), as numpy, with the
    training targets moved by ``twin`` ulps."""
    size = {**KIN40K, **size}
    ds = port_kin40k.load_data("synthetic", SEED, size["n_test"])
    theta0, Xu, Xb, yb, prior_v = port_kin40k.setup(
        ds, size["m_inducing"], size["batch_size"], size["n_train"], SEED, "cpu", dtype)
    return dict(theta0=_np(theta0), Xu=_np(Xu), Xb=_np(Xb), yb=_twin(_np(yb), twin),
                xi0=_np(prior_v.xi), prec0=_np(prior_v.prec), x_test=_np(
                    torch.as_tensor(ds.x_test, dtype=dtype)), y_test=np.asarray(ds.y_test))


def banana_arrays(twin=0, **size):
    """The port runner's banana arrays (``experiments/banana.py::setup`` on
    ``banana_synthetic(SEED)``, float32), as numpy, with the training
    inputs moved by ``twin`` ulps."""
    size = {**BANANA, **size}
    ds = port_banana.load_data("synthetic", SEED)
    theta0, Xu, Xb, yb, prior_v, prior_w = port_banana.setup(
        ds, size["m_inducing"], size["batch_size"], SEED, "cpu", torch.float32)
    return dict(theta0=_np(theta0), Xu=_np(Xu), Xb=_twin(_np(Xb), twin), yb=_np(yb),
                xi0=_np(prior_v.xi), prec0=_np(prior_v.prec),
                w0=(float(prior_w.shape), float(prior_w.rate)),
                x_test=_np(torch.as_tensor(ds.x_test, dtype=torch.float32)),
                y_test=np.asarray(ds.y_test))


def collapsed_arrays(twin=0, **size):
    """The port's collapsed runner's arrays (``run_kin40k_collapsed``:
    float32 training rows and inducing rows, float64 test rows), as numpy,
    with the training targets moved by ``twin`` ulps."""
    size = {**COLLAPSED, **size}
    ds, theta0, Xu, Xb, yb = port_vsgp._kin40k("synthetic", SEED, size["m_inducing"],
                                               size["n_train"], size["n_test"], 500, "cpu",
                                               torch.float32)
    X, y = Xb.reshape(-1, Xb.shape[-1]), yb.reshape(-1)
    return dict(theta0=_np(theta0), Xu=_np(Xu), X=_np(X), y=_twin(_np(y), twin),
                x_test=np.asarray(ds.x_test, np.float64), y_test=np.asarray(ds.y_test))


def _depths(total, chunk, keep):
    ends = list(range(chunk, total, chunk)) + [total]
    return ends, {d for d in keep if d in ends}


def jax_kin40k(a, epochs, keep=(), learning_rate=1e-3):
    """``fit_kin40k_fast`` in chunks of ``FAST_CHUNK`` epochs, as the JAX
    runner drives it; at every depth in ``keep`` (and the last) the SMSE of
    ``recover_and_predict`` on the test rows and θ. Returns {depth: dict}."""
    kernel = Kernel("se", transform="softplus", use_pallas=True)
    dtype = a["theta0"].dtype
    theta0, Xu = jnp.asarray(a["theta0"]), jnp.asarray(a["Xu"])
    Xb, yb = jnp.asarray(a["Xb"]), jnp.asarray(a["yb"])
    prior_v = MvGaussianNat(jnp.asarray(a["xi0"]), jnp.asarray(a["prec0"]))
    Xte = jnp.asarray(a["x_test"])
    w_val = port_kin40k.W_VAL

    @jax.jit
    def recover_and_predict(qv_nat, cov64, theta):
        prec = sym(qv_nat.prec)
        mu_v = ir_solve(prec, qv_nat.xi, cov64, rounds=4).astype(dtype)
        mean, _ = predict_out(kernel, theta, Xu, Xte, mu_v, w_val)
        return mean

    state = jmb.init_kin40k_fast_state(theta0, prior_v, Xu.shape[0], 1)
    ends, keep = _depths(epochs, port_kin40k.FAST_CHUNK, set(keep) | {epochs})
    out, done, t0 = {}, 0, time.perf_counter()
    for end in ends:
        theta, qv_nat, cov64, state = jmb.fit_kin40k_fast(
            kernel, theta0, Xu, Xb, yb, prior_v, w_val, end - done,
            learning_rate=learning_rate, resume_state=state)
        theta.block_until_ready()
        done = end
        if end in keep:
            mean = recover_and_predict(qv_nat, cov64, theta)
            out[end] = {"smse": float(smse(a["y_test"], np.asarray(mean))),
                        "theta": np.asarray(theta, np.float64).tolist(),
                        "theta_softplus": np.asarray(softplus(theta), np.float64).tolist(),
                        "seconds_cpu": time.perf_counter() - t0}
    return out


def jax_banana(a, epochs, keep=()):
    """``fit_banana_fast`` from ``init_banana_state`` in chunks of 100, as
    the JAX runner drives it; at every depth in ``keep`` (and the last) the
    test errors of ``recover_and_predict``, θ, w̄ and the probabilities."""
    kernel = Kernel("se", transform="softplus")
    theta0, Xu = jnp.asarray(a["theta0"]), jnp.asarray(a["Xu"])
    Xb, yb = jnp.asarray(a["Xb"]), jnp.asarray(a["yb"])
    prior_v = MvGaussianNat(jnp.asarray(a["xi0"]), jnp.asarray(a["prec0"]))
    prior_w = GammaShapeRate(jnp.asarray(a["w0"][0], jnp.float32),
                             jnp.asarray(a["w0"][1], jnp.float32))
    Xte = jnp.asarray(a["x_test"])

    @jax.jit
    def recover_and_predict(qv_nat, qw, theta):
        prec = sym(qv_nat.prec)
        cov = spd_inverse_ns(prec, iters=60)
        mu_v = ir_solve(prec, qv_nat.xi, cov, rounds=4).astype(jnp.float32)
        return predict_probit(kernel, theta, Xu, Xte, mu_v, gamma_mean(qw))

    state = jmb.init_banana_state(kernel, theta0, Xu, prior_v, prior_w)
    ends, keep = _depths(epochs, port_banana.CHUNK, set(keep) | {epochs})
    out, done, t0 = {}, 0, time.perf_counter()
    for end in ends:
        theta, qv_nat, qw, state = jmb.fit_banana_fast(
            kernel, theta0, Xu, Xb, yb, prior_v, prior_w, end - done, resume_state=state)
        theta.block_until_ready()
        done = end
        if end in keep:
            probs = np.asarray(recover_and_predict(qv_nat, qw, theta), np.float64)
            pred = (probs >= 0.5).astype(np.float64)
            out[end] = {"errors": float(num_error(a["y_test"], pred)),
                        "theta": np.asarray(theta, np.float64).tolist(),
                        "theta_softplus": np.asarray(softplus(theta), np.float64).tolist(),
                        "w_mean": float(gamma_mean(qw)), "probs": probs.tolist(),
                        "seconds_cpu": time.perf_counter() - t0}
    return out


def jax_collapsed(a, steps, keep=(), eval_every=25, learning_rate=0.05):
    """``fit_svgp_collapsed_resumable`` in chunks of ``eval_every`` steps
    (f32 θ), each chunk's θ scored by ``collapsed_predict`` in float64 on
    the float64 casts of the same rows, as the port's runner scores them."""
    kernel = Kernel("se", transform="softplus")
    noise, jitter = port_vsgp.COLLAPSED_NOISE, port_vsgp.COLLAPSED_JITTER
    theta = jnp.asarray(a["theta0"])
    Xu, X, y = jnp.asarray(a["Xu"]), jnp.asarray(a["X"]), jnp.asarray(a["y"])
    f64 = jnp.float64
    Xu64, X64, y64 = Xu.astype(f64), X.astype(f64), y.astype(f64)
    Xte = jnp.asarray(a["x_test"], f64)
    predict = jax.jit(lambda th: jsvgp.collapsed_predict(kernel, th.astype(f64), Xu64, Xte,
                                                         X64, y64, noise, jitter=jitter))
    opt_state = jsvgp.collapsed_opt_init(theta, learning_rate)
    ends, keep = _depths(steps, eval_every, set(keep) | {steps})
    out, history, done, t0 = {}, [], 0, time.perf_counter()
    for end in ends:
        theta, opt_state, trace = jsvgp.fit_svgp_collapsed_resumable(
            kernel, theta, opt_state, Xu, X, y, noise, steps=end - done,
            learning_rate=learning_rate, jitter=jitter)
        done = end
        score = float(smse(a["y_test"], np.asarray(predict(theta))))
        history.append({"step": end, "smse": score, "neg_elbo": float(trace[-1])})
        if end in keep:
            out[end] = {"smse": score, "theta_softplus": np.asarray(softplus(theta),
                                                                    np.float64).tolist(),
                        "history": list(history), "seconds_cpu": time.perf_counter() - t0}
    return out


def trajectory(dtype, m_inducing, epochs, every):
    """θ of the kin40k fast trainer every ``every`` epochs in three runs on
    the runner's arrays at ``m_inducing``: JAX, JAX on the one-ulp twin of
    the targets, and the port's ``fit_kin40k_fast`` on the CPU, each in
    chunks of ``every`` epochs. Yields (epoch, max |θ_twin − θ_JAX|,
    max |θ_port − θ_JAX|): whether the port parts from JAX sooner than
    JAX's own rounding does."""
    from gaussianprocessnode_tpu_torch.dists import MvGaussianNat as PortNat
    from gaussianprocessnode_tpu_torch.infer import minibatch as pmb
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as PortKernel

    thetas = {}
    for who, twin in (("jax", 0), ("twin", 1), ("port", 0)):
        a = kin40k_arrays(dtype, twin, m_inducing=m_inducing, n_test=1)
        if who == "port":
            args = [torch.as_tensor(a[k]) for k in ("theta0", "Xu", "Xb", "yb")]
            prior = PortNat(torch.as_tensor(a["xi0"]), torch.as_tensor(a["prec0"]))
            kernel, fit = PortKernel("se", transform="softplus", use_kernel=True), \
                pmb.fit_kin40k_fast
            state = pmb.init_kin40k_fast_state(args[0], prior, m_inducing, 1)
        else:
            args = [jnp.asarray(a[k]) for k in ("theta0", "Xu", "Xb", "yb")]
            prior = MvGaussianNat(jnp.asarray(a["xi0"]), jnp.asarray(a["prec0"]))
            kernel, fit = Kernel("se", transform="softplus", use_pallas=True), \
                jmb.fit_kin40k_fast
            state = jmb.init_kin40k_fast_state(args[0], prior, m_inducing, 1)
        thetas[who] = []
        for _ in range(0, epochs, every):
            theta, _, _, state = fit(kernel, *args, prior, port_kin40k.W_VAL, every,
                                     resume_state=state)
            thetas[who].append(np.asarray(theta, np.float64))
    for i, (j, t, p) in enumerate(zip(thetas["jax"], thetas["twin"], thetas["port"])):
        yield (i + 1) * every, float(np.abs(t - j).max()), float(np.abs(p - j).max())


def collapsed_rounding(figs):
    """The collapsed bound and its θ-gradient of both packages in float32
    and float64 at full width, at θ0 and at JAX's θ after the full run
    (``figs``): each float32 value's and gradient's distance from the same
    package's float64 ones, which agree across the packages to round-off.
    Shows whose float32 reductions the two trainers' distance comes from."""
    from gaussianprocessnode_tpu_torch.infer import svgp as port_svgp
    from gaussianprocessnode_tpu_torch.ops.kernels import Kernel as PortKernel

    a = collapsed_arrays()
    noise, jitter = port_vsgp.COLLAPSED_NOISE, port_vsgp.COLLAPSED_JITTER
    jk, pk = Kernel("se", transform="softplus"), PortKernel("se", transform="softplus",
                                                             use_kernel=True)
    sp = np.asarray(figs["collapsed"]["depths"][str(FULL_DEPTH["collapsed"])]["theta_softplus"])
    rows = []
    for where, th in (("theta0", a["theta0"]), ("theta_jax_final",
                                                np.log(np.expm1(sp)).astype(np.float32))):
        got = {}
        for dt in ("float32", "float64"):
            data = [a[k].astype(dt) for k in ("Xu", "X", "y")]
            jv, jg = jax.value_and_grad(lambda t: jsvgp.collapsed_neg_elbo(
                jk, t, *map(jnp.asarray, data), noise, jitter))(jnp.asarray(th, dt))
            t = torch.tensor(th, dtype=getattr(torch, dt), requires_grad=True)
            pv = port_svgp.collapsed_neg_elbo(pk, t, *map(torch.as_tensor, data), noise, jitter)
            (pg,) = torch.autograd.grad(pv, t)
            got[dt] = {"jax": (float(jv), np.asarray(jg, np.float64)),
                       "port": (float(pv.detach()), pg.double().numpy())}
        row = {"at": where}
        for who in ("jax", "port"):
            v64, g64 = got["float64"][who]
            v32, g32 = got["float32"][who]
            row[who] = {"value_f64": v64, "value_f32_minus_f64": v32 - v64,
                        "grad_f32_rel_err": float(np.max(np.abs(g32 - g64) / np.abs(g64)))}
        v, g = got["float64"]["jax"], got["float64"]["port"]
        row["f64_port_vs_jax"] = {"value_rel": abs(g[0] - v[0]) / abs(v[0]),
                                  "grad_rel": float(np.max(np.abs(g[1] - v[1]) / np.abs(v[1])))}
        rows.append(row)
    return rows


def run_one(trainer, twin=0):
    """One JAX run of ``trainer`` at full width and the runner's depth,
    recorded at ``SMOKE_DEPTH`` and at the end."""
    depth = FULL_DEPTH[trainer]
    keep = (SMOKE_DEPTH[trainer], depth)
    if trainer.startswith("kin40k"):
        dtype = torch.float32 if trainer == "kin40k_f32" else torch.float64
        res = jax_kin40k(kin40k_arrays(dtype, twin), depth, keep)
    elif trainer == "banana":
        res = jax_banana(banana_arrays(twin), depth, keep)
    else:
        res = jax_collapsed(collapsed_arrays(twin), depth, keep)
    return {"trainer": trainer, "twin_ulps": twin, "seed": SEED, "depth": depth,
            "jax": jax.__version__, "results": {str(k): v for k, v in res.items()}}


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def figures(runs):
    """The committed figures from the runs: per trainer and depth, JAX's
    figure and θ (the run with ``twin_ulps`` 0), the twins' spreads (the
    largest over the twins of ``TWIN_ULPS``) and the bounds they set."""
    out = {}
    for trainer in TRAINERS:
        mine = [r for r in runs if r["trainer"] == trainer]
        base = [r for r in mine if r["twin_ulps"] == 0]
        if not base:
            continue
        base = base[0]
        twins = [r for r in mine if r["twin_ulps"] != 0]
        have = sorted(r["twin_ulps"] for r in twins)
        if have != sorted(TWIN_ULPS):
            raise ValueError(f"{trainer}: twins {have}, the procedure needs {sorted(TWIN_ULPS)}")
        entry = {"seed": base["seed"], "jax": base["jax"], "twin_ulps": sorted(
            r["twin_ulps"] for r in twins), "config": config(trainer),
            "figure": FIGURE[trainer], "depths": {}}
        for depth, b in base["results"].items():
            ts = {r["twin_ulps"]: r["results"][depth] for r in twins}
            d = {k: v for k, v in b.items() if k not in ("probs", "history")}
            each = {k: {"theta_softplus": _relmax(t["theta_softplus"], b["theta_softplus"])}
                    for k, t in ts.items()}
            if trainer == "banana":
                p = np.asarray(b["probs"])
                for k, t in ts.items():
                    each[k]["errors"] = abs(t["errors"] - b["errors"])
                    each[k]["probs"] = float(np.max(np.abs(np.asarray(t["probs"]) - p)))
            else:
                for k, t in ts.items():
                    each[k]["smse"] = abs(t["smse"] - b["smse"]) / b["smse"]
            d["twins"] = {str(k): each[k] for k in sorted(each)}
            spread = {q: max(e[q] for e in each.values()) for q in next(iter(each.values()))}
            d["theta_softplus_twin_spread"] = spread["theta_softplus"]
            d["theta_softplus_rtol"] = TWIN_MULTIPLE * spread["theta_softplus"]
            if trainer == "banana":
                d["errors_twin_spread"] = spread["errors"]
                d["probs_twin_spread"] = spread["probs"]
                d["errors_atol"] = int(np.sum(np.abs(p - 0.5) <= TWIN_MULTIPLE * spread["probs"]))
            else:
                d["smse_twin_spread"] = spread["smse"]
                d["smse_rtol"] = TWIN_MULTIPLE * spread["smse"]
            entry["depths"][depth] = d
        out[trainer] = entry
    if "kin40k_f32" in out and "kin40k_f64" in out:
        out["kin40k_f32_over_f64"] = {
            dep: out["kin40k_f32"]["depths"][dep]["smse"] / out["kin40k_f64"]["depths"][dep]["smse"]
            for dep in out["kin40k_f32"]["depths"] if dep in out["kin40k_f64"]["depths"]}
    return out


def config(trainer):
    if trainer.startswith("kin40k"):
        return {**KIN40K, "dtype": trainer[-3:].replace("f", "float"), "w": port_kin40k.W_VAL,
                "learning_rate": 1e-3, "chunk": CHUNK[trainer], "data": "kin40k_synthetic",
                "runner": "gaussianprocessnode_tpu_torch.experiments.kin40k"}
    if trainer == "banana":
        return {**BANANA, "dtype": "float32", "learning_rate": 1e-3, "chunk": CHUNK[trainer],
                "data": "banana_synthetic",
                "runner": "gaussianprocessnode_tpu_torch.experiments.banana"}
    return {**COLLAPSED, "dtype": "float32", "predict_dtype": "float64",
            "learning_rate": 0.05, "noise": port_vsgp.COLLAPSED_NOISE,
            "jitter": port_vsgp.COLLAPSED_JITTER, "eval_every": CHUNK[trainer],
            "data": "kin40k_synthetic",
            "runner": "gaussianprocessnode_tpu_torch.experiments.vsgp_baselines kin40k_collapsed"}


def _line(path):
    with open(path) as f:
        return json.loads([ln for ln in f.read().splitlines() if ln.startswith("{")][-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="one JAX run at full width")
    r.add_argument("trainer", choices=TRAINERS)
    r.add_argument("--twin", type=int, default=0, help="ulps by which the data move")
    r.add_argument("--out", required=True)
    tr = sub.add_parser("trajectory", help="kin40k θ of JAX, its twin and the port by chunk")
    tr.add_argument("dtype", choices=("float32", "float64"))
    tr.add_argument("--m-inducing", type=int, default=300)
    tr.add_argument("--epochs", type=int, default=100)
    tr.add_argument("--every", type=int, default=10)
    cr = sub.add_parser("collapsed-rounding",
                        help="both packages' collapsed bound in float32 against float64")
    cr.add_argument("--figures", default=str(FIGURES))
    f = sub.add_parser("figures", help="the figures and bounds from runs")
    f.add_argument("runs", nargs="+")
    f.add_argument("--write", action="store_true", help=f"write {FIGURES.name}")
    c = sub.add_parser("compare", help="the port's runner lines against the figures")
    for t in TRAINERS:
        c.add_argument("--" + t.replace("_", "-"), metavar="JSON")
    c.add_argument("--figures", default=str(FIGURES))
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")

    if args.cmd == "run":
        res = run_one(args.trainer, args.twin)
        with open(args.out, "w") as fh:
            json.dump(res, fh)
        last = res["results"][str(res["depth"])]
        print(json.dumps({"trainer": args.trainer, "twin_ulps": args.twin,
                          **{k: v for k, v in last.items() if k not in ("probs", "history")}}))
        return 0
    if args.cmd == "trajectory":
        rows = []
        for epoch, twin, port in trajectory(getattr(torch, args.dtype), args.m_inducing,
                                            args.epochs, args.every):
            rows.append({"epoch": epoch, "twin": twin, "port": port})
            print(f"epoch {epoch}: max |theta - JAX| twin {twin:.3e}, port {port:.3e}",
                  flush=True)
        print(json.dumps({"dtype": args.dtype, "m_inducing": args.m_inducing, "rows": rows}))
        return 0
    if args.cmd == "collapsed-rounding":
        with open(args.figures) as fh:
            rows = collapsed_rounding(json.load(fh))
        for r in rows:
            print(f"{r['at']}: " + "; ".join(
                f"{w} f32 value - f64 {r[w]['value_f32_minus_f64']:.4g}, f32 gradient rel err "
                f"{r[w]['grad_f32_rel_err']:.3e}" for w in ("jax", "port"))
                + f"; f64 port vs JAX value {r['f64_port_vs_jax']['value_rel']:.2e}, gradient "
                f"{r['f64_port_vs_jax']['grad_rel']:.2e}", flush=True)
        print(json.dumps({"collapsed_rounding": rows}))
        return 0
    if args.cmd == "figures":
        runs = []
        for p in args.runs:
            with open(p) as fh:
                runs.append(json.load(fh))
        figs = figures(runs)
        if args.write:
            with open(FIGURES, "w") as fh:
                json.dump({"twin_multiple": TWIN_MULTIPLE, "twin_ulps": list(TWIN_ULPS),
                           "smoke_depth": SMOKE_DEPTH,
                           **figs}, fh, indent=1)
                fh.write("\n")
        print(json.dumps(figs))
        return 0
    with open(args.figures) as fh:
        figs = json.load(fh)
    out, ok = {}, True
    for t in TRAINERS:
        path = getattr(args, t)
        if not path:
            continue
        port = _line(path)
        out[t] = headline.hold(t, port, figs)
        out[t]["port_device"] = port.get("device")
        ok &= out[t]["within"]
        o = out[t]
        print(f"{t} at {o['depth']}: {o['figure']} port {o['port']} JAX {o['jax']} "
              f"({o['kind'][0]}diff {o['diff']:.3e}, bound {o['bound']:.3e}); θ (softplus) port "
              f"{np.round(o['theta_softplus_port'], 6).tolist()} JAX "
              f"{np.round(o['theta_softplus_jax'], 6).tolist()}, rel "
              f"{o['theta_softplus_rel']:.3e} (bound {o['theta_softplus_rtol']:.3e}); "
              f"{'within' if o['within'] else 'OUTSIDE'} its bounds", flush=True)
    if "kin40k_f32" in out and "kin40k_f64" in out:
        d = str(out["kin40k_f32"]["depth"])
        out["kin40k_f32_over_f64"] = {
            "port": out["kin40k_f32"]["port"] / out["kin40k_f64"]["port"],
            "jax": figs["kin40k_f32_over_f64"][d]}
    print(json.dumps({"ok": bool(ok), "compared": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
