#!/usr/bin/env python3
"""Hold the port's toy runs to the JAX package's on the same data.

Reads the JSON lines that the port's runners wrote
(``python -m gaussianprocessnode_tpu_torch.experiments.toy_regression
--json=PATH`` and ``... .toy_classification --json=PATH``, on the card or
the host), runs the JAX package's ``fit_regression`` /
``fit_classification`` (library calls on the CPU, float64, the JAX runners'
configurations and local data draws, the same number of epochs) and prints
both results and their relative differences: θ (softplus), SMSE or the test
errors, the first and last free energy; and, for classification, the test
points whose two probabilities straddle 0.5.

    python scripts/toy_jax_parity.py --regression reg.json --classification cls.json

The JAX experiment scripts are not imported: they set a compilation cache
inside the repository.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gaussianprocessnode_tpu.dists import GammaShapeRate, MvGaussianNat, gamma_mean  # noqa: E402
from gaussianprocessnode_tpu.infer.batch_vmp import predict_out, predict_probit  # noqa: E402
from gaussianprocessnode_tpu.infer.training import (fit_classification,  # noqa: E402
                                                    fit_regression)
from gaussianprocessnode_tpu.ops.kernels import Kernel, invsoftplus, softplus  # noqa: E402
from gaussianprocessnode_tpu.utils.datasets import toy_classification, toy_sinc  # noqa: E402
from gaussianprocessnode_tpu.utils.metrics import num_error, smse  # noqa: E402

KERNEL = Kernel("se", transform="softplus")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def regression(epochs):
    d = toy_sinc()
    Xu = jnp.linspace(-4.0, 4.0, 20)[:, None]
    t = time.perf_counter()
    theta, fe, res = fit_regression(KERNEL, invsoftplus(jnp.asarray([1.0, 1.0])), Xu,
                                    jnp.asarray(d.x_train), jnp.asarray(d.y_train),
                                    MvGaussianNat(jnp.zeros(20), jnp.eye(20) / 50.0),
                                    GammaShapeRate(jnp.asarray(1e-2), jnp.asarray(1e-2)),
                                    epochs=epochs)
    mean, _ = predict_out(KERNEL, theta, Xu, jnp.asarray(d.x_test), res.qv.mean,
                          gamma_mean(res.qw))
    return dict(theta_softplus=np.asarray(softplus(theta)).tolist(),
                smse=float(smse(jnp.asarray(d.y_test), mean)), fe_first=float(fe[0]),
                fe_last=float(fe[-1]), seconds_cpu=time.perf_counter() - t)


def classification(epochs):
    d = toy_classification()
    Xu = jnp.linspace(-5.0, 5.0, 15)[:, None]
    g = GammaShapeRate(jnp.asarray(1e-2), jnp.asarray(1e-2))
    t = time.perf_counter()
    theta, fe, res = fit_classification(KERNEL, invsoftplus(jnp.asarray([1.0, 1.0])), Xu,
                                        jnp.asarray(d.x_train), jnp.asarray(d.y_train),
                                        MvGaussianNat(jnp.zeros(15), jnp.eye(15) / 50.0), g, g,
                                        epochs=epochs)
    probs = np.asarray(predict_probit(KERNEL, theta, Xu, jnp.asarray(d.x_test), res.qv.mean,
                                      gamma_mean(res.qw)))
    pred = (probs >= 0.5).astype(float)
    return dict(theta_softplus=np.asarray(softplus(theta)).tolist(),
                errors=float(num_error(jnp.asarray(d.y_test), jnp.asarray(pred))),
                fe_first=float(fe[0]), fe_last=float(fe[-1]),
                near_half=[[int(i), float(probs[i])] for i in
                           np.flatnonzero(np.abs(probs - 0.5) <= 1e-6)],
                seconds_cpu=time.perf_counter() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regression", metavar="JSON")
    ap.add_argument("--classification", metavar="JSON")
    args = ap.parse_args(argv)
    for name, path, fit, metric in (("regression", args.regression, regression, "smse"),
                                    ("classification", args.classification, classification,
                                     "errors")):
        if not path:
            continue
        with open(path) as f:
            port = json.loads(f.read().strip().splitlines()[-1])
        ref = fit(port["epochs"])
        diff = {k: _rel(port[k], ref[k]) for k in ("theta_softplus", metric, "fe_first",
                                                    "fe_last")}
        print(json.dumps({"workload": name, "epochs": port["epochs"],
                          "port_device": port["device"], "port": {k: port[k] for k in diff},
                          "jax_cpu": ref, "relative_difference": diff}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
