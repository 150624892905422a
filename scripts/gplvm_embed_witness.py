#!/usr/bin/env python3
"""The GPLVM embedding's fixed point at full width, in both packages on the CPU.

Run from the root of the repository:

    python3 scripts/gplvm_embed_witness.py [--seeds 0 1] [--sweeps 4]

For each seed it takes ``chip_smoke.py`` phase 13's float64 inputs
(``chip_smoke.gplvm_setup``: the GPLVM runner's 200 synthetic oil-flow
rows, D = 12, Din = 2, M = 30) and, in the port and in the JAX package on
the same numpy arrays, fits 2 epochs of ``fit_gplvm_grad`` (6 sweeps
each), then embeds the training rows by one pass of ``gplvm_embed``
started at the latents, from the fit's state and after each of
``--sweeps`` more sweeps at the trained θ, and prints the largest distance
a row moved, per number of those polish sweeps, beside phase 13's
``GPLVM_POLISH_SWEEPS`` and limit ``GPLVM_FIXED_POINT``. The JAX
experiment script is not imported: it sets a compilation cache inside the
repository. Last line: one JSON object.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gaussianprocessnode_tpu.infer import gplvm as jg  # noqa: E402
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel  # noqa: E402
from gaussianprocessnode_tpu_torch.infer import gplvm as tg  # noqa: E402
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel  # noqa: E402


def moved(pkg, kernel, theta, Xu, Y, Xm, state, sweeps):
    """Largest move of the training rows under one embedding pass started
    at the latents of ``state`` and of each of ``sweeps`` polish sweeps."""
    out = []
    for k in range(sweeps + 1):
        if k:
            state, _ = pkg.gplvm_vmp(kernel, theta, Xu, Y, Xm, n_iters=1, init_state=state,
                                     compute_fe=False)
        m, _ = pkg.gplvm_embed(kernel, theta, Xu, Y, state, Xm, x_start=state.x_means,
                               n_iters=1)
        out.append(float(np.abs(np.asarray(m) - np.asarray(state.x_means)).max()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--sweeps", type=int, default=4)
    args = ap.parse_args(argv)
    out = {}
    for seed in args.seeds:
        s, theta, state, _ = cs.gplvm_fit(seed, "cpu")
        port = moved(tg, Kernel("se", "softplus"), theta, s["Xu"], s["Y"], s["Xm"], state,
                     args.sweeps)
        J = [jnp.asarray(s[k].numpy()) for k in ("theta0", "Xu", "Y", "Xm")]
        jk = JKernel("se", transform="softplus")
        jtheta, jstate, _ = jg.fit_gplvm_grad(jk, *J, epochs=cs.GPLVM_EPOCHS,
                                              n_iters=cs.GPLVM_SWEEPS)
        ref = moved(jg, jk, jtheta, J[1], J[2], J[3], jstate, args.sweeps)
        out[seed] = {"port": port, "jax": ref}
        print(f"seed {seed}: training rows move by (max abs, after 0..{args.sweeps} polish "
              f"sweeps) port {['%.3e' % v for v in port]}, JAX {['%.3e' % v for v in ref]}; "
              f"phase 13: {cs.GPLVM_POLISH_SWEEPS} sweeps, limit {cs.GPLVM_FIXED_POINT:.0e}",
              flush=True)
    print(json.dumps({"polish_sweeps": cs.GPLVM_POLISH_SWEEPS, "limit": cs.GPLVM_FIXED_POINT,
                      "moved": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
