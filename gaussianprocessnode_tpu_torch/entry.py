"""The flagship forward step, with example arguments.

Counterpart of ``__graft_entry__.py::entry``: the predictive means of the
UniSGP :out rule at point test inputs (reference: UniSGPnode.jl:96-104),
kin40k-shaped (M = 600 inducing inputs, 8-D inputs, 512 test points). The
multi-rank dry run, the counterpart of ``dryrun_multichip``, is
``parallel/dryrun.py``.
"""

import numpy as np
import torch

from .ops.kernels import Kernel, invsoftplus

__all__ = ["entry"]

M, D, N = 600, 8, 512


def entry(device="cuda", dtype=torch.float64):
    """Return (forward, args): ``forward(theta, Xu, X_test, mu_v)`` is the SE
    Gram K(Xu, X_test) by ``Kernel("se", transform="softplus")``, then
    Kᵀμ_v; ``args`` are drawn as the JAX entry draws them (numpy's
    generator from 0; θ = softplus⁻¹(1)), in ``dtype`` on ``device``. The
    Gram routes by dtype (``ops/se_gram.py::se_gram_auto``): float32 on the
    card takes the CUDA kernel, float64 (the JAX entry's type, the default)
    the plain Gram."""
    kernel = Kernel("se", transform="softplus", use_kernel=True)

    def forward(theta, Xu, X_test, mu_v):
        with torch.no_grad():
            Kut = kernel(theta, Xu, X_test)
            return Kut.T @ mu_v

    rng = np.random.default_rng(0)
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    args = (
        invsoftplus(torch.ones(D + 1, dtype=dtype, device=dev)),
        t(rng.standard_normal((M, D))),
        t(rng.standard_normal((N, D))),
        t(rng.standard_normal(M)),
    )
    return forward, args
