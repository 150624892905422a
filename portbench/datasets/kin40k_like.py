"""kin40k's shape, rewritten from ``gaussianprocessnode_tpu_torch/utils/datasets.py``'s
``kin40k_synthetic`` so that nothing is read from a file: inputs N(0, I_D);
the latent function is an SE function with the configuration's θ,
f(x) = K_θ(C, x)ᵀa over ``num_inducing`` centres C ~ N(0, I_D) with weights
a ~ N(0, 1) (the original used the committed trained state's μ_v, a file),
scaled to unit deviation over the training inputs; targets add N(0, 1/w)
noise, w the noise precision."""

import math

import torch

from ..reference.se import se_gram

F64 = torch.float64


def make(cfg: dict, gen: torch.Generator, device):
    """(X (N, D), y (N,)) in float64 on ``device``."""
    D, M, N = cfg["input_dim"], cfg["num_inducing"], cfg["num_train"]
    var = torch.tensor(cfg["theta"]["variance"], dtype=F64, device=device)
    ls = torch.tensor(cfg["theta"]["lengthscales"], dtype=F64, device=device)
    C = torch.randn(M, D, generator=gen, dtype=F64, device=device)
    a = torch.randn(M, generator=gen, dtype=F64, device=device)
    X = torch.randn(N, D, generator=gen, dtype=F64, device=device)
    f = se_gram(C, X, var, ls).T @ a
    f = f / f.std(unbiased=False)
    noise = torch.randn(N, generator=gen, dtype=F64, device=device)
    return X, f + noise / math.sqrt(cfg["noise_precision"])
