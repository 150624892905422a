"""banana's shape, rewritten from ``gaussianprocessnode_tpu_torch/utils/datasets.py``'s
``banana_synthetic``: two interleaved arcs with isotropic noise (labels in
{0, 1}, alternating before one shuffle), inputs standardised."""

import math

import torch

F64 = torch.float64


def make(cfg: dict, gen: torch.Generator, device):
    """(X (N, 2), labels (N,) in {0, 1}) in float64 on ``device``."""
    N, sd = cfg["num_train"], cfg["data_noise"]
    y = (torch.arange(N, device=device) % 2).to(F64)
    y = y[torch.randperm(N, generator=gen, device=device)]
    t = math.pi * torch.rand(N, generator=gen, dtype=F64, device=device)
    upper = torch.stack([torch.cos(t), torch.sin(t)], dim=1)
    lower = torch.stack([1.0 - torch.cos(t), 0.5 - torch.sin(t)], dim=1)
    x = torch.where(y[:, None] == 1.0, upper, lower)
    x = x + sd * torch.randn(N, 2, generator=gen, dtype=F64, device=device)
    x = (x - x.mean(0)) / x.std(0, unbiased=False)
    return x, y
