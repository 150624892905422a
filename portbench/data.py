"""Seeded data on the run's device: the generator, the training set of a
configuration (``datasets/<cfg["data"]>.py``, found by name) and the
inducing rows. Data is made in float64; a driver casts what it serves or
trains on."""

import importlib

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def training_set(cfg: dict, gen: torch.Generator, device):
    return importlib.import_module(f"portbench.datasets.{cfg['data']}").make(cfg, gen, device)


def inducing_rows(X: torch.Tensor, M: int, gen: torch.Generator) -> torch.Tensor:
    """M distinct training rows drawn by the generator, as the runners take
    their inducing inputs."""
    return X[torch.randperm(X.shape[0], generator=gen, device=X.device)[:M]]
