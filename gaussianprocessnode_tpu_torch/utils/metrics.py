"""Evaluation metrics (reference: gp_helperfunction.jl:145-158).

Counterpart of ``gaussianprocessnode_tpu/utils/metrics.py``.
"""

import torch

__all__ = ["smse", "num_error", "error_rate"]


def smse(y_true, y_pred):
    """Standardized mean squared error: MSE / var(y_true), with the
    corrected (sample) variance as Julia's ``var``."""
    y_true = torch.as_tensor(y_true)
    y_pred = torch.as_tensor(y_pred, dtype=y_true.dtype, device=y_true.device)
    n = y_true.shape[0]
    mse = torch.sum((y_true - y_pred) ** 2) / n
    return mse / torch.var(y_true, correction=1)


def num_error(y_true, y_pred):
    """Σ|y − ŷ| for {0,1} labels (reference: gp_helperfunction.jl:152-154)."""
    y_true = torch.as_tensor(y_true)
    y_pred = torch.as_tensor(y_pred, device=y_true.device)
    return torch.sum(torch.abs(y_pred - y_true))


def error_rate(y_true, y_pred):
    return num_error(y_true, y_pred) / torch.as_tensor(y_true).shape[0]
