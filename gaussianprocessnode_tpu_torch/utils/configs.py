"""Experiment configurations — one frozen dataclass per reference workload
(SURVEY.md §5 "Config / flag system": the reference keeps these as notebook
constants; here they are checked-in, importable records).

Counterpart of ``gaussianprocessnode_tpu/utils/configs.py``, the same
records (the port keeps its own copy: it imports nothing of the JAX
package).
"""

from dataclasses import dataclass
from typing import Tuple

__all__ = [
    "ToyRegressionConfig",
    "ToyClassificationConfig",
    "Kin40kConfig",
    "BananaConfig",
    "GPLVMConfig",
    "PendulumConfig",
]


@dataclass(frozen=True)
class ToyRegressionConfig:
    """GPT_regression.ipynb cells 3-10."""

    n_train: int = 50
    n_test: int = 600
    noise_precision: float = 100.0
    m_inducing: int = 20
    inducing_range: Tuple[float, float] = (-4.0, 4.0)
    prior_v_var: float = 50.0
    prior_w: Tuple[float, float] = (1e-2, 1e-2)
    vmp_iters: int = 7
    epochs: int = 300
    reference_smse: float = 0.008132


@dataclass(frozen=True)
class ToyClassificationConfig:
    """GPT_classification.ipynb cells 3-10."""

    n_train: int = 100
    n_test: int = 400
    m_inducing: int = 15
    inducing_range: Tuple[float, float] = (-5.0, 5.0)
    prior_v_var: float = 50.0
    prior_w: Tuple[float, float] = (1e-2, 1e-2)
    vmp_iters: int = 30
    epochs: int = 500
    probit_gh_points: int = 32
    reference_errors: int = 35
    reference_error_rate: float = 0.0875


@dataclass(frozen=True)
class Kin40kConfig:
    """regression_kin40k.ipynb cells 3-10."""

    n_train: int = 10_000
    m_inducing: int = 600
    batch_size: int = 500
    w_fixed: float = 1e4
    prior_v_var: float = 50.0
    epochs: int = 500
    learning_rate: float = 0.001  # Flux.AdaMax default
    inducing_seed: int = 1
    reference_smse: float = 0.083431
    reference_seconds: float = 12600.0
    vsgp_baseline_smse: float = 0.087478


@dataclass(frozen=True)
class BananaConfig:
    """classification_banana.ipynb cells 3-10."""

    n_train: int = 4000
    m_inducing: int = 500
    batch_size: int = 200
    prior_v_var: float = 50.0
    prior_w: Tuple[float, float] = (1e-2, 1e-2)
    epochs: int = 500
    learning_rate: float = 0.001
    inducing_seed: int = 1
    reference_errors: int = 125
    reference_error_rate: float = 0.09615
    reference_seconds: float = 2965.76


@dataclass(frozen=True)
class GPLVMConfig:
    """GPLVM.ipynb cells 4-17."""

    n_data: int = 200
    d_out: int = 12
    d_in: int = 2
    m_inducing: int = 30
    w_fixed: float = 100.0
    x_prior_var: float = 100.0
    vmp_iters: int = 6
    neldermead_iters: int = 25
    inducing_seed: int = 86
    theta_init: Tuple[float, float, float] = (1.0, 0.6, 0.5)


@dataclass(frozen=True)
class PendulumConfig:
    """Pendulum_Wishart_2d.ipynb cells 4-17."""

    n_steps: int = 700
    n_train: int = 300
    max_time: float = 7.0
    qc: float = 0.01
    obs_var: float = 0.1
    m_inducing: int = 48
    prior_v_var: float = 50.0
    wishart_df: float = 100.0
    vmp_iters: int = 10
    adamax_steps: int = 100
    epochs: int = 150
    reference_smse: Tuple[float, float] = (0.005455, 0.001077)
    reference_ut_smse: Tuple[float, float] = (0.006313, 0.000800)
    reference_seconds: float = 1615.25
