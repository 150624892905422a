"""Declarative model front-end: the reference's ``@model`` ergonomics as
four dataclasses that lower onto the structured inference programs.

Counterpart of ``gaussianprocessnode_tpu/infer/model.py``, with the same
classes, fields, defaults and methods. The reference's four model shapes:

    SGPRegression       y_i ~ UniSGP(x_i, v, w, θ)            (+ PointMass w)
    SGPClassification   f_i ~ UniSGP(x_i, v, w, θ); y_i ~ Probit(f_i)
    GPSSM               x_t ~ MultiSGP(x_{t-1}, v, W, θ); y_t ~ MvN(x_t, P)
    GPLVM               y_i ~ MultiSGP(x_i, v, W, θ); x_i latent

Example (GPT_regression.ipynb cells 6-10):

    model = SGPRegression(kernel=Kernel("se", transform="softplus"),
                          Xu=Xu, prior_v_var=50.0, prior_w=(1e-2, 1e-2))
    result = model.infer(theta, X, y, iterations=7)
    theta, fe_trace, res = model.fit(theta0, X, y, epochs=300)
    mean, var = model.predict(theta, res, X_test)

Everything runs on the device of ``Xu``; the priors are made there in the
data's dtype.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..dists import GammaShapeRate, MvGaussianNat, gamma_mean
from ..ops.kernels import Kernel
from . import batch_vmp, chain_smoother, gplvm, training

__all__ = ["SGPRegression", "SGPClassification", "GPSSM", "GPLVM"]


def _prior_nat(M, var, dtype, device):
    return MvGaussianNat(torch.zeros(M, dtype=dtype, device=device),
                         torch.eye(M, dtype=dtype, device=device) / var)


def _gamma(ab, dtype, device):
    return GammaShapeRate(torch.tensor(ab[0], dtype=dtype, device=device),
                          torch.tensor(ab[1], dtype=dtype, device=device))


@dataclass(frozen=True)
class SGPRegression:
    """v ~ MvN(0, σ_v²·I); w ~ Γ(a,b) or PointMass; y_i ~ UniSGP(x_i, v, w, θ).
    Mean-field q(v)q(w) (reference: GPT_regression.ipynb cell 6)."""

    kernel: Kernel
    Xu: torch.Tensor
    prior_v_var: float = 50.0
    prior_w: Tuple[float, float] = (1e-2, 1e-2)
    w_fixed: Optional[float] = None

    def _priors(self, dtype):
        dev = self.Xu.device
        return (_prior_nat(self.Xu.shape[0], self.prior_v_var, dtype, dev),
                _gamma(self.prior_w, dtype, dev))

    def infer(self, theta, X, y, iterations: int = 7):
        pv, pw = self._priors(X.dtype)
        return batch_vmp.regression_vmp(self.kernel, theta, self.Xu, X, y, pv, pw,
                                        n_iters=iterations, w_fixed=self.w_fixed)

    def fit(self, theta0, X, y, epochs: int = 300, iterations: int = 7):
        pv, pw = self._priors(X.dtype)
        return training.fit_regression(self.kernel, theta0, self.Xu, X, y, pv, pw,
                                       epochs=epochs, n_iters=iterations)

    def _w(self, result):
        return self.w_fixed if self.w_fixed is not None else gamma_mean(result.qw)

    def predict(self, theta, result, X_test):
        mu_v = result.qv.mean
        w = torch.as_tensor(self._w(result), dtype=mu_v.dtype, device=mu_v.device)
        return batch_vmp.predict_out(self.kernel, theta, self.Xu, X_test, mu_v, w)

    def predictor(self, theta, result):
        """Frozen serving handle for the inferred posterior (serve.py)."""
        from ..serve import SGPRegressor

        return SGPRegressor.from_natural(self.kernel, theta, self.Xu, result.qv_nat,
                                         self._w(result), device=self.Xu.device)


@dataclass(frozen=True)
class SGPClassification:
    """f_i ~ UniSGP(x_i, v, w, θ); y_i ~ Probit(f_i); q(f)q(v)q(w)
    (reference: GPT_classification.ipynb cell 7)."""

    kernel: Kernel
    Xu: torch.Tensor
    prior_v_var: float = 50.0
    prior_w: Tuple[float, float] = (1e-2, 1e-2)
    init_w: Tuple[float, float] = (1e-2, 1e-2)

    def _priors(self, dtype):
        dev = self.Xu.device
        return (_prior_nat(self.Xu.shape[0], self.prior_v_var, dtype, dev),
                _gamma(self.prior_w, dtype, dev), _gamma(self.init_w, dtype, dev))

    def infer(self, theta, X, y, iterations: int = 30):
        pv, pw, iw = self._priors(X.dtype)
        return batch_vmp.classification_vmp(self.kernel, theta, self.Xu, X, y, pv, pw, iw,
                                            n_iters=iterations)

    def fit(self, theta0, X, y, epochs: int = 500, iterations: int = 30):
        pv, pw, iw = self._priors(X.dtype)
        return training.fit_classification(self.kernel, theta0, self.Xu, X, y, pv, pw, iw,
                                           epochs=epochs, n_iters=iterations)

    def predict_proba(self, theta, result, X_test):
        return batch_vmp.predict_probit(self.kernel, theta, self.Xu, X_test, result.qv.mean,
                                        gamma_mean(result.qw))

    def predictor(self, theta, result):
        """Frozen serving handle for the inferred posterior (serve.py)."""
        from ..serve import SGPClassifier

        return SGPClassifier.from_natural(self.kernel, theta, self.Xu, result.qv_nat,
                                          result.qw, device=self.Xu.device)


@dataclass(frozen=True)
class GPSSM:
    """x_t ~ MultiSGP(x_{t-1}, v, W, θ); y_t ~ MvN(x_t, P); W ~ Wishart
    (reference: Pendulum_Wishart_2d.ipynb cell 12)."""

    kernel: Kernel
    Xu: torch.Tensor
    obs_cov: torch.Tensor
    prior_x0_mean: torch.Tensor
    prior_x0_cov: torch.Tensor
    prior_v_var: float = 50.0
    wishart_df: float = 100.0

    def infer(self, theta, ys, iterations: int = 10, compute_fe: bool = True):
        M = self.Xu.shape[0]
        D = ys.shape[1]
        pv = _prior_nat(M * D, self.prior_v_var, ys.dtype, ys.device)
        return chain_smoother.gpssm_vmp(
            self.kernel, theta, self.Xu, ys, self.obs_cov, self.prior_x0_mean,
            self.prior_x0_cov, pv, self.wishart_df,
            torch.eye(D, dtype=ys.dtype, device=ys.device), n_iters=iterations,
            compute_fe=compute_fe)

    def predict(self, theta, state, ys_test):
        return chain_smoother.one_step_ahead(self.kernel, theta, self.Xu, state, ys_test,
                                             self.obs_cov)

    def predictor(self, theta, state):
        """Frozen streaming serving handle for the smoothed state
        (serve.py); unlike :meth:`predict` it returns its carry, so windows
        chain."""
        from ..serve import GPSSMFilter

        return GPSSMFilter.from_state(self.kernel, theta, self.Xu, state, self.obs_cov)


@dataclass(frozen=True)
class GPLVM:
    """y_i ~ MultiSGP(x_i, v, W=w·I, θ); x_i ~ MvN(x̄_i, σ_x²·I); whitened
    v-prior (reference: GPLVM.ipynb cell 12)."""

    kernel: Kernel
    Xu: torch.Tensor
    w_fixed: float = 100.0
    x_prior_var: float = 100.0

    def infer(self, theta, Y, x_init_means, iterations: int = 6):
        return gplvm.gplvm_vmp(self.kernel, theta, self.Xu, Y, x_init_means,
                               x_prior_cov_scale=self.x_prior_var, W_val=self.w_fixed,
                               n_iters=iterations)
