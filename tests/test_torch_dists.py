"""Parity of the port's dists.py Wishart family, multivariate Gaussian
helpers and entropies with the JAX package's, on the CPU.

Seeded SPD matrices of d = 1, 2, 3 (AAᵀ + I/2 from a standard-normal A);
degrees of freedom d + 2 (the MultiSGP w-message's) and d + 8.5. Tolerance:
float64, 1e-13 relative to the result's largest entry (measured ≤ 2.7e-14,
the entropy at d = 3, df = 5, whose terms cancel to a tenth of their size;
the Cholesky factors, digamma and log-gamma agree to a few ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu import dists as jd
from gaussianprocessnode_tpu_torch import dists as td

RTOL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: torch's intra-op threads would only
    contend with the other test workers' (4x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL):
    g = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.max(np.abs(w)), 1e-300)
    assert np.max(np.abs(g - w)) <= rtol * scale, np.max(np.abs(g - w)) / scale


def _spd(d, seed):
    A = np.random.default_rng(seed).standard_normal((d, d))
    return A @ A.T + 0.5 * np.eye(d)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("df_extra", [2.0, 8.5])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_wishart_moments_and_entropy_match_jax(d, df_extra, fast):
    S = _spd(d, d)
    jq = (jd.WishartFast if fast else jd.Wishart)(jnp.asarray(d + df_extra), jnp.asarray(S))
    tq = (td.WishartFast if fast else td.Wishart)(torch.tensor(d + df_extra, dtype=torch.float64),
                                                 torch.as_tensor(S))
    close(td.wishart_mean(tq), jd.wishart_mean(jq))
    close(td.wishart_mean_logdet(tq), jd.wishart_mean_logdet(jq))
    close(td.wishart_entropy(tq), jd.wishart_entropy(jq))


def test_wishart_rejects_other_types():
    with pytest.raises(TypeError):
        td.wishart_mean(td.PointMass(torch.eye(2)))
    with pytest.raises(TypeError):
        td.wishart_mean_logdet(td.PointMass(torch.eye(2)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_mv_gaussian_helpers_match_jax(d):
    rng = np.random.default_rng(10 + d)
    m, V = rng.standard_normal(d), _spd(d, 20 + d)
    jn = jd.mv_meancov_to_nat(jd.MvGaussian(jnp.asarray(m), jnp.asarray(V)))
    tn = td.mv_meancov_to_nat(td.MvGaussian(torch.as_tensor(m), torch.as_tensor(V)))
    close(tn.xi, jn.xi)
    close(tn.prec, jn.prec)
    back = td.mv_nat_to_meancov(tn)
    close(back.mean, m, 1e-12)
    close(back.cov, V, 1e-12)
    jp = jd.mv_gaussian_prod_nat(jn, jn)
    tp = td.mv_gaussian_prod_nat(tn, tn)
    close(tp.xi, jp.xi)
    close(tp.prec, jp.prec)
    close(td.mv_gaussian_entropy(td.MvGaussian(torch.as_tensor(m), torch.as_tensor(V))),
          jd.mv_gaussian_entropy(jd.MvGaussian(jnp.asarray(m), jnp.asarray(V))))
    close(td.mv_gaussian_entropy_from_prec(tn.prec),
          jd.mv_gaussian_entropy_from_prec(jn.prec))


def test_float32_wishart_stays_in_float32():
    """Digamma and log-gamma run in the parameter's dtype."""
    q = td.WishartFast(torch.tensor(4.0), torch.as_tensor(_spd(2, 1), dtype=torch.float32))
    for v in (td.wishart_mean(q), td.wishart_mean_logdet(q), td.wishart_entropy(q)):
        assert v.dtype == torch.float32
    jq = jd.WishartFast(jnp.asarray(4.0, jnp.float32), jnp.asarray(_spd(2, 1), jnp.float32))
    close(td.wishart_entropy(q), jax.device_get(jd.wishart_entropy(jq)), 1e-6)
