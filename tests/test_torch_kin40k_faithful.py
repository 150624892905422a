"""The port's faithful kin40k trainer (``infer/minibatch.py::fit_kin40k``,
the reference's per-batch schedule) against the JAX package's, on the CPU,
epoch by epoch, in float64 and float32, at the fast trainer's parity
configuration (``test_torch_minibatch.py``: M = 32, D = 3, N = 512 in 4
batches, w = 1e4).

The first epoch of both starts from no carry (each trainer's own initial
state: q(v) at the prior, zero warm starts); each later epoch resumes the
JAX trainer from its carry, and the port both from its own carry and from
``convert.banana_state_from_jax`` of the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.dists import MvGaussianNat as JNat
from gaussianprocessnode_tpu.infer import minibatch as jmb
from gaussianprocessnode_tpu.ops.kernels import Kernel as JKernel
from gaussianprocessnode_tpu_torch import convert
from gaussianprocessnode_tpu_torch.dists import MvGaussianNat
from gaussianprocessnode_tpu_torch.infer import minibatch as tmb
from gaussianprocessnode_tpu_torch.ops.kernels import Kernel
from test_torch_minibatch import B, W, trainer_case

EPOCHS = 3
FIELDS = ("xi_v", "prec_v", "cov_v", "kuu_inv", "theta")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _from_jax(carry):
    return convert.banana_state_from_jax(jax.tree.map(np.asarray, carry), device="cpu")


def faithful_parity(dtype, tol):
    c = trainer_case(dtype)
    ja = dict(kernel=JKernel("se", "softplus", use_pallas=True),
              theta0=jnp.asarray(c["theta0"]), Xu=jnp.asarray(c["Xu"]),
              X_batched=jnp.asarray(c["Xb"]), y_batched=jnp.asarray(c["yb"]),
              prior_v=JNat(jnp.asarray(c["xi0"]), jnp.asarray(c["prec0"])), w_val=W)
    ta = dict(kernel=Kernel("se", "softplus", use_kernel=True),
              theta0=torch.as_tensor(c["theta0"]), Xu=torch.as_tensor(c["Xu"]),
              X_batched=torch.as_tensor(c["Xb"]), y_batched=torch.as_tensor(c["yb"]),
              prior_v=MvGaussianNat(torch.as_tensor(c["xi0"]), torch.as_tensor(c["prec0"])),
              w_val=W)
    jcarry = tcarry = None
    errs = []
    for e in range(EPOCHS):
        jth, jnat, jnext = jmb.fit_kin40k(**ja, epochs=1, resume_state=jcarry)
        tth, tnat, tcarry = tmb.fit_kin40k(**ta, epochs=1, resume_state=tcarry)
        err = {f: _rel(getattr(tcarry, f).numpy(), getattr(jnext, f)) for f in FIELDS}
        if jcarry is not None:
            _, _, rcarry = tmb.fit_kin40k(**ta, epochs=1, resume_state=_from_jax(jcarry))
            err["resume"] = max(_rel(getattr(rcarry, f).numpy(), getattr(jnext, f))
                                for f in FIELDS)
        jcarry = jnext
        errs.append(err)
        assert tth.dtype == torch.from_numpy(c["theta0"]).dtype
        assert tnat.prec.dtype == tcarry.cov_v.dtype == torch.float64
        assert torch.equal(tnat.xi, tcarry.xi_v) and torch.equal(tth, tcarry.theta)
        assert int(tcarry.opt_state["count"]) == int(jnext.opt_state[2][0].count) == (e + 1) * B
        assert tcarry.w_shape.dtype == tcarry.theta.dtype and float(tcarry.w_rate) == 0.0
        for k, v in err.items():
            assert v <= tol.get(k, tol["carry"]), (e + 1, k, errs)
    return errs


# f64: the per-batch refresh inverts Λ (κ ≈ 1e7–1e8) by warm-started
# Newton–Schulz, a gain of up to κ on other summation orders: κ·ε₆₄ ≈ 1e-8,
# as for the fast trainer; measured ≤ 6.1e-12 over three epochs. f32 θ:
# the fast trainer's f32 bound, 2e-5 (a few hundred ε₃₂ in θ's gradient,
# carried by AdaMax and through the f32 Gram into ξ, Λ; measured ≤ 2.2e-6);
# the warm f32 Kuu⁻¹ itself carries its rounding with a gain of up to
# κ(Kuu) ≈ 2.7e3 here: κ·ε₃₂ = 3.2e-4 (measured ≤ 2.8e-5), and so does an
# epoch resumed from the JAX carry, which holds JAX's Kuu⁻¹.
@pytest.mark.parametrize("dtype,tol", [
    (np.float64, dict(carry=1e-8)),
    (np.float32, dict(carry=2e-5, kuu_inv=3.2e-4, resume=3.2e-4)),
], ids=["f64", "f32"])
def test_fit_kin40k_matches_jax_epoch_by_epoch(dtype, tol):
    faithful_parity(dtype, tol)


def test_q_v_resets_each_epoch():
    """Per-epoch reset (regression_kin40k.ipynb cell 9): Λ after 3 epochs
    holds the prior plus one pass of the data, not three; resuming gives
    the same bits as one call of 3 epochs."""
    c = trainer_case(np.float64)
    ta = dict(kernel=Kernel("se", "softplus", use_kernel=True),
              theta0=torch.as_tensor(c["theta0"]), Xu=torch.as_tensor(c["Xu"]),
              X_batched=torch.as_tensor(c["Xb"]), y_batched=torch.as_tensor(c["yb"]),
              prior_v=MvGaussianNat(torch.as_tensor(c["xi0"]), torch.as_tensor(c["prec0"])),
              w_val=W)
    _, nat1, carry = tmb.fit_kin40k(**ta, epochs=1)
    th3, nat3, _ = tmb.fit_kin40k(**ta, epochs=3)
    assert float(torch.trace(nat3.prec)) < 1.5 * float(torch.trace(nat1.prec))
    for _ in range(2):
        th, nat, carry = tmb.fit_kin40k(**ta, epochs=1, resume_state=carry)
    assert torch.equal(th, th3) and torch.equal(nat.prec, nat3.prec)


def test_ns_budget_matches_jax():
    """``ns_budget`` sets both Newton–Schulz counts (the objective's Kuu⁻¹
    and the per-batch q(v) refresh), as in the JAX trainer: 2 epochs at
    budget 20 in float64 agree to the f64 bound of the default budget's
    test above (1e-8: κ(Λ)·ε₆₄). Warm-started, budgets 20 and 34 both reach
    the f64 floor; a budget of 3 does not, and its q(v) inverse differs by
    far more than the parity error (the count reaches the result)."""
    c = trainer_case(np.float64)
    ja = dict(kernel=JKernel("se", "softplus", use_pallas=True),
              theta0=jnp.asarray(c["theta0"]), Xu=jnp.asarray(c["Xu"]),
              X_batched=jnp.asarray(c["Xb"]), y_batched=jnp.asarray(c["yb"]),
              prior_v=JNat(jnp.asarray(c["xi0"]), jnp.asarray(c["prec0"])), w_val=W)
    ta = dict(kernel=Kernel("se", "softplus", use_kernel=True),
              theta0=torch.as_tensor(c["theta0"]), Xu=torch.as_tensor(c["Xu"]),
              X_batched=torch.as_tensor(c["Xb"]), y_batched=torch.as_tensor(c["yb"]),
              prior_v=MvGaussianNat(torch.as_tensor(c["xi0"]), torch.as_tensor(c["prec0"])),
              w_val=W)
    _, _, jcarry = jmb.fit_kin40k(**ja, epochs=2, ns_budget=20)
    _, _, tcarry = tmb.fit_kin40k(**ta, epochs=2, ns_budget=20)
    _, _, tshort = tmb.fit_kin40k(**ta, epochs=2, ns_budget=3)
    errs = {f: _rel(getattr(tcarry, f).numpy(), getattr(jcarry, f)) for f in FIELDS}
    assert max(errs.values()) <= 1e-8, errs
    assert _rel(tshort.cov_v.numpy(), tcarry.cov_v.numpy()) > 1e3 * errs["cov_v"]
