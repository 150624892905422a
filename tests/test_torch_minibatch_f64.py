"""The port's fast trainer against the JAX package's with float64 θ, on the
CPU, epoch by epoch over three epochs (``test_torch_minibatch.py`` holds the
float32 configurations and the harness). One configuration decays the
learning rate, so the schedule's state is carried through
``fast_state_from_jax`` too.
"""

import numpy as np
import pytest

from test_torch_minibatch import trainer_parity

# Both packages do the same f64 operations in other summation orders. The
# refresh inverts Λ (κ ≈ 1e7–1e8 here) by Newton–Schulz, which carries a
# rounding perturbation with a gain of up to κ(Λ), into μ_v and Rv and so
# into θ's gradient: κ·ε₆₄ ≈ 1e-8. Measured ≤ 1.5e-10 over three epochs.
F64_TOL = dict(theta=1e-8, xi=1e-8, prec=1e-8, resume=1e-8)


@pytest.mark.parametrize("stats_refreshes,lr_decay_rate", [(1, 1.0), (2, 0.5)])
def test_fit_kin40k_fast_f64_matches_jax_epoch_by_epoch(stats_refreshes, lr_decay_rate):
    trainer_parity(np.float64, stats_refreshes, lr_decay_rate, F64_TOL)
