"""The port's batched L-BFGS (``infer/training.py::lbfgs_solve_batched``)
against ``jax.vmap`` of the JAX package's ``lbfgs_solve``, on the CPU in
float64.

The rows are chosen so that their linesearches end at different
iterations: Rosenbrock valleys of three steepnesses, an ill-scaled
quadratic (curvatures 1 and 1e4), a linear row whose linesearch never meets
the curvature condition (it fails at its 20th iteration and takes the safe
step, every step), and a row started at the kink of ‖x‖, whose gradient is
NaN: its iterate is not finite, so it keeps its point. Each row is also
held to the port's single-problem ``lbfgs_solve`` of that row alone, which
counts the row's own linesearch iterations.

Tolerances: the iterates to 1e-12 relative to JAX (the two packages sum
the two-loop recursion's dot products in other orders; measured ≤ 3e-14 on
these O(1) rows), and the values at each step's start to 1e-12 of the
row's largest value (the quadratic row descends to ~1e-22, where its last
digits are rounding); the single-problem port runs the same arithmetic row
for row, held to 1e-13 (measured: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.infer import training as jt
from gaussianprocessnode_tpu_torch.infer import training as tt

STEPS = 12
# per row: weights of (Rosenbrock, ill-scaled quadratic, linear, ‖x‖)
P = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [10.0, 0.0, 0.0, 0.0],
    [100.0, 0.0, 0.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])
X0 = np.array([[-1.2, 1.0], [-1.2, 1.0], [0.5, -0.3], [3.0, 2.0], [0.3, 0.4], [0.0, 0.0]])
LINEAR, KINK = 4, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jrow(x, p):
    ros = p[0] * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
    quad = p[1] * (0.5 * x[0] ** 2 + 5e3 * x[1] ** 2 + 0.1 * x[0] ** 4)
    lin = p[2] * (-x[0] - 2 * x[1])
    norm = jnp.where(p[3] != 0, p[3] * jnp.sqrt(x[0] ** 2 + x[1] ** 2), 0.0)
    return ros * (p[0] != 0) + quad + lin + norm


def _trows(X, Pt):
    ros = Pt[:, 0] * (X[:, 1] - X[:, 0] ** 2) ** 2 + (1 - X[:, 0]) ** 2
    quad = Pt[:, 1] * (0.5 * X[:, 0] ** 2 + 5e3 * X[:, 1] ** 2 + 0.1 * X[:, 0] ** 4)
    lin = Pt[:, 2] * (-X[:, 0] - 2 * X[:, 1])
    norm = torch.where(Pt[:, 3] != 0, Pt[:, 3] * torch.sqrt(X[:, 0] ** 2 + X[:, 1] ** 2), 0.0)
    return ros * (Pt[:, 0] != 0) + quad + lin + norm


@pytest.fixture(scope="module")
def jax_result():
    run = jax.jit(jax.vmap(lambda x0, p: jt.lbfgs_solve(lambda x: _jrow(x, p), x0,
                                                         max_steps=STEPS)))
    x, v = run(jnp.asarray(X0), jnp.asarray(P))
    return np.asarray(x), np.asarray(v).T  # values as (steps, rows)


def _batched(rows):
    Pt = torch.as_tensor(P[rows])
    counts = {}
    x, v = tt.lbfgs_solve_batched(lambda X: _trows(X, Pt), torch.as_tensor(X0[rows]),
                                  STEPS, counts=counts)
    return x.numpy(), v.numpy(), counts


def _single(i):
    Pt = torch.as_tensor(P[i:i + 1])
    counts = {}
    x, _ = tt.lbfgs_solve(lambda x: _trows(x[None], Pt)[0], torch.as_tensor(X0[i]), STEPS,
                          counts=counts)
    return x.numpy(), counts


def test_rows_match_jax_vmap(jax_result):
    jx, jv = jax_result
    x, v, _ = _batched(slice(None))
    scale = np.maximum(np.abs(jx).max(axis=1, keepdims=True), 1.0)
    assert np.all(np.abs(x - jx) <= 1e-12 * scale), np.abs(x - jx)
    assert np.all(np.abs(v - jv) <= 1e-12 * np.abs(jv).max(axis=0)), np.abs(v - jv)
    # the kink row never moves; the linear row took 2^19 safe steps
    assert np.array_equal(x[KINK], X0[KINK])
    assert np.all(np.abs(x[LINEAR]) > 1e6)


def test_rows_match_the_single_problem_solver_and_stop_at_their_own_iteration():
    x, _, counts = _batched(slice(None))
    singles = [_single(i) for i in range(len(P))]
    for i, (xi, _) in enumerate(singles):
        np.testing.assert_allclose(x[i], xi, rtol=1e-13, atol=0)
    iters = [c["linesearch_steps"] for _, c in singles]
    assert len(set(iters[:LINEAR])) == LINEAR, iters  # each row its own count
    # the failing rows exhaust 20 iterations at every step, so the batch does
    assert iters[LINEAR] == iters[KINK] == counts["linesearch_steps"] == 20 * STEPS
    # one host read per linesearch iteration, one evaluation per iteration
    # plus one per step
    assert counts["host_reads"] == counts["linesearch_steps"]
    assert counts["evaluations"] == counts["linesearch_steps"] + STEPS


def test_the_batch_runs_until_its_slowest_row():
    """Without the failing rows the batch's iterations per step are the
    largest of its rows', so the total lies between the slowest row's and
    the sum of all rows'."""
    rows = slice(0, LINEAR)
    _, _, counts = _batched(rows)
    iters = [_single(i)[1]["linesearch_steps"] for i in range(LINEAR)]
    assert max(iters) <= counts["host_reads"] < sum(iters), (counts, iters)
