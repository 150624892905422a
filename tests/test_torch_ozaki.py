"""The port's Ozaki f64 product (``ops/ozaki.py``) against the JAX
package's, on the CPU: every case of tests/test_ozaki.py through both
packages. The two compute the same arithmetic (the same power-of-2 table,
the same half-to-even rounding of the 7-bit chunks, exact int32 group
products, the same order of the f64 accumulation and scaling), so their
results must be bit-equal; the numpy limits are the JAX tests' own, on
the JAX tests' own draws (``_jax_test_draws``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.ops.ozaki import ozaki_matmul as jax_ozaki
from gaussianprocessnode_tpu_torch.ops import ozaki
from gaussianprocessnode_tpu_torch.ops.ozaki import ozaki_matmul

torch.set_num_threads(1)


def _jax_test_draws():
    """tests/test_ozaki.py's inputs: its module generator (default_rng(7))
    drawn in its file order."""
    rng = np.random.default_rng(7)
    d = {}
    for shape in ((60, 40, 50), (128, 600, 64)):
        m, k, n = shape
        d[shape] = (rng.standard_normal((m, k)), rng.standard_normal((k, n)))
    m = k = n = 48
    A = rng.standard_normal((m, k)) * (10.0 ** rng.uniform(-12, 12, (m, 1)))
    B = rng.standard_normal((k, n)) * (10.0 ** rng.uniform(-12, 12, (1, n)))
    d["wild"] = (A, B)
    M = 96
    Q = rng.standard_normal((M, M))
    S = (Q * 10.0 ** np.linspace(-6, 6, M)) @ Q.T  # κ = 1e12, the kin40k regime
    d["spd"] = (S + S.T) / 2.0
    d["slices"] = (rng.standard_normal((64, 64)), rng.standard_normal((64, 64)))
    return d


DRAWS = _jax_test_draws()


def _both(A, B, **kw):
    """(port, JAX) results as numpy arrays; asserts they are bit-equal."""
    C = ozaki_matmul(torch.as_tensor(A), torch.as_tensor(B), **kw).numpy()
    C_jax = np.asarray(jax_ozaki(jnp.asarray(A), jnp.asarray(B), **kw))
    assert C.dtype == C_jax.dtype == np.float64
    np.testing.assert_array_equal(C, C_jax)
    return C


def _relerr(C, C_ref):
    return float(np.max(np.abs(C - C_ref)) / np.max(np.abs(C_ref)))


@pytest.mark.parametrize("shape", [(60, 40, 50), (128, 600, 64)])
def test_matches_jax_bitwise_and_numpy_f64(shape):
    A, B = DRAWS[shape]
    assert _relerr(_both(A, B), A @ B) < 1e-14  # measured ≤ 1.2e-15


def test_wild_dynamic_range():
    A, B = DRAWS["wild"]
    C_ref = A @ B
    rel = np.abs(_both(A, B) - C_ref) / np.maximum(np.abs(C_ref), 1e-300)
    assert float(np.max(rel)) < 1e-12


def test_spd_product_stays_symmetric_psd():
    S = DRAWS["spd"]
    C = _both(S, S)
    assert _relerr(C, S @ S) < 1e-14
    np.testing.assert_allclose(C, C.T, rtol=1e-13)


def test_zero_rows_and_exact_integers():
    A = np.zeros((8, 8))
    A[2, 3] = 3.0
    A[5, :] = np.arange(8)
    np.testing.assert_array_equal(_both(A, np.eye(8)), A)


@pytest.mark.parametrize("n_slices,limit", [(6, 5e-11), (4, 5e-7)])
def test_fewer_slices_degrade_gracefully(n_slices, limit):
    A, B = DRAWS["slices"]
    C_ref = A @ B
    e = _relerr(_both(A, B, n_slices=n_slices), C_ref)
    assert e < limit  # ~(7·n_slices − 1)-bit envelope
    assert e > _relerr(_both(A, B), C_ref)


def test_near_overflow_magnitudes():
    A = np.full((2, 8), 2.0 ** 1022)
    A[1, 3] = -(2.0 ** 1021)
    np.testing.assert_array_equal(_both(A, np.eye(8)), A)
    A2 = np.full((2, 8), 2.0 ** -1021)
    np.testing.assert_array_equal(_both(A2, np.eye(8)), A2)


def test_rejects_f32():
    with pytest.raises(TypeError):
        ozaki_matmul(torch.zeros((4, 4)), torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        ozaki_matmul(torch.zeros((4, 4), dtype=torch.float64), torch.zeros((4, 4)))


def test_rejects_an_inner_length_that_could_overflow_int32():
    """n_slices·k ≥ 2^19 could carry a group's sum past 2^31 − 1."""
    k = (1 << 19) // ozaki.OZAKI_SLICES
    with pytest.raises(ValueError, match="overflow"):
        ozaki_matmul(torch.ones((1, k), dtype=torch.float64),
                     torch.ones((k, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="overflow"):  # k padded to a multiple of 8
        ozaki_matmul(torch.ones((1, k - 7), dtype=torch.float64),
                     torch.ones((k - 7, 1), dtype=torch.float64))
    assert ozaki_matmul(torch.ones((1, k - 8), dtype=torch.float64),
                        torch.ones((k - 8, 1), dtype=torch.float64)).item() == k - 8


@pytest.mark.parametrize("shape", [(5, 13, 7), (16, 16, 16), (20, 9, 3), (1, 1, 1)])
def test_cuda_padding_keeps_the_bits(shape):
    """The zero padding to torch._int_mm's CUDA shape rules (> 16 rows, k and
    n multiples of 8), which ozaki_matmul applies on every device, gives the
    bits of JAX's unpadded product, and a product of the padded operands
    gives them in its first m rows and n columns."""
    rng = np.random.default_rng(11)
    m, k, n = shape
    A = rng.standard_normal((m, k)) * 10.0 ** rng.uniform(-3, 3, (m, 1))
    B = rng.standard_normal((k, n))
    Ap, Bp = ozaki._padded(torch.as_tensor(A), torch.as_tensor(B))
    assert Ap.shape[0] > 16 and Ap.shape[1] % 8 == 0 and Bp.shape[1] % 8 == 0
    C = _both(A, B)
    assert C.shape == (m, n)
    assert np.array_equal(ozaki_matmul(Ap, Bp)[:m, :n].numpy(), C)
