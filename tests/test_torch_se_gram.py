"""The SE Gram kernel module (ops/se_gram.py): its plain version against the
JAX package's Pallas kernel, its analytic VJP against jax.grad, its input
checks and its build. The kernel itself runs only on a CUDA card:
tests/test_torch_gpu.py holds it against this plain version there.

The JAX Pallas kernel runs through the Pallas interpreter on the CPU, as
tests/test_sharding.py runs it. Tolerances are stated per test.
"""

import ctypes
import re
import stat
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessnode_tpu.ops import pallas_gram as pg
from gaussianprocessnode_tpu_torch.ops import _build
from gaussianprocessnode_tpu_torch.ops import se_gram as sg

CU = Path(sg.__file__).resolve().parent / "csrc" / "se_gram.cu"


def _interpret(fn):
    pg._INTERPRET = True
    jax.clear_caches()  # se_gram_pallas's jit trace depends on the flag
    try:
        return fn()
    finally:
        pg._INTERPRET = False
        jax.clear_caches()


def _case(seed, M, N, D, ard):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((M, D)).astype(np.float32)
    X = rng.standard_normal((N, D)).astype(np.float32)
    ls = (rng.uniform(0.7, 2.5, D) if ard else np.array(1.3)).astype(np.float32)
    return Z, X, np.float32(0.8), ls


@pytest.mark.parametrize("M,N,D,ard", [(300, 700, 8, True), (37, 101, 3, False)])
def test_reference_matches_pallas_kernel_interpreted(M, N, D, ard):
    """se_gram_reference against the Pallas kernel (padding, tiling and all),
    float32: 1e-6 absolute on σ² = 0.8 — a few ulp of the largest entry,
    the f32 rounding of the expanded form."""
    Z, X, var, ls = _case(0, M, N, D, ard)
    want = _interpret(lambda: np.asarray(
        pg.se_gram_pallas(jnp.asarray(Z), jnp.asarray(X), var, jnp.asarray(ls))))
    got = sg.se_gram_reference(torch.as_tensor(Z), torch.as_tensor(X),
                               torch.tensor(var), torch.as_tensor(ls))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("device,dtype,route", [
    ("cpu", torch.float32, "plain"),
    ("cpu", torch.float64, "plain"),
    ("cuda", torch.float32, "kernel"),
    ("cuda:1", torch.float32, "kernel"),
    ("cuda", torch.float64, "plain"),
    ("cuda", torch.float16, "plain"),
    ("cuda", torch.bfloat16, "plain"),
    ("meta", torch.float64, "plain"),
])
def test_route_by_device_and_dtype(device, dtype, route):
    """The kernel only for float32 on a CUDA card; every other dtype takes
    the plain Gram, as pallas_gram.se_gram_auto keeps f64 off its kernel."""
    assert sg.se_gram_route(device, dtype) == route


def test_route_refuses_float32_on_a_device_without_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        sg.se_gram_route("meta", torch.float32)


@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.float64)])
def test_auto_takes_the_plain_gram_for_non_float32(dtypes):
    """se_gram_auto against the JAX se_gram_auto in f64 (its jnp path):
    1e-12 relative (the inputs are f32 values, exact in f64, so a float32 Z
    beside a float64 X changes nothing); no kernel launch, the result in
    the promoted dtype."""
    Z, X, var, ls = _case(11, 25, 40, 5, True)
    want = np.asarray(pg.se_gram_auto(jnp.asarray(Z, np.float64), jnp.asarray(X, np.float64),
                                      jnp.asarray(var, np.float64),
                                      jnp.asarray(ls, np.float64)))
    before = sg.se_gram_cuda.launches
    got = sg.se_gram_auto(torch.as_tensor(Z, dtype=dtypes[0]),
                          torch.as_tensor(X, dtype=dtypes[1]),
                          torch.tensor(var, dtype=torch.float64),
                          torch.as_tensor(ls, dtype=torch.float64))
    assert sg.se_gram_cuda.launches == before
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_matches_jax_se_gram(dtype):
    """In f64 as well: the plain version is the JAX package's jnp SE Gram
    (se_gram_auto's path off the TPU), 1e-12 relative in f64 and 1e-6
    absolute in f32."""
    Z, X, var, ls = _case(2, 25, 40, 5, True)
    npd = np.float64 if dtype == torch.float64 else np.float32
    want = np.asarray(pg.se_gram_auto(jnp.asarray(Z, npd), jnp.asarray(X, npd),
                                      jnp.asarray(var, npd), jnp.asarray(ls, npd)))
    got = sg.se_gram_reference(torch.as_tensor(Z, dtype=dtype), torch.as_tensor(X, dtype=dtype),
                               torch.tensor(var, dtype=dtype), torch.as_tensor(ls, dtype=dtype))
    if dtype == torch.float64:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ard", [True, False])
def test_fused_vjp_matches_jax_grad(ard):
    """The analytic VJP of se_gram_fused (σ̄², ℓ̄, Z̄, X̄) against jax.grad of
    the JAX se_gram_fused, f64: 1e-10 relative (both are the same GEMM
    formulas; they differ in summation order only)."""
    rng = np.random.default_rng(3)
    Z = rng.standard_normal((7, 3))
    X = rng.standard_normal((11, 3))
    ls = np.array([0.7, 1.1, 1.4]) if ard else np.array(0.9)
    var = np.array(1.3)
    G = rng.standard_normal((7, 11))

    def loss(Z, X, v, l):
        return jnp.sum(jnp.asarray(G) * pg.se_gram_fused(Z, X, v, l))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(Z), jnp.asarray(X), jnp.asarray(var), jnp.asarray(ls))
    args = [torch.tensor(a, requires_grad=True) for a in (Z, X, var, ls)]
    torch.sum(torch.as_tensor(G) * sg.se_gram_fused(*args)).backward()
    for a, w in zip(args, want):
        assert tuple(a.grad.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("ard", [True, False])
def test_fused_vjp_matches_autograd_of_plain_version(ard):
    """The analytic VJP against torch autograd through the plain version
    (f64, 1e-9 relative, as tests/test_core.py holds the JAX VJP)."""
    rng = np.random.default_rng(4)
    vals = (rng.standard_normal((6, 2)), rng.standard_normal((9, 2)), np.array(2.0),
            np.array([0.8, 1.3]) if ard else np.array(0.9))
    G = torch.as_tensor(rng.standard_normal((6, 9)))
    a1 = [torch.tensor(v, requires_grad=True) for v in vals]
    a2 = [torch.tensor(v, requires_grad=True) for v in vals]
    torch.sum(G * sg.se_gram_fused(*a1) ** 2).backward()
    torch.sum(G * sg.se_gram_reference(*a2) ** 2).backward()
    for x, y in zip(a1, a2):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("ard", [True, False])
def test_fused_vjp_is_differentiable_again(ard):
    """The VJP under create_graph (reverse over reverse, as the MultiSGP
    Laplace rule takes its Hessian): K is saved as the Function's output
    and unpacks with its grad_fn, so the second derivative holds K's
    dependence on every input. gradgradcheck in f64 (its own finite
    differences, atol 1e-5 / rtol 1e-3), then the Hessian in Z against the
    plain version's (f64, 1e-12 absolute)."""
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal((4, 2)), rng.standard_normal((5, 2)), np.array(1.3),
            np.array([0.7, 1.2]) if ard else np.array(0.9))
    args = [torch.tensor(v, requires_grad=True) for v in vals]
    assert torch.autograd.gradgradcheck(sg.se_gram_fused, args)
    Z, X, v, ls = (torch.tensor(a) for a in vals)
    H = [torch.autograd.functional.hessian(lambda z: torch.sum(f(z, X, v, ls) ** 2), Z)
         for f in (sg.se_gram_fused, sg.se_gram_reference)]
    np.testing.assert_allclose(H[0].numpy(), H[1].numpy(), rtol=0, atol=1e-12)


def _t(shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError),
    ("non_contiguous", ValueError),
    ("mismatched_D", ValueError),
    ("too_wide", ValueError),
    ("lengthscale_count", ValueError),
    ("variance_count", ValueError),
    ("not_a_tensor", TypeError),
])
def test_cuda_input_checks_raise(case, exc):
    """What the kernel does not take raises before any launch."""
    Z, X, var, ls = _t((4, 3)), _t((5, 3)), _t(()), _t((3,))
    if case == "dtype":
        Z = Z.double()
    elif case == "non_contiguous":
        X = _t((3, 5)).T
    elif case == "mismatched_D":
        X = _t((5, 2))
    elif case == "too_wide":
        D = sg.SE_GRAM_MAX_D + 1
        Z, X, ls = _t((4, D)), _t((5, D)), _t((D,))
    elif case == "lengthscale_count":
        ls = _t((2,))
    elif case == "variance_count":
        var = _t((2,))
    elif case == "not_a_tensor":
        var = 1.0
    with pytest.raises(exc):
        sg._check_cuda(Z, X, var, ls)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_no_fallback_for_other_devices(device):
    """The wrapper gives the kernel or an error, never the plain version:
    tensors on any device but a CUDA card raise before a launch (the route
    sends them to the plain version before the call)."""
    Z, X, var, ls = _case(1, 20, 33, 4, True)
    args = [torch.as_tensor(a).to(device) for a in (Z, X, var, ls)]
    before = sg.se_gram_cuda.launches
    with pytest.raises(ValueError, match=f"no kernel for device {device}"):
        sg.se_gram_cuda(*args)
    assert sg.se_gram_cuda.launches == before


def test_source_cap_matches_wrapper():
    m = re.search(r"constexpr int kMaxD = (\d+);", CU.read_text())
    assert m and int(m.group(1)) == sg.SE_GRAM_MAX_D


def test_sources_include_no_pytorch_headers():
    """The kernel library is plain C++ for nvcc: including PyTorch's headers
    turns a seconds-long build into minutes."""
    for src in CU.parent.glob("*.cu*"):
        text = src.read_text()
        assert "torch/" not in text and "ATen/" not in text, src


def test_failed_build_raises_with_compiler_output_and_leaves_nothing(tmp_path,
                                                                     monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'se_gram.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_BUILD_DIR", build)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="error: broken"):
        _build.load_library()
    assert list(build.iterdir()) == []  # no partial library, no lock file


def test_library_name_follows_sources_and_flags(monkeypatch):
    srcs = _build._sources()
    assert CU in srcs
    d0 = _build._digest(srcs)
    assert d0 == _build._digest(srcs)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._digest(srcs) != d0


class _Library:
    """A stand-in for the kernel library: ``demo_f32`` records its
    arguments and returns the next code of ``codes``."""

    def __init__(self, codes, max_n=8):
        self.calls, self.codes = [], list(codes)
        self.demo_f32 = lambda *args: self.calls.append(args) or self.codes.pop(0)
        self.demo_error_string = lambda code: f"error {code}".encode()
        self.demo_max_n = lambda: max_n


def _stand_in_card(monkeypatch, lib):
    """``lib`` as the loaded library (``lib.loads`` counts the loads) and
    card 0 as the current device, its current stream 77."""
    lib.loads = 0

    def load():
        lib.loads += 1
        return lib

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(_build, "_counted", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=77))


def test_entry_point_binds_once_raises_with_the_library_text_and_counts(monkeypatch):
    """The launch path of ``ops/_build.py`` on a stand-in library: the entry
    point is bound once, with its argtypes and the stream's after them; a
    launch passes its arguments and the current stream; a nonzero return
    code raises with the library's error string and counts nothing; each
    launch that returns 0 counts one in the wrapper's ``launches``."""
    lib = _Library([0, 700, 0])
    _stand_in_card(monkeypatch, lib)

    def wrapper():
        pass

    launch = _build.EntryPoint("demo", [ctypes.c_int], wrapper, ("max_n", 8))
    assert wrapper.launches == 0 and _build._counted == {"wrapper": wrapper}
    card = torch.device("cuda", 0)
    launch(card, 5)
    assert lib.demo_f32.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert lib.demo_f32.restype is ctypes.c_int
    with pytest.raises(RuntimeError, match=r"wrapper: launch failed \(700\): error 700"):
        launch(card, 6)
    launch(card, 7)
    assert lib.calls == [(5, 77), (6, 77), (7, 77)] and wrapper.launches == 2
    assert lib.loads == 1


def test_entry_point_refuses_a_library_whose_limit_differs(monkeypatch):
    """A library built from sources whose limit differs from the wrapper's
    raises before any launch."""
    lib = _Library([0], max_n=4)
    _stand_in_card(monkeypatch, lib)

    def wrapper():
        pass

    launch = _build.EntryPoint("demo", [], wrapper, ("max_n", 8))
    with pytest.raises(RuntimeError, match="demo.cu's max_n 4 and the wrapper's 8 disagree"):
        launch(torch.device("cuda", 0))
    assert lib.calls == [] and wrapper.launches == 0


def _rn32(x):
    """An exact rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += 1 if Fraction(2) ** (e + 1) <= x else 0
    e -= 1 if Fraction(2) ** e > x else 0
    ulp = Fraction(2) ** (max(e, -126) - 23)
    m = x / ulp
    q, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and q % 2):
        q += 1
    return float(sign * q * ulp)


def test_fma_corrected_division_is_correctly_rounded():
    """The kernel scales its inputs by ℓ with q = RN(a·r), r = RN(1/ℓ), then
    q + RN(a − ℓq)·r in one FMA (se_gram.cu: fast_div), where the plain
    version divides. Emulated here in exact arithmetic, step by step, it
    gives RN(a/ℓ) for every pair: random inputs, and quotients on either
    side of rounding midpoints."""
    from fractions import Fraction as F

    rng = np.random.default_rng(0)
    A = np.concatenate([rng.standard_normal(1500), rng.uniform(-1e3, 1e3, 1500),
                        1 + np.arange(500) * 2.0 ** -23]).astype(np.float32)
    B = np.concatenate([rng.uniform(0.05, 30, 1500), np.exp(rng.uniform(-5, 5, 1500)),
                        np.full(500, 3.0)]).astype(np.float32)
    for a, b in zip(A.tolist(), B.tolist()):
        r = _rn32(1 / F(b))
        q = _rn32(F(a) * F(r))
        rem = _rn32(F(a) - F(b) * F(q))       # exact: fma(−q, ℓ, a)
        got = _rn32(F(q) + F(rem) * F(r))     # fma(rem, r, q)
        assert got == _rn32(F(a) / F(b)) == float(np.float32(a) / np.float32(b)), (a, b)


_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("z_dtype", _DTYPES)
@pytest.mark.parametrize("x_dtype", _DTYPES)
def test_route_checks_both_dtypes(x_dtype, z_dtype, device):
    """The kernel only when Z and X are both float32 on a card, as
    pallas_gram.se_gram_auto checks both dtypes; a mixed pair whose
    promotion is float32 (f16 or bf16 beside f32) takes the plain Gram."""
    want = ("kernel" if device == "cuda" and z_dtype == x_dtype == torch.float32
            else "plain")
    assert sg.se_gram_route(device, z_dtype, x_dtype) == want


def test_vjp_with_f64_hyperparameters_and_f32_inputs_matches_jax():
    """f64 σ² and ℓ beside f32 Z and X, as an f64 θ gives them: off the
    card both packages take the plain Gram in the promoted f64, and the
    analytic VJP rounds ℓ to Z's dtype in both. Each cotangent comes back
    in its own input's dtype; values to 1e-6 relative (the f32 cotangents
    of Z and X are JAX's f64 ones rounded to f32) and 1e-10 for σ̄², ℓ̄."""
    rng = np.random.default_rng(12)
    Z = rng.standard_normal((9, 4)).astype(np.float32)
    X = rng.standard_normal((13, 4)).astype(np.float32)
    var, ls = np.array(1.3), np.array([0.7, 1.1, 1.4, 0.9])
    G = rng.standard_normal((9, 13))

    def loss(Z, X, v, l):
        return jnp.sum(jnp.asarray(G) * pg.se_gram_fused(Z, X, v, l))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(Z), jnp.asarray(X), jnp.asarray(var), jnp.asarray(ls))
    args = [torch.tensor(a, requires_grad=True) for a in (Z, X, var, ls)]
    K = sg.se_gram_fused(*args)
    assert K.dtype == torch.float64
    torch.sum(torch.as_tensor(G) * K).backward()
    for a, w, rtol in zip(args, want, (1e-6, 1e-6, 1e-10, 1e-10)):
        assert a.grad.dtype == a.dtype and tuple(a.grad.shape) == a.shape
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vjp_skips_input_cotangents_not_needed(dtype, monkeypatch):
    """With Z and X needing no gradient (the θ-steps) the backward leaves out
    their two GEMMs and returns the same σ̄² and ℓ̄, bit for bit."""
    rng = np.random.default_rng(13)
    vals = (rng.standard_normal((8, 3)), rng.standard_normal((11, 3)), np.array(0.9),
            np.array([0.8, 1.2, 1.5]))
    G = torch.as_tensor(rng.standard_normal((8, 11)), dtype=dtype)
    calls = []
    real_matmul = torch.matmul

    def counting_matmul(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real_matmul(a, b)

    grads = {}
    for need_inputs in (True, False):
        args = [torch.tensor(v, dtype=dtype, requires_grad=(need_inputs or i >= 2))
                for i, v in enumerate(vals)]
        K = sg.se_gram_fused(*args)
        calls.clear()
        monkeypatch.setattr(torch, "matmul", counting_matmul)
        torch.sum(G * K).backward()
        monkeypatch.setattr(torch, "matmul", real_matmul)
        grads[need_inputs] = (args[2].grad, args[3].grad, len(calls))
        assert (args[0].grad is not None) == need_inputs
        assert (args[1].grad is not None) == need_inputs
    assert torch.equal(grads[True][0], grads[False][0])
    assert torch.equal(grads[True][1], grads[False][1])
    assert grads[True][2] == 2 and grads[False][2] == 1
